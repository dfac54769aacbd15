"""pump_ms.live: the pump's host time a block inside ``FrontEnd.run_once``
outside its wait on the ring and outside ``process_host`` (control writes,
the publish's gather and spectrum copy, the hand-off to the fan-out), in
ms, over the calls of the window. Layer: topology pump
(``radio.FrontEnd.run_once``)."""


def read(run):
    t0, t1 = run.window
    own = blocks = 0
    for start, end, wait, n, dispatch in run.pump_calls:
        if t0 <= start and end <= t1 and n:
            own += end - start - wait - dispatch
            blocks += n
    return 1e3 * own / blocks if blocks else None
