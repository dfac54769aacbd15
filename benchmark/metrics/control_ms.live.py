"""control_ms.live: the mean host time a block of the pump's control
writes (``radio.FrontEnd.apply_control`` before the block: the queued
slot scatters of the retunes), in ms, over the blocks whose writes began
in the window, from the program's flight recorder
(``webradio_tpu_torch.trace``). Layer: topology pump."""


def read(run):
    try:
        from webradio_tpu_torch import trace
    except ImportError:
        return None
    got = trace.window("control0", *run.window)
    if got is None:
        return None
    rec, rows = got
    end = rec.column(rows, "control1")
    spans = (end - rec.column(rows, "control0"))[end > 0]
    return float(spans.mean()) / 1e6 if spans.size else None
