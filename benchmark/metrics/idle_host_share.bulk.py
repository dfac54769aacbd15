"""idle_host_share.bulk: the share of the busiest card's idle time in the
traced window that falls inside the pump's own spans (``control``,
``dispatch``, ``publish``, ``handoff`` of ``radio.FrontEnd.run_once``:
the card waits on the pump's host work), not its ring wait or between
its calls, in %, from the program's flight recorder
(``webradio_tpu_torch.trace``) laid over the device timeline on the same
clock. Layer: device."""

SPANS = (("control0", "control1"), ("dispatch0", "dispatch1"),
         ("publish0", "publish1"), ("handoff0", "handoff1"))


def _union(spans) -> list:
    merged = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    dev, _ = tl.busiest()
    if dev is None:
        return None
    try:
        from webradio_tpu_torch import trace
    except ImportError:
        return None
    lo, hi = tl.start_s, tl.stop_s
    got = trace.window("dispatch0", lo, hi)
    if got is None:
        return None
    # every held block: a block's publish and hand-off come a call after
    # its dispatch, which may fall before the window
    rec = got[0]
    rows = rec.rows()
    host = []
    for a, b in SPANS:
        start, end = rec.column(rows, a) / 1e9, rec.column(rows, b) / 1e9
        host += [(max(s, lo), min(e, hi)) for s, e in zip(start, end)
                 if s > 0 and e > s and e > lo and s < hi]
    idle, t = [], lo
    for b0, b1 in tl.busy_intervals(dev):
        if b0 > t:
            idle.append((t, min(b0, hi)))
        t = max(t, b1)
        if t >= hi:
            break
    if t < hi:
        idle.append((t, hi))
    idle = [(a, b) for a, b in idle if b > a]
    idle_s = sum(b - a for a, b in idle)
    if idle_s <= 0 or not host:
        return None
    inside, i = 0.0, 0
    host = _union(host)
    for a, b in idle:  # both sorted and disjoint
        while i < len(host) and host[i][1] <= a:
            i += 1
        j = i
        while j < len(host) and host[j][0] < b:
            inside += min(b, host[j][1]) - max(a, host[j][0])
            j += 1
    return 100.0 * inside / idle_s
