"""idle_share.bulk: the share of the traced window in which no kernel,
copy or memset runs on the busiest card, in %. Layer: device."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    dev, busy = tl.busiest()
    if dev is None:
        return None
    return 100.0 * (1.0 - busy / tl.window_s)
