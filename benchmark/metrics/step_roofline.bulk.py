"""step_roofline.bulk: the two-stage bound of one card's share of a block
(the filterbank GEMM at the tier, then kernel #1; ``roofline.roofline_ms``)
over the busiest card's busy time a block in the traced window, in %: the
same work whatever implements it. Layer: the serving step on the device
(``pipeline.channelized``: ``ops.channelizer`` and the tail)."""


def read(run):
    tl = run.timeline
    if tl is None or not run.dispatched:
        return None
    dev, busy = tl.busiest()
    if dev is None or busy <= 0:
        return None
    per_block_ms = 1e3 * busy / len(run.dispatched)
    return 100.0 * run.step_bound_ms() / per_block_ms
