"""launch_spread_ms.bulk: the median, over the blocks dispatched in the
window, of the host time from the first card's graph launch of a block's
round to the end of the last card's (the recorder's ``launch0`` and
``launch1``, stamped in ``parallel.graphs.BlockProgram.run``): one pump
thread starting four cards, in ms, from the program's flight recorder
(``webradio_tpu_torch.trace``). The harness reads per-layer metrics in
traced runs only, where the profiler's hooks on every launch make this
span about three times what it is untraced (2.5-3.8 ms against
0.75-0.85 ms on four H100s); the recorder's ``/status`` summary
(``launch_ms``) gives the untraced span. None on a program whose
recorder has no launch span. Layer: step host wrapper and graphs."""

import numpy as np


def read(run):
    try:
        from webradio_tpu_torch import trace
    except ImportError:
        return None
    if "launch0" not in getattr(trace, "COLUMN", {}):
        return None
    got = trace.window("dispatch0", *run.window)
    if got is None:
        return None
    rec, rows = got
    start = rec.column(rows, "launch0")
    spans = (rec.column(rows, "launch1") - start)[start > 0]
    return float(np.median(spans)) / 1e6 if spans.size else None
