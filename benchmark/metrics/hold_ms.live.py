"""hold_ms.live: the 95th percentile, over the blocks dispatched in the
window, of the time from the end of a block's own ``process_host`` to the
end of the pump's hand-off of its rows to the fan-out (one call later: the
pipeline hands back the previous block's outputs), in ms, from the
program's flight recorder (``webradio_tpu_torch.trace``). Layer: topology
pump (``radio.FrontEnd.run_once``)."""

import numpy as np


def read(run):
    try:
        from webradio_tpu_torch import trace
    except ImportError:
        return None
    got = trace.window("dispatch1", *run.window)
    if got is None:
        return None
    rec, rows = got
    end = rec.column(rows, "handoff1")
    spans = (end - rec.column(rows, "dispatch1"))[end > 0]
    return float(np.percentile(spans, 95)) / 1e6 if spans.size else None
