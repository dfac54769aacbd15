"""deliver_ms.live: the 95th percentile, over the blocks whose delivery
began in the window, of the fan-out's delivery of a block
(``radio.FrontEnd._deliver_rows``: each listened receiver's encode and
the push to its consumers' queues), in ms, from the program's flight
recorder (``webradio_tpu_torch.trace``). Layer: fan-out and listeners
(``web.audiostream``, ``web.encoders``)."""

import numpy as np


def read(run):
    try:
        from webradio_tpu_torch import trace
    except ImportError:
        return None
    got = trace.window("deliver0", *run.window)
    if got is None:
        return None
    rec, rows = got
    end = rec.column(rows, "deliver1")
    spans = (end - rec.column(rows, "deliver0"))[end > 0]
    return float(np.percentile(spans, 95)) / 1e6 if spans.size else None
