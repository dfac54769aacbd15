"""fetch_ms.live: the 95th percentile, over the blocks whose fetch began
in the window, of the fan-out's fetch of a block's gathered rows
(``radio._rows_to_host``: the copy into pinned host memory and the wait
on its event, which the one stream orders after the next block's step),
in ms, from the program's flight recorder (``webradio_tpu_torch.trace``).
Layer: fan-out and listeners (``radio.FrontEnd._fanout_worker``)."""

import numpy as np


def read(run):
    try:
        from webradio_tpu_torch import trace
    except ImportError:
        return None
    got = trace.window("fetch0", *run.window)
    if got is None:
        return None
    rec, rows = got
    end = rec.column(rows, "fetch1")
    spans = (end - rec.column(rows, "fetch0"))[end > 0]
    return float(np.percentile(spans, 95)) / 1e6 if spans.size else None
