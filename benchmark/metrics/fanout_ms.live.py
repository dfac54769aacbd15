"""fanout_ms.live: the 95th percentile, over the window's blocks that
reached every listener, of the time from the ``run_once`` that handed a
block to the fan-out returning to the last listener reading that block's
bytes (the fan-out's D2H copy, delivery, encoding and the listeners'
threads), in ms. Layer: fan-out and listeners (``radio.FrontEnd.
_fanout_worker``, ``web.audiostream``, ``web.encoders``)."""

import numpy as np


def read(run):
    spans = [b.last_read - b.handed for b in run.blocks
             if b.reads >= run.listeners and b.handed == b.handed]
    if not spans:
        return None
    return 1e3 * float(np.percentile(spans, 95))
