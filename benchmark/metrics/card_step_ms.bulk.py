"""card_step_ms.bulk: the median, over the blocks dispatched in the
window, of the slowest card's step (the recorder's ``step_ns``: on a
sharded front end the largest of its cards' timing-event pairs, each
recorded on its card's stream just before that card's first graph replay
of the block and just after its last, ``parallel.graphs.BlockProgram.
run``), in ms, from the program's flight recorder
(``webradio_tpu_torch.trace``). A pair spans the card's own work and any
wait on that card for the host's later launches of the same round, not
the other cards' launches before its first. None on a program whose
recorder keeps no per-card step (no ``step_min_ns`` field). Layer:
multi-device (``parallel``)."""

import numpy as np


def read(run):
    try:
        from webradio_tpu_torch import trace
    except ImportError:
        return None
    if "step_min_ns" not in getattr(trace, "COLUMN", {}):
        return None
    got = trace.window("dispatch0", *run.window)
    if got is None:
        return None
    rec, rows = got
    steps = rec.column(rows, "step_ns")[rec.column(rows, "step_min_ns") > 0]
    return float(np.median(steps)) / 1e6 if steps.size else None
