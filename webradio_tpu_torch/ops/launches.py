"""The launch counts of the four kernel wrappers.

Each wrapper (``tail_tm.fused_tail_audio_tm``, ``tail_tm.fused_tail_tm``,
``tail_tm.fused_pfb_tail_audio_tm``, ``tail.fused_receiver_tail``) calls
:func:`count_launch` where it launches its kernel, which adds one to its
``launches``. A launch made while a CUDA graph is being captured is
recorded, not run: while a thread captures (:func:`recording`), the
launches it makes go to the capture's own tally instead, and each replay of
the graph adds that tally (:func:`add_launches`). The tally is the
capturing thread's alone, so launches that other threads make meanwhile
(a pump replaying another pipeline's graphs) are counted as they happen
and never credited to the graph: a count stays one per kernel run on the
card.
"""

from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
_local = threading.local()


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: into this thread's capture tally
    while it records a graph, else into ``wrapper.launches``."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """The launches this thread makes in the body, as ``{wrapper: n}``,
    kept out of the wrappers' counts."""
    outer = getattr(_local, "tally", None)
    _local.tally = tally = {}
    try:
        yield tally
    finally:
        _local.tally = outer


def add_launches(tally: dict) -> None:
    """Add a recorded tally to the wrappers' counts (one graph replay)."""
    with _lock:
        for wrapper, n in tally.items():
            wrapper.launches += n
