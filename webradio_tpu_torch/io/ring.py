"""Host-side ingest ring: capture thread -> pipeline thread (the port's own
copy of ``webradio_tpu.io.ring``).

The reference decouples USB DMA cadence from DSP cadence with a 4-slot ring
+ mutex + condvar, dropping data with a log line on overrun
(src/io/rtlsdrtuner.cxx:33-34,86-117). Same semantics here: a bounded
deque of IQ blocks filled by a reader thread; ``get`` blocks the pipeline
thread until a block is ready; overruns drop the oldest block and count it.

Each block put is numbered (its id: ``first_id`` plus the blocks put
before it) and, where the ring has a flight recorder (``trace.Recorder``),
begins that block's row there with its ``put`` time and the ring's depth
after the put. The ids travel beside the blocks; the pump takes those of
the blocks it popped with :meth:`BlockRing.take_ids`.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

log = logging.getLogger(__name__)


class BlockRing:
    """Bounded block queue with drop-oldest overflow (depth 4 like
    N_BUFFERS_LOG2=2, rtlsdrtuner.cxx:33-34)."""

    def __init__(self, depth: int = 4, recorder=None, first_id: int = 0):
        self.depth = depth
        self._q: collections.deque = collections.deque()
        # the ids of the blocks in _q, and of those popped since the last
        # take_ids() with the ring's depth just after each pop (a pump's
        # get and drain pop at most 1 + depth; a reader that never takes
        # them keeps the latest only)
        self._ids: collections.deque = collections.deque()
        self._popped: collections.deque = collections.deque(
            maxlen=2 * depth + 2)
        self.recorder = recorder
        self.first_id = first_id
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._closed = False
        self.dropped_blocks = 0
        self.total_blocks = 0
        self._last_drop_log = 0.0

    def put(self, block) -> None:
        with self._lock:
            if len(self._q) >= self.depth:
                self._q.popleft()
                self._ids.popleft()
                self.dropped_blocks += 1
                now = time.monotonic()
                if now - self._last_drop_log >= 1.0:  # rate-limited
                    self._last_drop_log = now
                    log.warning("ingest overrun: dropping blocks (%d total)",
                                self.dropped_blocks)
            bid = self.first_id + self.total_blocks
            self._q.append(block)
            self._ids.append(bid)
            self.total_blocks += 1
            if self.recorder is not None:
                self.recorder.begin(bid, time.perf_counter_ns(),
                                    len(self._q))
            self._ready.notify()

    def get(self, timeout: float | None = None):
        """Block until a block is available; None if closed/timeout."""
        with self._lock:
            while not self._q:
                if self._closed:
                    return None
                if not self._ready.wait(timeout):
                    return None
            return self._pop()

    def _pop(self):
        block = self._q.popleft()
        self._popped.append((self._ids.popleft(), len(self._q)))
        return block

    def take_ids(self) -> list:
        """``(id, depth after the pop)`` of each block popped by ``get`` and
        ``drain`` since the last call, in order."""
        with self._lock:
            out = list(self._popped)
            self._popped.clear()
        return out

    def drain(self, max_n: int) -> list:
        """Pop up to ``max_n`` immediately-available blocks, no waiting
        (the pump's catch-up path: a backlog runs as one scanned dispatch)."""
        out: list = []
        with self._lock:
            while self._q and len(out) < max_n:
                out.append(self._pop())
        return out

    @property
    def backlog(self) -> int:
        with self._lock:
            return len(self._q)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._ready.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed


class CaptureThread(threading.Thread):
    """Reader thread pumping tuner blocks into a BlockRing
    (the reference's USB async capture thread, rtlsdrtuner.cxx:65-78)."""

    def __init__(self, tuner, ring: BlockRing):
        super().__init__(daemon=True, name="capture")
        self.tuner = tuner
        self.ring = ring
        # NOT named _stop: that would shadow threading.Thread's private
        # _stop() method, which Thread.join() calls internally
        self._stop_evt = threading.Event()

    def run(self) -> None:
        while not self._stop_evt.is_set():
            block = self.tuner.read_block()
            if block is None:
                break
            self.ring.put(block)
        self.ring.close()

    def stop(self) -> None:
        self._stop_evt.set()
