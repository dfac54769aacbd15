"""The ``/profile`` trace never runs its stretches that hold the pump back
to back (``web/handlers._TraceSession``): after the profiler's stop, and
after the export, the trace thread waits until the pump has served what
the rings took in meanwhile (``wait_for_pump``).

A stand-in profiler's ``stop`` and ``export_chrome_trace`` hold a lock for
0.3 s that a counter-driven stand-in pump needs for every block, as the
profiler's stop holds the card's CUDA calls and its export the
interpreter; the stand-in source delivers one block every 50 ms meanwhile.
The test reads, at the export's start, how many blocks the pump had
served against how many had arrived by the end of the stop. No assertion
is on the wall clock.
"""

import threading
import time
import types

import pytest
import torch.profiler

from webradio_tpu_torch.radio import Radio
from webradio_tpu_torch.web import handlers

BLOCK_S, HOLD_S = 0.05, 0.3


class PumpedFrontEnd:
    """Stands in for a running ``FrontEnd``: its source delivers a block
    every ``BLOCK_S``, and a pump thread serves one whenever its ring holds
    one and it can take ``held``."""

    def __init__(self, held: threading.Lock):
        self.uuid = "fake"
        self.running = True
        self.cfg = types.SimpleNamespace(block_seconds=BLOCK_S)
        self.block_count = 0
        self._held = held
        self._t0 = time.monotonic()
        self.ring = self  # its ``backlog`` below
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._run, daemon=True)
        self._pump.start()

    @property
    def backlog(self) -> int:
        return self.delivered() - self.block_count

    def graph_stats(self) -> dict:
        return {"captures": 0, "replays": 0, "warms": 0, "kernels": 0}

    def graph_kernels_per_block(self) -> int:
        return 0

    def delivered(self, at=None) -> int:
        return int(((at or time.monotonic()) - self._t0) / BLOCK_S)

    def _run(self):
        while not self._stop.is_set():
            with self._held:
                if self.delivered() > self.block_count:
                    self.block_count += 1
            time.sleep(0.001)

    def close(self):
        self._stop.set()
        self._pump.join(5)
        assert not self._pump.is_alive()


@pytest.fixture
def front_end():
    held = threading.Lock()
    fe = PumpedFrontEnd(held)
    Radio.front_ends[fe.uuid] = fe
    yield fe, held
    fe.close()
    Radio.front_ends.pop(fe.uuid, None)


def test_the_trace_exports_only_after_the_pump_caught_up(front_end,
                                                         monkeypatch, tmp_path):
    fe, held = front_end
    seen = {}

    class HoldingProfile:
        def __init__(self, activities):
            pass

        def start(self):
            pass

        def stop(self):
            with held:  # the pump can serve no block meanwhile
                time.sleep(HOLD_S)
                seen["stop_end"] = time.monotonic()

        def export_chrome_trace(self, path):
            seen["served_at_export"] = fe.block_count
            with held:
                time.sleep(HOLD_S)
                seen["export_end"] = time.monotonic()
            with open(path, "w") as f:
                f.write('{"traceEvents": []}')

    monkeypatch.setattr(torch.profiler, "profile", HoldingProfile)
    while fe.block_count < 2:  # the pump is serving
        time.sleep(0.005)
    session = handlers._TraceSession(str(tmp_path))
    session.stop()
    # every block that arrived while the stop held the pump was served
    # before the export began
    assert seen["served_at_export"] >= fe.delivered(seen["stop_end"])
    assert fe.delivered(seen["stop_end"]) >= 6  # the stop held a backlog
    assert set(session.timings_ms) == {"start", "stop", "wait_after_stop",
                                       "export", "wait_after_export"}
    assert session.timings_ms["wait_after_stop"] > 0
    assert (tmp_path / "trace.json").exists()
    # and the trace thread waited out the export's backlog too
    assert fe.block_count >= fe.delivered(seen["export_end"])


def test_wait_for_pump_is_bounded_and_skips_stopped_front_ends(front_end):
    fe, held = front_end
    with held:  # a pump that cannot serve
        mark = handlers._pump_mark()
        time.sleep(3 * BLOCK_S)
        t0 = time.monotonic()
        assert handlers.wait_for_pump(mark, timeout=0.1) is False
        assert time.monotonic() - t0 >= 0.1
        fe.running = False  # a stopped front end no longer counts
        assert handlers.wait_for_pump(mark, timeout=10) is True
    fe.running = True
    assert handlers.wait_for_pump(handlers._pump_mark(), timeout=10) is True
