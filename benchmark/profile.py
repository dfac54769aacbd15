"""The device's own timeline from ``torch.profiler`` over the measured
window: what ran on each card and when, and the arithmetic the per-layer
metrics read (the union of busy intervals, the idle share, device time by
kernel name, the longest idle gaps).

The arithmetic is the one ``chip_smoke.device_profile`` and
``tools/profile_windows.py`` apply (kernel, memcpy and memset events only,
overlapping streams counted once), copied here so that a change to the
program cannot move it. The profiler's start and stop hold the program's
``LAUNCH_LOCK``, as its own ``/profile`` does: a profiler stop and a CUDA
graph launch on another thread were seen to deadlock on the H100.
"""

from __future__ import annotations

import collections
import time


def warm() -> None:
    """Start and stop one profiler session: the first start in a process
    sets up CUPTI (seconds); later starts take milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from webradio_tpu_torch.pipeline.graph import LAUNCH_LOCK

    prof = profile(activities=[ProfilerActivity.CUDA])
    with LAUNCH_LOCK:
        prof.start()
    torch.cuda.synchronize()
    with LAUNCH_LOCK:
        prof.stop()


class Window:
    """One profiler session of the card's activity."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.start_s = self.stop_s = 0.0

    def start(self) -> None:
        from webradio_tpu_torch.pipeline.graph import LAUNCH_LOCK

        with LAUNCH_LOCK:
            self._prof.start()
        self.start_s = time.perf_counter()

    def stop(self) -> None:
        import torch

        from webradio_tpu_torch.pipeline.graph import LAUNCH_LOCK

        self.stop_s = time.perf_counter()
        torch.cuda.synchronize()
        with LAUNCH_LOCK:
            self._prof.stop()

    def timeline(self) -> "Timeline":
        """The device events of the session, on the host's
        ``perf_counter`` clock."""
        from torch.autograd import DeviceType

        # the profiler's timestamps are wall-clock nanoseconds
        offset_ns = time.time_ns() - time.perf_counter_ns()
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            t0 = (e.start_ns() - offset_ns) * 1e-9
            events.append((t0, t0 + e.duration_ns() * 1e-9,
                           e.device_index(), e.name()))
        return Timeline(events, self.start_s, self.stop_s)


def _union(spans) -> list:
    merged = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


class Timeline:
    """Device events ``(start s, end s, device, name)`` inside a traced
    window ``[start_s, stop_s]`` of the host clock."""

    def __init__(self, events, start_s: float, stop_s: float):
        self.events = events
        self.start_s, self.stop_s = start_s, stop_s

    @property
    def window_s(self) -> float:
        return self.stop_s - self.start_s

    @property
    def devices(self) -> list:
        return sorted({e[2] for e in self.events})

    def busy_intervals(self, device) -> list:
        return _union((t0, t1) for t0, t1, d, _ in self.events
                      if d == device)

    def busy_s(self, device) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy_intervals(device))

    def busiest(self):
        """``(device, busy s)`` of the busiest card (None without
        events)."""
        if not self.events:
            return None, 0.0
        return max(((d, self.busy_s(d)) for d in self.devices),
                   key=lambda x: x[1])

    def by_name(self, device=None) -> dict:
        """Device seconds by event name (every card, or one)."""
        out: dict = collections.defaultdict(float)
        for t0, t1, d, name in self.events:
            if device is None or d == device:
                out[name] += t1 - t0
        return dict(out)

    def idle_gaps(self, device, n: int = 10) -> list:
        """The ``n`` longest gaps between busy intervals of ``device``:
        ``(start s, length s)``."""
        busy = self.busy_intervals(device)
        gaps = [(a[1], b[0] - a[1]) for a, b in zip(busy, busy[1:])]
        return sorted(gaps, key=lambda g: -g[1])[:n]
