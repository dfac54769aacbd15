"""Probe ``torch.profiler`` on a CUDA card while another thread launches
work, as the port's server pump does (``webradio_tpu_torch``).

    python3 tools/torch_profiler_probe.py [out.json]

A worker thread stands in for the pump: every 42.67 ms (one block of
signal) it launches a float32 matmul and a few small elementwise kernels
and waits for them on an event, recording when each block ends. The main
thread meanwhile opens profiler windows of 0.5 s, in turns:

- "main": ``profile(activities=[CUDA])`` started and stopped on the main
  thread, as ``chip_smoke.device_profile`` does;
- "main+cpu": the same with CPU activity too;
- "own thread": started and stopped on a thread of its own, as the
  server's ``/profile`` (``web/handlers._TraceSession``) does;
- "worker": started and stopped by the launching thread itself.

For each window: the ms of ``start()``, ``stop()`` and
``export_chrome_trace`` (and of ``events()``, which parses the trace in
Python), the kernel and copy events the trace holds, the blocks the worker
finished inside it and its longest gap between two blocks (a gap above
four blocks would overflow the server's ring). Prints one JSON object and
writes it to ``out.json`` when given. Needs a CUDA card; exits 1 without.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import tempfile
import threading
import time

BLOCK_S = 102_400 / 2_400_000
WINDOW_S = 0.5
REPEATS = 3


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    a = torch.randn(2048, 2048, device=dev)
    stamps: list[float] = []
    stop = threading.Event()
    # the worker's own profiler requests: (function, done event)
    requests: list = []

    def one_block():
        y = a @ a
        y = torch.tanh(y) * 0.5 + 1.0
        done = torch.cuda.Event()
        done.record()
        done.synchronize()

    def worker():
        nxt = time.monotonic()
        while not stop.is_set():
            if requests:
                fn, ev = requests.pop(0)
                fn()
                ev.set()
            one_block()
            stamps.append(time.monotonic())
            nxt += BLOCK_S
            time.sleep(max(0.0, nxt - time.monotonic()))

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    time.sleep(0.5)

    def counts(path):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        cats = [e.get("cat", "") for e in events]
        return (sum(c == "kernel" for c in cats),
                sum(c in ("gpu_memcpy", "gpu_memset") for c in cats))

    def window(variant):
        acts = [ProfilerActivity.CUDA]
        if variant == "main+cpu":
            acts.append(ProfilerActivity.CPU)
        prof = profile(activities=acts)
        rec: dict = {"variant": variant}

        def timed(name, fn):
            t0 = time.perf_counter()
            fn()
            rec[name + "_ms"] = 1e3 * (time.perf_counter() - t0)

        def in_worker(fn):
            ev = threading.Event()
            requests.append((fn, ev))
            ev.wait()

        # the profiler is stopped on the thread that started it
        run = {"main": lambda fn: fn(), "main+cpu": lambda fn: fn(),
               "own thread": own.run, "worker": in_worker}[variant]
        n0, t_start = len(stamps), time.monotonic()
        try:
            run(lambda: timed("start", prof.start))
            time.sleep(WINDOW_S)
            run(lambda: timed("stop", prof.stop))
            path = os.path.join(tempfile.mkdtemp(), "trace.json")
            timed("export", lambda: prof.export_chrome_trace(path))
            t_end = time.monotonic()
            timed("events", prof.events)
            rec["kernel_events"], rec["copy_events"] = counts(path)
        except Exception as e:  # recorded: the probe goes on
            t_end = time.monotonic()
            rec["error"] = f"{type(e).__name__}: {e}"
        inside = [t for t in stamps[n0:] if t <= t_end]
        rec["blocks"] = len(inside)
        edges = [t_start] + inside + [t_end]
        rec["max_gap_ms"] = 1e3 * max(b - a_ for a_, b in zip(edges,
                                                               edges[1:]))
        return rec

    class OwnThread:
        """One thread that runs what it is given, in turn."""

        def __init__(self):
            self.q: queue.Queue = queue.Queue()
            threading.Thread(target=self._loop, daemon=True).start()

        def _loop(self):
            while True:
                fn, ev = self.q.get()
                fn()
                ev.set()

        def run(self, fn):
            ev = threading.Event()
            self.q.put((fn, ev))
            ev.wait()

    own = OwnThread()
    out = []
    for rep in range(REPEATS):
        for variant in ("main", "main+cpu", "own thread", "worker"):
            rec = window(variant)
            rec["repeat"] = rep
            out.append(rec)
            print(json.dumps(rec), flush=True)
            time.sleep(0.3)
    stop.set()
    th.join(timeout=5)
    result = {"device": torch.cuda.get_device_name(0), "windows": out}
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
