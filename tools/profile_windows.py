"""Many profiler windows over the port's server under load, on one CUDA
card: how often a window records fewer kernel events than the pump's graph
replays launched in it (none, or a part), and what a ``/profile`` trace
costs the pump.

    python3 tools/profile_windows.py [--windows N] [out.json]

Starts ``RadioApp`` with ``chip_smoke.server_config``'s three tone tuners
(C=16,384 with kernel #1 every block, the direct demo tuner, 256
channelized slots) on the card, then ``--windows`` times in turns: a 1 s
``torch.profiler`` window of the device on this thread
(``chip_smoke.device_profile``), a second for the pump to catch up, and a
``/profile`` trace of 0.5 s over HTTP. For each window: its kernel and copy
events and the kernel events the replays in it launched
(``web.handlers.expected_kernel_events``; for a trace the server refuses,
the event categories of the trace it kept aside); for each trace
the blocks each tuner's rings dropped from its start to the moment every
ring had drained after it, and each of its stretches (the profiler's
start, stop and export, the waits for the pump, the check) with its ms,
the pump's longest gap over it and each tuner's ring depths and drops
(``chip_smoke.TraceProbe``). Writes them as JSON to ``out.json`` when
given and prints a summary; needs a CUDA card and exits 1 without. A
window and trace that runs past ``--watchdog`` seconds dumps every
thread's stack to stderr (and again each period while it lasts).
"""

from __future__ import annotations

import argparse
import collections
import faulthandler
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def _drained(fes, limit=5.0):
    t0 = time.monotonic()
    while any(fe.ring.backlog for fe in fes) and time.monotonic() < t0 + limit:
        time.sleep(0.005)


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("out", nargs="?")
    parser.add_argument("--windows", type=int, default=20)
    parser.add_argument("--watchdog", type=float, default=120.0,
                        help="seconds after which a window and trace that "
                        "has not ended dumps every thread's stack")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_windows: torch sees no CUDA device", file=sys.stderr)
        return 1
    from webradio_tpu_torch import app as tapp
    from webradio_tpu_torch.ops import _build
    from webradio_tpu_torch.radio import Radio

    _build.build_library()
    _build.load_library()
    tmp = tempfile.mkdtemp(prefix="profile_windows_")
    app = tapp.RadioApp(cs.server_config(pathlib.Path(tmp) / "sink.wav"))
    restore_start = cs.TraceProbe.note_opening()
    try:
        if not app.start():
            print("profile_windows: the server did not start",
                  file=sys.stderr)
            return 1
    finally:
        restore_start()
    fes, port = list(app.front_ends), app.server.port
    probe, watch = cs.TraceProbe(fes), cs.PumpWatch(fes, app._pump)
    drops = lambda: [cs.PumpWatch.dropped(fe) for fe in fes]
    out = {"device": cs.nvidia_smi("name,power.limit"), "windows": [],
           "traces": []}
    try:
        while min(fe.block_count for fe in fes) < 10:
            time.sleep(0.05)
        for i in range(args.windows):
            faulthandler.dump_traceback_later(args.watchdog, repeat=True)
            _drained(fes)
            prof = cs.device_profile(lambda j: time.sleep(0.1), 10,
                                     cpu=False,
                                     mark=lambda: cs.graph_kernels(fes))
            out["windows"].append({"kernels": prof["kernels"],
                                   "copies": prof["copies"],
                                   "expected": cs.window_expected(prof)})
            # the window's trace parse holds the interpreter for about
            # 0.85 s, which leaves a backlog in the native rings too: the
            # pump has a second to catch up before the trace
            time.sleep(1.0)
            _drained(fes)
            d0, k0 = drops(), len(probe.stretches)
            trace_dir = f"{tmp}/trace{i}"
            s1, _ = cs.http_call(port, "POST", "/profile",
                                 {"action": "start", "dir": trace_dir})
            time.sleep(0.5)
            s2, data = cs.http_call(port, "POST", "/profile",
                                    {"action": "stop"})
            _drained(fes)
            answer = json.loads(data)
            rec = {"status": [s1, s2],
                   "kernel_events": answer.get("kernel_events"),
                   "expected_kernel_events": answer.get(
                       "expected_kernel_events"),
                   "dropped": [b - a for a, b in zip(d0, drops())],
                   "stretches": probe.records(watch, k0)}
            for kept in ("trace_without_kernels.json",
                         "trace_missing_kernels.json"):
                kept = pathlib.Path(trace_dir) / kept
                if kept.exists():
                    events = json.loads(kept.read_text())["traceEvents"]
                    rec["categories"] = dict(collections.Counter(
                        e.get("cat", "") for e in events))
            out["traces"].append(rec)
            cs.log(f"  {i}: window {out['windows'][-1]}, trace "
                   f"{rec['status']} {rec['kernel_events']} kernel events, "
                   f"dropped {rec['dropped']}; " + ", ".join(
                       f"{r['stretch']} {r['ms']:.0f} ms (pump gap "
                       f"{r['pump_gap_ms']:.0f})" for r in rec["stretches"]))
    finally:
        faulthandler.cancel_dump_traceback_later()
        probe.close()
        watch.close(())
        app.close()
        Radio.reset()
    w = out["windows"]
    t = out["traces"]
    out["summary"] = {
        "kernelless_windows": sum(not r["kernels"] for r in w),
        "kernelless_traces": sum(not r["kernel_events"] for r in t),
        "short_windows": sum(r["kernels"] < r.get("expected", 0) for r in w),
        "refused_traces": sum(r["status"][1] != 200 for r in t),
        "traces_with_drops": sum(any(r["dropped"]) for r in t),
        "dropped_blocks": sum(sum(r["dropped"]) for r in t),
        "graph": [fe.graph_stats() for fe in fes],
        "n": len(w)}
    cs.log("  summary " + json.dumps(out["summary"]))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
