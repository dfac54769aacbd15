"""Run ``chip_smoke.phase_server`` (the port's ``RadioApp`` over HTTP on
one CUDA card: three tone tuners, a 1 s profiler window and a ``/profile``
trace) several times in one process, and report each run.

    python3 tools/server_phase_runs.py [runs] [out.json]

For each run: whether the phase passed (or its error), the ``/profile``
trace's kernel events and each of its stretches (the profiler's start,
stop, export, the trace's check, and the waits for the pump between them)
with its ms, the pump's longest gap over it and the drops of each tuner's
Python and native rings (``chip_smoke.TraceProbe``). Set
``TEARDOWN_CUPTI=0`` in the environment to keep the profiler's CUDA side
(CUPTI) attached between sessions. Writes the runs as JSON to ``out.json``
when given; needs a CUDA card and exits 1 without.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("server_phase_runs: torch sees no CUDA device", file=sys.stderr)
        return 1
    from webradio_tpu_torch.ops import _build

    runs = int(argv[1]) if len(argv) > 1 else 2
    _build.build_library()
    _build.load_library()
    out = {"device": chip_smoke.nvidia_smi("name,power.limit"),
           "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"), "runs": []}
    for run in range(runs):
        chip_smoke.log(f"== server run {run}")
        results: dict = {}
        try:
            chip_smoke.phase_server(results)
            error = None
        except Exception as e:  # a run's failure is its reading
            error = f"{type(e).__name__}: {e}"
            chip_smoke.log(f"  failed: {error}")
        server = results.get("server", {})
        out["runs"].append({
            "error": error,
            "trace_kernel_events": results.get("server_trace_kernel_events"),
            "stretches": results.get("server_trace_stretches"),
            "dropped_trace": {k: v["dropped_trace"]
                              for k, v in server.items()
                              if isinstance(v, dict) and "dropped_trace" in v},
        })
        chip_smoke.log("  " + json.dumps(out["runs"][-1])[:2000])
    if len(argv) > 2:
        pathlib.Path(argv[2]).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
