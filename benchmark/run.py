"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs as many CUDA cards as the cell asks for; without them it exits 1 and
prints no result. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a ``torch.profiler`` window over
the same measurement. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the outputs
check compared, beside its limit); the last lines of standard error repeat
those numbers.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "webradio_tpu")


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux's
    ``/proc``; where it cannot be read, this module's import)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


T_START = process_start()


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cards(n: int) -> str | None:
    """Why a run asking for ``n`` cards cannot run here, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch sees no CUDA device"
    if torch.cuda.device_count() < n:
        return f"the cell asks for {n} cards, torch sees " \
               f"{torch.cuda.device_count()}"
    return None


def measure(cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = T_START,
            fault=None) -> dict:
    """One run: the result line's fields (``checks`` last)."""
    from . import check, harness, tracing

    run = harness.Run(cell, seed, seconds, trace, device=device,
                      t_start=t_start, fault=fault)
    run.setup()
    got = run.go()
    e2e = run.end_to_end(got["setup_s"])
    numbers = check.outputs(run.record(), device=device)
    gates = run.gates()
    for line in gates["lines"]:
        print(f"benchmark: {line}", file=sys.stderr)
    numbers.update(gates["numbers"])
    ok, checks = check.verdict(numbers, dict(cell.config["limits"],
                                             **gates["limits"]))
    if trace:
        view = tracing.view(run, got["timeline"])
        metrics = {}
        for m in cell.per_layer:
            value = m.reader.read(view)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        metrics = {m.name: {"value": e2e[m.name], "unit": m.unit}
                   for m in cell.end_to_end if m.name in e2e}
    extra = {k: v for k, v in e2e.items()
             if k not in metrics and k not in ("attempted", "failed")}
    print("benchmark: " + json.dumps({"run": extra}), file=sys.stderr)
    device_info = run.device_info(got)
    out = {"correct": ok, "attempted": e2e["attempted"],
           "failed": e2e["failed"], "metrics": metrics,
           "device": device_info}
    if trace and got["timeline"] is not None:
        out["breakdown"] = tracing.breakdown(run, got["timeline"])
        out["device"].update(tracing.busy_window(got["timeline"]))
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from . import registry

    try:
        cell = registry.find_cell(args.workload)
    except registry.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    why = cards(cell.chips)
    if why:
        print(f"benchmark: {why}; no result", file=sys.stderr)
        return 1
    out = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"benchmark: check {name} = {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
