"""The control of the outputs check: the plain reference computed in
float32 with TF32 products (the step below the float32 the configuration
states, with TF32 off), put in the program's place on the blocks a run of
the cell compares, read against the float64 reference. Its numbers must
fail the limits in the configuration's file; the program's must pass them.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds S] [--rt R]

A run's served sequence is stood in for by consecutive blocks: the warm-up,
then the window (``S`` seconds of blocks at the tuner's rate, times ``R``
in a closed loop, the real-time factor a run reads), with each retune
applied at the block of its schedule and each spectrum poll at its block.
The compared blocks are drawn as a run draws them. Prints one JSON line a
seed. Runs on the card where there is one (as TF32 is), else on the CPU
with the TF32 rounding done by hand.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


from . import check, harness, reference, registry, signal


def stand_in(cell, seed: int, seconds: float, rt: float,
             device: str) -> check.Record:
    """A run's record with consecutive blocks served and no program."""
    tr = cell.traffic
    chain = reference.Chain(cell.tuner)
    period = chain.block_seconds
    retune_times = [(i + 0.5) / tr["retunes_per_s"]
                    for i in range(int(tr["retunes_per_s"] * seconds))]
    plan = signal.make_plan(cell.tuner, tr, seed, len(retune_times))
    pool = signal.make_pool(cell.tuner, plan, seed, device)
    warm = harness.WARM_BLOCKS
    rate = 1.0 if tr["loop"] == "open" else rt
    n_window = int(seconds * rate / period)
    offered = list(range(warm, warm + n_window))
    sample = check.Reservoir(seed)
    for seq in offered:
        sample.offer(seq)
    applied: dict = {}
    for k, t in enumerate(retune_times):
        seq = warm + math.ceil(t * rate / period)
        applied.setdefault(seq, []).append(k)
    polls = []
    if tr["spectrum_polls_per_s"]:
        for j in range(int(seconds * tr["spectrum_polls_per_s"])):
            t = (j + 1) / tr["spectrum_polls_per_s"]
            polls.append(([warm + int(t * rate / period)], None))
    template = cell.config["topology"]["receivers"][0]
    return check.Record(chain=chain, pool=pool, plan=plan, template=template,
                        served=list(range(warm + n_window + 2)),
                        applied=applied,
                        compared=check.compared(sample.sample, offered),
                        polls=polls, listeners=len(plan.receivers))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--rt", type=float, default=1.0,
                   help="a closed loop's real-time factor")
    args = p.parse_args(argv)
    import torch

    cell = registry.find_cell(args.workload)
    bench = json.loads((cell.root / "BENCHMARK.json").read_text())
    seconds = args.seconds or float(bench["run_seconds"])
    device = "cuda" if torch.cuda.is_available() else "cpu"
    limits = cell.config["limits"]
    for seed in args.seeds:
        rec = stand_in(cell, seed, seconds, args.rt, device)
        numbers = check.outputs(rec, device=device, control=True)
        failed = [k for k, v in numbers.items()
                  if limits.get(k) is not None and v > limits[k]]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "device": device, "control": numbers,
                          "limits": limits, "fails": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
