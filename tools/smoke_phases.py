"""Run some of ``chip_smoke.py``'s phases alone on the card: the build,
then each named phase, a failure printed and the next phase run.

    python3 tools/smoke_phases.py [--tree DIR] [sharded] [sharded_channel]
        [offline] [multihost] [two_process] [bench] [accuracy]

With no phase named it runs the first five (the multi-device layer and the
offline runners, ~3 minutes with the build); ``sharded_channel`` is the
sharded engine's per-channel body on kernel #4 (its (2, 2) and (4, 1)
runs, a live bandwidth switch); ``bench`` is the smoke's ``bench_torch.py``
phase (``--parity``, two sweep points, the point past 2^31 elements held
against the plain tail); ``accuracy`` is ``bench_torch.py --accuracy``
through kernel #1 and the plain tail, gated on the JAX laws (the tier
rule). ``--tree DIR`` runs another
checkout's ``chip_smoke.py`` and package (an unpacked ``git archive`` of
another commit, for an A/B in one call: run the trees in turns). Prints
the card's name and power limit first, each phase's log as the smoke
prints it, and one ``PHASES {...}`` line of the tree and the phases'
results (also written to ``chiprun_out/smoke_phases.json``); exits 1 if a
phase failed.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
import traceback

TREE = pathlib.Path(sys.argv[sys.argv.index("--tree") + 1]
                    if "--tree" in sys.argv
                    else pathlib.Path(__file__).parent.parent).resolve()
sys.path.insert(0, str(TREE))

import chip_smoke  # noqa: E402

PHASES = {
    "sharded": lambda dev, results: chip_smoke.phase_sharded(dev, results,
                                                            {}),
    "sharded_channel": lambda dev, results: chip_smoke.phase_sharded_channel(
        dev, results, {"fused_receiver_tail": {}}),
    "offline": chip_smoke.phase_offline,
    "multihost": lambda dev, results: chip_smoke.phase_multihost(results),
    "two_process": lambda dev, results: chip_smoke.phase_two_process(
        results),
    "bench": chip_smoke.phase_bench,
    "accuracy": chip_smoke.phase_accuracy,
}
DEFAULT = ("sharded", "sharded_channel", "offline", "multihost",
           "two_process")


def main(argv) -> int:
    import torch
    from webradio_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("smoke_phases: torch sees no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    _build.build_library()
    _build.load_library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda:0")
    results: dict = {}
    failed = []
    names = [a for a in argv[1:] if a in PHASES]
    for name in names or DEFAULT:
        t1 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            PHASES[name](dev, results)
        except Exception:
            failed.append(name)
            traceback.print_exc()
        chip_smoke.release()
        print(f"== {name} done in {time.perf_counter() - t1:.1f} s",
              flush=True)
    line = json.dumps({"tree": str(TREE), "failed": failed,
                       "results": results}, default=str)
    print("PHASES " + line, flush=True)
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "smoke_phases.json").write_text(line)
    print(f"failed: {failed}" if failed else "all phases passed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
