"""Kernel #1's decimating audio FIR in its two forms on the card, side by
side: the three-term TF32 tensor-core product the kernel builds for the
stock decimation 5, and the float32 FMA loop it builds for every other
decimation. Reads kernel #1's device time at C=1,024 and 16,384 (nd =
10,240) and ``bench_torch.py --accuracy``'s SNRs against float64 at C=128
for four filterbank tiers, in each form.

    python3 tools/audio_fir_ab.py [OUT_JSON]

The FMA form is a copy of the package under ``_checkout/audio_fir_ab/``
(gitignored) whose kernel picks the loop at decimation 5 too; each form
runs in its own process, in turns (tensor, fma, fma, tensor), each
building its own library. Prints the card's name and power limit, then
one JSON line of every run (also written to OUT_JSON, default
``chiprun_out/audio_fir_ab.json``). Needs a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPY = ROOT / "_checkout" / "audio_fir_ab" / "fma"
PICK = "return HAS_AUDIO_FIR && D == AD"
PAIRS = (("highest", "highest"), ("highest", "high"),
         ("highest", "u8exact"), ("highest", "default"))


def fma_tree() -> pathlib.Path:
    """The package copy whose kernel takes the FMA loop at every
    decimation."""
    shutil.rmtree(COPY, ignore_errors=True)
    COPY.mkdir(parents=True)
    shutil.copytree(ROOT / "webradio_tpu_torch", COPY / "webradio_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("chip_smoke.py", "bench_torch.py"):
        shutil.copy(ROOT / name, COPY / name)
    src = COPY / "webradio_tpu_torch" / "csrc" / "tail_tm.cu"
    text = src.read_text()
    if text.count(PICK) != 1:
        raise RuntimeError("the kernel's audio-FIR pick was not found")
    src.write_text(text.replace(PICK, "return false && D == AD"))
    return COPY


def measure(tree: str) -> dict:
    """One form: kernel #1's ms (three readings a width) and the SNRs."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import bench_torch
    import chip_smoke
    from webradio_tpu_torch.ops import _build, tail_tm

    _build.build_library()
    _build.load_library()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(7)
    w, wa = chip_smoke.shared_fir_weights(dev, 5)
    out = {}
    for c in (1_024, 16_384):
        nd, k = 10_240, 64
        u = lambda *s: torch.empty(s, device=dev).uniform_(-0.5, 0.5)
        prod = u(nd, 2 * c)
        lo = [torch.from_numpy(rng.integers(0, 2**n, c)).to(dev)
              for n in (31, 32)]
        mode = torch.from_numpy((np.arange(c) % 4).astype(np.int32)).to(dev)
        args = (prod, prod, *lo, w, wa, 5, mode, u(k - 1, c), u(k - 1, c),
                u(2, c), u(k - 1, c))
        out[f"kernel1_ms_c{c}"] = [chip_smoke.cuda_ms(
            lambda: tail_tm.fused_tail_audio_tm(*args, packed=True,
                                                fast=True), 50)
            for _ in range(3)]
    snr = bench_torch.accuracy(dev, pairs=PAIRS)
    out.update({k: v for k, v in snr.items()
                if k.startswith(("noise", "fm_tones", "u8_noise"))})
    return out


def main(argv) -> int:
    if argv[1:2] == ["--measure"]:
        print("MEASURED " + json.dumps(measure(argv[2])), flush=True)
        return 0
    out_path = pathlib.Path(argv[1] if len(argv) > 1
                            else ROOT / "chiprun_out" / "audio_fir_ab.json")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    trees = {"tensor": str(ROOT), "fma": str(fma_tree())}
    runs = []
    for form in ("tensor", "fma", "fma", "tensor"):
        proc = subprocess.run(
            [sys.executable, __file__, "--measure", trees[form]],
            capture_output=True, text=True, cwd=trees[form])
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("MEASURED ")]
        if proc.returncode or not line:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append({"form": form, **json.loads(line[0][9:])})
    result = {"card": card, "runs": runs}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
