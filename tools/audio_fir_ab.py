"""Kernel #1's forms on the card, side by side: its decimating audio FIR
on the tensor cores (a three-term TF32 product) or on float32 FMAs, and
its shaping FIR's and LO's arithmetic. Reads kernel #1's device time at
C=1,024 and 16,384 (nd = 10,240), kernel #2's at nd=25,600 and #3's at
C=1,024, and ``bench_torch.py --accuracy``'s 33 SNRs against float64 at
C=128 in each form.

    python3 tools/audio_fir_ab.py --parent DIR [--forms A,B,..] [OUT_JSON]

``DIR`` holds the tree before the audio FIR's FMA form (the tensor-core
audio FIR), unpacked from git, e.g. ``git archive 7aa342f | tar -x -C
_checkout/audio_fir_ab/parent``. The forms, each a copy under
``_checkout/audio_fir_ab/`` (gitignored) with its kernel source patched:

* ``tensor``: DIR as it is;
* ``fma_loop``: DIR with its float32 FMA loop (one chain an output, two
  lanes a column) at decimation 5 too;
* ``fma``: this tree as it is (the audio FIR's FMA groups, two chains an
  output: its even and its odd taps);
* ``fma_chain``: this tree with one chain an output (the odd taps into the
  even taps' chain, in tap order);
* ``exact_lo``: this tree with the ``fast`` LO's sin and cos evaluated at
  every row, where the kernel rotates the exact phasor of one row in two
  by the exact phasors of 2, 4, .., 14 steps;
* ``four_term``: this tree with the shaping FIR's fourth split term
  ``a_lo b_lo`` on the tensor cores too;
* ``lo_rn``: this tree with each split's small part rounded to TF32,
  where the tensor cores truncate it;
* ``all``: ``exact_lo``, ``four_term`` and ``lo_rn`` together;
* ``hh1``: this tree with the shaping FIR's ``a_hi b_hi`` in a fresh
  tensor-core accumulator every k-step, added to the output's sum with
  round to nearest (the accumulators round toward zero);
* ``shape_simt``: this tree with the shaping FIR as float32 FMA chains in
  tap order read from the mixed ring (no tensor cores; slow, for its
  accuracy).

With no ``--forms`` it runs ``tensor``, ``fma_loop``, ``fma_chain`` and
``fma``.

Each form runs in its own process, in turns (the forms in order, then
backward), each building its own library. Prints the card's name and power
limit, then one JSON line of every run (also written to OUT_JSON, default
``chiprun_out/audio_fir_ab.json``). Needs a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ROOT / "_checkout" / "audio_fir_ab"
KERNEL = pathlib.Path("webradio_tpu_torch") / "csrc" / "tail_tm.cu"
#: the parent's pick of its audio FIR's form, and its FMA loop's pick
PARENT_PICK = ("return HAS_AUDIO_FIR && D == AD", "return false && D == AD")
EXACT_LO = ("""            s = s0 * rot_c[r] + co0 * rot_s[r];
            co = co0 * rot_c[r] - s0 * rot_s[r];""",
            """            lo_sincos<true>(p0, st, n0 + 2 * r + hm, &s, &co);""")
FOUR_TERM = ("""            mma_tf32(ac[q], eh[8], eh[0], eh[12], eh[4], bl[q][0], bl[q][1]);
""", """            mma_tf32(ac[q], eh[8], eh[0], eh[12], eh[4], bl[q][0], bl[q][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            mma_tf32(ac[q], el[8], el[0], el[12], el[4], bl[q][0], bl[q][1]);
""")
LO_RN = ("lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;",
         "lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & "
         "TF32_MASK;")
SHAPE_SIMT = ("""        // fragment (nt, i) is row g + 8(i / 2) of column 2(2t + i % 2) + nt
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            y_i[2 * (i & 1) + nt][i >> 1] = am[nt][i] + ac[nt][i];
            y_q[2 * (i & 1) + nt][i >> 1] = am[2 + nt][i] + ac[2 + nt][i];
          }""", """#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = g + 8 * h;
            float si = 0.0f, sq = 0.0f;
            for (int k = 0; k < K; ++k) {
              const int j = r + 1 + k;
              int slot = cur + 1 + (j >> 4);
              if (slot >= NSLOT) slot -= NSLOT;
              const int at = swz(slot * S + (j & 15), 4 * t + cc);
              const float hk = h_shape[k];
              si = fmaf(hk, ring_i[at], si);
              sq = fmaf(hk, ring_q[at], sq);
            }
            y_i[cc][h] = si;
            y_q[cc][h] = sq;
          }""")
FMA_CHAIN = ("""        odd[0] = fmaf(h1.x, x1, odd[0]);
        odd[1] = fmaf(h1.y, x1, odd[1]);
        odd[2] = fmaf(h1.z, x1, odd[2]);
        odd[3] = fmaf(h1.w, x1, odd[3]);""", """        even[0] = fmaf(h1.x, x1, even[0]);
        even[1] = fmaf(h1.y, x1, even[1]);
        even[2] = fmaf(h1.z, x1, even[2]);
        even[3] = fmaf(h1.w, x1, even[3]);""")
HH1 = ("""          for (int q = 0; q < 4; ++q)
            mma_tf32(am[q], eh[8], eh[0], eh[12], eh[4], bh[q][0], bh[q][1]);
""", """          for (int q = 0; q < 4; ++q) {
            float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(hh, eh[8], eh[0], eh[12], eh[4], bh[q][0], bh[q][1]);
            for (int i = 0; i < 4; ++i) am[q][i] += hh[i];
          }
""")
#: form -> (the tree it copies: "parent" or "this", the patches)
FORMS = {
    "tensor": ("parent", ()),
    "fma_loop": ("parent", (PARENT_PICK,)),
    "fma": ("this", ()),
    "fma_chain": ("this", (FMA_CHAIN,)),
    "exact_lo": ("this", (EXACT_LO,)),
    "four_term": ("this", (FOUR_TERM,)),
    "lo_rn": ("this", (LO_RN,)),
    "all": ("this", (EXACT_LO, FOUR_TERM, LO_RN)),
    "hh1": ("this", (HH1,)),
    "shape_simt": ("this", (SHAPE_SIMT,)),
}
DEFAULT_FORMS = ("tensor", "fma_loop", "fma_chain", "fma")


def copy_tree(src: pathlib.Path, name: str, patches=()) -> pathlib.Path:
    """``src``'s package and root scripts under ``COPIES / name``, the
    kernel source patched by each ``(old, new)`` (``old`` must occur
    once)."""
    dst = COPIES / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(src / "webradio_tpu_torch", dst / "webradio_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for script in ("chip_smoke.py", "bench_torch.py"):
        shutil.copy(src / script, dst / script)
    path = dst / KERNEL
    text = path.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} not found once in {path}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def trees(parent: pathlib.Path, forms) -> dict:
    return {form: copy_tree(parent if FORMS[form][0] == "parent" else ROOT,
                            form, FORMS[form][1]) for form in forms}


def measure(tree: str) -> dict:
    """One form: the kernels' ms (a few readings each) and the SNRs."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import bench_torch
    import chip_smoke
    from webradio_tpu_torch.ops import _build, tail_tm
    from webradio_tpu_torch.ops.channelizer import pfb_frames_tm
    from webradio_tpu_torch.pipeline import channelized as ch

    _build.build_library()
    _build.load_library()
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(7)
    w, wa = chip_smoke.shared_fir_weights(dev, 5)
    k = 64
    u = lambda *s: torch.empty(s, device=dev).uniform_(-0.5, 0.5)
    lo = lambda c: [torch.from_numpy(rng.integers(0, 2**n, c)).to(dev)
                    for n in (31, 32)]
    modes = lambda c: torch.from_numpy(
        (np.arange(c) % 4).astype(np.int32)).to(dev)
    out = {}
    for c in (1_024, 16_384):
        nd = 10_240
        prod = u(nd, 2 * c)
        args = (prod, prod, *lo(c), w, wa, 5, modes(c), u(k - 1, c),
                u(k - 1, c), u(2, c), u(k - 1, c))
        out[f"kernel1_ms_c{c}"] = [chip_smoke.cuda_ms(
            lambda: tail_tm.fused_tail_audio_tm(*args, packed=True,
                                                fast=True), 50)
            for _ in range(3)]
    c, nd = 1_024, 25_600
    prod = u(nd, 2 * c)
    args = (prod, prod, *lo(c), w, modes(c), u(k - 1, c), u(k - 1, c),
            u(2, c))
    out["kernel2_ms_nd25600"] = [chip_smoke.cuda_ms(
        lambda: tail_tm.fused_tail_tm(*args, packed=True, fast=True), 30)
        for _ in range(2)]
    cfg = ch.ChannelizedConfig(num_channels=c, tail_kernel="pallas_pfb")
    ifs, laws = chip_smoke.slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, laws)
    kp = cfg.proto_taps
    frames, _ = pfb_frames_tm(u(2, cfg.block_frames), kp, cfg.num_bins,
                              u(2, kp - 1))
    args = (frames, params.pfb_weights.reshape(2 * kp, 2 * c), *lo(c),
            params.chan_toep, params.audio_toep, cfg.audio_decim,
            params.mode, u(k - 1, c), u(k - 1, c), u(2, c), u(k - 1, c))
    out["kernel3_ms_c1024"] = [chip_smoke.cuda_ms(
        lambda: tail_tm.fused_pfb_tail_audio_tm(*args, fast=True), 20)
        for _ in range(2)]
    snr = bench_torch.accuracy(dev)
    out.update({key: v for key, v in snr.items()
                if key.startswith(("noise", "fm_tones", "u8_noise"))})
    out["kernel_launches"] = snr["kernel_launches"]
    return out


def main(argv) -> int:
    if argv[1:2] == ["--measure"]:
        print("MEASURED " + json.dumps(measure(argv[2])), flush=True)
        return 0
    args = list(argv[1:])
    forms = list(DEFAULT_FORMS)
    if "--forms" in args:
        i = args.index("--forms")
        forms = args[i + 1].split(",")
        del args[i:i + 2]
    if args[:1] != ["--parent"] or len(args) < 2 or not set(forms) <= set(
            FORMS):
        print(__doc__, file=sys.stderr)
        return 2
    parent = pathlib.Path(args[1]).resolve()
    if not (parent / KERNEL).is_file():
        print(f"audio_fir_ab: no {KERNEL} under {parent}", file=sys.stderr)
        return 2
    out_path = pathlib.Path(args[2] if len(args) > 2
                            else ROOT / "chiprun_out" / "audio_fir_ab.json")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    made = trees(parent, forms)
    runs = []
    for form in forms + forms[::-1]:
        proc = subprocess.run(
            [sys.executable, __file__, "--measure", str(made[form])],
            capture_output=True, text=True, cwd=made[form])
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("MEASURED ")]
        if proc.returncode or not line:
            print(form, proc.stdout[-2000:], proc.stderr[-4000:],
                  file=sys.stderr)
            return 1
        runs.append({"form": form, **json.loads(line[0][9:])})
        print(json.dumps(runs[-1]), flush=True)
    result = {"card": card, "runs": runs}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
