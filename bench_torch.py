"""Real-time NBFM channels per H100: the PyTorch port's measuring program,
the counterpart of ``bench.py`` (which drives the JAX package and stays as
it is).

    python3 bench_torch.py                     # the sweep (the card only)
    python3 bench_torch.py --parity            # the tier laws' parity gate
    python3 bench_torch.py --accuracy          # audio SNR against float64
    python3 bench_torch.py --soak [SECONDS CAPACITY CONSUMERS PFB DRIVER FIR]
    python3 bench_torch.py --recovery [STALL_MS CAPACITY]

Every mode runs on the CUDA device and refuses, with a non-zero exit,
where torch sees none; ``--device cpu`` runs ``--parity``, ``--accuracy``,
``--soak`` and ``--recovery`` on the CPU (the tests' path). ``--settle S``
sets the live modes' settle time (15 s for the soak, 2 s for the
recovery, as ``bench.py`` has them).

The default mode measures the port's serving program as the pump
dispatches it: a ``ChannelizedPipeline`` on its CUDA graphs, fed one
device-resident block of ``rng(0)`` normal IQ through ``step_device`` (the
slot's input copy and one replay a block), every slot at 80 / 8 kHz, FM,
the IFs of ``bench.py``. A point's ms/block is the median of three runs of
20 blocks back to back, each ended by one synchronize; the same point is
also read one block at a time on CUDA events, with the peak of allocated
device memory. Capture and warm-up stay outside the timed region, and
kernel #1 (``ops.tail_tm.fused_tail_audio_tm``) must have launched once a
block (``ops.launches``), so no point that fell to a plain or per-channel
tail is reported as the kernel's. For each filterbank tier at FIR "highest"
the search doubles C from 16,384 until a point misses the 42.67 ms block
(or runs out of memory: an ``error`` line, counted as a miss), then narrows
the bracket on multiples of 1,024 within a budget of points. The FIR tiers
hx5, hx4 and high run once at the "highest" tier's best C (the port
computes them as "highest", so they read the same), and the direct engine
at C = 4 .. 1,024 on its graph, with the channelized engine (kernel #1) at
C = 16 and 64 beside it.

The measurements run in a child process that streams one JSON line per
result to a file; the parent enforces the deadline, kills the child's
process group (never by pattern) where it overruns, and prints a detail
line and then, last, the headline line with ``bench.py``'s keys plus the
card's name and power limit (``nvidia-smi``). A kernel build failure or a
CUDA error ends the run with a non-zero exit; so does a parity violation.

Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

STEPS = 20  # blocks back to back per run
REPEATS = 3  # runs per point; the median is the point's ms/block
ONE_AT_A_TIME = 20  # blocks read one at a time on CUDA events
#: absolute wall-clock cap of the default mode; progress (a new line from
#: the worker) extends the soft deadline up to this (``BENCH_DEADLINE_S``)
DEADLINE_S = 900
PROGRESS_GRACE_S = 240

SAMPLE_RATE = 2_400_000
BLOCK_FRAMES = 102_400
BLOCK_MS = 1e3 * BLOCK_FRAMES / SAMPLE_RATE  # 42.67 ms of signal
#: the filterbank tiers (``ChannelizedConfig.pfb_precision``), swept at FIR
#: "highest", the headline's first
PFB_TIERS = ("highest", "u8exact", "default", "high", "bf16")
FIR_TIERS = ("hx5", "hx4", "high")
SWEEP_START = 16_384
SWEEP_STEP = 1_024
#: points a tier: doubling from 16,384 takes six to pass a lossy tier's
#: crossing (~250-300k), and the line through the bracket then needs two to
#: four more to close it to 1,024
SWEEP_POINTS = 10
DIRECT_CHANNELS = (4, 16, 64, 256, 1_024)
#: widths where the channelized engine is read beside the direct one (the
#: "auto" engine goes channelized from 16 channels; on the card kernel #1
#: serves it at any width)
SMALL_CHANNELIZED = (16, 64)

# the card's published peaks (NVIDIA H100 SXM data sheet; chip_smoke.py
# holds the same): float32 outside the tensor cores, dense bfloat16 on
# them, device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# --parity's bounds (bench.py's): max abs audio deviation from the
# "highest" chain
PARITY_C = 128
HX_BOUNDS = (("USB", 2e-6), ("FM", 3e-6))
U8_BOUND = 3e-6

ACCURACY_C = 128
#: --accuracy's (fir, pfb) pairs, bench.py's eleven
ACCURACY_PAIRS = (("highest", "default"), ("highest", "high"),
                  ("highest", "highest"), ("high", "default"),
                  ("high", "high"), ("highest", "u8exact"),
                  ("high", "u8exact"), ("hx5", "highest"),
                  ("hx5", "u8exact"), ("hx4", "highest"),
                  ("highest", "bf16"))

#: --accuracy's SNRs of the JAX package at C=ACCURACY_C (dB against the
#: same float64 reference): its step on the CPU with each filterbank tier's
#: explicit law, as ``tools/accuracy_jax.py`` reads them
#: (``tests/test_torch_accuracy_laws.py`` holds this table to it). The
#: tier rule (PERF.md section 2): the port at every key >= the law less
#: LAW_SLACK_DB
JAX_LAW_SNR_DB = {
    "noise_fir_highest_pfb_default": 38.2,
    "noise_fir_highest_pfb_high": 137.1,
    "noise_fir_highest_pfb_highest": 138.9,
    "noise_fir_high_pfb_default": 38.2,
    "noise_fir_high_pfb_high": 137.1,
    "noise_fir_highest_pfb_u8exact": 40.0,
    "noise_fir_high_pfb_u8exact": 40.0,
    "noise_fir_hx5_pfb_highest": 138.9,
    "noise_fir_hx5_pfb_u8exact": 40.0,
    "noise_fir_hx4_pfb_highest": 138.9,
    "noise_fir_highest_pfb_bf16": 37.7,
    "fm_tones_fir_highest_pfb_default": 30.9,
    "fm_tones_fir_highest_pfb_high": 58.3,
    "fm_tones_fir_highest_pfb_highest": 137.3,
    "fm_tones_fir_high_pfb_default": 30.9,
    "fm_tones_fir_high_pfb_high": 58.3,
    "fm_tones_fir_highest_pfb_u8exact": 30.9,
    "fm_tones_fir_high_pfb_u8exact": 30.9,
    "fm_tones_fir_hx5_pfb_highest": 137.3,
    "fm_tones_fir_hx5_pfb_u8exact": 30.9,
    "fm_tones_fir_hx4_pfb_highest": 137.3,
    "fm_tones_fir_highest_pfb_bf16": 30.1,
    "u8_noise_fir_highest_pfb_default": 39.6,
    "u8_noise_fir_highest_pfb_high": 138.6,
    "u8_noise_fir_highest_pfb_highest": 138.9,
    "u8_noise_fir_high_pfb_default": 39.6,
    "u8_noise_fir_high_pfb_high": 138.6,
    "u8_noise_fir_highest_pfb_u8exact": 138.6,
    "u8_noise_fir_high_pfb_u8exact": 138.6,
    "u8_noise_fir_hx5_pfb_highest": 138.9,
    "u8_noise_fir_hx5_pfb_u8exact": 138.6,
    "u8_noise_fir_hx4_pfb_highest": 138.9,
    "u8_noise_fir_highest_pfb_bf16": 38.8,
}
LAW_SLACK_DB = 0.5

HTML_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "html")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def ifs(c: int) -> list[int]:
    """bench.py's IFs: 2 kHz apart around the centre."""
    return [int((i - c // 2) * 2_000) for i in range(c)]


def offset_ifs(c: int) -> list[int]:
    """bench.py's IFs of ``--parity`` and ``--accuracy``: :func:`ifs`
    moved 777 Hz off the bins."""
    return [f + 777 for f in ifs(c)]


def device_of(name: str):
    """The torch device a mode runs on: "cuda" is the card (and an error
    where there is none), "cpu" the CPU."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    from webradio_tpu_torch import require_cuda

    return require_cuda()


def device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def release(dev) -> None:
    """Hand what the last point left back to the card before the next."""
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# timing: the pipeline on its graphs, as the pump dispatches it
# ---------------------------------------------------------------------------

def time_pipeline(pipe, iq, steps: int = STEPS, repeats: int = REPEATS,
                  one_at_a_time: int = ONE_AT_A_TIME) -> dict:
    """``pipe.step_device(iq)`` blocks: two first (the eager warm and the
    capture, then a replay), then ``repeats`` runs of ``steps`` blocks back
    to back, each ended by one synchronize (``step_ms``: their median, ms
    per block), then ``one_at_a_time`` blocks each between two CUDA events
    and synchronized (``one_ms``: their median; the host clock on the CPU).
    ``blocks`` counts every block run."""
    import torch

    dev = pipe.device
    for _ in range(2):
        pipe.step_device(iq)
    sync(dev)
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            pipe.step_device(iq)
        sync(dev)
        runs.append(1e3 * (time.perf_counter() - t0) / steps)
    one = []
    for _ in range(one_at_a_time):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pipe.step_device(iq)
            end.record()
            end.synchronize()
            one.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            pipe.step_device(iq)
            one.append(1e3 * (time.perf_counter() - t0))
    return {"step_ms": statistics.median(runs), "step_ms_runs": runs,
            "one_ms": statistics.median(one) if one else None,
            "blocks": 2 + steps * repeats + one_at_a_time}


def bench_iq(dev, block_frames: int = BLOCK_FRAMES):
    """bench.py's input: ``rng(0)`` normal ``[2, block_frames]`` float32,
    on the device."""
    import torch

    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.standard_normal((2, block_frames)).astype(np.float32)).to(dev)


def point_key(c: int, fir: str, pfb: str) -> str:
    """bench.py's result key."""
    return (f"pfb_c{c}" + ("" if fir == "highest" else f"_{fir}")
            + ("" if pfb == "default" else f"_pfb{pfb}"))


def _fresh_point(make, iq, **timing) -> dict:
    """A pipeline made by ``make()`` after the last point's memory went
    back, timed by :func:`time_pipeline`, with its peak of allocated device
    memory (None on the CPU), its graph counts and its real-time channels;
    the pipeline goes before the return."""
    import torch

    dev = iq.device
    release(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pipe = make()
    t = time_pipeline(pipe, iq, **timing)
    t["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                    if dev.type == "cuda" else None)
    t["graph"] = pipe.graph_stats()
    block_ms = 1e3 * pipe.cfg.block_seconds
    t["rt_channels"] = pipe.cfg.num_channels * block_ms / t["step_ms"]
    t["realtime"] = t["step_ms"] <= block_ms
    return t


def channelized_point(c: int, fir: str, pfb: str, iq, **timing) -> dict:
    """One sweep point: the channelized pipeline at C=``c`` on the tier
    (:func:`_fresh_point`). On the card kernel #1 must have launched once
    a block."""
    from webradio_tpu_torch.ops.tail_tm import fused_tail_audio_tm
    from webradio_tpu_torch.pipeline.channelized import (
        ChannelizedConfig,
        ChannelizedPipeline,
        make_channelized_params,
    )

    cfg = ChannelizedConfig(num_channels=c, fir_precision=fir,
                            pfb_precision=pfb, block_frames=iq.shape[-1])
    before = fused_tail_audio_tm.launches
    t = _fresh_point(lambda: ChannelizedPipeline(cfg, make_channelized_params(
        cfg, ifs(c), 80_000, 8_000, "FM", device=iq.device)), iq, **timing)
    launches = fused_tail_audio_tm.launches - before
    if iq.device.type == "cuda" and launches != t["blocks"]:
        raise AssertionError(
            f"C={c} fir={fir} pfb={pfb}: kernel #1 launched {launches} "
            f"times for {t['blocks']} blocks (a plain or per-channel tail "
            f"ran)")
    roof = roofline_ms(c, pfb, cfg.chan_frames)["ideal_ms"]
    return {"kind": "result", "path": "pfb", "key": point_key(c, fir, pfb),
            "channels": c, "precision": fir, "pfb_precision": pfb, **t,
            "kernel_launches": launches, "roofline_ms": roof,
            "roofline_frac": roof / t["step_ms"]}


def direct_point(c: int, iq, **timing) -> dict:
    """The direct engine (``FrontEndPipeline``) at C=``c`` on its graph."""
    from webradio_tpu_torch.pipeline.frontend import FrontEndPipeline
    from webradio_tpu_torch.pipeline.state import (
        ChainConfig,
        make_receiver_params,
    )

    cfg = ChainConfig(num_channels=c, block_frames=iq.shape[-1])
    t = _fresh_point(lambda: FrontEndPipeline(cfg, make_receiver_params(
        cfg, ifs(c), 80_000, 8_000, "FM", device=iq.device)), iq, **timing)
    return {"kind": "result", "path": "direct", "channels": c, **t,
            "realtime_factor": 1e3 * cfg.block_seconds / t["step_ms"]}


def search_realtime(measure, start: int = SWEEP_START,
                    step: int = SWEEP_STEP, limit_ms: float = BLOCK_MS,
                    budget: int = SWEEP_POINTS, on_oom=None) -> dict:
    """The largest C, a multiple of ``step``, whose ``measure(c)`` (ms per
    block) is at most ``limit_ms``, measuring at most ``budget`` points.

    C doubles from ``start`` until a point misses; then the bracket (the
    largest hit, the smallest miss) narrows to ``step``. Each probe is the
    crossing on the line through two timed points, rounded down to
    ``step`` and kept strictly inside the bracket: the bracket's two ends,
    or, where the miss has no time, the largest hit and the largest hit at
    most half of it; after two probes in a row landed on one side, the
    probe goes twice as far from that side as the line says (at least a
    step), after three four times, and so on; where the line
    crosses outside the bracket (out of memory below the crossing), the
    probe is the bracket's midpoint. A ``torch.OutOfMemoryError`` of ``measure`` is a miss without
    a time (``on_oom(c, error)`` is told); any other error propagates.
    Returns ``best`` (0 where no point fit), ``miss`` (the smallest C that
    missed, None if none did), ``resolution`` (``miss - best``, or None)
    and ``points`` ``[(c, ms or None)]`` in order."""
    import torch

    points: list = []
    hits = [(0, 0.0)]  # (c, ms) of every hit, ascending
    hi, hi_ms = None, None
    side, run = None, 0
    c = start
    while len(points) < budget:
        try:
            ms = measure(c)
        except torch.OutOfMemoryError as e:
            if on_oom is not None:
                on_oom(c, e)
            ms = None
        points.append((c, ms))
        hit = ms is not None and ms <= limit_ms
        run = run + 1 if hit == side else 1
        side = hit
        if hit:
            hits = sorted(hits + [(c, ms)])
            if hi is None:
                c *= 2
                continue
        else:
            hi, hi_ms = c, ms
        lo, lo_ms = hits[-1]
        if hi - lo <= step:
            break
        # the line through the bracket's ends or, where the miss has no
        # time, through the largest hit and the largest at most half of it
        # (a base wide enough that the times' noise leaves its slope)
        (a, a_ms), (b, b_ms) = ((lo, lo_ms), (hi, hi_ms)) if hi_ms \
            is not None else (max(h for h in hits if h[0] <= lo // 2),
                              (lo, lo_ms))
        guess = (a + (limit_ms - a_ms) * (b - a) / (b_ms - a_ms)
                 if b_ms > a_ms else hi)
        if not lo < guess < hi:  # no crossing inside (out of memory past it)
            guess = (lo + hi) / 2
        elif run >= 2:  # probes in a row on one side: 2, 4, .. as far
            far = 2 ** (run - 1)
            guess = (lo + far * max(guess - lo, step) if side
                     else hi - far * max(hi - guess, step))
        c = min(max(int(guess) // step * step, lo + step), hi - step)
    lo = hits[-1][0]
    return {"best": lo, "miss": hi,
            "resolution": None if hi is None else hi - lo,
            "points": points}


# ---------------------------------------------------------------------------
# roofline: the least time the card could take for one block
# ---------------------------------------------------------------------------

#: each filterbank tier's contraction depth, as a multiple of 2 K_p, and
#: whether its GEMM runs on bfloat16 operands (ops/channelizer.py: u8exact
#: doubles K, "high" triples it)
_PFB_K = {"highest": (1, False), "u8exact": (2, True), "default": (1, True),
          "high": (3, True), "bf16": (1, True)}


def _bound(fp32_flops: float, bf16_flops: float, nbytes: float):
    """``(ops ms, bytes ms)`` at the card's peaks."""
    ops = 1e3 * (fp32_flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS)
    return ops, 1e3 * nbytes / PEAK_BYTES_PER_S


def tail_flops(nd: int, c: int, k: int = 64, d: int = 5) -> float:
    """Kernel #1's float32 operations a block (chip_smoke.py's count): per
    row and channel the shaping FIR on both planes (4K), the mix (6), the
    power (4) and the decimating audio FIR (2K/D); the transcendentals and
    the demod law left out."""
    return nd * c * (4 * k + 10 + 2 * k / d)


def tail_bytes(nd: int, c: int, product_bytes: int = 4, k: int = 64,
               d: int = 5) -> float:
    """Kernel #1's bytes a block, each read or written once: the packed
    product, the audio, the carries (mixed FIR tails, the demod lag and
    the audio FIR tail, read and written), the power, and the per-channel
    phase, step and law."""
    carries = (2 * (k - 1) + 2 + (k - 1)) * c * 4
    return (nd * 2 * c * product_bytes + (nd // d) * c * 4 + 2 * carries
            + c * 4 + c * (8 + 8 + 4))


def roofline_ms(c: int, pfb: str, nd: int = BLOCK_FRAMES // 10,
                kp2: int = 320) -> dict:
    """The two stages of one block, which serialize (kernel #1 reads the
    product the filterbank GEMM wrote), each bound by the larger of its
    operations and its bytes: the front, the filterbank GEMM ``[nd, K] x
    [K, 2C]`` at the tier (K = ``kp2`` times the tier's depth; float32
    outside the tensor cores at "highest", bfloat16 on them otherwise) with
    the frames and weights read and the packed product written; the tail,
    kernel #1. ``ideal_ms`` is their sum, ``serial_ms`` every term summed
    (no overlap of operations and bytes within a stage)."""
    mult, bf16 = _PFB_K[pfb]
    k = kp2 * mult
    gemm = 2.0 * nd * k * 2 * c
    operand = 2 if bf16 else 4
    product = 2 if pfb == "bf16" else 4
    front_ops, front_bytes = _bound(0.0 if bf16 else gemm,
                                    gemm if bf16 else 0.0,
                                    nd * k * operand + k * 2 * c * operand
                                    + nd * 2 * c * product)
    tail_ops, tail_b = _bound(tail_flops(nd, c), 0.0,
                              tail_bytes(nd, c, product))
    front, tail = max(front_ops, front_bytes), max(tail_ops, tail_b)
    return {"front_ops_ms": front_ops, "front_bytes_ms": front_bytes,
            "tail_ops_ms": tail_ops, "tail_bytes_ms": tail_b,
            "front_ms": front, "tail_ms": tail, "ideal_ms": front + tail,
            "serial_ms": front_ops + front_bytes + tail_ops + tail_b}


# ---------------------------------------------------------------------------
# the worker: every measurement, one JSON line per result
# ---------------------------------------------------------------------------

def sweep(iq, emit) -> None:
    """Every filterbank tier's search at FIR "highest", the FIR tiers at
    the "highest" tier's best C, and the direct engine's points with the
    channelized engine's beside them at SMALL_CHANNELIZED."""
    best = {}
    for pfb in PFB_TIERS:
        def measure(c, pfb=pfb):
            rec = channelized_point(c, "highest", pfb, iq)
            emit(**rec)
            log(f"  {rec['key']}: {rec['step_ms']:.3f} ms/block back to "
                f"back, {rec['one_ms']:.3f} one at a time, peak "
                f"{rec['peak_gb']:.2f} GB")
            return rec["step_ms"]

        def oom(c, e, pfb=pfb):
            emit(kind="error", key=point_key(c, "highest", pfb),
                 error="OutOfMemoryError: " + str(e)[:400])
            log(f"  C={c} pfb={pfb}: out of memory")

        found = search_realtime(measure, on_oom=oom)
        best[pfb] = found["best"]
        emit(kind="search", pfb_precision=pfb, **found)
    c = best["highest"]
    for fir in FIR_TIERS:
        if not c:
            emit(kind="error", key=f"fir_{fir}",
                 error="no real-time C at pfb highest to run it at")
            continue
        # computed as "highest" (ROADMAP section 3): they read the same
        rec = channelized_point(c, fir, "highest", iq)
        emit(**rec, note="computed as highest")
    for c in DIRECT_CHANNELS:
        rec = direct_point(c, iq)
        emit(**rec)
        if c in SMALL_CHANNELIZED:
            # kept out of the tiers' search: path "channelized"
            emit(**dict(channelized_point(c, "highest", "highest", iq),
                        path="channelized", key=f"channelized_c{c}"))
        if rec["step_ms"] > 4 * BLOCK_MS:
            break


def worker(out_path: str) -> None:
    import torch

    from webradio_tpu_torch.ops import _build

    out = open(out_path, "a", buffering=1)

    def emit(**kv):
        out.write(json.dumps(kv) + "\n")

    try:
        dev = device_of("cuda")
        t0 = time.perf_counter()
        _build.build_library()
        _build.load_library()
        iq = bench_iq(dev)
        sync(dev)
        emit(kind="warm", seconds=time.perf_counter() - t0,
             device=torch.cuda.get_device_name(dev))
        emit(kind="parity", **parity_check(dev))
        sweep(iq, emit)
        emit(kind="done")
    except BaseException as e:
        emit(kind="fatal", error=f"{type(e).__name__}: {e}"[:400])
        traceback.print_exc()
        raise
    finally:
        out.close()


# ---------------------------------------------------------------------------
# the parent: deadline, then the two lines
# ---------------------------------------------------------------------------

def summarize(records: list) -> tuple[dict, dict]:
    """``(detail line, headline line)`` from the worker's records, with
    ``bench.py``'s keys: ``value`` is the largest real-time C at FIR
    "highest" over the filterbank tiers but "bf16" (the bit-exact FIR
    tier), ``realtime_channels_*`` each tier family's, ``roofline_frac``
    the roofline over the measured ms at that headline point."""
    report, parity, searches = {}, {}, {}
    # the largest real-time C by FIR tier over every product but "bf16",
    # and at FIR "highest" by filterbank tier
    best_rt = {"highest": 0, "hx5": 0, "hx4": 0, "high": 0}
    by_pfb = {p: 0 for p in PFB_TIERS}
    best_any = best_u8_parity = 0
    best_tp, best_tp_c, best_tp_fp = 0.0, 0, ""
    headline = None
    for rec in records:
        kind = rec.get("kind")
        if kind == "result":
            key = rec.get("key") or f"{rec['path']}_c{rec['channels']}"
            report[f"{key}_step_ms"] = round(rec["step_ms"], 3)
            report[f"{key}_one_ms"] = (None if rec["one_ms"] is None
                                       else round(rec["one_ms"], 3))
            report[f"{key}_rt_channels"] = round(rec["rt_channels"], 1)
            if rec.get("peak_gb") is not None:
                report[f"{key}_peak_gb"] = round(rec["peak_gb"], 2)
            if rec["path"] != "pfb":
                continue
            report[f"{key}_roofline_frac"] = round(rec["roofline_frac"], 3)
            fp, pp, c = rec["precision"], rec["pfb_precision"], rec["channels"]
            if rec["rt_channels"] > best_tp:
                best_tp, best_tp_c, best_tp_fp = rec["rt_channels"], c, fp
            if not rec["realtime"]:
                continue
            best_any = max(best_any, c)
            if fp == "highest":
                by_pfb[pp] = max(by_pfb[pp], c)
            if pp == "bf16":
                continue
            if c > best_rt[fp]:
                best_rt[fp] = c
                if fp == "highest":
                    headline = rec
            if pp == "u8exact" and fp in ("highest", "hx5", "hx4"):
                best_u8_parity = max(best_u8_parity, c)
        elif kind == "parity":
            parity = {k: v for k, v in rec.items() if k != "kind"}
        elif kind == "search":
            searches[rec["pfb_precision"]] = {
                "best": rec["best"], "miss": rec["miss"],
                "resolution": rec["resolution"],
                "points": len(rec["points"])}
        elif kind in ("error", "fatal"):
            report[rec.get("key", kind) + "_error"] = rec["error"]
    bitexact = best_rt["highest"]
    f32parity = max(best_rt["hx5"], best_rt["hx4"], bitexact)
    bf16x3 = max(best_rt["high"], f32parity)
    value, best_c, best_fp = float(bitexact), bitexact, "highest"
    if value == 0.0 and bf16x3 > 0:
        value, best_c, best_fp = float(bf16x3), bf16x3, "high"
        report["note_headline"] = ("no bit-exact config fit the budget; "
                                   "value is the bf16x3 tier")
    elif value == 0.0 and best_tp > 0.0:
        value, best_c, best_fp = best_tp, best_tp_c, best_tp_fp
        report["note_headline"] = ("no config fit the block budget; value "
                                   "is throughput-normalized")
    roofline, roofline_detail = {}, {}
    if headline is not None:
        model = roofline_ms(headline["channels"], headline["pfb_precision"])
        roofline = {"roofline_ms": round(model["ideal_ms"], 3),
                    "roofline_serial_ms": round(model["serial_ms"], 3),
                    "roofline_frac": round(model["ideal_ms"]
                                           / headline["step_ms"], 3)}
        roofline_detail = {**{k: round(v, 4) for k, v in model.items()},
                           "measured_ms": round(headline["step_ms"], 3),
                           "config": (f"c{headline['channels']}_highest_pfb"
                                      f"{headline['pfb_precision']}")}
    hx = [v for k, v in parity.items()
          if k.startswith("hx_") and isinstance(v, float)]
    u8 = [v for k, v in parity.items()
          if k.startswith("u8exact") and isinstance(v, float)]
    parity_summary = {} if not parity else {
        "parity_ok": bool(parity.get("ok", False)),
        "parity_hx_max_dev": max(hx) if hx else None,
        "parity_u8exact_max_dev": max(u8) if u8 else None}
    detail = {"metric": "realtime_nbfm_channels_per_chip_detail",
              "detail": report, "searches": searches,
              "roofline_detail": roofline_detail, "parity": parity}
    value = round(value, 1)
    final = {
        "metric": "realtime_nbfm_channels_per_chip",
        "value": value,
        "unit": "channels @ 2.4Msps full chain",
        "vs_baseline": value,  # the reference sustains 1 channel (SURVEY §6)
        "realtime_channels_bitexact": bitexact,
        # hx5 / hx4 / high are computed as "highest" in the port
        "realtime_channels_f32parity": f32parity,
        "realtime_channels_bf16x3": bf16x3,
        "realtime_channels_bf16product": by_pfb["bf16"],
        "realtime_channels_max_any_tier": best_any,
        **roofline,
        "realtime_channels_reference_quality": by_pfb["highest"],
        "realtime_channels_reference_quality_u8input": max(
            by_pfb["u8exact"], by_pfb["highest"]),
        "realtime_channels_u8input_f32parity": max(best_u8_parity,
                                                   by_pfb["highest"]),
        "realtime_channels_by_pfb": by_pfb,
        "best_precision": best_fp,
        "best_batch": best_c,
        **parity_summary,
    }
    return detail, final


def run_sweep() -> int:
    """The default mode's parent: the worker in its own process group, its
    lines read after it ends or the deadline hits, then the two lines."""
    deadline = int(os.environ.get("BENCH_DEADLINE_S", DEADLINE_S))
    fd, path = tempfile.mkstemp(prefix="webradio_bench_torch_",
                                suffix=".jsonl")
    os.close(fd)
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", path],
        stdout=sys.stderr, stderr=sys.stderr, start_new_session=True)
    start = time.time()
    soft = start + PROGRESS_GRACE_S
    done, last_size = False, 0
    try:
        while True:
            if child.poll() is not None:
                done = True
                break
            now = time.time()
            if now > start + deadline:
                break
            size = os.path.getsize(path)
            if size != last_size:
                last_size, soft = size, now + PROGRESS_GRACE_S
            elif size > 0 and now > soft:
                break  # produced something, then stalled
            time.sleep(2.0)
    finally:
        if not done:
            # the exact process group made for the worker; never by pattern
            try:
                os.killpg(child.pid, signal.SIGKILL)
            except OSError:
                child.kill()
            child.wait()
    records = []
    with open(path) as f:
        for line in f:
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
    os.unlink(path)
    detail, final = summarize(records)
    if not done:
        detail["detail"]["note"] = f"deadline {deadline}s hit; partial results"
    smi = nvidia_smi("name,power.limit").split(",")
    final["device"] = smi[0].strip()
    final["power_limit"] = smi[1].strip() if len(smi) > 1 else None
    print(json.dumps(detail))
    print(json.dumps(final), flush=True)
    fatal = any(r.get("kind") == "fatal" for r in records)
    parity = next((r for r in records if r.get("kind") == "parity"), None)
    if (done and child.returncode != 0) or fatal:
        return 1
    if parity is not None and not parity.get("ok", False):
        return 1
    return 0


# ---------------------------------------------------------------------------
# --parity
# ---------------------------------------------------------------------------

def parity_check(dev, c: int = PARITY_C, block_frames: int = BLOCK_FRAMES
                 ) -> dict:
    """The split-weight laws against the "highest" chain (bench.py's
    ``parity_check``): C=``c`` with ``tail_kernel="pallas"`` (kernel #1
    on the card below the "auto" threshold), one block; USB and FM at hx5
    and hx4 against highest (the port computes hx5 and hx4 as highest, so
    these read 0 but for run-to-run rounding of the product), and u8exact
    against highest on 8-bit-grid input. Bounds 2e-6 (USB) and 3e-6 (FM),
    3e-6 (u8exact). On the card kernel #1 must have launched once a
    step."""
    import torch

    from webradio_tpu_torch.ops.tail_tm import fused_tail_audio_tm
    from webradio_tpu_torch.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )

    pifs = offset_ifs(c)
    prng = np.random.default_rng(7)
    x = torch.from_numpy(
        prng.standard_normal((2, block_frames)).astype(np.float32)).to(dev)
    # real hardware signals live on the u8 ADC grid (x - 128) / 128
    xu8 = torch.from_numpy(
        (np.round(prng.standard_normal((2, block_frames)) * 64)
         .clip(-128, 127) / 128.0).astype(np.float32)).to(dev)
    before = fused_tail_audio_tm.launches
    steps = 0

    def audio_of(fir, pfb, mode, sig):
        nonlocal steps
        cfg = ChannelizedConfig(num_channels=c, fir_precision=fir,
                                pfb_precision=pfb, tail_kernel="pallas",
                                block_frames=block_frames)
        params = make_channelized_params(cfg, pifs, 80_000, 8_000, mode,
                                         device=dev)
        _, audio, _ = channelized_step(
            cfg, params, init_channelized_state(cfg, dev), sig)
        steps += 1
        return audio.double().cpu().numpy()

    res = {"device": device_name(dev), "channels": c}
    checks = []
    for mode, bound in HX_BOUNDS:
        base = audio_of("highest", "highest", mode, x)
        for tier in ("hx5", "hx4"):
            d = float(np.max(np.abs(audio_of(tier, "highest", mode, x)
                                    - base)))
            checks.append((f"hx_{tier}_{mode}", d, bound))
    for mode in ("USB", "FM"):
        base = audio_of("highest", "highest", mode, xu8)
        d = float(np.max(np.abs(audio_of("highest", "u8exact", mode, xu8)
                                - base)))
        checks.append((f"u8exact_{mode}", d, U8_BOUND))
    launches = fused_tail_audio_tm.launches - before
    res["kernel_launches"] = launches
    if dev.type == "cuda" and launches != steps:
        raise AssertionError(f"parity: kernel #1 launched {launches} times "
                             f"for {steps} steps")
    ok = True
    for name, d, bound in checks:
        res[name] = float(f"{d:.2e}")
        if d > bound:
            res[name + "_VIOLATION"] = f"bound {bound:g}"
            ok = False
    res["hx_note"] = "hx5 and hx4 are computed as highest (the same law)"
    res["ok"] = ok
    return res


# ---------------------------------------------------------------------------
# --accuracy
# ---------------------------------------------------------------------------

def f64_reference(cfg, params, x64: np.ndarray) -> np.ndarray:
    """Float64 evaluation of the channelized math on exact-float32 input
    and the port's float32 parameter values (bench.py's reference, every
    channel FM with channel 0's FIRs): ``[C, audio_frames]``."""
    c = cfg.num_channels
    d, kp, nd = cfg.num_bins, cfg.proto_taps, cfg.chan_frames
    k, ad = cfg.fir_length, cfg.audio_decim
    host = lambda t: t.detach().cpu().numpy()
    w64 = host(params.pfb_weights).astype(np.float64).reshape(2 * kp, 2 * c)
    # im2col frames [nd, 2kp] (zero history, as the initial state)
    ext = np.concatenate([np.zeros((2, kp - 1)), x64], axis=-1)
    fr = np.empty((nd, 2 * kp))
    for t in range(kp):
        col = ext[:, (kp - 1 - t): (kp - 1 - t) + nd * d: d].T
        fr[:, t] = col[:, 0]
        fr[:, kp + t] = col[:, 1]
    y = fr @ w64
    ci, cq = y[:, :c], y[:, c:]
    # residual NCO (fast law: the full 31-bit angle), phase 0
    n = np.arange(nd, dtype=np.uint64)[:, None]
    steps = host(params.residual_step).astype(np.uint64)[None, :]
    ph = (n * steps) & np.uint64((1 << 31) - 1)
    theta = ph.astype(np.float64) * (2.0 * np.pi / (1 << 31))
    s_, c_ = np.sin(theta), np.cos(theta)
    mi = ci * c_ + cq * s_
    mq = cq * c_ - ci * s_
    # shaping FIR (decimation 1), the reference's correlation
    rev = host(params.chan_coeff).astype(np.float64)[0][::-1]
    exti = np.concatenate([np.zeros((k - 1, c)), mi], axis=0)
    extq = np.concatenate([np.zeros((k - 1, c)), mq], axis=0)
    yi = np.zeros((nd, c))
    yq = np.zeros((nd, c))
    for j in range(k):
        yi += rev[j] * exti[j: j + nd]
        yq += rev[j] * extq[j: j + nd]
    # FM: the conjugate-previous product, atan2(ii, qq), / 2 pi. Against
    # the zero first lag qq is a signed zero, and numpy's atan2(0, -0.0)
    # is pi where the step's law gives 0: "+ 0.0" makes it +0.0 (bench.py's
    # reference leaves it, which turns its first FM sample into half a
    # turn and caps every SNR it reads at that transient's ~40-50 dB)
    li = np.concatenate([np.zeros((1, c)), yi[:-1]], axis=0)
    lq = np.concatenate([np.zeros((1, c)), yq[:-1]], axis=0)
    fm = np.arctan2(yi * li + yq * lq, yq * li - yi * lq + 0.0) / (
        2.0 * np.pi)
    # the audio FIR, decimating
    arev = host(params.audio_coeff).astype(np.float64)[0][::-1]
    exta = np.concatenate([np.zeros((k - 1, c)), fm], axis=0)
    ref = np.zeros((nd // ad, c))
    for j in range(k):
        ref += arev[j] * exta[j: j + (nd // ad) * ad: ad]
    return ref.T


def accuracy_signals(cfg, ifs_hz) -> dict:
    """bench.py's three inputs (float64): full-band noise, one NBFM
    carrier per receiver plus a little noise, and the noise on the 8-bit
    grid."""
    rng = np.random.default_rng(7)
    nb = cfg.block_frames
    signals = {"noise": rng.standard_normal((2, nb))}
    t = np.arange(nb) / cfg.sample_rate
    z = np.zeros(nb, np.complex128)
    for f in ifs_hz:
        z += 0.08 * np.exp(1j * (2 * np.pi * f * t
                                 + 5.0 * np.sin(2 * np.pi * 1_000.0 * t)))
    z += 0.002 * (rng.standard_normal(nb) + 1j * rng.standard_normal(nb))
    signals["fm_tones"] = np.stack([z.real, z.imag])
    signals["u8_noise"] = (np.round(signals["noise"] * 64).clip(-128, 127)
                           / 128.0)
    return signals


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    err = got - ref
    return float(10.0 * np.log10(np.mean(ref ** 2) / np.mean(err ** 2)))


def accuracy(dev, c: int = ACCURACY_C, block_frames: int = BLOCK_FRAMES,
             pairs=ACCURACY_PAIRS, tail_kernel: str = "auto") -> dict:
    """Each (fir, pfb) tier's audio SNR in dB against the float64
    reference, one block of each of bench.py's three inputs through
    ``channelized_step`` (the ``tail_kernel`` tail) on ``dev``. On the card
    kernel #1 must have launched once a step, or never under
    ``tail_kernel="xla"`` (the plain tail). At C=ACCURACY_C on stock blocks
    ``below_jax_law`` names the keys that miss the tier rule."""
    import torch

    from webradio_tpu_torch.ops.tail_tm import fused_tail_audio_tm
    from webradio_tpu_torch.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )

    cfg0 = ChannelizedConfig(num_channels=c, block_frames=block_frames)
    rx_ifs = offset_ifs(c)
    params0 = make_channelized_params(cfg0, rx_ifs, 80_000, 8_000, "FM",
                                      device="cpu")
    out = {"metric": "channelized_audio_snr_db_vs_float64", "channels": c,
           "device": device_name(dev)}
    before, steps = fused_tail_audio_tm.launches, 0
    for name, sig in accuracy_signals(cfg0, rx_ifs).items():
        x32 = sig.astype(np.float32)
        ref = f64_reference(cfg0, params0, x32.astype(np.float64))
        x = torch.from_numpy(x32).to(dev)
        for fir, pfb in pairs:
            cfg = ChannelizedConfig(num_channels=c, fir_precision=fir,
                                    pfb_precision=pfb,
                                    block_frames=block_frames,
                                    tail_kernel=tail_kernel)
            params = make_channelized_params(cfg, rx_ifs, 80_000, 8_000,
                                             "FM", device=dev)
            _, audio, _ = channelized_step(cfg, params,
                                           init_channelized_state(cfg, dev),
                                           x)
            steps += 1
            got = audio.double().cpu().numpy()
            out[f"{name}_fir_{fir}_pfb_{pfb}"] = round(snr_db(ref, got), 1)
    out["kernel_launches"] = launches = fused_tail_audio_tm.launches - before
    want = 0 if tail_kernel == "xla" else steps
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"accuracy: kernel #1 launched {launches} "
                             f"times for {steps} steps (tail "
                             f"{tail_kernel!r})")
    if c == ACCURACY_C and block_frames == BLOCK_FRAMES:
        out["below_jax_law"] = below_jax_law(out)
    return out


def below_jax_law(snr: dict) -> dict:
    """The keys of an ``--accuracy`` result (at C=ACCURACY_C) that miss the
    tier rule: SNR under the JAX law's less LAW_SLACK_DB; key -> [SNR,
    the law's]."""
    return {k: [snr[k], law] for k, law in JAX_LAW_SNR_DB.items()
            if k in snr and snr[k] < law - LAW_SLACK_DB}


# ---------------------------------------------------------------------------
# --soak and --recovery: the live server
# ---------------------------------------------------------------------------

def _http(app, method: str, path: str, body=None, timeout: float = 30.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                      timeout=timeout)
    try:
        headers = {"Host": "127.0.0.1"}
        if body is not None:
            headers["Content-Type"] = "application/json"
            body = json.dumps(body)
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _status(app, fe) -> dict:
    _, raw = _http(app, "GET", "/status")
    return json.loads(raw)["front_ends"][fe.uuid]


def audio_format() -> str:
    """MP3 where the port's encoder loads libmp3lame, else WAV."""
    from webradio_tpu_torch.web.encoders import lame_available

    return "mp3" if lame_available() else "wav"


def soak(seconds: float = 30, capacity: int = 1024, consumers: int = 8,
         pfb: str = "highest", driver: str = "tone", fir: str = "highest",
         settle: float = 15.0, device: str = "cuda") -> dict:
    """bench.py's live soak on the port: ``RadioApp`` with one tone (or
    looping 8-bit file) tuner at stock rates, the channelized engine at
    ``capacity``, ``settle`` seconds, then ``consumers`` audio listeners on
    distinct mounts (``POST /receivers``) and a 5 Hz waterfall poller, 5
    seconds more (at most ``settle``: the POSTs' parameter writes land),
    and ``/status``'s deltas over
    ``seconds``. ``ok``: no drop, blocks at least 0.97 of those due, and
    every consumer got audio past its stream's header."""
    import threading

    from webradio_tpu_torch.app import RadioApp
    from webradio_tpu_torch.web.encoders import make_encoder

    subdevice = ""
    if driver == "file":
        # a pre-loaded looping capture: near-zero host cost a block
        fd, subdevice = tempfile.mkstemp(suffix=".cu8")
        os.close(fd)
        rng = np.random.default_rng(1)
        np.asarray(rng.integers(0, 256, 4 * 204_800), np.uint8).tofile(
            subdevice)
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": HTML_DIR},
        "tuners": [{"driver": driver, "subdevice": subdevice,
                    "centre_frequency": 124_325_000,
                    "sample_rate": SAMPLE_RATE, "block_frames": BLOCK_FRAMES,
                    "capacity": capacity, "engine": "channelized",
                    "pfb_precision": pfb, "fir_precision": fir}],
        "receivers": [{"tuner": 0, "if_frequency": 100_000,
                       "demodulator": "FM"}],
    }
    fmt = audio_format()
    header = len(make_encoder(fmt, 48_000).header())
    stop = threading.Event()
    stream_bytes: list[int] = []
    polls = [0]
    threads = []
    app = RadioApp(config, device=device)

    def listen(idx, uuid):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=60)
        try:
            conn.request("GET", f"/audio/{uuid}.{fmt}",
                         headers={"Host": "127.0.0.1"})
            resp = conn.getresponse()
            while not stop.is_set():
                chunk = resp.read1(4096)
                if not chunk:
                    break
                stream_bytes[idx] += len(chunk)
        except OSError:
            pass
        finally:
            conn.close()

    def poll_waterfall(fe):
        while not stop.is_set():
            try:
                _http(app, "GET", f"/tuners/{fe.uuid}/waterfall")
                polls[0] += 1
            except OSError:
                pass
            stop.wait(0.2)  # the UI's 5 Hz cadence

    try:
        if not app.start():
            return {"metric": "live_soak", "ok": False,
                    "error": "app failed to start"}
        fe = app.front_ends[0]
        time.sleep(settle)
        uuids = [app.receivers[0].uuid]
        for i in range(max(1, consumers) - 1):
            code, raw = _http(app, "POST", "/receivers", {
                "tuner": fe.uuid, "if_frequency": 100_000 + 5_000 * (i + 1),
                "demodulator": "FM"})
            if code >= 300:
                raise RuntimeError(f"POST /receivers answered {code}")
            uuids.append(json.loads(raw)["uri"].rsplit("/", 1)[1])
        stream_bytes.extend([0] * len(uuids))
        for i, u in enumerate(uuids):
            threads.append(threading.Thread(target=listen, args=(i, u),
                                            daemon=True))
        threads.append(threading.Thread(target=poll_waterfall, args=(fe,),
                                        daemon=True))
        for t in threads:
            t.start()
        attach_settle = min(5.0, settle)
        time.sleep(attach_settle)
        base = _status(app, fe)
        time.sleep(seconds)
        end = _status(app, fe)
        failed = app.failed
    finally:
        stop.set()
        app.close()
        for t in threads:
            t.join(timeout=5.0)
        if subdevice:
            os.unlink(subdevice)
    blocks = end["blocks"] - base["blocks"]
    dropped = end["dropped_blocks"] - base["dropped_blocks"]
    expected = seconds / (BLOCK_FRAMES / SAMPLE_RATE)
    fed = bool(stream_bytes) and all(b > header for b in stream_bytes)
    ok = (dropped == 0 and blocks >= 0.97 * expected and fed
          and failed is None)
    return {
        "metric": "live_soak", "ok": ok, "device": app.device.type,
        "seconds": seconds, "settle_seconds": settle,
        "attach_settle_seconds": attach_settle, "capacity": capacity,
        "pfb_precision": pfb, "fir_precision": fir, "driver": driver,
        "engine": end["engine"], "blocks": blocks,
        "blocks_expected": round(expected, 1), "dropped_blocks": dropped,
        "dropped_total_with_warmup": end["dropped_blocks"],
        "fanout_dropped": end["fanout_dropped"] - base["fanout_dropped"],
        "throughput_factor": end["throughput_factor"],
        "sampled_latency_ns_per_frame": end["ns_per_frame"],
        "last_step_ms": end["last_step_ms"],
        "last_dispatch_ms": end["last_dispatch_ms"],
        "graph": end["graph"], "audio_format": fmt,
        "audio_consumers": len(stream_bytes),
        "audio_stream_bytes": stream_bytes, "waterfall_polls": polls[0],
        "pump_failed": None if failed is None else repr(failed)[:200],
    }


def recovery(stall_ms: int = 500, capacity: int = 1024,
             settle: float = 2.0, window: float = 3.0,
             device: str = "cuda") -> dict:
    """bench.py's backlog recovery on the port: ``RadioApp`` with a tone
    tuner and the channelized engine at ``capacity``; once the step is
    ready (on the card its graphs captured and replaying, ``/status``'s
    ``"graph"``; on the CPU a block served) and ``settle`` seconds on, a
    ``window`` of steady state (its drops are counted), then one stall of
    the pump of ``stall_ms`` while the paced source goes on filling the
    front end's ring (16 blocks on the card, 4 on the CPU). Measured: the
    ring's drops over the stall (at most ``stall / block - ring`` are
    due), the time until the ring is empty again, and a ``window`` after
    it."""
    import threading

    from webradio_tpu_torch.app import RadioApp

    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": HTML_DIR},
        "tuners": [{"driver": "tone", "centre_frequency": 124_325_000,
                    "sample_rate": SAMPLE_RATE, "block_frames": BLOCK_FRAMES,
                    "capacity": capacity, "engine": "channelized"}],
        "receivers": [{"tuner": 0, "if_frequency": 100_000,
                       "demodulator": "FM"}],
    }
    block_ms = BLOCK_MS
    app = RadioApp(config, device=device)
    try:
        if not app.start():
            return {"metric": "backlog_recovery", "ok": False,
                    "error": "app failed to start"}
        fe = app.front_ends[0]
        card = app.device.type == "cuda"
        t0 = time.monotonic()
        ready = False
        while time.monotonic() - t0 < 120:
            st = _status(app, fe)
            g = st["graph"]
            ready = (g["captures"] >= 1 and g["replays"] >= 1 if card
                     else st["blocks"] >= 1)
            if ready:
                break
            time.sleep(0.1)
        ready_s = time.monotonic() - t0
        time.sleep(settle)
        pre = fe.dropped_blocks
        time.sleep(window)
        steady_drops = fe.dropped_blocks - pre

        # one stall of the pump at its next pass
        orig = fe.run_once
        stalled = threading.Event()
        held = []  # the ring's backlog as the stall ends

        def stalling_run_once(timeout=1.0):
            fe.run_once = orig  # one shot
            time.sleep(stall_ms / 1e3)
            held.append(fe.ring.backlog)
            stalled.set()
            return orig(timeout)

        drops0, blocks0 = fe.dropped_blocks, fe.block_count
        fe.run_once = stalling_run_once
        if not stalled.wait(30):
            raise RuntimeError("the stall never ran")
        t_end = time.monotonic()
        max_backlog = fe.ring.backlog
        recovered = None
        while time.monotonic() - t_end < 30:
            max_backlog = max(max_backlog, fe.ring.backlog)
            if fe.ring.backlog == 0 and fe.block_count > blocks0:
                recovered = time.monotonic() - t_end
                break
            time.sleep(0.005)
        post0, post_drops0 = fe.block_count, fe.dropped_blocks
        time.sleep(window)
        post_blocks = fe.block_count - post0
        post_drops = fe.dropped_blocks - post_drops0
        drops = fe.dropped_blocks - drops0
        blocks = fe.block_count - blocks0
        tput = fe.throughput_factor()
        ring = fe.ring_blocks
        graph = fe.graph_stats()
        failed = app.failed
    finally:
        app.close()
    expected_drops = max(0, int(stall_ms / block_ms) - ring)
    ok = (ready and steady_drops == 0 and recovered is not None
          and drops <= expected_drops + 2 and post_drops == 0
          and post_blocks >= 0.9 * (1e3 * window / block_ms)
          and failed is None)
    return {
        "metric": "backlog_recovery", "ok": ok, "device": app.device.type,
        "stall_ms": stall_ms, "capacity": capacity, "ring_blocks": ring,
        "ready": ready, "ready_s": round(ready_s, 3), "graph": graph,
        "steady_state_drops": steady_drops,
        "backlog_after_stall": held[0],
        "max_backlog_seen": max_backlog,
        "ring_drops_during_stall": drops,
        "expected_drops_at_most": expected_drops,
        "blocks_processed_after": blocks,
        "recovery_ms_after_stall": (None if recovered is None
                                    else round(recovered * 1e3, 1)),
        "post_recovery_window_s": window,
        "post_recovery_blocks": post_blocks,
        "post_recovery_drops": post_drops,
        "throughput_factor_since_start": tput,
        "pump_failed": None if failed is None else repr(failed)[:200],
    }


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--worker", metavar="PATH", help=argparse.SUPPRESS)
    mode.add_argument("--parity", action="store_true")
    mode.add_argument("--accuracy", action="store_true")
    mode.add_argument("--soak", nargs="*", metavar="ARG",
                      help="SECONDS CAPACITY CONSUMERS PFB DRIVER FIR")
    mode.add_argument("--recovery", nargs="*", metavar="ARG",
                      help="STALL_MS CAPACITY")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--settle", type=float, default=None,
                   help="seconds before the live modes measure")
    return p.parse_args(argv)


def _positional(values, defaults):
    """``values`` over ``defaults``, each converted to its default's
    type."""
    return [type(d)(v) for v, d in zip(values, defaults)] + list(
        defaults[len(values):])


def main(argv=None) -> int:
    import torch

    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.worker:
        worker(args.worker)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: torch sees no CUDA device; nothing was run "
              "(--device cpu runs --parity, --accuracy, --soak and "
              "--recovery on the CPU)", file=sys.stderr)
        return 2
    if args.parity:
        res = parity_check(device_of(args.device))
        print(json.dumps({"metric": "split_weight_law_parity", **res}))
        return 0 if res["ok"] else 1
    if args.accuracy:
        print(json.dumps(accuracy(device_of(args.device))))
        return 0
    if args.soak is not None:
        seconds, capacity, consumers, pfb, driver, fir = _positional(
            args.soak, (30.0, 1024, 8, "highest", "tone", "highest"))
        extra = {} if args.settle is None else {"settle": args.settle}
        res = soak(seconds, capacity, consumers, pfb, driver, fir,
                   device=args.device, **extra)
        print(json.dumps(res))
        return 0 if res["ok"] else 1
    if args.recovery is not None:
        stall_ms, capacity = _positional(args.recovery, (500, 1024))
        extra = {} if args.settle is None else {"settle": args.settle}
        res = recovery(stall_ms, capacity, device=args.device, **extra)
        print(json.dumps(res))
        return 0 if res["ok"] else 1
    if args.device != "cuda":
        print("bench_torch: the sweep measures the card; --device cpu runs "
              "only the other modes", file=sys.stderr)
        return 2
    return run_sweep()


if __name__ == "__main__":
    sys.exit(main())
