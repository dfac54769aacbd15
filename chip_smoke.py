"""Drive the PyTorch port's channelized serving path once on one CUDA card.

    python3 chip_smoke.py

Phases (each fails the run on error):

1. device: the card's name and power limit, and that the entry points
   place tensors on the card when no device is named;
2. build: compile the CUDA kernels from the checkout's sources;
3. kernel against plain version, each on the card at the shapes its path
   gives it, two carried blocks: ``fused_tail_audio_tm`` (nd=10,240,
   C=1,024, both LO laws), ``fused_tail_tm`` (nd=25,600, both LO laws,
   packed and separate planes), ``fused_pfb_tail_audio_tm`` (frames from
   tone-source blocks, both LO laws) and ``fused_receiver_tail``
   (per-channel coefficients of alternating 12.5 / 80 kHz designs); each
   kernel's time beside its plain version's and its bound;
4. main path: tone-source blocks through ``ChannelizedPipeline.process_host``
   at C=1,024 with the kernel launch counts checked, the AM/FM tones heard,
   and the audio held against the same step with the tail's plain version;
5. timing of the main path: ms/block at C=1,024 and C=16,384, one block at
   a time on CUDA events and back to back on the host clock, and the
   device's idle share from ``torch.profiler`` device events;
6. the other paths through ``process_host`` at C=1,024, each with its
   launch counts and its audio held against the plain tail: (a) mixed
   bandwidths through ``fused_receiver_tail`` and through the plain
   per-channel fallback, (b) 9.6 kHz audio through ``fused_tail_tm``, (c)
   the fused filterbank through ``fused_pfb_tail_audio_tm``, (d) catch-up
   (``process_host_many``), capacity growth and slot scatter;
7. timing of the other paths: back-to-back ms/block of (a), (b), (c) at
   C=1,024, and of (c) against the packed path at C=16,384 in turns.

Prints a ``{"kernels": [...]}`` line and, last, a ``{"ok": true, ...}``
line. Exits non-zero, without a result, where torch sees no CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

BLOCK_FRAMES = 102_400
SAMPLE_RATE = 2_400_000
BLOCK_MS = 1e3 * BLOCK_FRAMES / SAMPLE_RATE  # 42.67 ms of signal
MAIN_CHANNELS = 1_024
WIDE_CHANNELS = 16_384
MAIN_BLOCKS = 16
TIMED_BLOCKS = 24
PATH_BLOCKS = 8  # blocks through each of the paths (a) and (c)
PATH_TIMED_BLOCKS = 8
# the card's published peaks (NVIDIA H100 SXM data sheet): float32 outside
# the tensor cores, and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# kernel against plain version, the CPU tests' bounds (tests/test_torch_*)
BOUNDS = {"audio48": 1e-5, "hist_i": 1e-6, "hist_q": 1e-6,
          "demod_prev": 1e-6, "audio_hist": 1e-5}
POWER_RTOL = 1e-5
# fused_pfb_tail_audio_tm makes the 320-term filterbank product itself, one
# FMA chain per output, where the plain version's matmul may sum in another
# order: the products then differ by float32 rounding of a 320-term sum at
# unit level, so the mixed carries and the FM lag get 2e-6
PFB_BOUNDS = dict(BOUNDS, hist_i=2e-6, hist_q=2e-6, demod_prev=2e-6)
# the serving step with the kernel against the same step with the plain tail
STEP_AUDIO_BOUND = 1e-5
# FM samples a branch-cut flip may move (see audio_mismatch), as a fraction
MAX_FLIP_FRACTION = 1e-4
# Raw FM demod rows (kernels that write channel-rate audio): beside the
# flips, which are whole turns and removed, the angle is ill-conditioned
# where consecutive shaped samples are small: its error is the float32
# rounding of (ii, qq) over |y[n]| |y[n-1]|, and uniform random inputs do
# come that close to zero (first seen: 4 of 6.5e6 samples, max 1.9e-5). So
# up to MAX_FLIP_FRACTION of the FM samples may exceed the bound, none by
# more than 2 * RAW_FM_STEP. Every other slot is held to the bound.
RAW_FM_STEP = 5e-4


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def audio_mismatch(got, ref, fm, flip_step, bound, raw=False):
    """Check ``got`` against ``ref`` (``[t, C]`` tensors) and return
    ``(max error off FM slots, FM samples moved by a flip, FM max error)``.

    The reference FM law, ``atan2(ii, qq) / 2pi``, jumps by a whole turn
    where ``ii`` crosses zero with ``qq < 0``; two float32 evaluations a
    rounding apart can land on opposite sides of that cut. On raw demod
    rows (``raw``) such a flip is removed modulo one turn. Through the
    decimating audio FIR a flip moves an output by at most ``flip_step``
    (the largest audio tap) per flipped sample, so on FM slots an output may
    exceed ``bound`` only by a flip: by at most two taps, and on at most
    MAX_FLIP_FRACTION of the samples. Every other slot is held to
    ``bound``."""
    import torch

    err = got - ref
    if raw:
        err[:, fm] -= torch.round(err[:, fm])
    err = err.abs()
    strict = float(err[:, ~fm].max())
    fm_err = err[:, fm]
    flipped = int((fm_err > bound).sum())
    fm_max = float(fm_err.max())
    if not strict <= bound:
        raise AssertionError(f"audio error off FM slots {strict:.3e}")
    if flipped > MAX_FLIP_FRACTION * fm_err.numel() or not (
            fm_max <= 2 * flip_step + bound):
        raise AssertionError(f"FM audio: {flipped} samples above {bound}, "
                             f"max {fm_max:.3e}")
    return strict, flipped, fm_max


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(step, n: int):
    """Run ``step(i)`` for ``i < n`` back to back under ``torch.profiler``
    and read the device's own timeline: only kernel, memcpy and memset
    events (host-side ``aten::`` rows are not device time). Returns
    ``(busy ms/block, window ms/block, idle share, top kernels)`` where the
    window runs from the first device event's start to the last one's end;
    all None where the profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    spans = []
    per_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if "annotation" in str(getattr(e, "activity_type", "")).lower():
            continue  # user ranges drawn on the device row, not device work
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        per_name[e.name] = per_name.get(e.name, 0.0) + (t1 - t0)
    if not spans:
        return None, None, None, []
    spans.sort()
    busy, cur0, cur1 = 0.0, spans[0][0], spans[0][1]
    for t0, t1 in spans[1:]:  # union, so overlapping streams count once
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    window = cur1 - spans[0][0]
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    top = [(name[:60], us / 1e3 / n) for name, us in top]
    return busy / 1e3 / n, window / 1e3 / n, 1.0 - busy / window, top


def tone_blocks(n: int, seed: int = 0, block_frames: int = BLOCK_FRAMES,
                noise: float = 0.01):
    from webradio_tpu_torch.io.source import ToneSource

    # AM 1 kHz at IF 0, FM 440 Hz at +100 kHz
    src = ToneSource(noise=noise, seed=seed)
    src.sample_rate = SAMPLE_RATE
    src.block_frames = block_frames
    src.realtime = False
    out = []
    for _ in range(n):
        z = src.read_block()
        out.append(np.stack([z.real, z.imag]).astype(np.float32))
    return out


def slot_controls(c: int):
    """Slot 0 AM at IF 0, slot 1 FM at +100 kHz (the tone source's
    carriers); the rest spread over the band, laws cycling. Every slot at
    80 kHz IF / 8 kHz AF bandwidth, so all share one FIR kernel."""
    ifs = [0, 100_000] + [int(f) for f in
                          np.linspace(-1_150_000, 1_150_000, c - 2)]
    modes = ["AM", "FM"] + [("AM", "FM", "USB", "LSB")[i % 4]
                            for i in range(c - 2)]
    return ifs, modes


def tail_wrappers():
    """The four kernel wrappers by name; each counts its launches."""
    from webradio_tpu_torch.ops import tail, tail_tm

    return {
        "fused_tail_audio_tm": tail_tm.fused_tail_audio_tm,
        "fused_tail_tm": tail_tm.fused_tail_tm,
        "fused_pfb_tail_audio_tm": tail_tm.fused_pfb_tail_audio_tm,
        "fused_receiver_tail": tail.fused_receiver_tail,
    }


def reset_counts():
    for fn in tail_wrappers().values():
        fn.launches = 0


def expect_counts(path: str, **expected):
    """Fail unless each named kernel launched exactly that often since
    :func:`reset_counts` and every other tail kernel not at all."""
    got = {name: fn.launches for name, fn in tail_wrappers().items()}
    want = {name: expected.get(name, 0) for name in got}
    log(f"  {path}: kernel launches {got}")
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


class plain_tails:
    """Within the block the step's four kernel wrappers are their plain
    torch versions (same arguments, same returns)."""

    def __enter__(self):
        from webradio_tpu_torch.ops import tail, tail_tm
        from webradio_tpu_torch.pipeline import channelized as ch

        self.saved = {name: getattr(ch, name) for name in tail_wrappers()}
        ch.fused_tail_audio_tm = tail_tm.fused_tail_audio_tm_ref
        ch.fused_tail_tm = tail_tm.fused_tail_tm_ref
        ch.fused_pfb_tail_audio_tm = tail_tm.fused_pfb_tail_audio_tm_ref
        ch.fused_receiver_tail = tail.fused_receiver_tail_ref

    def __exit__(self, *exc):
        from webradio_tpu_torch.pipeline import channelized as ch

        for name, fn in self.saved.items():
            setattr(ch, name, fn)


def io_bytes(inputs, outputs) -> int:
    """Bytes of every distinct tensor among the inputs (each read once) and
    outputs (each written once)."""
    import torch

    seen, total = set(), 0
    for t in (*inputs, *outputs):
        if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def roofline(flops: float, nbytes: int):
    """``(bound ms, what binds)``: the larger of the operations at the
    card's float32 peak outside the tensor cores and the bytes at its
    memory rate."""
    t_ops = 1e3 * flops / PEAK_FP32_FLOPS
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tail_flops(nd, c, k=64, d=None, kp2=0):
    """Float32 operations of a tail per call: per row and channel the
    shaping FIR on both planes (4K), the mix (6), the power (4), the
    decimating audio FIR (2K/D) where there is one, and the filterbank
    product (2 outputs x ``kp2`` MACs) where the kernel makes it. The
    transcendentals and the demod law are left out."""
    per = 4 * k + 10
    if d:
        per += 2 * k / d
    per += 4 * kp2
    return nd * c * per


def compare(tag, names, bounds, got, ref, fm, flip_step, raw=(),
            filtered=()):
    """Hold a kernel's outputs to its plain version's: ``names`` in output
    order, the last being the power (relative); ``raw`` names demod rows
    (``[t, C]``, a flip is a whole turn), ``filtered`` names audio behind
    the decimating FIR (see :func:`audio_mismatch`). Returns the
    deviations, with ``worst`` / ``worst_fm`` / ``flips`` over the audio
    outputs."""
    devs = {"worst": 0.0, "worst_fm": 0.0, "flips": 0}
    for name, g, r in zip(names[:-1], got, ref):
        bound = bounds[name]
        if name in raw or name in filtered:
            devs[name], flips, fm_max = audio_mismatch(
                g, r, fm, flip_step, bound, raw=name in raw)
            devs[name + "_fm"] = fm_max
            devs[name + "_fm_flips"] = flips
            if name == names[0]:
                devs["worst"] = devs[name]
                devs["worst_fm"] = fm_max
                devs["flips"] = flips
            continue
        devs[name] = float((g - r).abs().max())
        if not devs[name] <= bound:
            raise AssertionError(
                f"{tag} {name}: {devs[name]:.3e} > {bound}")
    gp, rp = got[len(names) - 1], ref[len(names) - 1]
    prel = float(((gp - rp).abs() / rp.abs()).max())
    if not prel <= POWER_RTOL:
        raise AssertionError(f"{tag} power: rel {prel:.3e}")
    devs["power_rel"] = prel
    if not float(got[0].abs().max()) > 1e-3:
        raise AssertionError(f"{tag}: kernel audio is (near) zero")
    log(f"  {tag}: " + " ".join(
        f"{n}={v:.2e}" if isinstance(v, float) else f"{n}={v}"
        for n, v in devs.items() if n not in ("worst", "worst_fm", "flips")))
    return devs


class Worst:
    """Running maxima of a kernel's audio deviation over its comparisons."""

    def __init__(self):
        self.non_fm = self.fm = 0.0
        self.flips = 0

    def add(self, devs):
        self.non_fm = max(self.non_fm, devs["worst"])
        self.fm = max(self.fm, devs["worst_fm"])
        self.flips += devs["flips"]

    def record(self, ms, plain_ms, flops, nbytes):
        bound_ms, bound_by = roofline(flops, nbytes)
        return {
            # every slot's audio; FM slots include branch-cut flips,
            # counted beside it (see audio_mismatch)
            "max_abs_err": max(self.non_fm, self.fm),
            "max_abs_err_non_fm": self.non_fm, "fm_flips": self.flips,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes a fused receiver tail
            "library_ms": None,
        }


def shared_fir_weights(dev, d=5):
    import torch
    from webradio_tpu_torch.ops import fir, firdesign

    w = torch.from_numpy(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(80_000, 240_000), 1, 128)).to(dev)
    wa = torch.from_numpy(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(8_000, 240_000), d, 32)).to(dev)
    return w, wa


AUDIO_NAMES = ("audio48", "hist_i", "hist_q", "demod_prev", "audio_hist",
               "power")


def phase_kernel_vs_plain(dev, results, kernels):
    """Kernel #1, ``fused_tail_audio_tm``, at the stock shape."""
    import torch
    from webradio_tpu_torch.ops import tail_tm

    nd, c, k, d = BLOCK_FRAMES // 10, MAIN_CHANNELS, 64, 5
    rng = np.random.default_rng(7)
    w, wa = shared_fir_weights(dev, d)
    u = lambda *s: torch.from_numpy(
        rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(dev)
    step = torch.from_numpy(rng.integers(0, 2**32, c)).to(dev)
    mode = torch.from_numpy((np.arange(c) % 4).astype(np.int32)).to(dev)
    fm = mode == 1
    flip_step = float(wa[:k, 0].abs().max())
    worst = Worst()
    for fast in (True, False):
        phase = torch.from_numpy(rng.integers(0, 2**31, c)).to(dev)
        carry = ref_carry = (u(k - 1, c), u(k - 1, c), u(2, c), u(k - 1, c))
        for blk in range(2):
            prod = u(nd, 2 * c)
            common = (phase, step, w, wa, d, mode)
            got = tail_tm.fused_tail_audio_tm(prod, prod, *common, *carry,
                                              packed=True, fast=fast)
            torch.cuda.synchronize()
            ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common,
                                                  *ref_carry, packed=True,
                                                  fast=fast)
            worst.add(compare(f"fast={fast} block {blk}", AUDIO_NAMES,
                              BOUNDS, got, ref, fm, flip_step,
                              raw=("audio_hist",), filtered=("audio48",)))
            carry, ref_carry = got[1:5], ref[1:5]
            phase = (phase + nd * step) & 0x7FFFFFFF
    results["kernel_vs_plain_max_audio_err_non_fm"] = worst.non_fm
    results["kernel_vs_plain_max_audio_err_fm"] = worst.fm
    results["kernel_vs_plain_fm_flips"] = worst.flips

    # time the kernel and the plain tail on the same inputs
    prod = u(nd, 2 * c)
    args = (prod, prod, phase, step, w, wa, d, mode, *carry)
    kernel_ms = cuda_ms(lambda: tail_tm.fused_tail_audio_tm(
        *args, packed=True, fast=True), 50)
    plain_ms = cuda_ms(lambda: tail_tm.fused_tail_audio_tm_ref(
        *args, packed=True, fast=True), 10)
    kernel_ms2 = cuda_ms(lambda: tail_tm.fused_tail_audio_tm(
        *args, packed=True, fast=True), 50)
    log(f"  tail at C={c}: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
        f"plain torch {plain_ms:.4f} ms")
    results["tail_kernel_ms"] = min(kernel_ms, kernel_ms2)
    results["tail_plain_ms"] = plain_ms
    kernels["fused_tail_audio_tm"] = worst.record(
        results["tail_kernel_ms"], plain_ms, tail_flops(nd, c, k, d),
        io_bytes(args, got))
    cw = WIDE_CHANNELS
    prod = torch.empty(nd, 2 * cw, device=dev).uniform_(-0.5, 0.5)
    z = lambda *s: torch.zeros(s, device=dev)
    wide = (prod, prod, torch.zeros(cw, dtype=torch.int64, device=dev),
            step.repeat(cw // c), w, wa, d, mode.repeat(cw // c),
            z(k - 1, cw), z(k - 1, cw), z(2, cw), z(k - 1, cw))
    ms = cuda_ms(lambda: tail_tm.fused_tail_audio_tm(
        *wide, packed=True, fast=True), 10)
    out = tail_tm.fused_tail_audio_tm(*wide, packed=True, fast=True)
    bound, by = roofline(tail_flops(nd, cw, k, d), io_bytes(wide, out))
    log(f"  tail kernel at C={cw}: {ms:.4f} ms (bound {bound:.4f} ms, "
        f"{by})")
    results[f"tail_kernel_ms_c{cw}"] = ms
    results[f"tail_bound_ms_c{cw}"] = bound


def phase_chanrate_vs_plain(dev, results, kernels):
    """Kernel #2, ``fused_tail_tm``, at the 9.6 kHz-audio path's shape."""
    import torch
    from webradio_tpu_torch.ops import tail_tm

    nd, c, k = 25_600, MAIN_CHANNELS, 64
    rng = np.random.default_rng(8)
    w, _ = shared_fir_weights(dev)
    u = lambda *s: torch.from_numpy(
        rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(dev)
    step = torch.from_numpy(rng.integers(0, 2**32, c)).to(dev)
    mode = torch.from_numpy((np.arange(c) % 4).astype(np.int32)).to(dev)
    fm = mode == 1
    names = ("audio", "hist_i", "hist_q", "demod_prev", "power")
    bounds = dict(BOUNDS, audio=BOUNDS["audio_hist"])  # raw demod rows
    worst = Worst()
    for fast in (True, False):
        for packed in (True, False):
            phase = torch.from_numpy(rng.integers(0, 2**31, c)).to(dev)
            carry = ref_carry = (u(k - 1, c), u(k - 1, c), u(2, c))
            for blk in range(2):
                planes = (u(nd, 2 * c),) * 2 if packed else (u(nd, c),
                                                             u(nd, c))
                common = (phase, step, w, mode)
                got = tail_tm.fused_tail_tm(*planes, *common, *carry,
                                            packed=packed, fast=fast)
                torch.cuda.synchronize()
                ref = tail_tm.fused_tail_tm_ref(*planes, *common, *ref_carry,
                                                packed=packed, fast=fast)
                worst.add(compare(
                    f"fast={fast} packed={packed} block {blk}", names,
                    bounds, got, ref, fm, RAW_FM_STEP, raw=("audio",)))
                carry, ref_carry = got[1:4], ref[1:4]
                phase = (phase + nd * step) & 0x7FFFFFFF
    prod = u(nd, 2 * c)
    args = (prod, prod, phase, step, w, mode, *carry)
    ms = cuda_ms(lambda: tail_tm.fused_tail_tm(*args, packed=True,
                                               fast=True), 30)
    plain_ms = cuda_ms(lambda: tail_tm.fused_tail_tm_ref(
        *args, packed=True, fast=True), 5)
    ms2 = cuda_ms(lambda: tail_tm.fused_tail_tm(*args, packed=True,
                                                fast=True), 30)
    log(f"  fused_tail_tm at nd={nd}, C={c}: kernel {ms:.4f} / {ms2:.4f} ms,"
        f" plain torch {plain_ms:.4f} ms")
    kernels["fused_tail_tm"] = worst.record(
        min(ms, ms2), plain_ms, tail_flops(nd, c, k), io_bytes(args, got))


def phase_pfb_vs_plain(dev, results, kernels):
    """Kernel #3, ``fused_pfb_tail_audio_tm``: frames of tone-source blocks
    (with noise at 0.3, so every slot carries signal) at the stock shape."""
    import torch
    from webradio_tpu_torch.ops import tail_tm
    from webradio_tpu_torch.ops.channelizer import pfb_frames_tm
    from webradio_tpu_torch.pipeline import channelized as ch

    c, k = MAIN_CHANNELS, 64
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                               tail_kernel="pallas_pfb")
    nd, d, kp = cfg.chan_frames, cfg.audio_decim, cfg.proto_taps
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes)
    w2 = params.pfb_weights.reshape(2 * kp, 2 * c)
    rng = np.random.default_rng(9)
    u = lambda *s: torch.from_numpy(
        rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(dev)
    fm = params.mode == 1
    flip_step = float(params.audio_toep[:k, 0].abs().max())
    blocks = [torch.from_numpy(b).to(dev)
              for b in tone_blocks(2, seed=2, noise=0.3)]
    worst = Worst()
    for fast in (True, False):
        phase = torch.from_numpy(rng.integers(0, 2**31, c)).to(dev)
        pfb_hist = u(2, kp - 1)
        carry = ref_carry = (u(k - 1, c), u(k - 1, c), u(2, c), u(k - 1, c))
        for blk, iq in enumerate(blocks):
            frames, pfb_hist = pfb_frames_tm(iq, kp, cfg.num_bins, pfb_hist)
            common = (frames, w2, phase, params.residual_step,
                      params.chan_toep, params.audio_toep, d, params.mode)
            got = tail_tm.fused_pfb_tail_audio_tm(*common, *carry, fast=fast)
            torch.cuda.synchronize()
            ref = tail_tm.fused_pfb_tail_audio_tm_ref(*common, *ref_carry,
                                                      fast=fast)
            worst.add(compare(f"fast={fast} block {blk}", AUDIO_NAMES,
                              PFB_BOUNDS, got, ref, fm, flip_step,
                              raw=("audio_hist",), filtered=("audio48",)))
            carry, ref_carry = got[1:5], ref[1:5]
            phase = (phase + nd * params.residual_step) & 0x7FFFFFFF
    args = (*common, *carry)
    ms = cuda_ms(lambda: tail_tm.fused_pfb_tail_audio_tm(*args, fast=True),
                 20)
    plain_ms = cuda_ms(lambda: tail_tm.fused_pfb_tail_audio_tm_ref(
        *args, fast=True), 5)
    ms2 = cuda_ms(lambda: tail_tm.fused_pfb_tail_audio_tm(*args, fast=True),
                  20)
    log(f"  fused_pfb_tail_audio_tm at nd={nd}, C={c}: kernel {ms:.4f} / "
        f"{ms2:.4f} ms, plain torch (matmul + plain tail) {plain_ms:.4f} ms")
    kernels["fused_pfb_tail_audio_tm"] = worst.record(
        min(ms, ms2), plain_ms, tail_flops(nd, c, k, d, 2 * kp),
        io_bytes(args, got))
    # the in-kernel filterbank product's time, estimated by difference to
    # kernel #1 on the same shape (not a measurement of the product alone:
    # kernel #3 keeps two blocks an SM where #1 keeps three), and the
    # float32 rate that time would mean for [nd, 2K_p] x [2K_p, 2C], with
    # the halo rows of every time tile but the first made again
    from webradio_tpu_torch.ops.tail_tm import KERNEL_TAPS, tile_rows_for

    product_ms = min(ms, ms2) - results["tail_kernel_ms"]
    rows = nd + (-(-nd // tile_rows_for(nd, c)) - 1) * 2 * KERNEL_TAPS
    tflops = 2.0 * rows * 2 * kp * 2 * c / (1e-3 * product_ms) / 1e12
    results["pfb_product_by_difference_ms"] = product_ms
    results["pfb_product_by_difference_tflops"] = tflops
    log(f"  in-kernel filterbank product, by difference (kernel #3 less "
        f"kernel #1): {product_ms:.4f} ms, {tflops:.1f} TFLOP/s float32")


def phase_legacy_vs_plain(dev, results, kernels):
    """Kernel #4, ``fused_receiver_tail``: time-minor planes, per-channel
    coefficients of alternating 12.5 / 80 kHz designs, laws cycling."""
    import torch
    from webradio_tpu_torch.ops import firdesign, tail

    nd, c, k = BLOCK_FRAMES // 10, MAIN_CHANNELS, 64
    rng = np.random.default_rng(10)
    u = lambda *s: torch.from_numpy(
        rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(dev)
    designs = [firdesign.design_lowpass_fir(bw, 240_000)
               for bw in (12_500, 80_000)]
    coeff = torch.from_numpy(
        np.stack([designs[i % 2] for i in range(c)])).to(dev)
    step = torch.from_numpy(rng.integers(0, 2**32, c)).to(dev)
    phase = torch.from_numpy(rng.integers(0, 2**31, c)).to(dev)
    mode = torch.from_numpy((np.arange(c) % 4).astype(np.int32)).to(dev)
    fm = mode == 1
    names = ("audio", "raw_hist", "demod_prev", "power")
    # the raw history is a slice of the input: exact
    bounds = dict(BOUNDS, audio=BOUNDS["audio_hist"], raw_hist=0.0)
    worst = Worst()
    carry = ref_carry = (u(2, c, k - 1), u(2, c))
    for blk in range(2):
        chan_in = u(2, c, nd)
        common = (chan_in, phase, step, coeff, mode)
        got = tail.fused_receiver_tail(*common, *carry)
        torch.cuda.synchronize()
        ref = tail.fused_receiver_tail_ref(*common, *ref_carry)
        # audio is [C, nd]: time first for the comparison
        worst.add(compare(f"block {blk}", names, bounds,
                          (got[0].T, *got[1:]), (ref[0].T, *ref[1:]), fm,
                          RAW_FM_STEP, raw=("audio",)))
        carry, ref_carry = got[1:3], ref[1:3]
        phase = (phase + nd * step) & 0x7FFFFFFF
    args = (chan_in, phase, step, coeff, mode, *carry)
    ms = cuda_ms(lambda: tail.fused_receiver_tail(*args), 30)
    plain_ms = cuda_ms(lambda: tail.fused_receiver_tail_ref(*args), 3)
    ms2 = cuda_ms(lambda: tail.fused_receiver_tail(*args), 30)
    log(f"  fused_receiver_tail at nd={nd}, C={c}: kernel {ms:.4f} / "
        f"{ms2:.4f} ms, plain torch {plain_ms:.4f} ms")
    kernels["fused_receiver_tail"] = worst.record(
        min(ms, ms2), plain_ms, tail_flops(nd, c, k), io_bytes(args, got))


def run_pipeline(cfg, params, blocks):
    """``blocks`` through ``ChannelizedPipeline.process_host``; returns the
    audio ``[t, C]`` on the host, the last spectrum row and the pipeline."""
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch

    pipe = ch.ChannelizedPipeline(cfg, params)
    outs = [pipe.process_host(b) for b in blocks]
    outs = outs[1:] + [pipe.flush()]
    torch.cuda.synchronize()
    audio = torch.cat([a for a, _ in outs]).cpu()
    if tuple(audio.shape) != (len(blocks) * cfg.audio_frames,
                              cfg.num_channels):
        raise AssertionError(f"audio shape {tuple(audio.shape)}")
    if not bool(torch.isfinite(audio).all()):
        raise AssertionError("non-finite audio")
    db = outs[-1][1]
    if db.shape != (cfg.fft_size,) or not bool(torch.isfinite(db).all()):
        raise AssertionError("spectrum row not finite")
    return audio, db, pipe


def hear_tones(tag, cfg, audio, modes, results):
    """Slot 0 must carry the AM carrier's 1 kHz, slot 1 the FM carrier's
    440 Hz (the tone source's ensemble)."""
    audio = audio.numpy()
    for slot, want in ((0, 1_000.0), (1, 440.0)):
        x = audio[cfg.audio_frames:, slot]  # skip the first block's fill
        spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(x.size)))
        got = np.argmax(spec) * cfg.audio_rate / x.size
        log(f"  {tag} slot {slot} ({modes[slot]}): dominant tone "
            f"{got:.1f} Hz")
        if abs(got - want) > 5.0:
            raise AssertionError(f"{tag} slot {slot}: heard {got:.1f} Hz, "
                                 f"expected {want:.0f} Hz")
        results[f"{tag}slot{slot}_tone_hz"] = got


def against(tag, audio, ref_audio, params, results, key):
    """Hold a path's audio to a reference run's (see audio_mismatch)."""
    fm = params.mode.cpu() == 1
    flip_step = float(params.audio_coeff.abs().max())
    err, flips, fm_max = audio_mismatch(audio, ref_audio, fm, flip_step,
                                        STEP_AUDIO_BOUND)
    log(f"  {tag}: max audio err {err:.3e} off FM slots; FM {fm_max:.3e}, "
        f"{flips} of {int(fm.sum()) * len(audio)} samples moved by a "
        f"branch-cut flip (peak {float(ref_audio.abs().max()):.3f})")
    if not float(ref_audio.abs().max()) > 1e-2:
        raise AssertionError(f"{tag}: the audio is (near) zero")
    results[key + "_max_audio_err"] = err
    results[key + "_fm_flips"] = flips


def phase_main_path(dev, results, kernels):
    from webradio_tpu_torch.pipeline import channelized as ch

    c = MAIN_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=dev)
    blocks = tone_blocks(MAIN_BLOCKS)

    reset_counts()
    audio, _, _ = run_pipeline(cfg, params, blocks)
    expect_counts("main path", fused_tail_audio_tm=len(blocks))
    results["launches"] = len(blocks)
    kernels["fused_tail_audio_tm"]["launches"] = len(blocks)
    hear_tones("", cfg, audio, modes, results)

    # the same blocks through the same step with the tail's plain version
    # in the kernel's place
    with plain_tails():
        ref_audio, _, _ = run_pipeline(cfg, params, blocks)
    against("kernel step vs plain-tail step", audio, ref_audio, params,
            results, "step_vs_plain")
    return cfg, params, blocks, audio


def phase_other_paths(dev, results, kernels, main):
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch

    c = MAIN_CHANNELS
    main_cfg, main_params, main_blocks, main_audio = main

    # ---- (a) mixed bandwidths: slot 0 AM at IF 0 with 12.5 / 8 kHz, slot 1
    # FM at +100 kHz with 80 / 8 kHz, the rest at the server's defaults for
    # an empty slot (IF 0, 80 / 8 kHz, the first slot's law)
    log("  -- (a) mixed bandwidths: the per-channel fallback")
    ifs = [0, 100_000] + [0] * (c - 2)
    modes = ["AM", "FM"] + ["AM"] * (c - 2)
    ifbw = [12_500] + [80_000] * (c - 1)
    cfg_k = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                                 use_pallas_tail=True)
    cfg_p = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    params = ch.make_channelized_params(cfg_k, ifs, ifbw, 8_000, modes,
                                        device=dev)
    if params.chan_toep is not None:
        raise AssertionError("(a): the slots still share one shaping FIR")
    blocks = tone_blocks(PATH_BLOCKS, seed=3)
    reset_counts()
    audio_k, _, _ = run_pipeline(cfg_k, params, blocks)
    expect_counts("(a) use_pallas_tail=True",
                  fused_receiver_tail=len(blocks))
    kernels["fused_receiver_tail"]["launches"] = len(blocks)
    hear_tones("a_kernel_", cfg_k, audio_k, modes, results)
    reset_counts()
    audio_p, _, _ = run_pipeline(cfg_p, params, blocks)
    expect_counts("(a) use_pallas_tail=False")
    hear_tones("a_plain_", cfg_p, audio_p, modes, results)
    with plain_tails():
        ref, _, _ = run_pipeline(cfg_k, params, blocks)
    against("(a) kernel step vs plain-tail step", audio_k, ref, params,
            results, "a_step_vs_plain")
    against("(a) kernel step vs plain fallback step", audio_k, audio_p,
            params, results, "a_kernel_vs_fallback")
    paths = {"a_kernel": (cfg_k, params, blocks),
             "a_plain": (cfg_p, params, blocks)}

    # ---- (b) 9.6 kHz audio: no audio time tile, so the channel-rate kernel
    log("  -- (b) 9.6 kHz audio: fused_tail_tm + the Toeplitz audio FIR")
    cfg_b = ch.ChannelizedConfig(num_channels=c, audio_rate=9_600,
                                 block_frames=256_000)
    ifs_m, modes_m = slot_controls(c)
    params_b = ch.make_channelized_params(cfg_b, ifs_m, 80_000, 8_000,
                                          modes_m, device=dev)
    blocks_b = tone_blocks(4, seed=4, block_frames=cfg_b.block_frames)
    reset_counts()
    audio_b, _, _ = run_pipeline(cfg_b, params_b, blocks_b)
    expect_counts("(b)", fused_tail_tm=len(blocks_b))
    kernels["fused_tail_tm"]["launches"] = len(blocks_b)
    if cfg_b.audio_frames != 1_024:
        raise AssertionError(f"(b): {cfg_b.audio_frames} audio frames")
    hear_tones("b_", cfg_b, audio_b, modes_m, results)
    with plain_tails():
        ref, _, _ = run_pipeline(cfg_b, params_b, blocks_b)
    against("(b) kernel step vs plain-tail step", audio_b, ref, params_b,
            results, "b_step_vs_plain")
    paths["b"] = (cfg_b, params_b, blocks_b)

    # ---- (c) fused filterbank: the main path's blocks and parameters
    log("  -- (c) tail_kernel='pallas_pfb': fused_pfb_tail_audio_tm")
    cfg_c = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                                 tail_kernel="pallas_pfb")
    blocks_c = main_blocks[:PATH_BLOCKS]
    reset_counts()
    audio_c, _, _ = run_pipeline(cfg_c, main_params, blocks_c)
    expect_counts("(c)", fused_pfb_tail_audio_tm=len(blocks_c))
    kernels["fused_pfb_tail_audio_tm"]["launches"] = len(blocks_c)
    hear_tones("c_", cfg_c, audio_c, slot_controls(c)[1], results)
    with plain_tails():
        ref, _, _ = run_pipeline(cfg_c, main_params, blocks_c)
    # the fused filterbank's product is one FMA chain per output; where the
    # matmul sums in that order too its audio is the main path's exactly,
    # and it is held to the audio bound either way
    against("(c) kernel step vs plain-tail step", audio_c, ref, main_params,
            results, "c_step_vs_plain")
    against("(c) fused filterbank vs the main path's packed kernel",
            audio_c, main_audio[:len(audio_c)], main_params, results,
            "c_vs_main")
    paths["c"] = (cfg_c, main_params, blocks_c)

    # ---- (d) catch-up, growth and scatter on the main configuration
    log("  -- (d) process_host_many, grow_channelized_state, "
        "update_params_slots")
    k = 4
    reset_counts()
    many = ch.ChannelizedPipeline(main_cfg, main_params)
    if many.process_host_many(np.stack(main_blocks[:k])) is not None:
        raise AssertionError("(d): a result before anything was pending")
    audio_many, db_many = many.flush()
    torch.cuda.synchronize()
    expect_counts("(d) process_host_many", fused_tail_audio_tm=k)
    if tuple(audio_many.shape) != (k, c, main_cfg.audio_frames):
        raise AssertionError(f"(d): audio shape {tuple(audio_many.shape)}")
    one = ch.ChannelizedPipeline(main_cfg, main_params)
    outs = [one.process_host(b) for b in main_blocks[:k]][1:] + [one.flush()]
    err = max(float((a.T - audio_many[i]).abs().max())
              for i, (a, _) in enumerate(outs))
    err_db = float((outs[-1][1] - db_many).abs().max())
    err_state = max(
        float((getattr(one.state, f) - getattr(many.state, f)).abs().max())
        for f in ch.ChannelizedState._fields)
    log(f"  (d) process_host_many vs {k} process_host calls: audio "
        f"{err:.3e}, spectrum row {err_db:.3e} dB, state {err_state:.3e}")
    # the same kernels on the same inputs in the same order
    if max(err, err_db, err_state) > 0.0:
        raise AssertionError("(d): the catch-up path differs from the "
                             "per-block path")
    results["d_many_vs_one_max_err"] = max(err, err_state)

    # growth from C to 2C between blocks: the old slots' next block
    ifs_m, modes_m = slot_controls(c)
    wide_cfg = ch.ChannelizedConfig(num_channels=2 * c,
                                    block_frames=BLOCK_FRAMES)
    wide_params = ch.make_channelized_params(
        wide_cfg, ifs_m + ifs_m, 80_000, 8_000, modes_m + modes_m,
        device=dev)
    nxt = main_blocks[k]
    want = one.process_host_sync(nxt)[0].cpu()
    grown = ch.ChannelizedPipeline(wide_cfg, wide_params)
    grown.state = ch.grow_channelized_state(many.state, 2 * c)
    got = grown.process_host_sync(nxt)[0][:, :c].cpu()
    # a filterbank GEMM of another width may sum in another order
    against("(d) grown pipeline's first C slots vs the ungrown pipeline",
            got, want, main_params, results, "d_grow")

    # slot scatter: three slots retuned, against a full rebuild
    idx = [3, 17, c - 24]
    ifs2, modes2 = list(ifs_m), list(modes_m)
    for n, i in enumerate(idx):
        ifs2[i], modes2[i] = 12_345 * (n + 1), ("USB", "FM", "AM")[n]
    sub_cfg = ch.ChannelizedConfig(num_channels=len(idx),
                                   block_frames=BLOCK_FRAMES)
    sub = ch.make_channelized_params(
        sub_cfg, [ifs2[i] for i in idx], 80_000, 8_000,
        [modes2[i] for i in idx], device="cpu")
    base = ch.make_channelized_params(main_cfg, ifs_m, 80_000, 8_000,
                                      modes_m, device=dev)
    pipe = ch.ChannelizedPipeline(main_cfg, base)
    pipe.update_params_slots(idx, sub, (0, 1, 2, 3))
    full = ch.make_channelized_params(main_cfg, ifs2, 80_000, 8_000, modes2,
                                      device=dev)
    for f in ch.ChannelizedParams._fields:
        x, y = getattr(pipe.params, f), getattr(full, f)
        if (x is None) != (y is None) or (x is not None and not torch.equal(
                torch.nan_to_num(x.double()), torch.nan_to_num(y.double()))):
            raise AssertionError(f"(d): scattered params differ in {f}")
    ref_pipe = ch.ChannelizedPipeline(main_cfg, full)
    a = pipe.process_host_sync(nxt)[0]
    b = ref_pipe.process_host_sync(nxt)[0]
    if not torch.equal(a, b):
        raise AssertionError("(d): audio after a slot scatter differs from "
                             "a full update_params")
    log(f"  (d) update_params_slots on slots {idx} equals a full rebuild, "
        f"parameters and next block's audio")
    return paths


def phase_timing(dev, results):
    import torch
    from webradio_tpu_torch.ops.channelizer import pfb_channelize_direct_tm
    from webradio_tpu_torch.ops.spectrum import spectrum_accumulate
    from webradio_tpu_torch.pipeline import channelized as ch

    blocks = tone_blocks(8, seed=1)
    for c in (MAIN_CHANNELS, WIDE_CHANNELS):
        cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
        ifs, modes = slot_controls(c)
        params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                            device=dev)
        pipe = ch.ChannelizedPipeline(cfg, params)
        for b in blocks[:4]:  # warm: allocator, cuBLAS handles
            pipe.process_host(b)
        torch.cuda.synchronize()
        dev_ms, wall_ms = [], []
        for i in range(TIMED_BLOCKS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            pipe.process_host(blocks[i % len(blocks)])
            end.record()
            end.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            dev_ms.append(start.elapsed_time(end))
        med, wall = statistics.median(dev_ms), statistics.median(wall_ms)
        # serving cadence: blocks back to back, one synchronize at the end
        t0 = time.perf_counter()
        for i in range(TIMED_BLOCKS):
            pipe.process_host(blocks[i % len(blocks)])
        torch.cuda.synchronize()
        stream = 1e3 * (time.perf_counter() - t0) / TIMED_BLOCKS
        # stage breakdown on one block's tensors
        iq = torch.from_numpy(blocks[0]).to(dev)
        spec_ms = cuda_ms(lambda: spectrum_accumulate(iq, cfg.fft_size), 10)
        pfb_ms = cuda_ms(lambda: pfb_channelize_direct_tm(
            iq, params.pfb_weights, cfg.num_bins, pipe.state.pfb_hist,
            split=False), 10)
        prof_blocks = 8
        busy, window, idle, top = device_profile(
            lambda i: pipe.process_host(blocks[i % len(blocks)]), prof_blocks)
        log(f"  C={c}: one block at a time, median {med:.3f} ms/block on "
            f"the device clock (min {min(dev_ms):.3f}, {TIMED_BLOCKS} blocks; "
            f"wall {wall:.3f}); back to back {stream:.3f} ms/block, "
            f"real-time factor {BLOCK_MS / stream:.2f}; spectrum "
            f"{spec_ms:.3f} ms, filterbank {pfb_ms:.3f} ms")
        if busy is None:
            log(f"  C={c}: profiler saw no device events; idle share not "
                f"measured")
        else:
            log(f"  C={c}: profiled {prof_blocks} blocks back to back: device "
                f"busy {busy:.3f} of a {window:.3f} ms/block device window, "
                f"idle share {idle:.3f}")
            for name, ms in top:
                log(f"    {ms:8.4f} ms/block  {name}")
        results[f"c{c}"] = {
            "median_ms_per_block_device": med,
            "median_ms_per_block_wall": wall,
            "min_ms_per_block_device": min(dev_ms),
            "stream_ms_per_block": stream,
            "realtime_factor_stream": BLOCK_MS / stream,
            "realtime_factor_device": BLOCK_MS / med,
            "spectrum_ms": spec_ms,
            "filterbank_ms": pfb_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "profiled_busy_ms_per_block": busy,
            "profiled_window_ms_per_block": window,
            "profiled_idle_share": idle,
        }
        del pipe, params
        torch.cuda.empty_cache()


def stream_ms(cfg, params, blocks, n: int) -> float:
    """Back-to-back ms/block of ``process_host`` (host clock, one
    synchronize at the end), after two warm blocks."""
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch

    pipe = ch.ChannelizedPipeline(cfg, params)
    for b in blocks[:2]:
        pipe.process_host(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        pipe.process_host(blocks[i % len(blocks)])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def phase_path_timing(dev, results, paths):
    from webradio_tpu_torch.pipeline import channelized as ch

    c = MAIN_CHANNELS
    for name, (cfg, params, blocks) in paths.items():
        ms = stream_ms(cfg, params, blocks, PATH_TIMED_BLOCKS)
        block_ms = 1e3 * cfg.block_seconds
        log(f"  path {name} at C={c}: back to back {ms:.3f} ms/block of "
            f"{block_ms:.2f} ms, real-time factor {block_ms / ms:.2f}")
        results[f"path_{name}_stream_ms_per_block"] = ms
    # the open A/B: fused filterbank against the packed product at the wide
    # width, in turns within this one call (packed, fused, fused, packed)
    cw = WIDE_CHANNELS
    ifs, modes = slot_controls(cw)
    blocks = tone_blocks(4, seed=1)
    kw = dict(num_channels=cw, block_frames=BLOCK_FRAMES)
    packed = ch.ChannelizedConfig(**kw)
    fused = ch.ChannelizedConfig(tail_kernel="pallas_pfb", **kw)
    params = ch.make_channelized_params(packed, ifs, 80_000, 8_000, modes,
                                        device=dev)
    turns = [(n, stream_ms(cfg, params, blocks, PATH_TIMED_BLOCKS))
             for n, cfg in (("packed", packed), ("fused", fused),
                            ("fused", fused), ("packed", packed))]
    log(f"  C={cw}, back to back ms/block in turns: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in turns))
    results[f"c{cw}_packed_stream_ms"] = [ms for n, ms in turns
                                          if n == "packed"]
    results[f"c{cw}_fused_pfb_stream_ms"] = [ms for n, ms in turns
                                             if n == "fused"]


def check_default_device():
    """The entry points that place tensors take the card when no device is
    named."""
    from webradio_tpu_torch import convert
    from webradio_tpu_torch.pipeline import channelized as ch

    cfg = ch.ChannelizedConfig(num_channels=16, block_frames=BLOCK_FRAMES)
    params = ch.make_channelized_params(cfg, 0, 80_000, 8_000, "AM")
    state = ch.init_channelized_state(cfg)
    host = lambda nt: type(nt)(*(None if t is None else t.cpu().numpy()
                                 for t in nt))
    for nt in (params, state, convert.params_from_numpy(host(params)),
               convert.state_from_numpy(host(state))):
        for name, t in zip(nt._fields, nt):
            if t is not None and t.device.type != "cuda":
                raise AssertionError(f"{name} is on {t.device} when no "
                                     f"device was named")
    log("  entry points place tensors on the card when no device is named")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from webradio_tpu_torch import require_cuda
    from webradio_tpu_torch.ops import _build

    dev = require_cuda()
    results: dict = {}
    kernels: dict = {}
    log("== device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {kind}")
    results["device"] = kind
    results["nvidia_smi"] = smi
    check_default_device()

    log("== build")
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    results["build_s"] = time.perf_counter() - t0
    log(f"  built {lib_path.name} in {results['build_s']:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or "Compiling entry" in line):
            log("  ptxas: " + line.strip())

    log("== kernel against plain version: fused_tail_audio_tm "
        "(nd=10240, C=1024)")
    phase_kernel_vs_plain(dev, results, kernels)
    log("== kernel against plain version: fused_tail_tm (nd=25600, C=1024)")
    phase_chanrate_vs_plain(dev, results, kernels)
    log("== kernel against plain version: fused_pfb_tail_audio_tm "
        "(nd=10240, C=1024)")
    phase_pfb_vs_plain(dev, results, kernels)
    log("== kernel against plain version: fused_receiver_tail "
        "(nd=10240, C=1024)")
    phase_legacy_vs_plain(dev, results, kernels)
    log("== main path: ChannelizedPipeline.process_host")
    main_run = phase_main_path(dev, results, kernels)
    # the main path is timed before the other paths run: in a process that
    # has driven them, every small torch launch costs the host more (the
    # step at C=1,024 is host-bound), and the earlier records were taken in
    # this order
    log("== timing of the main path")
    phase_timing(dev, results)
    log("== the other paths through process_host")
    paths = phase_other_paths(dev, results, kernels, main_run)
    del main_run
    log("== timing of the other paths")
    phase_path_timing(dev, results, paths)
    del paths
    clocks = nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    log(f"  after timing: sm clock, max sm clock, power draw, temp = "
        f"{clocks}")
    results["after_timing_smi"] = clocks

    meta = {
        "fused_tail_audio_tm": ("webradio_tpu_torch/csrc/tail_tm.cu",
                                "webradio_tpu/ops/pallas_tail_tm.py:736"),
        "fused_tail_tm": ("webradio_tpu_torch/csrc/tail_tm.cu",
                          "webradio_tpu/ops/pallas_tail_tm.py:372"),
        "fused_pfb_tail_audio_tm": ("webradio_tpu_torch/csrc/tail_tm.cu",
                                    "webradio_tpu/ops/pallas_tail_tm.py:904"),
        "fused_receiver_tail": ("webradio_tpu_torch/csrc/tail.cu",
                                "webradio_tpu/ops/pallas_tail.py:141"),
    }
    kernel_list = []
    for name, (source, replaces) in meta.items():
        rec = kernels[name]
        if rec["launches"] < 1:
            raise AssertionError(f"{name} was not launched on its path")
        kernel_list.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, **rec})
        results["kernel_" + name] = rec
    kernels = {"kernels": kernel_list}
    log("== results")
    log("  " + json.dumps(results))
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
