"""Drive the PyTorch port's channelized serving path once on one CUDA card.

    python3 chip_smoke.py

Phases (each fails the run on error):

1. device: the card's name and power limit;
2. build: compile the CUDA kernels from the checkout's sources;
3. kernel against plain version: ``fused_tail_audio_tm`` on the card at
   the stock shape (nd=10,240, C=1,024), both LO laws, two carried blocks;
4. main path: tone-source blocks through ``ChannelizedPipeline.process_host``
   at C=1,024 with the kernel launch count checked, the AM/FM tones heard,
   and the audio held against the same step with the tail's plain version;
5. timing: ms/block at C=1,024 and C=16,384, one block at a time on CUDA
   events and back to back on the host clock, the device's idle share from
   ``torch.profiler`` device events, and the kernel's time beside the
   plain tail's.

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
# kernel against plain version, the CPU tests' bounds (tests/test_torch_*)
BOUNDS = {"audio48": 1e-5, "hist_i": 1e-6, "hist_q": 1e-6,
          "demod_prev": 1e-6, "audio_hist": 1e-5}
POWER_RTOL = 1e-5
# the serving step with the kernel against the same step with the plain tail
STEP_AUDIO_BOUND = 1e-5
# FM samples a branch-cut flip may move (see audio_mismatch), as a fraction
MAX_FLIP_FRACTION = 1e-4


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


def tone_blocks(n: int, seed: int = 0):
    from webradio_tpu.io.source import ToneSource

    src = ToneSource(seed=seed)  # AM 1 kHz at IF 0, FM 440 Hz at +100 kHz
    src.sample_rate = SAMPLE_RATE
    src.block_frames = BLOCK_FRAMES
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


def phase_kernel_vs_plain(dev, results):
    import torch
    from webradio_tpu_torch.ops import fir, firdesign, tail_tm

    nd, c, k, d = BLOCK_FRAMES // 10, MAIN_CHANNELS, 64, 5
    rng = np.random.default_rng(7)
    w = torch.from_numpy(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(80_000, 240_000), 1, 128)).to(dev)
    wa = torch.from_numpy(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(8_000, 240_000), d, 32)).to(dev)
    u = lambda *s: torch.from_numpy(
        rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(dev)
    step = torch.from_numpy(rng.integers(0, 2**32, c)).to(dev)
    mode = torch.from_numpy((np.arange(c) % 4).astype(np.int32)).to(dev)
    fm = mode == 1
    flip_step = float(wa[:k, 0].abs().max())
    worst = worst_fm = 0.0
    flips_total = 0
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
            devs = {}
            for (name, bound), g, r in zip(BOUNDS.items(), got, ref):
                if name in ("audio48", "audio_hist"):
                    devs[name], flips, fm_max = audio_mismatch(
                        g, r, fm, flip_step, bound, raw=name == "audio_hist")
                    devs[name + "_fm"] = fm_max
                    devs[name + "_fm_flips"] = flips
                    if name == "audio48":
                        worst_fm = max(worst_fm, fm_max)
                        flips_total += flips
                    continue
                devs[name] = float((g - r).abs().max())
                if not devs[name] <= bound:
                    raise AssertionError(
                        f"kernel vs plain {name}: {devs[name]:.3e} > {bound}")
            prel = float(((got[5] - ref[5]).abs() / ref[5].abs()).max())
            if not prel <= POWER_RTOL:
                raise AssertionError(f"kernel vs plain power: rel {prel:.3e}")
            if not float(got[0].abs().max()) > 1e-3:
                raise AssertionError("kernel audio is (near) zero")
            log(f"  fast={fast} block {blk}: "
                + " ".join(f"{n}={v:.2e}" if isinstance(v, float)
                           else f"{n}={v}" for n, v in devs.items())
                + f" power_rel={prel:.2e}")
            worst = max(worst, devs["audio48"])
            carry, ref_carry = got[1:5], ref[1:5]
            phase = (phase + nd * step) & 0x7FFFFFFF
    results["kernel_vs_plain_max_audio_err_non_fm"] = worst
    results["kernel_vs_plain_max_audio_err_fm"] = worst_fm
    results["kernel_vs_plain_fm_flips"] = flips_total

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
    cw = WIDE_CHANNELS
    prod = torch.empty(nd, 2 * cw, device=dev).uniform_(-0.5, 0.5)
    z = lambda *s: torch.zeros(s, device=dev)
    wide = (prod, prod, torch.zeros(cw, dtype=torch.int64, device=dev),
            step.repeat(cw // c), w, wa, d, mode.repeat(cw // c),
            z(k - 1, cw), z(k - 1, cw), z(2, cw), z(k - 1, cw))
    ms = cuda_ms(lambda: tail_tm.fused_tail_audio_tm(
        *wide, packed=True, fast=True), 10)
    log(f"  tail kernel at C={cw}: {ms:.4f} ms")
    results[f"tail_kernel_ms_c{cw}"] = ms


def phase_main_path(dev, results):
    import torch
    from webradio_tpu_torch.ops import tail_tm
    from webradio_tpu_torch.pipeline import channelized as ch

    c = MAIN_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=dev)
    blocks = tone_blocks(MAIN_BLOCKS)
    pipe = ch.ChannelizedPipeline(cfg, params)

    tail_tm.fused_tail_audio_tm.launches = 0
    outs = [pipe.process_host(b) for b in blocks]
    outs = outs[1:] + [pipe.flush()]
    torch.cuda.synchronize()
    launches = tail_tm.fused_tail_audio_tm.launches
    log(f"  {len(blocks)} blocks through process_host, kernel launches "
        f"{launches}")
    if launches != len(blocks):
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{len(blocks)} blocks")
    results["launches"] = launches

    audio = torch.cat([a for a, _ in outs]).cpu().numpy()  # [t, C]
    if audio.shape != (len(blocks) * cfg.audio_frames, c):
        raise AssertionError(f"audio shape {audio.shape}")
    if not np.isfinite(audio).all():
        raise AssertionError("non-finite audio")
    for slot, want in ((0, 1_000.0), (1, 440.0)):
        x = audio[cfg.audio_frames:, slot]  # skip the first block's fill
        spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(x.size)))
        got = np.argmax(spec) * cfg.audio_rate / x.size
        log(f"  slot {slot} ({modes[slot]}): dominant tone {got:.1f} Hz")
        if abs(got - want) > 5.0:
            raise AssertionError(f"slot {slot}: heard {got:.1f} Hz, "
                                 f"expected {want:.0f} Hz")
        results[f"slot{slot}_tone_hz"] = got
    db = outs[-1][1]
    if db.shape != (cfg.fft_size,) or not bool(torch.isfinite(db).all()):
        raise AssertionError("spectrum row not finite")

    # the same blocks through the same step with the tail's plain version
    # in the kernel's place
    ch.fused_tail_audio_tm = tail_tm.fused_tail_audio_tm_ref
    try:
        plain = ch.ChannelizedPipeline(cfg, params)
        ref = [plain.process_host(b) for b in blocks][1:] + [plain.flush()]
        ref_audio = torch.cat([a for a, _ in ref]).cpu()
    finally:
        ch.fused_tail_audio_tm = tail_tm.fused_tail_audio_tm
    fm = params.mode.cpu() == 1
    flip_step = float(params.audio_coeff.abs().max())
    err, flips, fm_max = audio_mismatch(torch.from_numpy(audio), ref_audio,
                                        fm, flip_step, STEP_AUDIO_BOUND)
    log(f"  kernel step vs plain-tail step: max audio err {err:.3e} off FM "
        f"slots; FM {fm_max:.3e}, {flips} of {int(fm.sum()) * len(audio)} "
        f"samples moved by a branch-cut flip "
        f"(peak {float(ref_audio.abs().max()):.3f})")
    results["step_vs_plain_max_audio_err"] = err
    results["step_vs_plain_fm_flips"] = flips


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from webradio_tpu_torch import require_cuda
    from webradio_tpu_torch.ops import _build, tail_tm

    dev = require_cuda()
    results: dict = {}
    log("== device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {kind}")
    results["device"] = kind
    results["nvidia_smi"] = smi

    log("== build")
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    results["build_s"] = time.perf_counter() - t0
    log(f"  built {lib_path.name} in {results['build_s']:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas: " + line.strip())

    log("== kernel against plain version (nd=10240, C=1024)")
    phase_kernel_vs_plain(dev, results)
    log("== main path: ChannelizedPipeline.process_host")
    phase_main_path(dev, results)
    log("== timing")
    phase_timing(dev, results)
    clocks = nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    log(f"  after timing: sm clock, max sm clock, power draw, temp = "
        f"{clocks}")
    results["after_timing_smi"] = clocks

    kernels = {"kernels": [{
        "name": "fused_tail_audio_tm",
        "route": "cuda",
        "source": "webradio_tpu_torch/csrc/tail_tm.cu",
        "replaces": "webradio_tpu/ops/pallas_tail_tm.py:736",
        "launches": results["launches"],
        # every slot's audio; FM slots include branch-cut flips, counted
        # beside it (see audio_mismatch)
        "max_abs_err": max(results["kernel_vs_plain_max_audio_err_non_fm"],
                           results["kernel_vs_plain_max_audio_err_fm"]),
        "max_abs_err_non_fm": results["kernel_vs_plain_max_audio_err_non_fm"],
        "fm_flips": results["kernel_vs_plain_fm_flips"],
        "ms": results["tail_kernel_ms"],
        "plain_ms": results["tail_plain_ms"],
    }]}
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
