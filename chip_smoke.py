"""Drive the PyTorch port's channelized serving path once on one CUDA card.

    python3 chip_smoke.py

Phases (each fails the run on error):

1. device: the card's name and power limit, and that the entry points
   place tensors on the card when no device is named;
2. build: compile the CUDA kernels from the checkout's sources;
3. kernel against plain version, each on the card at the shapes its path
   gives it, two carried blocks: ``fused_tail_audio_tm`` (nd=10,240,
   C=1,024, both LO laws, on its mma.sync and its wgmma body, then #1's
   time on each body at C=1,024, 16,384 and 69,632), ``fused_tail_tm`` (nd=25,600, both LO laws,
   packed and separate planes), ``fused_pfb_tail_audio_tm`` (frames from
   tone-source blocks, both LO laws) and ``fused_receiver_tail``
   (per-channel coefficients of alternating 12.5 / 80 kHz designs); each
   kernel's time beside its plain version's and its bound;
4. main path: tone-source blocks through ``ChannelizedPipeline.process_host``
   at C=1,024 with the kernel launch counts checked, the AM/FM tones heard,
   and the audio held against the same step with the tail's plain version;
5. timing of the main path: ms/block at C=1,024 and C=16,384, one block at
   a time on CUDA events and back to back on the host clock, and the
   device's idle share from ``torch.profiler`` device events (a profiler
   window that holds fewer kernel events than its graph replays launched
   fails);
5b. each block as one CUDA graph replay: every single-card branch (main
   at C=1,024 and 16,384, bf16 and u8exact at 16,384, 9.6 kHz, the fused
   filterbank, the per-channel fallback plain and through its kernel, the
   direct engine at C=4 and 16) graphed against eager over 8 carried
   blocks, bit for bit; graph and eager in turns at C=1,024 and 16,384
   (ms/block one at a time and back to back, idle share, the host's launch
   calls a block, a 4-block catch-up); the offline runner at 16,384; peak
   device memory at C=69,632, u8exact;
6. the other paths through ``process_host`` at C=1,024, each with its
   launch counts and its audio held against the plain tail: (a) mixed
   bandwidths through ``fused_receiver_tail`` (on the card whatever
   ``use_pallas_tail`` says) and through the plain per-channel fallback
   (``tail_kernel="xla"``), (b) 9.6 kHz audio through ``fused_tail_tm``, (c)
   the fused filterbank through ``fused_pfb_tail_audio_tm``, (d) catch-up
   (``process_host_many``), capacity growth and slot scatter;
7. timing of the other paths: back-to-back ms/block of (a), (b), (c) at
   C=1,024, and of (c) against the packed path at C=16,384 in turns;
7b. widths: stock rates at C = 16, 32, 64, 100, 256 and 511 (below the
   JAX package's 512 and off its 128-channel tile), kernel #1 once a
   block, the audio against the same blocks through ``tail_kernel="xla"``,
   the tones, both back-to-back ms/block; kernel #2 the same at C=100 on
   the 9.6 kHz path; then one live pipeline on graphs at C=1,024 switched
   uniform -> mixed -> uniform bandwidths (#1, #4, #1), its audio against
   a plain pipeline across the same switches and its carried history
   against that pipeline's after every block;
8. the filterbank tiers (``pfb_precision``: highest, u8exact, default,
   high, bf16) on the main configuration at C=1,024 and C=16,384, fed
   8-bit-grid blocks: each tier's product SNR against a float64 product
   and its CUDA-event ms, the step's back-to-back ms/block with kernel #1
   once a block, the tones, and the audio against the "highest" tier's;
   kernel #1 and #2 on the "bf16" tier's bfloat16 product and #3 at
   "default" and "high" against their plain versions (#3 by the tier rule:
   audio SNR against the exactly made product within 0.5 dB of the plain
   version's), each on its path with its launches counted;
9. the headline topology, ``examples/headline_monitor.json``'s front end:
   C=69,632, 16 blocks of 8-bit-grid input back to back at u8exact,
   highest and bf16: ms/block, real-time factor (u8exact must be above 1),
   kernel #1 once a block and every launch on its wgmma body (the shape
   rule's at that width), the AM and FM tones, peak device memory;
9b. the bench (``bench_torch.py``): ``--parity`` on the card with its
   ``ok`` gated; one sweep point at C=16,384 "highest" through the bench's
   timing (device-resident input through ``step_device``, kernel #1 once a
   block) beside the main path's ms/block; and one at C=106,496, past 2^31
   elements of the packed product, where kernel #1's outputs are held
   against the plain tail on the last 256 channels;
9c. accuracy: ``bench_torch.py --accuracy`` (C=128, its 33 SNRs against
   the float64 reference) through kernel #1 (33 launches) and through the
   plain tail (``tail_kernel="xla"``): every key of #1 at least the JAX
   law's less 0.5 dB (``bench_torch.JAX_LAW_SNR_DB``, the tier rule) and
   at least the plain tail's less 0.5 dB;
10. offline: ``pipeline.stream.run_capture_channelized`` over 16 blocks
   and a part-block of tone-source input at C=16,384 (kernel #1 once a
   block, its audio and state bit-equal to 16 ``process_host`` calls, the
   AM and FM tones, its back-to-back ms/block beside ``process_host``'s),
   and ``run_capture`` at C=16 against ``FrontEndPipeline``;
11. the CLI: ``demod_cli.main`` on a 1 s ``.cf32`` tone capture with four
   receivers, on the direct and the channelized engine, every WAV heard;
12. the entry: ``entry()``'s step on the card against the same step on the
   CPU (1e-5, the FM flip rule);
13. the server: the port's ``RadioApp`` in this process on the card (no
   device named), HTTP on 127.0.0.1, four tone tuners for about ten
   seconds of real-time serving: tuner 0 at C=16,384 (channelized, every
   slot at the default bandwidths, so kernel #1 runs every block) with AM,
   FM, USB and LSB receivers, tuner 1 the demo topology at capacity 4 (the
   direct engine), tuner 2 channelized at 256 slots, all taken (kernel
   #1), tuner 3 shaped like ``examples/mass_monitor.json`` (1,024 slots,
   one FM receiver at 12.5 kHz: kernel #4). No tuner's tail may run plain
   (``plain_tail``). Requests: /status, /tuners, the waterfalls; two
   seconds of WAV from the AM and FM receivers of tuners 0 and 1 and the
   FM receiver of tuner 3 (1 kHz and 440 Hz within 2 Hz), a PUT
   moving tuner 0's AM receiver to FM at +100 kHz (then 440 Hz), a POST
   and a DELETE of a receiver; a POST that grows tuner 2 to 512 slots (the
   new receiver's 1 kHz heard after the swap, captured in the growth
   build); a forced stall of tuner 0 (its service held until its ring
   holds four blocks) that the pump serves in one ``run_once``, a graph
   replay a block; PUTs that move a tuner 1 receiver's bandwidth off the
   shared FIR and back (a recapture each) and change its law twice (none);
   a 1 s torch.profiler window and a /profile trace, each failing where it
   holds fewer kernel events than the graph replays in it launched (or
   none while blocks were served), with the profiler's start, stop and
   export/parse ms. Every tuner's served blocks must be graph replays but
   the eager warm before each capture. Kernel #1's launches against the
   blocks of tuners 0 and 2 (both sides of the growth), kernel #4's
   against tuner 3's, and per
   tuner the blocks, drops, the server's own real-time factor and
   ms/block, the pump's longest gap in each step, and the device's idle
   share in the window. Drops of the ring and of the tone source are
   counted by span: start-up, the profiler window, the /profile trace, and
   serving (everything else, growth and catch-up included); serving and
   the /profile trace must drop no block (each stretch of the trace is
   logged with the pump's longest gap and each ring's depths and drops).
   A fifth receiver on tuner 0 (AM) writes a ``file:`` audio sink whose
   WAV must hold 1 kHz with no sink drop; a receiver on tuner 1 asks for
   "pulse", which without libpulse-simple stays unbound;
13b. the clocks: one tone tuner at C=16,384 served by ``RadioApp`` with a
   ``file:`` sink on its receiver, and a ``/profile`` trace of its live
   pump, whose ``trace.json`` holds the host's tracks from the flight
   recorder (``webradio_tpu_torch.trace``) beside the card's kernels: for
   at least 99% of the traced blocks the graph launch of the block's step
   lies in its ``dispatch`` span, the step's first kernel starts after
   that span starts, and the block's ``fetch`` ends after the last kernel
   of the next block's step (which the one stream runs before the copy);
   and the recorder's host cost a block, its calls of one served block
   timed in a loop;
14. the soundcard tuner: a ``"soundcard"`` tuner on a libpulse-simple
   stand-in at a 96 kHz line-in clock, served by ``RadioApp`` on the card,
   its AM receiver heard over HTTP;
15. sharded, on virtual meshes whose every position is the one card (four
   shards on one card: a check and a measurement of the sharded code, not
   of scaling), each block one CUDA graph replay
   (``parallel/graphs.py``): the main configuration at C=16,384 on a
   (time=2, chan=2) mesh, graph and eager in turns (graph, eager, eager,
   graph), 8 tone-source blocks each, kernel #1 launched 4 times a block,
   the graphs' audio bit-equal to the eager stages' and within 3e-6 of
   the single-card ``ChannelizedPipeline`` (the FM flip rule), tones,
   back-to-back ms/block beside the single card's, a profiled window
   (busy, idle share, launch calls a block: one on graphs; kernel events
   at least the replays' kernel nodes) and the halo recompute's own
   device time; the same at (4, 1) (2,560-row shards off the JAX tile:
   kernel #1 on each, graph and eager bit-equal, within 3e-6 of the single
   card); u8exact on graphs; path (b)'s 9.6 kHz audio on a (1, 2)
   mesh at C=1,024 (kernel #2 twice a block); the direct sharded engine at
   C=16 against ``FrontEndPipeline`` and bit-equal to its eager stages;
   ``run_capture_sharded`` over 8 blocks and a part-block against
   ``run_capture_channelized`` and its eager loop, twice (the second call
   replays the kept front end's graphs: no warm, no capture); and
   ``entry.dryrun_multichip(4)`` on four positions of the card (#1 12
   times, #4 8: its C=4 run's 320-row shards take the per-channel body);
15b. the sharded per-channel body on kernel #4 (slots whose bandwidths
   differ): (2, 2) at C=1,024, #4 once a shard a block, graph and eager
   bit-equal, within 3e-6 of the single card's #4 fallback, tones; (4, 1)
   at C=16,384 with the server's mixed bandwidths: #4 at the shards' shape
   (2,560 rows, a partial last chunk) against its plain version and timed,
   the body on graphs (#4 four times a block) against the single card's
   fallback and the plain stage body (``tail_kernel="xla"``), both
   ms/block; a live uniform -> mixed -> uniform switch on (2, 2) (#1, #4,
   #1 on every shard), the carried history within 1e-6 of a unit peak of
   a single-card pipeline's through the same switches;
16. multihost: ``RadioApp`` in this process with a multihost sharded tone
   tuner at C=2,048 on a (1, 4) virtual mesh (kernel #1 per shard, 4 a
   block) and a ``"distributed"`` process group of one on NCCL, so the
   control broadcast, the sharded step's collectives between its graph
   segments and the gathers run NCCL on the card: ~5 s of serving,
   /status, the waterfall, the FM receiver's 440 Hz, every slot filled in
   one round, a POST past capacity answered 409, a PUT retune heard, 0
   drops, every served block a round of replays of one capture;
17. two processes: two NCCL ranks on the one card (NCCL's refusal
   logged), then two gloo ranks (``--worker`` subprocesses of this script)
   each driving two positions of a global (2, 2) mesh at C=1,024 on graph
   segments (kernel #1 per shard, CUDA halos staged through pinned host
   buffers between replays), each ingesting its half of every block,
   their gathered audio within 3e-6 of the single-card step; then the
   live two-process app for a few seconds (rank 0 hears its FM receiver
   and must drop no block while it listens, rank 1 pumps), both killed at
   the end.

Prints a ``{"kernels": [...]}`` line and, last, a ``{"ok": true, ...}``
line. Exits non-zero, without a result, where torch sees no CUDA device.
"""

from __future__ import annotations

import gc
import hashlib
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
SERVER_SECONDS = 10.0  # real-time serving in the server phase
GROW_FROM = 256  # the server's growing tuner: 256 slots, then 512
MONITOR_CHANNELS = 1_024  # the server's mixed-bandwidth tuner
HEAR_SECONDS = 2.0  # WAV audio read per receiver
TONE_TOLERANCE_HZ = 2.0
# the card's published peaks (NVIDIA H100 SXM data sheet): float32 outside
# the tensor cores, bfloat16 on them (dense), and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# the filterbank tiers (ops/channelizer.py), and the headline topology:
# examples/headline_monitor.json's front end
TIERS = ("highest", "u8exact", "default", "high", "bf16")
HEADLINE_CHANNELS = 69_632
HEADLINE_TIERS = ("u8exact", "highest", "bf16")
HEADLINE_BLOCKS = 16
# the tier rule (PERF.md section 2): a lossy kernel's audio SNR against the
# exactly made product within this of its plain version's
SNR_SLACK_DB = 0.5
# kernel against plain version, the CPU tests' bounds (tests/test_torch_*)
BOUNDS = {"audio48": 1e-5, "hist_i": 1e-6, "hist_q": 1e-6,
          "demod_prev": 1e-6, "audio_hist": 1e-5}
POWER_RTOL = 1e-5
# fused_pfb_tail_audio_tm makes the 320-term filterbank product itself, one
# FMA chain per output, where the plain version's matmul may sum in another
# order: the products then differ by float32 rounding of a 320-term sum at
# unit level, so the mixed carries and the FM lag get 2e-6
PFB_BOUNDS = dict(BOUNDS, hist_i=2e-6, hist_q=2e-6, demod_prev=2e-6)
# kernel #3 at a lossy tier makes the tier's law on the tensor cores, the
# plain version the same law with cuBLAS's sums: for "high" three products,
# each summed in its own order, so the carries get twice PFB_BOUNDS' 2e-6
TIER_PFB_BOUNDS = dict(BOUNDS, hist_i=4e-6, hist_q=4e-6, demod_prev=4e-6)
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
    """Mean device ms of ``fn()`` over ``reps`` launches (CUDA events). The
    launches queue up behind a few large matmuls, so what is timed is the
    device working through them back to back, not the host enqueueing them:
    a wrapper's host time per call (~0.12-0.25 ms) is no less than the
    faster kernels' device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    busy = torch.ones(4096, 4096, device="cuda")
    for _ in range(1 + reps // 8):  # ~3 ms each, ~0.35 ms per launch to come
        busy @ busy
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(step, n: int, cpu: bool = True, mark=None) -> dict:
    """Run ``step(i)`` for ``i < n`` back to back under ``torch.profiler``
    and read the device's own timeline: only kernel, memcpy and memset
    events (host-side ``aten::`` rows are not device time). Returns
    ``busy`` / ``window`` ms per block (the window runs from the first
    device event's start to the last one's end), ``idle`` share, ``top``
    kernels, the ``kernels`` and ``copies`` events it holds, and what the
    profiler's ``start``, ``stop`` and trace ``parse`` took
    (``timings_ms``); busy, window and idle are None where the profiler
    saw no device event. ``cpu=False`` records the device alone (lighter
    on the host, for a window of serving); with ``cpu`` the host's CUDA
    API calls a block are counted by name (``api_per_block``), and
    ``launch_calls_per_block`` sums the kernel and graph launches among
    them. ``mark()``, where given, is read just after the start and just
    before the closing synchronize (``marks``): what the window launched
    lies between the two."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    prof = profile(activities=acts)
    timings = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        timings[name] = 1e3 * (time.perf_counter() - t0)
        return out

    from webradio_tpu_torch.pipeline.graph import LAUNCH_LOCK

    with LAUNCH_LOCK:  # no graph launch of a pump meanwhile
        timed("start", prof.start)
    marks = [mark() if mark else None]
    for i in range(n):
        step(i)
    marks.append(mark() if mark else None)
    torch.cuda.synchronize()
    with LAUNCH_LOCK:
        timed("stop", prof.stop)
    events = timed("parse", prof.events)
    spans = []
    per_name: dict[str, float] = {}
    api: dict[str, int] = {}
    kernels = copies = 0
    for e in events:
        if e.device_type != DeviceType.CUDA:
            if e.name.startswith(("cuda", "cu")) and not e.name.startswith(
                    "cuda::"):
                api[e.name] = api.get(e.name, 0) + 1
            continue
        if "annotation" in str(getattr(e, "activity_type", "")).lower():
            continue  # user ranges drawn on the device row, not device work
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        per_name[e.name] = per_name.get(e.name, 0.0) + (t1 - t0)
    out = {"busy": None, "window": None, "idle": None, "top": [],
           "kernels": kernels, "copies": copies, "timings_ms": timings,
           "marks": marks,
           "api_per_block": {k: v / n for k, v in sorted(api.items())},
           "launch_calls_per_block": sum(
               v for k, v in api.items() if k in LAUNCH_CALLS) / n}
    if not spans:
        return out
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
    out.update(busy=busy / 1e3 / n, window=window / 1e3 / n,
               idle=1.0 - busy / window,
               top=[(name[:60], us / 1e3 / n) for name, us in top])
    return out


#: the host's CUDA API calls that launch device work a block
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def graph_kernels(fes):
    """Each pipeline's (or front end's) replayed kernel nodes so far."""
    return {fe: fe.graph_stats()["kernels"] for fe in fes}


def expect_kernel_events(tag, prof, launched, expected=0):
    """Fail where a profiler window saw work launched (blocks served, or a
    wrapper's count rising) but its trace holds no kernel event, or fewer
    than ``expected``: the kernel nodes of the graph replays launched in
    the window (``web.handlers.expected_kernel_events`` of its marks). A
    profiler fault, never a reading."""
    log(f"  {tag}: profiler start {prof['timings_ms']['start']:.1f} ms, "
        f"stop {prof['timings_ms']['stop']:.1f} ms, parse "
        f"{prof['timings_ms']['parse']:.1f} ms; {prof['kernels']} kernel and "
        f"{prof['copies']} copy events for {launched} launched, "
        f"{expected} kernel events expected of the graph replays")
    if launched and not prof["kernels"]:
        raise AssertionError(f"{tag}: the profiler saw {launched} launched "
                             f"but recorded no kernel event")
    if prof["kernels"] < expected:
        raise AssertionError(f"{tag}: the profiler recorded "
                             f"{prof['kernels']} kernel events of the "
                             f"{expected} the graph replays launched")
    return {"kernels": prof["kernels"], "expected": expected}


def window_expected(prof):
    """The kernel events a window whose ``mark`` was :func:`graph_kernels`
    must hold (one block's less per pipeline: a replay under way at the
    start may fall before it)."""
    from webradio_tpu_torch.web.handlers import expected_kernel_events

    return expected_kernel_events(*prof["marks"])


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


def mixed_controls(c: int):
    """Mixed bandwidths, the server's shape of them: slot 0 AM at IF 0 with
    a 12.5 kHz channel filter, slot 1 FM at +100 kHz, the rest at the
    server's defaults for an empty slot (IF 0, 80 / 8 kHz, the first
    slot's law): ``(ifs, modes, if bandwidths)``."""
    ifs = [0, 100_000] + [0] * (c - 2)
    modes = ["AM", "FM"] + ["AM"] * (c - 2)
    return ifs, modes, [12_500] + [80_000] * (c - 1)


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
    from webradio_tpu_torch.ops import tail_tm

    for fn in tail_wrappers().values():
        fn.launches = 0
    tail_tm.fused_tail_audio_tm.wgmma_launches = 0


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


def roofline(flops: float, nbytes: int, bf16_flops: float = 0.0):
    """``(bound ms, what binds)``: the larger of the operations (float32 at
    the card's peak outside the tensor cores, plus ``bf16_flops`` at its
    dense bfloat16 tensor-core peak) and the bytes at its memory rate."""
    t_ops = 1e3 * (flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS)
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

    def record(self, ms, plain_ms, flops, nbytes, bf16_flops=0.0):
        bound_ms, bound_by = roofline(flops, nbytes, bf16_flops)
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
    rows = tail_tm.tile_rows_for(nd, c)
    # both bodies of #1: the warp body (the shape rule's at this width) and
    # the wgmma body
    for body in (tail_tm.BODY_WARP, tail_tm.BODY_WG):
        for fast in (True, False):
            phase = torch.from_numpy(rng.integers(0, 2**31, c)).to(dev)
            carry = ref_carry = (u(k - 1, c), u(k - 1, c), u(2, c),
                                 u(k - 1, c))
            for blk in range(2):
                prod = u(nd, 2 * c)
                common = (phase, step, w, wa, d, mode)
                got = tail_tm._launch(prod, prod, *common, *carry, True, fast,
                                      rows, body)
                torch.cuda.synchronize()
                ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common,
                                                      *ref_carry, packed=True,
                                                      fast=fast)
                worst.add(compare(f"body {body} fast={fast} block {blk}",
                                  AUDIO_NAMES, BOUNDS, got, ref, fm,
                                  flip_step, raw=("audio_hist",),
                                  filtered=("audio48",)))
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
    # #1 at the main path's widths on the body its shape rule picks and on
    # the other, in turns (the wrapper's, then the other, twice)
    for cw in (c, WIDE_CHANNELS, HEADLINE_CHANNELS):
        prod = torch.empty(nd, 2 * cw, device=dev).uniform_(-0.5, 0.5)
        z = lambda *s: torch.zeros(s, device=dev)
        wide = (prod, prod, torch.zeros(cw, dtype=torch.int64, device=dev),
                step.repeat(cw // c), w, wa, d, mode.repeat(cw // c),
                z(k - 1, cw), z(k - 1, cw), z(2, cw), z(k - 1, cw))
        rows = tail_tm.tile_rows_for(nd, cw)
        body = tail_tm.tail_body(nd, cw, rows,
                                 tail_tm.sm_count(dev.index))
        other = (tail_tm.BODY_WARP if body == tail_tm.BODY_WG
                 else tail_tm.BODY_WG)
        reps = 50 if cw == c else 10
        times = {body: [], other: []}
        for _ in range(2):
            for b in (body, other):
                times[b].append(cuda_ms(lambda: tail_tm._launch(
                    *wide, True, True, rows, b), reps))
        out = tail_tm.fused_tail_audio_tm(*wide, packed=True, fast=True)
        bound, by = roofline(tail_flops(nd, cw, k, d), io_bytes(wide, out))
        ms, ms_other = min(times[body]), min(times[other])
        name = {tail_tm.BODY_WG: "wgmma", tail_tm.BODY_WARP: "mma.sync"}
        log(f"  tail kernel at C={cw}: {ms:.4f} ms on the {name[body]} body"
            f" (the {name[other]} body {ms_other:.4f} ms; bound "
            f"{bound:.4f} ms, {by}; {100 * bound / ms:.1f}% of it)")
        if cw != c:
            results[f"tail_kernel_ms_c{cw}"] = ms
            results[f"tail_bound_ms_c{cw}"] = bound
        results[f"tail_body_c{cw}"] = name[body]
        results[f"tail_other_body_ms_c{cw}"] = ms_other
        del prod, wide, out


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
    digest = hashlib.sha256()
    for blk in range(2):
        chan_in = u(2, c, nd)
        common = (chan_in, phase, step, coeff, mode)
        got = tail.fused_receiver_tail(*common, *carry)
        torch.cuda.synchronize()
        digest.update(got[0].cpu().numpy().tobytes())
        ref = tail.fused_receiver_tail_ref(*common, *ref_carry)
        # audio is [C, nd]: time first for the comparison
        worst.add(compare(f"block {blk}", names, bounds,
                          (got[0].T, *got[1:]), (ref[0].T, *ref[1:]), fm,
                          RAW_FM_STEP, raw=("audio",)))
        carry, ref_carry = got[1:3], ref[1:3]
        phase = (phase + nd * step) & 0x7FFFFFFF
    # every output of this kernel is one FMA chain in tap order whatever
    # its thread layout, so two builds of it on the same inputs (made from
    # the seed above) agree bit for bit: the digest says whether they do
    results["legacy_audio_sha256"] = digest.hexdigest()
    log(f"  fused_receiver_tail audio of both blocks, sha256 "
        f"{digest.hexdigest()}")
    args = (chan_in, phase, step, coeff, mode, *carry)
    ms = cuda_ms(lambda: tail.fused_receiver_tail(*args), 30)
    plain_ms = cuda_ms(lambda: tail.fused_receiver_tail_ref(*args), 3)
    ms2 = cuda_ms(lambda: tail.fused_receiver_tail(*args), 30)
    log(f"  fused_receiver_tail at nd={nd}, C={c}: kernel {ms:.4f} / "
        f"{ms2:.4f} ms, plain torch {plain_ms:.4f} ms")
    kernels["fused_receiver_tail"] = worst.record(
        min(ms, ms2), plain_ms, tail_flops(nd, c, k), io_bytes(args, got))


def keep(out):
    """A copy of what ``process_host`` handed back (None stays None)."""
    return None if out is None else tuple(t.clone() for t in out)


def run_pipeline(cfg, params, blocks):
    """``blocks`` through ``ChannelizedPipeline.process_host``; returns the
    audio ``[t, C]`` on the host, the last spectrum row and the pipeline's
    graph counts (the pipeline itself goes, and with it its graphs'
    memory)."""
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch

    pipe = ch.ChannelizedPipeline(cfg, params)
    # a graph replay rewrites its outputs two blocks on: keep copies
    outs = [keep(pipe.process_host(b)) for b in blocks]
    outs = outs[1:] + [keep(pipe.flush())]
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
    return audio, db, pipe.graph_stats()


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


def against(tag, audio, ref_audio, params, results, key,
            bound=STEP_AUDIO_BOUND):
    """Hold a path's audio to a reference run's (see audio_mismatch)."""
    fm = params.mode.cpu() == 1
    flip_step = float(params.audio_coeff.abs().max())
    err, flips, fm_max = audio_mismatch(audio, ref_audio, fm, flip_step,
                                        bound)
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
    ifs, modes, ifbw = mixed_controls(c)
    cfg_k = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                                 use_pallas_tail=True)
    cfg_p = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    cfg_x = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                                 tail_kernel="xla")
    params = ch.make_channelized_params(cfg_k, ifs, ifbw, 8_000, modes,
                                        device=dev)
    if params.chan_toep is not None:
        raise AssertionError("(a): the slots still share one shaping FIR")
    blocks = tone_blocks(PATH_BLOCKS, seed=3)
    reset_counts()
    audio_k, _, _ = run_pipeline(cfg_k, params, blocks)
    expect_counts("(a) use_pallas_tail=True",
                  fused_receiver_tail=len(blocks))
    hear_tones("a_kernel_", cfg_k, audio_k, modes, results)
    # the server's configuration: on the card the fallback takes kernel #4
    # whatever use_pallas_tail says
    reset_counts()
    audio_p, _, _ = run_pipeline(cfg_p, params, blocks)
    expect_counts("(a) use_pallas_tail=False",
                  fused_receiver_tail=len(blocks))
    kernels["fused_receiver_tail"]["launches"] = len(blocks)
    hear_tones("a_card_", cfg_p, audio_p, modes, results)
    if not torch.equal(audio_p, audio_k):
        raise AssertionError("(a): the fallback's kernel differs with "
                             "use_pallas_tail")
    with plain_tails():
        ref, _, _ = run_pipeline(cfg_p, params, blocks)
    against("(a) kernel step vs plain-tail step", audio_p, ref, params,
            results, "a_step_vs_plain")
    # the plain fallback, asked for by tail_kernel="xla"
    reset_counts()
    audio_x, _, _ = run_pipeline(cfg_x, params, blocks)
    expect_counts("(a) tail_kernel='xla'")
    hear_tones("a_plain_", cfg_x, audio_x, modes, results)
    against("(a) kernel step vs plain fallback step", audio_p, audio_x,
            params, results, "a_kernel_vs_fallback")
    paths = {"a_kernel": (cfg_p, params, blocks),
             "a_plain": (cfg_x, params, blocks)}

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
    outs = ([keep(one.process_host(b)) for b in main_blocks[:k]][1:]
            + [keep(one.flush())])
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
        launches = tail_wrappers()["fused_tail_audio_tm"].launches
        prof = device_profile(
            lambda i: pipe.process_host(blocks[i % len(blocks)]), prof_blocks,
            mark=lambda: graph_kernels([pipe]))
        expect_kernel_events(
            f"C={c} profile", prof,
            tail_wrappers()["fused_tail_audio_tm"].launches - launches,
            window_expected(prof))
        busy, window, idle, top = (prof[k] for k in ("busy", "window",
                                                     "idle", "top"))
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


GRAPH_BLOCKS = 8  # carried blocks through each branch, graph and eager
GRAPH_TIMED_BLOCKS = 24
GRAPH_CATCHUP_BLOCKS = 4
#: what a dropped pipeline may leave reserved on the card (GB): the
#: cuBLAS workspace of its capture stream
DROP_SLACK_GB = 0.25


def graph_branches(dev):
    """Each single-card branch as ``name -> (make(graph) -> pipeline,
    blocks, params, channel-major audio)``: the main path at C=1,024 and
    16,384 at "highest", bf16 and u8exact at 16,384, 9.6 kHz audio (kernel
    #2), the fused filterbank (kernel #3), the per-channel fallback plain
    and through kernel #4, and the direct engine at C=4 and 16."""
    from webradio_tpu_torch.pipeline import channelized as ch
    from webradio_tpu_torch.pipeline import frontend as tfe
    from webradio_tpu_torch.pipeline import state as tstate

    def channelized(c, bw=80_000, blocks=None, **kw):
        cfg = ch.ChannelizedConfig(num_channels=c, **{
            "block_frames": BLOCK_FRAMES, **kw})
        ifs, modes = slot_controls(c)
        if bw != 80_000:  # mixed bandwidths: slot 0 at bw
            ifs = [0, 100_000] + [0] * (c - 2)
            modes = ["AM", "FM"] + ["AM"] * (c - 2)
            bw = [bw] + [80_000] * (c - 1)
        params = ch.make_channelized_params(cfg, ifs, bw, 8_000, modes,
                                            device=dev)
        return (lambda graph: ch.ChannelizedPipeline(cfg, params, graph),
                blocks or tone_blocks(GRAPH_BLOCKS, seed=21,
                                      block_frames=cfg.block_frames),
                params, False)

    def direct(c):
        cfg = tstate.ChainConfig(num_channels=c, block_frames=BLOCK_FRAMES)
        ifs = [0, 100_000] + [(i - 8) * 100_000 for i in range(2, c)]
        modes = (["AM", "FM"] + ["USB", "LSB", "AM", "FM"] * 4)[:c]
        params = tstate.make_receiver_params(cfg, ifs, 80_000, 8_000, modes,
                                             device=dev)
        return (lambda graph: tfe.FrontEndPipeline(cfg, params, graph),
                tone_blocks(GRAPH_BLOCKS, seed=22), params.rx, True)

    u8 = u8_blocks(GRAPH_BLOCKS, seed=23)
    return {
        "main_c1024": lambda: channelized(MAIN_CHANNELS),
        "main_c16384": lambda: channelized(WIDE_CHANNELS),
        "bf16_c16384": lambda: channelized(WIDE_CHANNELS, blocks=u8,
                                           pfb_precision="bf16"),
        "u8exact_c16384": lambda: channelized(WIDE_CHANNELS, blocks=u8,
                                              pfb_precision="u8exact"),
        "b_9600_c1024": lambda: channelized(MAIN_CHANNELS, audio_rate=9_600,
                                            block_frames=256_000),
        "c_pallas_pfb_c1024": lambda: channelized(MAIN_CHANNELS,
                                                  tail_kernel="pallas_pfb"),
        "a_plain_c1024": lambda: channelized(MAIN_CHANNELS, bw=12_500,
                                             tail_kernel="xla"),
        "a_kernel_c1024": lambda: channelized(MAIN_CHANNELS, bw=12_500),
        "direct_c4": lambda: direct(4),
        "direct_c16": lambda: direct(16),
    }


def graph_against_eager(name, make, blocks, params, channel_major):
    """``blocks`` through a graphed and an eager pipeline, carried, each
    block's outputs read after the next block was dispatched: the audio of
    every block and the final state, bit for bit, or else within
    PERF.md section 2's bounds (audio 1e-5 with the FM flip rule, carries
    1e-6 with whole turns of raw FM rows removed); the graph's counts; the
    wrappers' launches alike in both."""
    import torch
    from webradio_tpu_torch.pipeline.graph import fields

    runs = {}
    for graph in (True, False):
        pipe = make(graph)
        reset_counts()
        # as the pump reads them: each block's outputs after the next
        # block's replay (the other slot's graph) was enqueued
        outs = [keep(pipe.process_host(b)) for b in blocks][1:]
        outs.append(keep(pipe.flush()))
        audio = [a if channel_major else a.T for a, _ in outs]
        torch.cuda.synchronize()
        runs[graph] = (torch.stack(audio).cpu(),
                       [t.cpu() for t in fields(pipe.state)],
                       {n: f.launches for n, f in tail_wrappers().items()},
                       pipe.graph_stats())
        del pipe
    (ga, gs, gl, stats), (ea, es, el, estats) = runs[True], runs[False]
    n = len(blocks)
    bit = torch.equal(ga, ea) and all(torch.equal(x, y)
                                      for x, y in zip(gs, es))
    audio_diff = float((ga - ea).abs().max())
    state_diff = max(float((x.double() - y.double()).abs().max())
                     for x, y in zip(gs, es))
    log(f"  {name}: graph against eager over {n} carried blocks: "
        f"{'bit-equal' if bit else 'NOT bit-equal'} (audio {audio_diff:.3e}"
        f", state {state_diff:.3e}); graph {stats}; launches {gl}")
    if not bit:
        # a cuBLAS algorithm picked under capture may sum in another order
        fm = params.mode.cpu() == 1
        flip = float(params.audio_coeff.abs().max())
        for i in range(n):
            audio_mismatch(ga[i].T, ea[i].T, fm, flip, STEP_AUDIO_BOUND)
        for x, y in zip(gs, es):
            if x.dtype == torch.int64:
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: NCO phases differ")
                continue
            err = x.double() - y.double()
            if err.ndim >= 2 and err.shape[-2] == fm.numel():
                err[..., fm, :] -= torch.round(err[..., fm, :])
            if not float(err.abs().max()) <= 1e-6:
                raise AssertionError(f"{name}: carries differ by "
                                     f"{float(err.abs().max()):.3e}")
    want = {"captures": 1, "replays": n - 1, "warms": 1}
    if {k: stats[k] for k in want} != want or any(estats.values()):
        raise AssertionError(f"{name}: graph counts {stats}, eager {estats}")
    if gl != el or sum(gl.values()) not in (0, n):
        raise AssertionError(f"{name}: launches graph {gl}, eager {el}")
    return {"bit_equal": bit, "audio_diff": audio_diff,
            "state_diff": state_diff, "graph": stats, "launches": gl}


def graph_mode_times(cfg, params, blocks, graph: bool) -> dict:
    """One pipeline, graphed or eager: ms/block one at a time (CUDA events,
    median) and back to back (host clock), a profiled window (idle share,
    the host's API calls a block, kernel events against the replays'),
    and a catch-up of GRAPH_CATCHUP_BLOCKS blocks (``process_host_many``,
    host clock to its end, after one to warm)."""
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch

    pipe = ch.ChannelizedPipeline(cfg, params, graph)
    nb = len(blocks)
    for b in blocks[:4]:
        pipe.process_host(b)
    torch.cuda.synchronize()
    one = []
    for i in range(GRAPH_TIMED_BLOCKS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.process_host(blocks[i % nb])
        end.record()
        end.synchronize()
        one.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    for i in range(GRAPH_TIMED_BLOCKS):
        pipe.process_host(blocks[i % nb])
    torch.cuda.synchronize()
    stream = 1e3 * (time.perf_counter() - t0) / GRAPH_TIMED_BLOCKS
    prof = device_profile(lambda i: pipe.process_host(blocks[i % nb]), 8,
                          mark=lambda: graph_kernels([pipe]))
    seen = expect_kernel_events(
        f"C={cfg.num_channels} {'graph' if graph else 'eager'} window", prof,
        8, window_expected(prof) if graph else 0)
    k = GRAPH_CATCHUP_BLOCKS
    backlog = np.stack([blocks[i % nb] for i in range(k)])
    pipe.process_host_many(backlog)
    torch.cuda.synchronize()
    catch = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.process_host_many(backlog)
        torch.cuda.synchronize()
        catch.append(1e3 * (time.perf_counter() - t0))
    pipe.flush()
    return {"one_at_a_time_ms": statistics.median(one),
            "back_to_back_ms": stream, "idle_share": prof["idle"],
            "busy_ms_per_block": prof["busy"],
            "launch_calls_per_block": prof["launch_calls_per_block"],
            "api_per_block": prof["api_per_block"],
            "window_kernels": seen,
            "catchup_ms": statistics.median(catch),
            "graph": pipe.graph_stats()}


def phase_graph(dev, results):
    """Each block as one CUDA graph replay, against the eager step: every
    single-card branch bit for bit over GRAPH_BLOCKS carried blocks; then
    graph and eager side by side in turns (graph, eager, eager, graph) at
    C=1,024 and 16,384: ms/block one at a time and back to back, idle
    share, the host's API calls a block, a 4-block catch-up; the offline
    runner at C=16,384; peak device memory at the headline C=69,632 at
    u8exact."""
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch
    from webradio_tpu_torch.pipeline import stream

    out = {"branches": {}}
    for name, build in graph_branches(dev).items():
        out["branches"][name] = graph_against_eager(name, *build())
        release()
    blocks = tone_blocks(8, seed=24)
    for c in (MAIN_CHANNELS, WIDE_CHANNELS):
        cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
        ifs, modes = slot_controls(c)
        params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                            device=dev)
        turns = []
        for g in (True, False, False, True):
            turns.append((g, graph_mode_times(cfg, params, blocks, g)))
            release()
        rec = {mode: [t for g, t in turns if g == (mode == "graph")]
               for mode in ("graph", "eager")}
        for g, t in turns:
            log(f"  C={c} {'graph' if g else 'eager'}: one at a time "
                f"{t['one_at_a_time_ms']:.3f} ms/block, back to back "
                f"{t['back_to_back_ms']:.3f}, idle share "
                f"{t['idle_share']:.3f} (busy {t['busy_ms_per_block']:.3f} "
                f"ms/block), launch calls {t['launch_calls_per_block']:.1f} "
                f"a block, {GRAPH_CATCHUP_BLOCKS}-block catch-up "
                f"{t['catchup_ms']:.3f} ms; API calls a block "
                f"{t['api_per_block']}")
        out[f"c{c}"] = rec
        del params
        torch.cuda.empty_cache()
    # the offline runner at C=16,384, in turns
    c = WIDE_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=dev)
    iq = torch.from_numpy(np.concatenate(
        tone_blocks(OFFLINE_BLOCKS, seed=25), axis=1)).to(dev)
    runner = {"graph": [], "eager": []}
    for g in (True, False, False, True):
        stream.run_capture_channelized(cfg, params, iq, graph=g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream.run_capture_channelized(cfg, params, iq, graph=g)
        torch.cuda.synchronize()
        runner["graph" if g else "eager"].append(
            1e3 * (time.perf_counter() - t0) / OFFLINE_BLOCKS)
    log(f"  offline runner C={c}, ms/block in turns (each a second call: "
        f"the kept pipeline): graph {runner['graph']}, eager "
        f"{runner['eager']}")
    out["offline_runner_ms_per_block"] = runner
    stream.KEPT.clear()
    del iq, params
    torch.cuda.empty_cache()
    # peak device memory at the headline width, u8exact
    c = HEADLINE_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                               pfb_precision="u8exact")
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=dev)
    u8 = u8_blocks(4, seed=26)
    mem = {}
    # no garbage collection here: a dropped pipeline must hand back its
    # buffers and its graphs' pool as its last reference goes
    gc.disable()
    try:
        for g in (True, False):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_reserved(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            pipe = ch.ChannelizedPipeline(cfg, params, g)
            for b in u8:
                pipe.process_host(b)
            pipe.flush()
            torch.cuda.synchronize()
            rec = mem["graph" if g else "eager"] = {
                "peak_allocated_gb": torch.cuda.max_memory_allocated(dev)
                / 1e9,
                "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9}
            del pipe
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            rec["kept_after_drop_gb"] = (torch.cuda.memory_reserved(dev)
                                         - base) / 1e9
    finally:
        gc.enable()
    log(f"  peak device memory at C={c}, u8exact, 4 blocks: {mem}")
    # a cuBLAS workspace per new stream may stay (tens of MB)
    kept = {m: r["kept_after_drop_gb"] for m, r in mem.items()}
    if max(kept.values()) > DROP_SLACK_GB:
        raise AssertionError(f"a dropped pipeline kept {kept} GB reserved "
                             f"without a garbage collection")
    out["headline_memory"] = mem
    del params
    torch.cuda.empty_cache()
    results["graph"] = out


def stream_ms(cfg, params, blocks, n: int, pipe=None) -> float:
    """Back-to-back ms/block of ``process_host`` (host clock, one
    synchronize at the end), after two warm blocks; of a new
    ``ChannelizedPipeline`` unless ``pipe`` is given."""
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch

    pipe = pipe or ch.ChannelizedPipeline(cfg, params)
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
    turns = []
    for n, cfg in (("packed", packed), ("fused", fused), ("fused", fused),
                   ("packed", packed)):
        turns.append((n, stream_ms(cfg, params, blocks, PATH_TIMED_BLOCKS)))
        release()
    log(f"  C={cw}, back to back ms/block in turns: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in turns))
    results[f"c{cw}_packed_stream_ms"] = [ms for n, ms in turns
                                          if n == "packed"]
    results[f"c{cw}_fused_pfb_stream_ms"] = [ms for n, ms in turns
                                             if n == "fused"]


#: server widths below the JAX package's 512-channel threshold and off its
#: 128-channel tile: on the card kernel #1 serves each of them
WIDTHS = (16, 32, 64, 100, 256, 511)
WIDTH_BLOCKS = 4
WIDTH_TIMED_BLOCKS = 16
CHANRATE_WIDTH = 100  # kernel #2 on the 9.6 kHz path at a small width
SWITCH_BLOCKS = 2  # blocks on each side of a live bandwidth switch


def phase_widths(dev, results):
    """Stock rates at every width of WIDTHS: kernel #1 once a block through
    ``process_host`` (graphs), the audio within section 2's bounds of the
    same blocks through ``tail_kernel="xla"`` (the plain tail), the tones
    heard, both back-to-back ms/block; then kernel #2 at CHANRATE_WIDTH on
    the 9.6 kHz path the same way."""
    import dataclasses

    from webradio_tpu_torch.pipeline import channelized as ch

    smi = nvidia_smi("name,power.limit")
    out = {}
    blocks = tone_blocks(WIDTH_BLOCKS, seed=31)

    def width(c, kernel, cfg, blocks):
        ifs, modes = slot_controls(c)
        params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                            device=dev)
        plain = dataclasses.replace(cfg, tail_kernel="xla")
        reset_counts()
        audio, _, _ = run_pipeline(cfg, params, blocks)
        expect_counts(f"C={c}", **{kernel: len(blocks)})
        reset_counts()
        ref, _, _ = run_pipeline(plain, params, blocks)
        expect_counts(f"C={c}, tail_kernel='xla'")
        tag = f"w{c}_{'chanrate_' if kernel == 'fused_tail_tm' else ''}"
        hear_tones(tag, cfg, audio, modes, results)
        against(f"C={c} {kernel} step vs plain tail", audio, ref, params,
                results, tag + "vs_plain")
        ms = stream_ms(cfg, params, blocks, WIDTH_TIMED_BLOCKS)
        plain_ms = stream_ms(plain, params, blocks, WIDTH_TIMED_BLOCKS)
        log(f"  C={c}: back to back {ms:.3f} ms/block with {kernel}, "
            f"{plain_ms:.3f} plain ({smi})")
        return {"kernel": kernel, "launches_per_block": 1,
                "ms_per_block": ms, "plain_ms_per_block": plain_ms,
                "max_audio_err": results[tag + "vs_plain_max_audio_err"],
                "card": smi}

    for c in WIDTHS:
        cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
        out[c] = width(c, "fused_tail_audio_tm", cfg, blocks)
        release()
    cfg_b = ch.ChannelizedConfig(num_channels=CHANRATE_WIDTH,
                                 audio_rate=9_600, block_frames=256_000)
    out[f"{CHANRATE_WIDTH}_9600"] = width(
        CHANRATE_WIDTH, "fused_tail_tm", cfg_b,
        tone_blocks(3, seed=32, block_frames=cfg_b.block_frames))
    results["widths"] = out


def phase_switch(dev, results):
    """One live ``ChannelizedPipeline`` on graphs goes uniform (kernel #1)
    -> mixed bandwidths (kernel #4) -> uniform, SWITCH_BLOCKS blocks each,
    its carried history converted at each switch; the same blocks through
    a ``tail_kernel="xla"`` pipeline (the plain time-major tail, then the
    plain fallback) across the same switches. The audio within section 2's
    bounds, and after every block the carried history (in the mixed
    domain) within 1e-6 of the plain pipeline's: no step at a switch."""
    import dataclasses

    import torch
    from webradio_tpu_torch.pipeline import channelized as ch

    c = MAIN_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    plain = dataclasses.replace(cfg, tail_kernel="xla")
    ifs, modes, ifbw = mixed_controls(c)
    uniform = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                         device=dev)
    mixed = ch.make_channelized_params(cfg, ifs, ifbw, 8_000, modes,
                                       device=dev)
    blocks = tone_blocks(3 * SWITCH_BLOCKS, seed=33)
    runs = {}
    for name, conf in (("kernel", cfg), ("plain", plain)):
        pipe = ch.ChannelizedPipeline(conf, uniform)
        reset_counts()
        outs, hist, raw = [], [], []
        for k, b in enumerate(blocks):
            if k and k % SWITCH_BLOCKS == 0:
                pipe.update_params(mixed if k == SWITCH_BLOCKS else uniform)
            outs.append(keep(pipe.process_host(b)))
            h = pipe.state.chan_hist
            if pipe.carries_raw():
                h = ch.switch_hist_domain(h, pipe.state.nco_phase,
                                          pipe.params.residual_step, False)
            hist.append(h.clone().cpu())  # the buffer is rewritten in place
            raw.append(pipe.carries_raw())
        outs = outs[1:] + [keep(pipe.flush())]
        torch.cuda.synchronize()
        launches = {n: f.launches for n, f in tail_wrappers().items() if
                    f.launches}
        runs[name] = (torch.cat([a for a, _ in outs]).cpu(), hist, raw,
                      launches, pipe.graph_stats())
        log(f"  {name}: history raw after each block {raw}, launches "
            f"{launches}, graph {pipe.graph_stats()}")
        del pipe
    (audio, hist, raw, launches, graph), (ref, ref_hist, ref_raw, ref_l, _) = (
        runs["kernel"], runs["plain"])
    n = SWITCH_BLOCKS
    if (raw != [False] * n + [True] * n + [False] * n or any(ref_raw)
            or launches != {"fused_tail_audio_tm": 2 * n,
                            "fused_receiver_tail": n} or ref_l
            or graph["captures"] != 3):
        raise AssertionError(f"switch: raw {raw}, launches {launches}, "
                             f"plain {ref_l}, graph {graph}")
    against("uniform -> mixed -> uniform, kernels vs the plain tails",
            audio, ref, uniform, results, "switch_vs_plain")
    step = [float((h - r).abs().max()) for h, r in zip(hist, ref_hist)]
    # section 2's carries bound at unit signal level
    scale = max(1.0, max(float(r.abs().max()) for r in ref_hist))
    log(f"  carried history against the plain pipeline's after each block "
        f"(peak {scale:.3f}): " + ", ".join(f"{e:.2e}" for e in step))
    if not max(step) <= 1e-6 * scale:
        raise AssertionError(f"switch: the carried history steps by "
                             f"{max(step):.3e}")
    results["switch"] = {"hist_err_per_block": step, "launches": launches,
                         "graph": graph}


def u8_blocks(n: int, seed: int = 0, block_frames: int = BLOCK_FRAMES):
    """Tone-source blocks as an 8-bit dongle delivers them: each sample
    quantized to ``(u8 - 128) / 128`` (``io/tuner.py``), every value a
    bfloat16, so the u8exact law is float32-accurate on them."""
    out = []
    for x in tone_blocks(n, seed=seed, block_frames=block_frames):
        u8 = np.clip(np.round(x * 40.0) + 128.0, 0.0, 255.0)
        out.append(((u8 - 128.0) / 128.0).astype(np.float32))
    return out


def snr_db(ref, got) -> float:
    """SNR of ``got`` against ``ref`` in dB, in float64."""
    ref, err = ref.double(), got.double() - ref.double()
    return float(10.0 * np.log10(float((ref * ref).sum())
                                 / max(float((err * err).sum()), 1e-300)))


def tier_params(cfg, params, tier):
    """The configuration and parameters of ``tier`` from a u8exact pair
    (every lossy tier reads the same split; "highest" none)."""
    import dataclasses

    return (dataclasses.replace(cfg, pfb_precision=tier),
            params._replace(pfb_weights_split=None) if tier == "highest"
            else params)


def phase_tiers(dev, results, kernels):
    """The filterbank tiers on the main configuration at C=1,024 and
    C=16,384, fed 8-bit-grid blocks: per tier the product's SNR against a
    float64 product and its CUDA-event ms, the step's back-to-back ms/block
    with kernel #1 once a block, and the audio against the "highest"
    tier's; then each kernel variant the tiers add, against its plain
    version: #1 on the "bf16" tier's bfloat16 product (both widths, and on
    the step), #2 on it (the 9.6 kHz path, C=1,024) and #3 at "default"
    and "high" (C=1,024)."""
    import torch
    from webradio_tpu_torch.ops import tail_tm
    from webradio_tpu_torch.ops.channelizer import pfb_frames_tm, pfb_product
    from webradio_tpu_torch.pipeline import channelized as ch

    k, out = 64, {}
    blocks = u8_blocks(8, seed=11)
    for c in (MAIN_CHANNELS, WIDE_CHANNELS):
        ifs, modes = slot_controls(c)
        base = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                                    pfb_precision="u8exact")
        p8 = ch.make_channelized_params(base, ifs, 80_000, 8_000, modes,
                                        device=dev)
        kp, nd, d = base.proto_taps, base.chan_frames, base.audio_decim
        cols = p8.mode.cpu() != 1  # AM/USB/LSB: SNR without FM's flips
        frames, _ = pfb_frames_tm(torch.from_numpy(blocks[0]).to(dev), kp,
                                  base.num_bins,
                                  torch.zeros(2, kp - 1, device=dev))
        w = p8.pfb_weights
        exact = frames.double() @ w.double().reshape(2 * kp, 2 * c)
        n_audio = len(blocks) if c == MAIN_CHANNELS else 4
        highest_audio = None
        for tier in TIERS:
            cfg, params = tier_params(base, p8, tier)
            split = params.pfb_weights_split
            y = pfb_product(frames, w, split, tier)
            rec = {"product_snr_db": snr_db(exact, y),
                   "product_ms": cuda_ms(
                       lambda: pfb_product(frames, w, split, tier), 10)}
            del y
            reset_counts()
            audio, _, _ = run_pipeline(cfg, params, blocks[:n_audio])
            expect_counts(f"tier {tier} at C={c}",
                          fused_tail_audio_tm=n_audio)
            hear_tones(f"tier_{tier}_c{c}_", cfg, audio, modes, results)
            rec["stream_ms_per_block"] = stream_ms(cfg, params, blocks,
                                                   PATH_TIMED_BLOCKS)
            rec["realtime_factor"] = BLOCK_MS / rec["stream_ms_per_block"]
            if highest_audio is None:
                highest_audio = audio
            else:
                rec["audio_snr_vs_highest_db"] = snr_db(
                    highest_audio[:, cols], audio[:, cols])
            if tier == "bf16":
                # kernel #1 on the bfloat16 product against the plain tail
                # on .float() of it, through the whole step
                with plain_tails():
                    ref, _, _ = run_pipeline(cfg, params, blocks[:n_audio])
                against(f"tier bf16 C={c}: kernel #1 step vs plain-tail step",
                        audio, ref, params, results, f"bf16_c{c}_step")
                if c == MAIN_CHANNELS:
                    kernels["fused_tail_audio_tm[bf16]"] = bf16_tail_record(
                        dev, cfg, params, frames, n_audio)
            del audio
            log(f"  tier {tier} at C={c}: product SNR "
                f"{rec['product_snr_db']:.1f} dB vs float64, cuBLAS product "
                f"{rec['product_ms']:.4f} ms; step back to back "
                f"{rec['stream_ms_per_block']:.3f} ms/block (real-time "
                f"factor {rec['realtime_factor']:.2f})" + (
                    f"; AM/USB/LSB audio {rec['audio_snr_vs_highest_db']:.1f}"
                    f" dB vs the highest tier's"
                    if "audio_snr_vs_highest_db" in rec else ""))
            out[f"c{c}_{tier}"] = rec
            release()
        del exact, frames, p8, highest_audio
        torch.cuda.empty_cache()
    results["tiers"] = out

    # ---- kernel #2 on the bfloat16 product: the 9.6 kHz-audio path
    cfg_b = ch.ChannelizedConfig(num_channels=MAIN_CHANNELS, audio_rate=9_600,
                                 block_frames=256_000, pfb_precision="bf16")
    ifs, modes = slot_controls(MAIN_CHANNELS)
    params_b = ch.make_channelized_params(cfg_b, ifs, 80_000, 8_000, modes,
                                          device=dev)
    blocks_b = u8_blocks(4, seed=12, block_frames=cfg_b.block_frames)
    reset_counts()
    audio_b, _, _ = run_pipeline(cfg_b, params_b, blocks_b)
    expect_counts("tier bf16, 9.6 kHz audio", fused_tail_tm=len(blocks_b))
    hear_tones("tier_bf16_b_", cfg_b, audio_b, modes, results)
    with plain_tails():
        ref, _, _ = run_pipeline(cfg_b, params_b, blocks_b)
    against("tier bf16 (b): kernel #2 step vs plain-tail step", audio_b, ref,
            params_b, results, "bf16_b_step")
    kernels["fused_tail_tm[bf16]"] = bf16_chanrate_record(
        dev, cfg_b, params_b, len(blocks_b))

    # ---- kernel #3 at "default" and "high"
    for tier in ("default", "high"):
        kernels[f"fused_pfb_tail_audio_tm[{tier}]"] = pfb_tier_record(
            dev, tier, results)


def bf16_product(rng, dev, *shape):
    """A uniform random product rounded to bfloat16, as the kernel
    comparisons of phase 3 draw theirs: the raw FM demod rows are
    ill-conditioned where a slot's samples are near zero, which most slots
    of a tone-source product are (the steps hold those through the filtered
    audio, phase 8)."""
    import torch

    return torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(
        np.float32)).to(dev).bfloat16()


def bf16_tail_record(dev, cfg, params, frames, launches):
    """Kernel #1 on a bfloat16 product of the main path's shape against
    its plain version on the same inputs (the step's LO and FIRs, carries
    of zeros), timed beside it; the kernels-line record."""
    import torch
    from webradio_tpu_torch.ops import tail_tm

    c, k, d = cfg.num_channels, 64, cfg.audio_decim
    prod = bf16_product(np.random.default_rng(15), dev, frames.shape[0],
                        2 * c)
    z = lambda *s: torch.zeros(s, device=dev)
    args = (prod, prod, torch.zeros(c, dtype=torch.int64, device=dev),
            params.residual_step, params.chan_toep, params.audio_toep, d,
            params.mode, z(k - 1, c), z(k - 1, c), z(2, c), z(k - 1, c))
    got = tail_tm.fused_tail_audio_tm(*args, packed=True, fast=True)
    torch.cuda.synchronize()
    ref = tail_tm.fused_tail_audio_tm_ref(*args, packed=True, fast=True)
    worst = Worst()
    worst.add(compare("kernel #1 on the bf16 product", AUDIO_NAMES, BOUNDS,
                      got, ref, params.mode == 1,
                      float(params.audio_coeff.abs().max()),
                      raw=("audio_hist",), filtered=("audio48",)))
    ms = cuda_ms(lambda: tail_tm.fused_tail_audio_tm(*args, packed=True,
                                                     fast=True), 50)
    plain_ms = cuda_ms(lambda: tail_tm.fused_tail_audio_tm_ref(
        *args, packed=True, fast=True), 10)
    log(f"  kernel #1 on the bf16 product at C={c}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms")
    rec = worst.record(ms, plain_ms, tail_flops(frames.shape[0], c, k, d),
                       io_bytes(args, got))
    rec["launches"] = launches
    # at the wide width, beside the float32 product's kernel (phase 3)
    cw, nd = WIDE_CHANNELS, frames.shape[0]
    wide = (bf16_product(np.random.default_rng(17), dev, nd, 2 * cw),) * 2
    wide += (torch.zeros(cw, dtype=torch.int64, device=dev),
             params.residual_step.repeat(cw // c), params.chan_toep,
             params.audio_toep, d, params.mode.repeat(cw // c),
             z(k - 1, cw), z(k - 1, cw), z(2, cw), z(k - 1, cw))
    rec["ms_c16384"] = cuda_ms(lambda: tail_tm.fused_tail_audio_tm(
        *wide, packed=True, fast=True), 10)
    log(f"  kernel #1 on the bf16 product at C={cw}: {rec['ms_c16384']:.4f}"
        f" ms")
    return rec


def bf16_chanrate_record(dev, cfg, params, launches):
    """Kernel #2 on a bfloat16 product of its path's shape against its
    plain version (carries of zeros), timed beside it."""
    import torch
    from webradio_tpu_torch.ops import tail_tm

    c, k = cfg.num_channels, 64
    prod = bf16_product(np.random.default_rng(16), dev, cfg.chan_frames,
                        2 * c)
    z = lambda *s: torch.zeros(s, device=dev)
    args = (prod, prod, torch.zeros(c, dtype=torch.int64, device=dev),
            params.residual_step, params.chan_toep, params.mode,
            z(k - 1, c), z(k - 1, c), z(2, c))
    got = tail_tm.fused_tail_tm(*args, packed=True, fast=True)
    torch.cuda.synchronize()
    ref = tail_tm.fused_tail_tm_ref(*args, packed=True, fast=True)
    names = ("audio", "hist_i", "hist_q", "demod_prev", "power")
    worst = Worst()
    worst.add(compare("kernel #2 on the bf16 product", names,
                      dict(BOUNDS, audio=BOUNDS["audio_hist"]), got, ref,
                      params.mode == 1, RAW_FM_STEP, raw=("audio",)))
    ms = cuda_ms(lambda: tail_tm.fused_tail_tm(*args, packed=True,
                                               fast=True), 30)
    plain_ms = cuda_ms(lambda: tail_tm.fused_tail_tm_ref(
        *args, packed=True, fast=True), 5)
    log(f"  kernel #2 on the bf16 product at nd={prod.shape[0]}, C={c}: "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    rec = worst.record(ms, plain_ms, tail_flops(prod.shape[0], c, k),
                       io_bytes(args, got))
    rec["launches"] = launches
    return rec


def pfb_tier_record(dev, tier, results):
    """Kernel #3 at a lossy tier on the main configuration, C=1,024: the
    path (``tail_kernel="pallas_pfb"``) through ``process_host`` with its
    launches counted and its audio held to the plain-tail step; then the
    kernel against its plain version on one block's frames: by the tier
    rule, its AM/USB/LSB audio SNR against the exactly made product (float64,
    rounded once to float32, through the plain tail) within SNR_SLACK_DB of
    the plain version's, and its outputs within TIER_PFB_BOUNDS of it."""
    import torch
    from webradio_tpu_torch.ops import tail_tm
    from webradio_tpu_torch.ops.channelizer import pfb_frames_tm
    from webradio_tpu_torch.pipeline import channelized as ch

    c, k = MAIN_CHANNELS, 64
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                               tail_kernel="pallas_pfb", pfb_precision=tier)
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=dev)
    blocks = tone_blocks(PATH_BLOCKS, seed=13, noise=0.3)
    reset_counts()
    audio, _, _ = run_pipeline(cfg, params, blocks)
    expect_counts(f"(c) at {tier}", fused_pfb_tail_audio_tm=len(blocks))
    hear_tones(f"c_{tier}_", cfg, audio, modes, results)
    with plain_tails():
        ref_audio, _, _ = run_pipeline(cfg, params, blocks)
    against(f"(c) at {tier}: kernel #3 step vs plain-tail step", audio,
            ref_audio, params, results, f"c_{tier}_step")

    kp, d = cfg.proto_taps, cfg.audio_decim
    frames, _ = pfb_frames_tm(torch.from_numpy(blocks[0]).to(dev), kp,
                              cfg.num_bins,
                              torch.zeros(2, kp - 1, device=dev))
    w2 = params.pfb_weights.reshape(2 * kp, 2 * c)
    z = lambda *s: torch.zeros(s, device=dev)
    common = (frames, w2, torch.zeros(c, dtype=torch.int64, device=dev),
              params.residual_step, params.chan_toep, params.audio_toep, d,
              params.mode, z(k - 1, c), z(k - 1, c), z(2, c), z(k - 1, c))
    kw = dict(fast=True, pfb_precision=tier,
              pfb_weights_split=params.pfb_weights_split)
    got = tail_tm.fused_pfb_tail_audio_tm(*common, **kw)
    torch.cuda.synchronize()
    ref = tail_tm.fused_pfb_tail_audio_tm_ref(*common, **kw)
    exact_prod = (frames.double() @ w2.double()).float()
    exact = tail_tm.fused_tail_audio_tm_ref(exact_prod, exact_prod,
                                            *common[2:], packed=True,
                                            fast=True)
    cols = params.mode != 1
    snr_k = snr_db(exact[0][:, cols], got[0][:, cols])
    snr_p = snr_db(exact[0][:, cols], ref[0][:, cols])
    log(f"  kernel #3 at {tier}: AM/USB/LSB audio SNR vs the exact product "
        f"{snr_k:.2f} dB (plain version {snr_p:.2f} dB)")
    if not snr_k >= snr_p - SNR_SLACK_DB:
        raise AssertionError(f"kernel #3 at {tier}: SNR {snr_k:.2f} dB, "
                             f"plain {snr_p:.2f} dB")
    results[f"pfb_{tier}_audio_snr_db"] = {"kernel": snr_k, "plain": snr_p}
    worst = Worst()
    worst.add(compare(f"kernel #3 at {tier}", AUDIO_NAMES, TIER_PFB_BOUNDS,
                      got, ref, params.mode == 1,
                      float(params.audio_coeff.abs().max()),
                      raw=("audio_hist",), filtered=("audio48",)))
    ms = cuda_ms(lambda: tail_tm.fused_pfb_tail_audio_tm(*common, **kw), 20)
    plain_ms = cuda_ms(lambda: tail_tm.fused_pfb_tail_audio_tm_ref(
        *common, **kw), 5)
    passes = 3 if tier == "high" else 1
    product_flops = passes * 2.0 * frames.shape[0] * 2 * kp * 2 * c
    log(f"  kernel #3 at {tier}, nd={frames.shape[0]}, C={c}: {ms:.4f} ms, "
        f"plain (cuBLAS tier GEMM + plain tail) {plain_ms:.4f} ms")
    rec = worst.record(
        ms, plain_ms, tail_flops(frames.shape[0], c, k, d),
        io_bytes((*common, params.pfb_weights_split), got), product_flops)
    rec["launches"] = len(blocks)
    return rec


def phase_headline(dev, results):
    """examples/headline_monitor.json's front end on the card: C=69,632,
    channelized, fir_precision "highest", fed 8-bit-grid blocks, 16 blocks
    back to back at u8exact, highest and bf16: ms/block, the real-time
    factor, kernel #1 once a block, the AM and FM tones of slots 0 and 1
    (only their audio leaves the card), and the device memory's peak."""
    import torch
    from webradio_tpu_torch.ops import tail_tm
    from webradio_tpu_torch.pipeline import channelized as ch

    c = HEADLINE_CHANNELS
    base = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES,
                                fir_precision="highest",
                                pfb_precision="u8exact")
    ifs, modes = slot_controls(c)
    t0 = time.perf_counter()
    p8 = ch.make_channelized_params(base, ifs, 80_000, 8_000, modes,
                                    device=dev)
    log(f"  parameters for C={c} made in {time.perf_counter() - t0:.1f} s")
    blocks = u8_blocks(HEADLINE_BLOCKS, seed=14)
    out = {}
    for tier in HEADLINE_TIERS:
        cfg, params = tier_params(base, p8, tier)
        torch.cuda.reset_peak_memory_stats(dev)
        pipe = ch.ChannelizedPipeline(cfg, params)
        for b in blocks[:2]:  # warm: allocator, cuBLAS handles
            pipe.process_host(b)
        pipe.flush()
        torch.cuda.synchronize()
        reset_counts()
        slots = []
        t0 = time.perf_counter()
        for b in blocks:
            r = pipe.process_host(b)
            if r is not None:
                slots.append(r[0][:, :2].clone())
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(blocks)
        slots.append(pipe.flush()[0][:, :2].clone())
        expect_counts(f"headline {tier}", fused_tail_audio_tm=len(blocks))
        # every launch at the headline's width on the wgmma body
        wg = tail_tm.fused_tail_audio_tm.wgmma_launches
        if wg != len(blocks):
            raise AssertionError(f"headline {tier}: {wg} of {len(blocks)} "
                                 "launches of #1 on the wgmma body")
        audio = torch.cat(slots).cpu()
        if not bool(torch.isfinite(audio).all()):
            raise AssertionError(f"headline {tier}: non-finite audio")
        hear_tones(f"headline_{tier}_", cfg, audio, modes, results)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        out[tier] = {"stream_ms_per_block": ms,
                     "realtime_factor": BLOCK_MS / ms,
                     "launches": len(blocks), "peak_mem_gb": peak}
        log(f"  headline C={c} at {tier}: back to back {ms:.3f} ms/block, "
            f"real-time factor {BLOCK_MS / ms:.2f}, kernel #1 "
            f"{len(blocks)} launches for {len(blocks)} blocks ({wg} on the "
            f"wgmma body), peak device memory {peak:.1f} GB")
        del pipe, slots
        torch.cuda.empty_cache()
    results["headline"] = out
    if not out["u8exact"]["realtime_factor"] > 1:
        raise AssertionError("the headline topology at u8exact is below "
                             "real time")



#: the bench phase (bench_torch.py): one sweep point at the smoke's wide
#: width, and one past 2^31 elements of the packed [10240, 2C] product,
#: whose kernel #1 audio is held against the plain tail on its last
#: WIDE_SLICE channels
BENCH_POINT_CHANNELS = WIDE_CHANNELS
PAST_2_31_CHANNELS = 106_496
INT32_ELEMENTS = 2**31
WIDE_SLICE = 256


def phase_bench(dev, results):
    """``bench_torch.py``'s parts on the card: ``--parity`` (its ``ok``
    gated; kernel #1 once a step), one sweep point at C=16,384 "highest"
    through the bench's own timing (``channelized_point``: kernel #1 once a
    block) beside the main path's ms/block of the timing phase, and the
    same at C=106,496, whose packed product holds more than 2^31 elements;
    there kernel #1's outputs on the bench's input are held against the
    plain tail on the last 256 channels (section 2's bounds, the FM flip
    rule; the laws cycle so that AM, USB and LSB slots meet 1e-5)."""
    import torch
    import bench_torch
    from webradio_tpu_torch.ops import tail_tm
    from webradio_tpu_torch.ops.channelizer import pfb_channelize_direct_tm
    from webradio_tpu_torch.pipeline import channelized as ch

    t0 = time.perf_counter()
    par = bench_torch.parity_check(dev)
    log(f"  --parity ({time.perf_counter() - t0:.1f} s): " + json.dumps(par))
    if not par["ok"]:
        raise AssertionError(f"bench parity failed: {par}")
    results["bench_parity"] = par
    iq = bench_torch.bench_iq(dev)
    out = {}
    for c in (BENCH_POINT_CHANNELS, PAST_2_31_CHANNELS):
        rec = bench_torch.channelized_point(c, "highest", "highest", iq)
        log(f"  bench point C={c}: {rec['step_ms']:.3f} ms/block back to "
            f"back (runs {', '.join(f'{m:.3f}' for m in rec['step_ms_runs'])}"
            f"), {rec['one_ms']:.3f} one at a time, kernel #1 "
            f"{rec['kernel_launches']} for {rec['blocks']} blocks, peak "
            f"{rec['peak_gb']:.2f} GB, roofline {rec['roofline_ms']:.3f} ms "
            f"({rec['roofline_frac']:.3f})")
        out[f"c{c}"] = {k: rec[k] for k in (
            "step_ms", "step_ms_runs", "one_ms", "kernel_launches", "blocks",
            "peak_gb", "roofline_ms", "roofline_frac", "realtime")}
    main = results.get(f"c{WIDE_CHANNELS}", {}).get("stream_ms_per_block")
    bench_ms = out[f"c{BENCH_POINT_CHANNELS}"]["step_ms"]
    log(f"  C={BENCH_POINT_CHANNELS}: the bench's {bench_ms:.3f} ms/block "
        f"(one device-resident block through step_device) beside the main "
        f"path's " + ("not measured in this run" if main is None else
                      f"{main:.3f} (tone blocks through process_host)"))
    results["bench"] = out
    release()

    # past 2^31: kernel #1 on the whole product, the plain tail on a slice
    c, n = PAST_2_31_CHANNELS, WIDE_SLICE
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    modes = [("AM", "FM", "USB", "LSB")[i % 4] for i in range(c)]
    params = ch.make_channelized_params(cfg, bench_torch.ifs(c), 80_000,
                                        8_000, modes, device=dev)
    state = ch.init_channelized_state(cfg, dev)
    y2, _, _ = pfb_channelize_direct_tm(iq, params.pfb_weights, cfg.num_bins,
                                        state.pfb_hist, split=False)
    if not y2.numel() > INT32_ELEMENTS:
        raise AssertionError(f"the product holds {y2.numel()} elements")
    k1 = cfg.fir_length - 1
    carries = lambda w: (torch.zeros(k1, w, device=dev),
                         torch.zeros(k1, w, device=dev),
                         torch.zeros(2, w, device=dev),
                         torch.zeros(k1, w, device=dev))
    common = (params.chan_toep, params.audio_toep, cfg.audio_decim)
    reset_counts()
    got = tail_tm.fused_tail_audio_tm(
        y2, y2, state.nco_phase, params.residual_step, *common, params.mode,
        *carries(c), packed=True, fast=True)
    torch.cuda.synchronize()
    expect_counts(f"C={c} past 2^31", fused_tail_audio_tm=1)
    cols = slice(c - n, c)
    y_slice = torch.cat([y2[:, cols], y2[:, c + c - n:]], dim=1)
    del y2
    ref = tail_tm.fused_tail_audio_tm_ref(
        y_slice, y_slice, state.nco_phase[cols], params.residual_step[cols],
        *common, params.mode[cols], *carries(n), packed=True, fast=True)
    got = tuple(t[..., cols] for t in got)
    fm = params.mode[cols] == 1
    devs = compare(f"C={c} kernel #1 vs plain, last {n} channels",
                   AUDIO_NAMES, BOUNDS, got, ref, fm,
                   float(params.audio_coeff.abs().max()),
                   raw=("audio_hist",), filtered=("audio48",))
    results["past_2_31"] = {"channels": c, "slice": n,
                            "product_elements": 2 * c * cfg.chan_frames,
                            **devs}
    del got, ref, params, state
    release()

OFFLINE_BLOCKS = 16  # whole blocks through the offline runner
CLI_SECONDS = 1.0  # the CLI phase's capture
ENTRY_BOUND = 1e-5  # the entry's card run against its CPU run


def hear_row(tag, row, rate, want, results, skip=0.25):
    """The dominant tone of one audio row (numpy) within 2 Hz of ``want``."""
    x = np.asarray(row, np.float64)[int(skip * rate):]
    if x.size < rate // 4 or np.abs(x).max() < 1e-3:
        raise AssertionError(f"{tag}: {x.size} samples, peak "
                             f"{np.abs(x).max(initial=0):.2e}")
    spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(x.size)))
    got = float(np.argmax(spec) * rate / x.size)
    log(f"  {tag}: dominant tone {got:.2f} Hz, expected {want:.0f}")
    if abs(got - want) > TONE_TOLERANCE_HZ:
        raise AssertionError(f"{tag}: heard {got:.2f} Hz, expected {want}")
    results[tag.replace(" ", "_") + "_tone_hz"] = got


def phase_offline(dev, results):
    """``run_capture_channelized`` at C=16,384 over OFFLINE_BLOCKS blocks
    and a part-block of the tone source (kernel #1 once a block), held
    against OFFLINE_BLOCKS ``process_host`` calls on the same blocks; then
    ``run_capture`` at the entry's C=16 against ``FrontEndPipeline``."""
    import torch
    from webradio_tpu_torch.pipeline import channelized as ch
    from webradio_tpu_torch.pipeline import frontend as tfe
    from webradio_tpu_torch.pipeline import state as tstate
    from webradio_tpu_torch.pipeline import stream

    c = WIDE_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=dev)
    blocks = tone_blocks(OFFLINE_BLOCKS + 1, seed=7)
    part = BLOCK_FRAMES // 3
    capture = np.concatenate(blocks[:-1] + [blocks[-1][:, :part]], axis=1)
    iq = torch.from_numpy(capture).to(dev)

    # one run first: the 2.1 GB output's first allocation is not the
    # runner's steady cost (in a process that has cached other sizes it
    # doubled the back-to-back time once), and its pipeline is kept: the
    # second call replays its graphs with no warm and no capture
    stream.KEPT.clear()
    stream.run_capture_channelized(cfg, params, iq)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, audio, latest = stream.run_capture_channelized(cfg, params, iq)
    torch.cuda.synchronize()
    runner_ms = 1e3 * (time.perf_counter() - t0) / OFFLINE_BLOCKS
    expect_counts("offline runner", fused_tail_audio_tm=OFFLINE_BLOCKS)
    (kept,) = stream.KEPT.entries.values()
    runner_graphs = kept.graph_stats()
    del kept
    log(f"  the kept pipeline after two calls: {runner_graphs}")
    if runner_graphs["captures"] != 1 or runner_graphs["replays"] != (
            2 * OFFLINE_BLOCKS - 1):
        raise AssertionError(f"the offline runner captured again: "
                             f"{runner_graphs}")
    stream.KEPT.clear()
    af = cfg.audio_frames
    if tuple(audio.shape) != (c, OFFLINE_BLOCKS * af) or tuple(
            latest.shape) != (OFFLINE_BLOCKS, 2, cfg.fft_size):
        raise AssertionError(f"offline shapes {tuple(audio.shape)}, "
                             f"{tuple(latest.shape)}")
    if not bool(torch.isfinite(audio).all()):
        raise AssertionError("offline audio is not finite")
    # the serving step on the same blocks, one at a time: the same kernels
    # in the same order, so the audio is expected bit-equal
    pipe = ch.ChannelizedPipeline(cfg, params)
    err = 0.0
    for b in range(OFFLINE_BLOCKS):
        ref, _ = pipe.process_host_sync(blocks[b])
        err = max(err, float((audio[:, b * af:(b + 1) * af] - ref.T)
                             .abs().max()))
    log(f"  runner vs {OFFLINE_BLOCKS} process_host calls: max audio "
        f"difference {err:.3e} (bit-equal expected)")
    if err != 0.0:
        raise AssertionError(f"offline audio differs from the serving "
                             f"step's by {err:.3e}")
    for name, t in zip(ch.ChannelizedState._fields, state):
        if not torch.equal(t, getattr(pipe.state, name)):
            raise AssertionError(f"offline state {name} differs")
    host = audio[:2].cpu().numpy()
    hear_row("offline C=16384 AM slot", host[0], cfg.audio_rate, 1_000,
             results)
    hear_row("offline C=16384 FM slot", host[1], cfg.audio_rate, 440,
             results)
    serving_ms = stream_ms(cfg, params, blocks[:-1], OFFLINE_BLOCKS)
    log(f"  back to back at C={c}: runner {runner_ms:.3f} ms/block, "
        f"process_host {serving_ms:.3f} ms/block")
    results["offline"] = {"channels": c, "blocks": OFFLINE_BLOCKS,
                          "runner_ms_per_block": runner_ms,
                          "serving_ms_per_block": serving_ms,
                          "max_audio_diff": err,
                          "runner_graph": runner_graphs}
    # a dropped kept pipeline hands its graphs' memory back at once, with
    # no garbage collection
    gc.disable()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved(dev)
        stream.run_capture_channelized(cfg, params, iq)
        stream.KEPT.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kept_gb = (torch.cuda.memory_reserved(dev) - base) / 1e9
    finally:
        gc.enable()
    log(f"  a dropped kept pipeline left {kept_gb:.3f} GB reserved")
    if kept_gb > DROP_SLACK_GB:
        raise AssertionError(f"a dropped kept pipeline kept {kept_gb:.3f} GB")
    results["offline"]["kept_after_drop_gb"] = kept_gb
    del audio, pipe, state, latest, params

    # ---- the direct engine at the entry's C=16
    cfg = tstate.ChainConfig(num_channels=16, block_frames=BLOCK_FRAMES)
    ifs = [0, 100_000] + [(i - 8) * 100_000 for i in range(2, 16)]
    modes = ["AM", "FM"] + ["USB", "LSB", "AM", "FM"] * 3 + ["USB", "LSB"]
    params = tstate.make_receiver_params(cfg, ifs, 80_000, 8_000, modes,
                                         device=dev)
    n = OFFLINE_BLOCKS
    state, audio, latest = stream.run_capture(cfg, params, iq)
    pipe = tfe.FrontEndPipeline(cfg, params)
    af = cfg.audio_frames
    err = 0.0
    for b in range(n):
        ref, _ = pipe.process_host_sync(blocks[b])
        err = max(err, float((audio[:, b * af:(b + 1) * af] - ref)
                             .abs().max()))
    log(f"  run_capture C=16 (direct) vs {n} FrontEndPipeline calls: max "
        f"audio difference {err:.3e}")
    if err != 0.0 or tuple(latest.shape) != (n, 2, cfg.fft_size):
        raise AssertionError(f"run_capture differs by {err:.3e}")
    hear_row("offline C=16 AM slot", audio[0].cpu().numpy(), cfg.audio_rate,
             1_000, results)
    results["offline"]["direct_max_audio_diff"] = err
    stream.KEPT.clear()


def phase_cli(results):
    """A 1 s tone capture written as ``.cf32`` and demodulated by
    ``demod_cli.main`` with four receivers, on both engines; every WAV
    heard."""
    import contextlib
    import io
    import tempfile

    from webradio_tpu_torch import demod_cli

    frames = int(CLI_SECONDS * SAMPLE_RATE)
    z = np.concatenate([b[0] + 1j * b[1] for b in tone_blocks(
        -(-frames // BLOCK_FRAMES), seed=9)])[:frames]
    wants = [(0, "AM", 1_000), (100_000, "FM", 440), (0, "USB", 1_000),
             (0, "LSB", 1_000)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cap = f"{tmp}/tones.cf32"
        np.stack([z.real, z.imag], -1).astype(np.float32).tofile(cap)
        for engine in ("direct", "channelized"):
            args = [cap, "--rate", str(SAMPLE_RATE), "--engine", engine,
                    "-o", f"{tmp}/{engine}"]
            for f, m, _ in wants:
                args += ["--if-freq", str(f), "--mode", m]
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = demod_cli.main(args)
            wall = time.perf_counter() - t0
            for line in err.getvalue().splitlines():
                log(f"  cli {engine}: {line}")
            if rc != 0:
                raise AssertionError(f"demod_cli --engine {engine}: rc {rc}")
            for i, (f, m, want) in enumerate(wants):
                raw = open(f"{tmp}/{engine}_{i:02d}.wav", "rb").read()
                pcm = np.frombuffer(raw[44:], "<i2") / 32767
                hear_row(f"cli {engine} {m} at {f:+d}", pcm, 48_000, want,
                         results)
            out[engine] = {"wall_s": wall}
            log(f"  cli {engine}: {wall:.2f} s for {CLI_SECONDS:.0f} s of "
                f"capture, start-up included")
    results["cli"] = out


def phase_entry(dev, results):
    """``entry()``'s ``fn`` once on the card and once on the CPU with the
    same inputs, held within ENTRY_BOUND (the FM flip rule on FM slots)."""
    import torch
    from webradio_tpu_torch.entry import entry

    fn, (params, state, iq0) = entry()
    if iq0.device.type != "cuda" or params.rx.phase_step.device.type != (
            "cuda"):
        raise AssertionError("entry() did not place its arguments on the "
                             "card")
    iq = tone_blocks(1, seed=11, noise=0.3)[0]
    audio, latest = fn(params, state, torch.from_numpy(iq).to(dev))
    torch.cuda.synchronize()
    fn_cpu, (p_cpu, s_cpu, _) = entry(device="cpu")
    ref, ref_latest = fn_cpu(p_cpu, s_cpu, torch.from_numpy(iq))
    fm = p_cpu.rx.mode == 1
    err, flips, fm_max = audio_mismatch(
        audio.cpu().T, ref.T, fm, float(p_cpu.rx.audio_coeff.abs().max()),
        ENTRY_BOUND)
    lat_err = float((latest.cpu() - ref_latest).abs().max())
    lat_peak = float(ref_latest.abs().max())
    log(f"  entry() C=16 card vs CPU: audio {err:.3e} off FM slots, FM "
        f"{fm_max:.3e} ({flips} flips), latest spectrum planes "
        f"{lat_err:.3e} of a {lat_peak:.1f} peak")
    if not float(ref.abs().max()) > 1e-2 or not lat_err <= 1e-5 * lat_peak:
        raise AssertionError("entry(): silent, or the spectrum differs")
    results["entry"] = {"max_audio_err": err, "fm_max": fm_max,
                        "fm_flips": flips, "latest_err": lat_err}


class PulseStandIn:
    """A libpulse-simple stand-in for the soundcard phase (this card's host
    has no sound stack): ``pa_simple_read`` hands out stereo FLOAT32LE
    line-in frames carrying I on the left and Q on the right, an AM
    carrier at ``offset`` Hz modulated at 1 kHz, paced at the line-in
    clock (``rate`` frames a second)."""

    class Fn:
        """A foreign function's stand-in (its prototype is assignable)."""

        def __init__(self, impl):
            self.impl = impl

        def __call__(self, *args):
            return self.impl(*args)

    def __init__(self, rate, offset):
        self.rate, self.offset, self.n0 = rate, offset, 0
        self.freed, self._t0 = [], None
        self.pa_simple_new = self.Fn(lambda *a: 0xBEEF)
        self.pa_simple_read = self.Fn(self._read)
        self.pa_simple_write = self.Fn(lambda *a: 0)
        self.pa_simple_free = self.Fn(self.freed.append)

    def _read(self, handle, ptr, nbytes, err):
        import ctypes

        frames = nbytes // 8
        t = (self.n0 + np.arange(frames)) / self.rate
        z = (1 + 0.5 * np.sin(2 * np.pi * 1_000 * t)) * np.exp(
            2j * np.pi * self.offset * t) / 2
        inter = np.stack([z.real, z.imag], -1).astype(np.float32).ravel()
        ctypes.memmove(ptr, inter.ctypes.data, nbytes)
        self.n0 += frames
        if self._t0 is None:
            self._t0 = time.monotonic()
        lag = self._t0 + self.n0 / self.rate - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        return 0


def phase_soundcard(results):
    """A ``"soundcard"`` tuner served by the port's ``RadioApp`` on the card
    (no device named) from a libpulse-simple stand-in at a 96 kHz line-in
    clock: the pump takes its blocks, and its AM receiver is heard over
    HTTP."""
    from webradio_tpu_torch import app as tapp
    from webradio_tpu_torch.io import soundcard
    from webradio_tpu_torch.radio import Radio

    rate, offset = 96_000, 12_000
    stand_in = PulseStandIn(rate, offset)
    real, soundcard._PA = soundcard._PA, stand_in
    cfg = {"server": {"port": 0, "host": "127.0.0.1", "html": "html"},
           "tuners": [{"driver": "soundcard", "subdevice": "line-in",
                       "sample_rate": rate, "channel_rate": 48_000,
                       "audio_rate": 8_000, "block_frames": 6_144,
                       "capacity": 2}],
           "receivers": [{"tuner": 0, "if_frequency": offset,
                          "if_bandwidth": 20_000, "demodulator": "AM"}]}
    app = tapp.RadioApp(cfg)
    try:
        if not app.start():
            raise AssertionError("the soundcard server did not start")
        fe = app.front_ends[0]
        log(f"  soundcard tuner on a libpulse-simple stand-in ({rate} Hz "
            f"line-in, AM at {offset:+d} Hz): {type(fe.pipeline).__name__} "
            f"at C={fe.pipeline.cfg.num_channels} on {fe.device}")
        got = {}
        hear_all(app.server.port, {"soundcard_am": (
            app.receivers[0].uuid, 1_000.0)}, 8_000, got, "")
        results["soundcard"] = {"tone_hz": got["soundcard_am_tone_hz"],
                                "blocks": fe.block_count,
                                "dropped": fe.ring.dropped_blocks,
                                "stand_in": True}
        log(f"  soundcard: {fe.block_count} blocks, "
            f"{fe.ring.dropped_blocks} dropped")
        if app.failed is not None:
            raise AssertionError(f"the pump stopped: {app.failed}")
    finally:
        app.close()
        Radio.reset()
        soundcard._PA = real
    if not stand_in.freed:
        raise AssertionError("the soundcard stream was not freed")


def server_config(sink_path):
    """Tuner 0: C=16,384, "auto" (the channelized engine), four receivers
    at the default 80 / 8 kHz bandwidths; tuner 1: examples/demo_tone.json
    (capacity 4: the direct engine); tuner 2: GROW_FROM slots, channelized,
    every slot taken (:func:`slot_controls`), kernel #1 on the card at any
    width, and one more receiver grows it across the JAX package's 512;
    tuner 3: examples/mass_monitor.json's shape (1,024 channelized slots,
    one FM receiver at 12.5 kHz, so the slots do not share the FIR kernels
    and kernel #4 serves them) with an 8 kHz audio filter where the example
    has 4 kHz. Every tone tuner: AM 1 kHz at IF 0, FM 440 Hz at +100 kHz.
    Last, two receivers with a local audio sink: an AM one on tuner 0
    writing ``sink_path`` (WAV) and an AM one on tuner 1 playing on
    "pulse"."""
    tuner = {"driver": "tone", "centre_frequency": 124_325_000,
             "sample_rate": SAMPLE_RATE, "block_frames": BLOCK_FRAMES}
    grow = [{"tuner": 2, "if_frequency": f, "demodulator": m}
            for f, m in zip(*slot_controls(GROW_FROM))]
    return {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [dict(tuner, capacity=WIDE_CHANNELS, engine="auto"),
                   dict(tuner, capacity=4),
                   dict(tuner, capacity=GROW_FROM, engine="channelized"),
                   dict(tuner, capacity=MONITOR_CHANNELS,
                        engine="channelized")],
        "receivers": [
            {"tuner": 0, "if_frequency": 0, "demodulator": "AM"},
            {"tuner": 0, "if_frequency": 100_000, "demodulator": "FM"},
            {"tuner": 0, "if_frequency": -200_000, "demodulator": "USB"},
            {"tuner": 0, "if_frequency": 300_000, "demodulator": "LSB"},
            {"tuner": 1, "if_frequency": 0, "demodulator": "AM"},
            {"tuner": 1, "if_frequency": 100_000, "demodulator": "FM",
             "af_bandwidth": 8_000},
            *grow,
            {"tuner": 3, "if_frequency": 100_000, "demodulator": "FM",
             "if_bandwidth": 12_500, "af_bandwidth": 8_000},
            {"tuner": 0, "if_frequency": 0, "demodulator": "AM",
             "audio_sink": f"file:{sink_path}"},
            {"tuner": 1, "if_frequency": 0, "demodulator": "AM",
             "audio_sink": "pulse"},
        ],
    }


def http_call(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def hear(port, rx, rate, seconds=HEAR_SECONDS, skip=0.25):
    """Read ``seconds`` of ``/audio/<rx>.wav``; the dominant tone in Hz."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", f"/audio/{rx}.wav")
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"/audio/{rx}.wav answered {resp.status}")
    want, data = 44 + int(2 * rate * (seconds + skip)), b""
    while len(data) < want:
        chunk = resp.read(16_384)
        if not chunk:
            break
        data += chunk
    conn.close()
    x = np.frombuffer(data[44:44 + (len(data) - 44) // 2 * 2],
                      "<i2")[int(skip * rate):].astype(np.float64)
    if x.size < rate or np.abs(x).max() < 100:
        raise AssertionError(f"receiver {rx}: {x.size} samples, silent?")
    spec = np.abs(np.fft.rfft((x - x.mean()) * np.hanning(x.size)))
    return float(np.argmax(spec) * rate / x.size)


def hear_all(port, wants, rate, results, tag):
    """Hear several receivers at once (one thread each): ``wants`` maps a
    label to (receiver uuid, expected Hz)."""
    import threading

    got, errors = {}, []

    def one(label, rx):
        try:
            got[label] = hear(port, rx, rate)
        except Exception as e:  # re-raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(label, rx))
               for label, (rx, _) in wants.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    for label, (rx, want) in wants.items():
        log(f"  {tag} {label} (receiver {rx}): dominant tone "
            f"{got[label]:.2f} Hz, expected {want:.0f}")
        if abs(got[label] - want) > TONE_TOLERANCE_HZ:
            raise AssertionError(f"{label}: heard {got[label]:.2f} Hz, "
                                 f"expected {want:.0f} Hz")
        results[f"{tag}{label}_tone_hz"] = got[label]


def check_waterfall(port, fe, results):
    """The waterfall JSON of a front end: not all -10000, its strongest bin
    at the centre (the AM carrier) or on the FM carrier +100 kHz up, which
    sweeps +/-5 kHz (the AM envelope swings 0.5-1.5, so in some rows the FM
    carrier is stronger), and the centre bin at least 20 dB above the
    median bin."""
    status, data = http_call(port, "GET", f"/tuners/{fe.uuid}/waterfall")
    spec = np.array(json.loads(data)["data"])
    n = spec.size
    fm_bin = n // 2 + round(100_000 / SAMPLE_RATE * n)
    fm_span = 1 + 5_000 * n // SAMPLE_RATE
    peak = int(np.argmax(spec))
    log(f"  waterfall {fe.uuid}: {status}, {n} bins, min {spec.min():.1f} "
        f"max {spec.max():.1f} dB at bin {peak} (centre {n // 2}, FM "
        f"{fm_bin}), centre {spec[n // 2]:.1f} dB, median "
        f"{np.median(spec):.1f} dB")
    if status != 200 or n != fe.cfg.fft_size or not (spec > -10000).any():
        raise AssertionError(f"waterfall {fe.uuid} is flat or missing")
    if (abs(peak - n // 2) > 1 and abs(peak - fm_bin) > fm_span) or not (
            spec[n // 2] >= np.median(spec) + 20.0):
        raise AssertionError(f"waterfall {fe.uuid}: strongest bin {peak}")
    results[f"server_waterfall_{fe.uuid}_peak_bin"] = peak


#: the steps of the server phase that count as serving (PumpWatch.mark)
SERVING_STEPS = ("first blocks", "GET /status, /tuners", "waterfalls",
                 "four WAV listeners", "PUT", "one WAV listener",
                 "POST, DELETE", "growth POST", "after the swap",
                 "catch-up", "after the catch-up", "bandwidth PUTs",
                 "plain serving")
#: blocks tuner 0's ring is held to before the pump drains it in one go
CATCHUP_HOLD = 4


class PumpWatch:
    """A thread that reads each front end's block count and drops every 10
    ms. It ties each drop to the step of the phase (:meth:`mark`) before
    it, and keeps the pump thread's stack whenever no tuner has had a block
    for :attr:`STALL_S`."""

    STALL_S = 0.12

    def __init__(self, front_ends, thread_of_pump):
        import threading

        self.fes, self.pump = front_ends, thread_of_pump
        self.marks = [(time.monotonic(), "first blocks")]
        self.drops, self.stalls = [], []
        #: the times at which some tuner's block count was seen to move
        self.progress: list[float] = []
        #: step -> the longest ms without a block of any tuner in it
        self.max_gap_ms: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def dropped(fe):
        """The front end's drops (its ring's, and the blocks a multihost
        round passed over) and its source's."""
        return fe.dropped_blocks + getattr(fe.tuner.source,
                                           "dropped_blocks", 0)

    def mark(self, label):
        self.marks.append((time.monotonic(), label))

    def _run(self):
        import traceback

        last = [(fe.block_count, self.dropped(fe)) for fe in self.fes]
        since, stack_taken = time.monotonic(), False
        while not self._stop.wait(0.01):
            now = time.monotonic()
            mark_t, label = self.marks[-1]
            now_ = [(fe.block_count, self.dropped(fe)) for fe in self.fes]
            for fe, (b0, d0), (b1, d1) in zip(self.fes, last, now_):
                if d1 > d0:
                    self.drops.append((fe.uuid, d1 - d0, label,
                                       1e3 * (now - mark_t),
                                       1e3 * (now - since)))
            if any(b1 != b0 for (b0, _), (b1, _) in zip(last, now_)):
                self.progress.append(now)
                gap = 1e3 * (now - since)
                if gap > self.max_gap_ms.get(label, 0.0):
                    self.max_gap_ms[label] = gap
                since, stack_taken = now, False
            elif now - since > self.STALL_S and not stack_taken:
                frame = sys._current_frames().get(self.pump.ident)
                stack = traceback.format_stack(frame)[-4:] if frame else []
                self.stalls.append((label, 1e3 * (now - mark_t),
                                    "".join(stack).rstrip()))
                stack_taken = True
            last = now_

    def longest_gap_ms(self, t0, t1):
        """The longest stretch without a block of any tuner that overlaps
        ``[t0, t1]`` (10 ms resolution)."""
        times = self.progress
        return 1e3 * max((b - a for a, b in zip(times, times[1:])
                          if b >= t0 and a <= t1), default=0.0)

    def close(self, serving):
        """Stop; log the drops of each step, and each drop and stall in the
        steps named in ``serving`` with the pump's stack."""
        self._stop.set()
        self._thread.join(timeout=5)
        by_step: dict = {}
        for uuid, n, label, after_ms, gap_ms in self.drops:
            step = by_step.setdefault(label, {})
            step[uuid] = step.get(uuid, 0) + n
            if label in serving:
                log(f"  drop: tuner {uuid} lost {n} in '{label}', "
                    f"{after_ms:.0f} ms after it began, {gap_ms:.0f} ms "
                    f"since the pump's last block")
        log(f"  drops by step: {by_step}")
        log("  the pump's longest gap by step (ms): " + ", ".join(
            f"{label} {ms:.0f}" for label, ms in self.max_gap_ms.items()))
        for label, after_ms, stack in self.stalls:
            if label in serving or label == "/profile trace":
                log(f"  stall: no block for {1e3 * self.STALL_S:.0f} ms in "
                    f"'{label}', {after_ms:.0f} ms after it began; the pump "
                    f"at:\n{stack}")


class TraceProbe:
    """The rings around each stretch of the ``/profile`` trace thread (the
    profiler's start and stop, the wait for the pump, the export). It wraps
    ``_TraceSession._timed``, so on the trace thread itself, just before
    and just after each stretch, it reads every tuner's Python ring
    (depth, drops) and its tone source's native ring (drops, and the depth
    estimated from the synthesizer's pacing: blocks made since the session
    opened, less those taken and those dropped). While the installed
    ``NativeToneSource.start`` is in place it notes when each session
    opened."""

    def __init__(self, fes):
        from webradio_tpu_torch.web import handlers

        self.fes, self.stretches = fes, []
        self._cls, self._real = handlers._TraceSession, (
            handlers._TraceSession._timed)
        probe = self

        def timed(session, name, fn):
            before, t0 = probe.rings(), time.monotonic()
            try:
                return probe._real(session, name, fn)
            finally:
                probe.stretches.append((name, t0, time.monotonic(), before,
                                        probe.rings()))

        self._cls._timed = timed

    @staticmethod
    def note_opening():
        """Install a ``NativeToneSource.start`` that notes the opening
        time; returns the function that restores the real one."""
        from webradio_tpu_torch.io import source

        real = source.NativeToneSource.start

        def start(src):
            ok = real(src)
            src.opened_at = time.monotonic()
            return ok

        source.NativeToneSource.start = start
        return lambda: setattr(source.NativeToneSource, "start", real)

    def rings(self):
        now, out = time.monotonic(), []
        for fe in self.fes:
            src = fe.tuner.source
            native_dropped = getattr(src, "dropped_blocks", 0)
            native = None
            if getattr(src, "opened_at", None) is not None:
                made = int((now - src.opened_at) / fe.cfg.block_seconds)
                native = max(0, made - fe.ring.total_blocks - native_dropped)
            out.append((fe.ring.backlog, native, fe.ring.dropped_blocks,
                        native_dropped))
        return out

    def records(self, watch, since: int = 0) -> list[dict]:
        """The stretches from the ``since``-th on: each one's ms, the pump's
        longest gap over it, each tuner's ring depths at its start and end
        and the drops of each ring in it."""
        out = []
        for name, t0, t1, before, after in self.stretches[since:]:
            out.append({
                "stretch": name, "ms": 1e3 * (t1 - t0),
                "pump_gap_ms": watch.longest_gap_ms(t0, t1),
                "rings": [{"tuner": fe.uuid, "ring": [b[0], a[0]],
                           "native": [b[1], a[1]],
                           "ring_dropped": a[2] - b[2],
                           "native_dropped": a[3] - b[3]}
                          for fe, b, a in zip(self.fes, before, after)]})
        return out

    def report(self, watch, results):
        """Log each stretch (:meth:`records`) and keep them in
        ``results``."""
        out = self.records(watch)
        for r in out:
            log(f"  /profile {r['stretch']}: {r['ms']:.1f} ms, the pump's "
                f"longest gap over it {r['pump_gap_ms']:.0f} ms; per tuner "
                f"[ring depth start, end] [native depth start, end (est.)] "
                f"drops ring/native: " + "; ".join(
                    f"{g['tuner']} {g['ring']} {g['native']} "
                    f"{g['ring_dropped']}/{g['native_dropped']}"
                    for g in r["rings"]))
        results["server_trace_stretches"] = out

    def close(self):
        self._cls._timed = self._real


def phase_server(results):
    """The server, driven over HTTP (see the module docstring, phase 13)."""
    import pathlib
    import shutil
    import tempfile

    from webradio_tpu_torch import app as tapp
    from webradio_tpu_torch.radio import Radio

    from webradio_tpu_torch.io.soundcard import pulse_available

    reset_counts()  # the server's launches only
    sink_dir = tempfile.mkdtemp(prefix="webradio_sink_")
    sink_path = pathlib.Path(sink_dir) / "rx0.wav"
    app = tapp.RadioApp(server_config(sink_path))
    t0 = time.perf_counter()
    restore_start = TraceProbe.note_opening()
    try:
        if not app.start():
            raise AssertionError("the server did not start")
    finally:
        restore_start()

    fes = list(app.front_ends)  # close() empties the app's list
    fe0, fe1, fe2, fe3 = fes
    port = app.server.port
    log(f"  up on 127.0.0.1:{port} in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"tuner {fe.uuid} {type(fe.pipeline).__name__} at "
                    f"C={fe.pipeline.cfg.num_channels} "
                    f"({type(fe.tuner.source).__name__})" for fe in fes))
    log(f"  the app's profiler warm-up before its pump: "
        f"{app.profiler_warm_ms:.0f} ms")
    sink_rx, pulse_rx = app.receivers[-2:]
    writer = sink_rx.audio_sink
    log(f"  audio sinks: receiver {sink_rx.uuid} (tuner {fe0.uuid}, AM) -> "
        f"{type(writer).__name__}({type(writer.sink).__name__}); receiver "
        f"{pulse_rx.uuid} (tuner {fe1.uuid}) 'pulse': libpulse-simple "
        f"{'present' if pulse_available() else 'absent'}, sink "
        f"{'bound' if pulse_rx.audio_sink is not None else 'unbound'}")
    results["server_pulse_available"] = pulse_available()
    if not pulse_available() and pulse_rx.audio_sink is not None:
        raise AssertionError("a 'pulse' sink was bound without libpulse")
    results["server_profiler_warm_ms"] = app.profiler_warm_ms
    if [type(fe.pipeline).__name__ for fe in fes] != [
            "ChannelizedPipeline", "FrontEndPipeline", "ChannelizedPipeline",
            "ChannelizedPipeline"
    ] or fe2.pipeline.cfg.num_channels != GROW_FROM or (
            fe3.pipeline.params.chan_toep is not None):
        raise AssertionError("the engines are not channelized / direct / "
                             f"channelized at {GROW_FROM} / channelized "
                             "with mixed bandwidths")
    if any(fe.plain_tail() for fe in fes):
        raise AssertionError("a tail runs plain: "
                             f"{[fe.plain_tail() for fe in fes]}")
    served_from = time.monotonic()
    failed = watch = None
    probe = TraceProbe(fes)
    trace_dir = tempfile.mkdtemp(prefix="webradio_trace_")
    try:
        deadline = time.monotonic() + 60
        while min(fe.block_count for fe in fes) < 5:
            if time.monotonic() > deadline or app.failed is not None:
                raise AssertionError(f"no blocks served: {app.failed}")
            time.sleep(0.05)
        # blocks lost by the pump's ring or by the tone source's own
        # native ring. Start-up (tuner 0 captures while tuner 1 warms) and
        # the two profiler windows are counted apart; everything else is
        # serving, which must drop nothing (PERF.md section 2)
        drops = lambda: [PumpWatch.dropped(fe) for fe in fes]
        mark = lambda: (time.monotonic(), drops(),
                        [fe.block_count for fe in fes])

        def caught_up(after):
            """Wait until the pump has drained every ring: the drops of a
            stall's backlog count to the span that stalled the pump."""
            t0 = time.monotonic()
            while (any(fe.ring.backlog for fe in fes)
                   and time.monotonic() < t0 + 5.0):
                time.sleep(0.005)
            log(f"  every ring drained {1e3 * (time.monotonic() - t0):.0f} "
                f"ms after {after}")

        def served(fe, n, what):
            b = fe.block_count
            deadline = time.monotonic() + 30
            while fe.block_count < b + n:
                if time.monotonic() > deadline or app.failed is not None:
                    raise AssertionError(f"{what}: tuner {fe.uuid} served "
                                         f"{fe.block_count - b} of {n} "
                                         f"blocks ({app.failed})")
                time.sleep(0.02)

        caught_up("the first blocks")
        m_start = mark()
        watch = PumpWatch(fes, app._pump)
        watch.mark("GET /status, /tuners")
        for path in ("/status", "/tuners"):
            status, data = http_call(port, "GET", path)
            if status != 200:
                raise AssertionError(f"GET {path}: {status}")
        tuners = json.loads(http_call(port, "GET", "/tuners")[1])
        log(f"  /tuners: {[t['uri'] for t in tuners]}")
        watch.mark("waterfalls")
        for fe in (fe0, fe1):
            check_waterfall(port, fe, results)
        rx0 = [r.uuid for r in app.receivers[:2]]
        rx1 = [r.uuid for r in app.receivers[4:6]]
        rate = fe0.cfg.audio_rate
        watch.mark("four WAV listeners")
        rx3 = app.receivers[6 + GROW_FROM].uuid
        hear_all(port, {"t0_am": (rx0[0], 1_000.0), "t0_fm": (rx0[1], 440.0),
                        "t1_am": (rx1[0], 1_000.0), "t1_fm": (rx1[1], 440.0),
                        "t3_fm_12k5": (rx3, 440.0)},
                 rate, results, "server_")
        watch.mark("PUT")
        status, _ = http_call(port, "PUT", f"/receivers/{rx0[0]}",
                         {"if_frequency": 100_000, "demodulator": "FM"})
        if status != 204:
            raise AssertionError(f"PUT answered {status}")
        blocks = fe0.block_count
        while fe0.block_count < blocks + 3:
            time.sleep(0.02)
        watch.mark("one WAV listener")
        hear_all(port, {"t0_am_put_to_fm": (rx0[0], 440.0)}, rate, results,
                 "server_")
        watch.mark("POST, DELETE")
        status, data = http_call(port, "POST", "/receivers",
                            {"tuner": f"/tuners/{fe0.uuid}",
                             "if_frequency": 50_000, "demodulator": "USB"})
        if status != 201:
            raise AssertionError(f"POST answered {status}")
        uri = json.loads(data)["uri"]
        status, _ = http_call(port, "DELETE", uri)
        if status != 204 or http_call(port, "GET", uri)[0] != 404:
            raise AssertionError(f"DELETE {uri} answered {status}")
        log(f"  POST then DELETE {uri}: 201, 204")

        # ---- growth across 512 while serving: one more receiver on the
        # full tuner 2 doubles its slots; the wider pipeline is built and
        # warmed off the pump (its warm block is the first at C=512, the
        # first that takes kernel #1) and swapped in between blocks
        watch.mark("growth POST")
        swapped_at = []
        real_swap = fe2._swap_grown_pipeline

        def swap():
            n = fe2.block_count
            published = real_swap()
            if fe2.pipeline.cfg.num_channels > GROW_FROM and not swapped_at:
                swapped_at.append(n)
            return published

        fe2._swap_grown_pipeline = swap
        t_grow = time.monotonic()
        status, data = http_call(port, "POST", "/receivers",
                                 {"tuner": f"/tuners/{fe2.uuid}",
                                  "if_frequency": 0, "demodulator": "AM"})
        if status != 201:
            raise AssertionError(f"growth POST answered {status}")
        grown_rx = json.loads(data)["uri"].rsplit("/", 1)[-1]
        while not swapped_at:
            if time.monotonic() > t_grow + 30 or app.failed is not None:
                raise AssertionError(f"no growth swap ({app.failed})")
            time.sleep(0.01)
        width = fe2.pipeline.cfg.num_channels
        log(f"  growth POST 201: tuner {fe2.uuid} {GROW_FROM} -> {width} "
            f"slots, swapped in {time.monotonic() - t_grow:.2f} s after "
            f"the POST, at block {swapped_at[0]}")
        if width != 2 * GROW_FROM:
            raise AssertionError(f"grown to {width} slots")
        watch.mark("after the swap")
        served(fe2, 10, "after the swap")
        hear_all(port, {"t2_grown_am": (grown_rx, 1_000.0)}, rate, results,
                 "server_")

        # ---- a forced stall: tuner 0's service held until its ring holds
        # CATCHUP_HOLD blocks (more than three blocks of signal); the pump
        # then serves the whole backlog in one run_once, a replay a block
        watch.mark("catch-up")
        many = []
        real_get, real_drain = fe0.ring.get, fe0.ring.drain
        replays0 = fe0.graph_stats()["replays"]

        def once_drain(n):
            fe0.ring.drain = real_drain
            got = real_drain(n)
            many.append(1 + len(got))
            return got

        def held_get(timeout=None):
            if fe0.ring.backlog < CATCHUP_HOLD:
                return None
            fe0.ring.get = real_get
            fe0.ring.drain = once_drain
            return real_get(timeout)

        t_hold = time.monotonic()
        fe0.ring.get = held_get
        while not many:
            if time.monotonic() > t_hold + 5 or app.failed is not None:
                raise AssertionError(f"no catch-up ({app.failed})")
            time.sleep(0.005)
        log(f"  catch-up: tuner {fe0.uuid} held "
            f"{1e3 * (time.monotonic() - t_hold):.0f} ms, then one run_once "
            f"served {many[0]} blocks")
        if many[0] < CATCHUP_HOLD:
            raise AssertionError(f"catch-up ran on {many} blocks")
        watch.mark("after the catch-up")
        served(fe0, 10, "after the catch-up")
        if fe0.graph_stats()["replays"] - replays0 < many[0]:
            raise AssertionError("the catch-up's blocks were not replays: "
                                 f"{fe0.graph_stats()}")
        results["server_catchup_blocks"] = many[0]

        # ---- recapture where the step's structure changes, and only
        # there: tuner 1's AM receiver leaves the shared channel FIR (its
        # own 12.5 kHz), comes back, then changes law twice
        watch.mark("bandwidth PUTs")
        rx_bw = app.receivers[4].uuid
        captures = []
        for body in ({"if_bandwidth": 12_500}, {"if_bandwidth": 80_000},
                     {"demodulator": "USB"}, {"demodulator": "AM"}):
            status, _ = http_call(port, "PUT", f"/receivers/{rx_bw}", body)
            if status != 204:
                raise AssertionError(f"PUT {body} answered {status}")
            served(fe1, 3, f"after PUT {body}")
            captures.append(fe1.graph_stats()["captures"])
        log(f"  tuner {fe1.uuid}: graph captures after the PUTs (off the "
            f"shared FIR, back, two law changes): {captures}")
        if captures != [2, 3, 3, 3]:
            raise AssertionError(f"recaptures {captures}: one for each "
                                 "bandwidth PUT, none for a law change")
        results["server_recaptures"] = captures
        m_serving = mark()  # HTTP requests, audio streams, control writes
        # the server's own real-time factor over serving, read before this
        # script's profiler windows
        serving_status = json.loads(http_call(port, "GET", "/status")[1])
        watch.mark("1 s profiler window")  # and the pump catching up
        # the device's idle share while serving, from the device's own
        # timeline (every stream); then the /profile endpoint's trace
        b0 = sum(fe.block_count for fe in fes)
        prof = device_profile(lambda i: time.sleep(0.1), 10, cpu=False,
                              mark=lambda: graph_kernels(fes))
        blocks_in = sum(fe.block_count for fe in fes) - b0
        results["server_window_kernels"] = expect_kernel_events(
            "1 s profiler window", prof, blocks_in, window_expected(prof))
        busy, window, idle, top = (prof[k] for k in ("busy", "window",
                                                     "idle", "top"))
        if busy is None:
            log("  profiler saw no device events; idle share not measured")
        else:
            log(f"  profiled 1 s of serving ({blocks_in} blocks of both "
                f"tuners): device busy {10 * busy:.2f} ms of a "
                f"{10 * window:.2f} ms device window, idle share {idle:.3f}")
            for name, ms in top:
                log(f"    {10 * ms:8.3f} ms in the window  {name}")
        # the window's trace parse holds the interpreter: its backlog's
        # drops belong to the window, not to the /profile trace after it
        caught_up("the 1 s profiler window")
        d_window = drops()
        results["server_idle_share"] = idle
        results["server_profiled_busy_ms_per_block"] = (
            None if busy is None or not blocks_in else 10 * busy / blocks_in)
        watch.mark("/profile trace")  # and the pump catching up
        rings_before_trace = probe.rings()
        status, _ = http_call(port, "POST", "/profile",
                         {"action": "start", "dir": trace_dir})
        time.sleep(0.5)
        status2, data = http_call(port, "POST", "/profile", {"action": "stop"})
        answer = json.loads(data)
        if (status, status2) != (200, 200):
            # a trace with copies but no kernel answers 500 with the reason
            raise AssertionError(f"/profile failed: {answer}")
        # the server has counted the trace's kernel events; this script
        # reads the trace only once the server is closed (a parse here
        # would hold the interpreter, and so the pump, inside the span)
        kernels = answer["kernel_events"]
        log(f"  /profile start {status}, stop {status2}: {kernels} kernel "
            f"events of {answer['expected_kernel_events']} expected of the "
            f"graph replays; ms: " + ", ".join(
                f"{k} {v:.1f}" for k, v in answer["timings_ms"].items()))
        results["server_trace_kernel_events"] = {
            "kernels": kernels, "expected": answer["expected_kernel_events"]}
        results["server_profiler_ms"] = {
            "window": prof["timings_ms"], "trace": answer["timings_ms"]}
        caught_up("the /profile trace")
        m_profiled = mark()
        trace_rings = [
            {"ring_dropped": a[2] - b[2], "native_dropped": a[3] - b[3]}
            for b, a in zip(rings_before_trace, probe.rings())]
        watch.mark("plain serving")
        # plain serving again, at least three seconds
        t_end = max(time.monotonic() + 3.0, served_from + SERVER_SECONDS)
        while time.monotonic() < t_end:
            time.sleep(0.1)
        m_end = mark()
        final = json.loads(http_call(port, "GET", "/status")[1])
    except BaseException as e:
        failed = e
    finally:
        probe.close()
        if watch is not None:
            watch.close(SERVING_STEPS)
            probe.report(watch, results)
        app.close()
        trace_file = pathlib.Path(trace_dir) / "trace.json"
        if trace_file.exists():
            events = json.loads(trace_file.read_text())["traceEvents"]
            log(f"  trace.json: {len(events)} events")
        shutil.rmtree(trace_dir, ignore_errors=True)
        Radio.reset()
        # the sink's writer drains its queue, then closes the WAV
        writer._thread.join(timeout=10)
        sink_wav = sink_path.read_bytes() if sink_path.exists() else b""
        shutil.rmtree(sink_dir, ignore_errors=True)
    if failed is not None:
        raise failed
    if writer._thread.is_alive() or len(sink_wav) < 44:
        raise AssertionError("the file sink was not closed")
    pcm = np.frombuffer(sink_wav[44:], "<i2") / 32767
    log(f"  file sink: {pcm.size} samples ({pcm.size / 48_000:.2f} s) from "
        f"receiver {sink_rx.uuid}, sink drops {writer.dropped}")
    hear_row("server file sink", pcm, 48_000, 1_000, results)
    results["server_sink"] = {"samples": int(pcm.size),
                              "sink_dropped": writer.dropped}
    if writer.dropped:
        raise AssertionError(f"the file sink dropped {writer.dropped}")
    if app.failed is not None:
        raise AssertionError(f"the pump stopped: {app.failed}")
    launches = {name: fn.launches for name, fn in tail_wrappers().items()}
    log(f"  server: kernel launches {launches}")
    out = {"max_gap_ms": watch.max_gap_ms}
    # the serving windows: first block to the profiler, and after the trace
    windows = ((m_start, m_serving), (m_profiled, m_end))
    for k, fe in enumerate(fes):
        st = final["front_ends"][fe.uuid]
        ms = st["ns_per_frame"] * BLOCK_FRAMES / 1e6
        serving = sum(b[1][k] - a[1][k] for a, b in windows)
        wall = sum(b[0] - a[0] for a, b in windows)
        served = sum(b[2][k] - a[2][k] for a, b in windows)
        out[fe.uuid] = {
            "engine": st["engine"], "capacity": st["channel_capacity"],
            "blocks": st["blocks"], "ring_dropped": st["dropped_blocks"],
            # ring and tone-source drops by span of the phase
            "dropped_startup": m_start[1][k],
            "dropped_idle_window": d_window[k] - m_serving[1][k],
            "dropped_trace": m_profiled[1][k] - d_window[k],
            "dropped_trace_by_ring": trace_rings[k],
            "dropped_serving": serving,
            "serving_s": wall,
            "serving_throughput": served * fe.cfg.block_seconds / wall,
            "fanout_dropped": st["fanout_dropped"],
            "realtime_factor": st["realtime_factor"],
            "realtime_factor_serving": serving_status["front_ends"][
                fe.uuid]["realtime_factor"],
            "throughput_factor": st["throughput_factor"],
            "step_ms_per_block": ms, "step_samples": st["step_samples"],
            "last_dispatch_ms": st["last_dispatch_ms"],
        }
        o = out[fe.uuid]
        log(f"  tuner {fe.uuid} ({st['engine']}, C={st['channel_capacity']})"
            f": {st['blocks']} blocks, drops {o['dropped_startup']} at "
            f"start-up, {o['dropped_idle_window']} in the 1 s profiler "
            f"window, {o['dropped_trace']} around the /profile trace "
            f"(ring {trace_rings[k]['ring_dropped']}, native "
            f"{trace_rings[k]['native_dropped']}), "
            f"{serving} in {wall:.2f} s of serving (throughput "
            f"{o['serving_throughput']:.4f}); fan-out drops "
            f"{st['fanout_dropped']}, real-time factor "
            f"{o['realtime_factor_serving']} over serving, at the end "
            f"{st['realtime_factor']} ({ms:.3f} ms/block on the card, the "
            f"step's mean over the last blocks of {st['step_samples']} "
            f"read), "
            f"throughput since start {st['throughput_factor']}")
    # kernel #1: every block of tuner 0 and of tuner 2 on both sides of its
    # growth, plus the warm blocks of tuner 0's and tuner 2's pipelines and
    # of the grown one, and at most a block in flight each; kernel #4:
    # every block of tuner 3, its warm, at most one in flight
    served0 = fe0.block_count  # the pump has stopped: final counts
    grown = fe2.block_count - swapped_at[0]
    served2, served3 = fe2.block_count, fe3.block_count
    others = {n: c for n, c in launches.items()
              if n not in ("fused_tail_audio_tm", "fused_receiver_tail")
              and c}
    n1 = launches["fused_tail_audio_tm"]
    n4 = launches["fused_receiver_tail"]
    log(f"  kernel #1: {n1} launches for {served0} blocks of tuner {fe0.uuid}"
        f" and {served2} of tuner {fe2.uuid} ({swapped_at[0]} before its "
        f"growth, {grown} after); kernel #4: {n4} for {served3} blocks of "
        f"tuner {fe3.uuid}")
    if (not served0 + served2 + 3 <= n1 <= served0 + served2 + 6
            or not served3 + 1 <= n4 <= served3 + 2 or others):
        raise AssertionError(f"server: launches {launches} for {served0} + "
                             f"{served2} and {served3} blocks")
    out["grown_blocks"] = grown
    out["t2_blocks_before_growth"] = swapped_at[0]
    # every served block a graph replay but the eager warm before each
    # capture: the start's (one each), the growth build's (off the pump),
    # and tuner 1's two recaptures on the pump
    for fe, off_pump in ((fe0, 1), (fe1, 1), (fe2, 2), (fe3, 1)):
        st = fe.graph_stats()
        log(f"  tuner {fe.uuid}: {fe.block_count} blocks served, graph "
            f"{st}, {fe.graph_kernels_per_block()} kernel nodes a replay")
        out[fe.uuid]["graph"] = st
        if st["replays"] != fe.block_count - (st["warms"] - off_pump):
            raise AssertionError(f"tuner {fe.uuid}: {st['replays']} replays "
                                 f"for {fe.block_count} blocks, "
                                 f"{st['warms']} warms")
    if (fe0.graph_stats()["captures"], fe2.pipeline.graph_captures) != (1, 1):
        raise AssertionError(
            f"captures: tuner 0 {fe0.graph_stats()}, the grown pipeline "
            f"{fe2.pipeline.graph_stats()} (one each: no recapture for a law "
            "change or a slot scatter, the growth's in its build)")
    if not (out[fe0.uuid]["realtime_factor_serving"] or 0) > 1:
        raise AssertionError("tuner 0 served below real time")
    lost = {fe.uuid: out[fe.uuid]["dropped_serving"] for fe in fes}
    if any(lost.values()):
        raise AssertionError(f"blocks dropped while serving: {lost}")
    lost = {fe.uuid: out[fe.uuid]["dropped_trace"] for fe in fes}
    if any(lost.values()):
        raise AssertionError(f"blocks dropped around /profile: {lost}")
    out["fused_tail_audio_tm_launches"] = launches["fused_tail_audio_tm"]
    results["server"] = out


SHARDED_BLOCKS = 8  # blocks through each sharded run
SHARDED_BOUND = 3e-6  # sharded against single-card audio (the FM flip rule)
MULTIHOST_CHANNELS = 2_048  # examples/multihost_pod.json's shape, widened
MULTIHOST_SECONDS = 5.0
TWO_PROC_CHANNELS = 1_024  # the gloo step
TWO_PROC_APP_CHANNELS = 16_384  # the live two-process app
TWO_PROC_TIMEOUT_S = 120
#: the two-process app's start, made uneven on purpose: rank 1 calls
#: app.start() this late (the start barrier absorbs it) and, once its
#: source runs, waits this long again before its warm, so both sources run
#: that long before the first round; rank 0's source ring holds
#: TWO_PROC_SHALLOW_RING blocks (the native default is 16), so at the first
#: round its ring has dropped more blocks than rank 1's
TWO_PROC_SKEW_S = 1.0
TWO_PROC_SHALLOW_RING = 8
#: rounds of (round, block index) a two-process app's rank prints
TWO_PROC_SERVED_SHOWN = 32
#: the gloo step's timed agreements (one all-reduce each)
AGREE_CALLS = 50
#: the card every virtual mesh repeats, and the multihost phase's backend
CARD = "cuda:0"
MULTIHOST_BACKEND = "nccl"


#: the /profile trace of the clocks phase, and the share of its blocks
#: that must be causally ordered against the card's kernels
CLOCK_TRACE_S = 2.0
CLOCK_GATE_SHARE = 0.99


def clock_gate(doc: dict) -> dict:
    """Lay a ``/profile`` trace's host tracks (``trace.HOST_PID``: each
    block's ``dispatch`` and ``fetch``, by block id) against its device
    kernels: a block's step is the kernels of the ``cudaGraphLaunch``
    (their ``correlation``) made inside the block's ``dispatch`` span.
    Counts the traced blocks (a step whose launch is in the trace), those
    whose launch falls in no dispatch span, and those causally ordered:
    the step's first kernel starts after its dispatch span starts and,
    where the block was fetched and the next block's step is traced, the
    fetch ends after that step's last kernel."""
    import bisect
    import collections

    from webradio_tpu_torch import trace

    events = doc["traceEvents"]
    host = [e for e in events if e.get("pid") == trace.HOST_PID
            and e.get("ph") == "X"]
    dispatch = sorted((e["ts"], e["ts"] + e["dur"], e["args"]["block"])
                      for e in host if e["name"] == "dispatch")
    fetched = {e["args"]["block"]: e["ts"] + e["dur"] for e in host
               if e["name"] == "fetch"}
    kernels = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e.get("args", {}).get("correlation")].append(
                (e["ts"], e["ts"] + e["dur"]))
    launches = [(e["ts"], e.get("args", {}).get("correlation"))
                for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name") == "cudaGraphLaunch"]
    starts = [d[0] for d in dispatch]
    step, unmatched = {}, 0
    for ts, corr in launches:
        ks = kernels.get(corr)
        if not ks:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i < 0 or ts > dispatch[i][1]:
            unmatched += 1
            continue
        step[dispatch[i][2]] = (dispatch[i][0], min(k[0] for k in ks),
                                max(k[1] for k in ks))
    ordered = fetch_checked = 0
    for bid, (d0, k0, _) in step.items():
        ok = k0 >= d0
        nxt = step.get(bid + 1)
        if ok and bid in fetched and nxt is not None:
            fetch_checked += 1
            ok = fetched[bid] >= nxt[2]
        ordered += ok
    traced = len(step) + unmatched
    return {"traced": traced, "unmatched": unmatched, "ordered": ordered,
            "fetch_checked": fetch_checked,
            "share": ordered / traced if traced else 0.0,
            "launches": len(launches), "host_events": len(host)}


def recorder_cost_us(consumers: int, n: int = 20_000, cards: int = 1) -> float:
    """The flight recorder's host microseconds a served block: the calls
    ``io.ring.BlockRing.put``, ``radio.FrontEnd.run_once`` (one block a
    call, its timing events and ``radio.read_steps``: a pair on one card,
    recorded around the block as ``HostPipeline.process_host`` does; on
    ``cards`` cards of a sharded front end a pair a card, recorded on each
    card's stream as ``parallel.graphs.BlockProgram.run`` does, and the
    launch span) and ``_fanout_worker`` make
    into it for one block, and ``AudioStreamManager.publish``'s counters
    for ``consumers`` consumers (their clock reads, drop checks and queue
    depths), timed in a loop of ``n`` blocks on a recorder of its own."""
    import collections
    import queue

    import torch

    from webradio_tpu_torch import trace
    from webradio_tpu_torch.radio import read_steps

    rec = trace.Recorder("cost")
    now = trace.now
    depths = queue.Queue(8).queue
    sharded = cards > 1
    streams = [torch.cuda.current_stream(d) for d in range(cards)]
    pending, free = collections.deque(), []

    def block(bid):
        rec.begin(bid, now(), 1)
        rec.got(bid, now(), 0, 1)
        c0, c1 = now(), now()
        pairs = free.pop() if free else [
            (stream, torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True)) for stream in streams]
        d0 = now()
        for k in (1, 2):  # before a card's first replay, after its last
            for pair in pairs:
                pair[k].record(pair[0])
        d1 = now()
        rec.dispatched(bid, c0, c1, d0, d1)
        if sharded:
            rec.launched(bid, d0, d1)
        pending.append((bid, pairs))
        read_steps(rec, pending, free, sharded)
        p0 = now()
        rec.published(bid, p0, now(), 64)
        h0, h1 = now(), now()
        rec.handed(bid, h0, h1, 0)
        picked, f0, f1 = now(), now(), now()
        encode = drops = deepest = 0
        for _ in range(consumers):  # a mount a consumer, as in the cells
            e0 = now()
            encode += now() - e0
            before = drops
            drops += before != drops
            depth = len(depths)
            if depth > deepest:
                deepest = depth
        rec.delivered(bid, picked, f0, f1, 1, f1, now(), encode,
                      consumers, drops, deepest)

    for bid in range(100):  # the events made first
        block(bid)
    for d in range(cards):
        torch.cuda.synchronize(d)
    t0 = time.perf_counter_ns()
    for bid in range(100, 100 + n):
        block(bid)
    return (time.perf_counter_ns() - t0) / n / 1e3


def phase_clocks(results):
    """The recorder's clocks against the card's (see the module
    docstring, phase 13b)."""
    import pathlib
    import shutil
    import tempfile

    import torch

    from webradio_tpu_torch import app as tapp
    from webradio_tpu_torch import trace
    from webradio_tpu_torch.radio import Radio

    trace.clear()  # the earlier phases' front ends
    work = pathlib.Path(tempfile.mkdtemp(prefix="webradio_clocks_"))
    tuner = {"driver": "tone", "centre_frequency": 124_325_000,
             "sample_rate": SAMPLE_RATE, "block_frames": BLOCK_FRAMES}
    app = tapp.RadioApp({
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [dict(tuner, capacity=WIDE_CHANNELS, engine="auto")],
        "receivers": [{"tuner": 0, "if_frequency": 0, "demodulator": "AM",
                       "audio_sink": f"file:{work / 'rx.wav'}"}]})
    try:
        if not app.start():
            raise AssertionError("the clocks phase's server did not start")
        fe = app.front_ends[0]
        port = app.server.port
        deadline = time.monotonic() + 60
        while fe.block_count < 10:
            if time.monotonic() > deadline or app.failed is not None:
                raise AssertionError(f"no blocks served: {app.failed}")
            time.sleep(0.05)
        trace_dir = str(work / "trace")
        status, _ = http_call(port, "POST", "/profile",
                              {"action": "start", "dir": trace_dir})
        time.sleep(CLOCK_TRACE_S)
        status2, data = http_call(port, "POST", "/profile",
                                  {"action": "stop"})
        if (status, status2) != (200, 200):
            raise AssertionError(f"/profile failed: {data[:500]}")
        summary = json.loads(http_call(port, "GET", "/status")[1])[
            "front_ends"][fe.uuid]["trace"]
    finally:
        app.close()
        Radio.reset()
    doc = json.loads((pathlib.Path(trace_dir) / "trace.json").read_text())
    shutil.rmtree(work, ignore_errors=True)
    gate = clock_gate(doc)
    log(f"  /profile trace of {CLOCK_TRACE_S:.0f} s: {gate['traced']} "
        f"traced blocks ({gate['launches']} graph launches, "
        f"{gate['host_events']} host spans), {gate['ordered']} causally "
        f"ordered ({100 * gate['share']:.2f}%; fetch checked on "
        f"{gate['fetch_checked']}), {gate['unmatched']} launches in no "
        f"dispatch span")
    log(f"  /status trace over the last blocks: {json.dumps(summary)}")
    results["clock_gate"] = gate
    results["clock_status_trace"] = summary
    cost = {k: recorder_cost_us(k) for k in (0, 8, 64)}
    cards = min(4, torch.cuda.device_count())
    if cards > 1:  # a sharded front end's pairs, steps and launch span
        cost[f"8 on {cards} cards"] = recorder_cost_us(8, cards=cards)
    log(f"  the recorder's host cost a block (its calls of one block in a "
        f"loop; by consumers pushed): " + ", ".join(
            f"{k}: {v:.2f} us" for k, v in cost.items()))
    results["recorder_cost_us"] = cost
    if gate["traced"] < 10 or gate["share"] < CLOCK_GATE_SHARE:
        raise AssertionError(f"the host's and the card's clocks disagree: "
                             f"{gate}")


def virtual_mesh(t: int, c: int):
    """A ``(t, c)`` mesh whose every position is the one card."""
    from webradio_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(t, c, [CARD] * (t * c))


def sharded_run(cfg, params, mesh, blocks, graph: bool = True):
    """``blocks`` through ``ShardedChannelizedFrontEnd.process_host``; the
    audio ``[t, C]`` on the host (each block's pieces joined as it is
    handed back: a graph replay rewrites them two blocks on) and the front
    end."""
    import torch
    from webradio_tpu_torch.parallel.sharded_channelized import (
        ShardedChannelizedFrontEnd,
    )

    fe = ShardedChannelizedFrontEnd(cfg, params, mesh, graph=graph)
    outs = []
    for b in blocks + [None]:
        out = fe.process_host(b) if b is not None else fe.flush()
        if out is not None:
            outs.append((out[0].full().T, out[1].clone()))
    torch.cuda.synchronize()
    audio = torch.cat([a for a, _ in outs]).cpu()
    if tuple(audio.shape) != (len(blocks) * cfg.audio_frames,
                              cfg.num_channels):
        raise AssertionError(f"sharded audio shape {tuple(audio.shape)}")
    if not bool(torch.isfinite(audio).all()):
        raise AssertionError("non-finite sharded audio")
    db = outs[-1][1]
    if db.shape != (cfg.fft_size,) or not bool(torch.isfinite(db).all()):
        raise AssertionError("sharded spectrum row not finite")
    return audio, fe


def sharded_turn(cfg, params, mesh, blocks, graph: bool) -> dict:
    """One sharded front end, on graphs or eager: the blocks' audio (kernel
    #1 once a shard a block), back-to-back ms/block, and a profiled window
    (busy, idle share, launch calls a block, kernel events against the
    replays' kernel nodes)."""
    tag = (f"sharded {tuple(mesh.shape.values())} C={cfg.num_channels} "
           f"{'graph' if graph else 'eager'}")
    reset_counts()
    audio, fe = sharded_run(cfg, params, mesh, blocks, graph)
    expect_counts(tag, fused_tail_audio_tm=mesh.size * len(blocks))
    ms = stream_ms(cfg, params, blocks, TIMED_BLOCKS, pipe=fe)
    prof = device_profile(lambda i: fe.process_host(blocks[i % len(blocks)]),
                          4, mark=lambda: graph_kernels([fe]))
    seen = expect_kernel_events(f"{tag} window", prof, 4,
                                window_expected(prof) if graph else 0)
    calls = prof["launch_calls_per_block"]
    log(f"  {tag}: back to back {ms:.3f} ms/block, busy {prof['busy']:.3f} "
        f"ms/block, idle {prof['idle']:.3f}, launch calls {calls:.1f} a "
        f"block; graphs {fe.graph_stats()}, "
        f"{fe.graph_kernels_per_block()} kernel nodes a block")
    if graph and calls != 1:
        raise AssertionError(f"{tag}: {calls} launch calls a block, not one")
    return {"audio": audio, "fe": fe, "back_to_back_ms": ms,
            "busy_ms_per_block": prof["busy"], "idle_share": prof["idle"],
            "launch_calls_per_block": calls,
            "api_per_block": prof["api_per_block"], "window_kernels": seen,
            "graph": fe.graph_stats(),
            "kernel_nodes_per_block": fe.graph_kernels_per_block(),
            "top": prof["top"]}


def phase_sharded(dev, results, kernels):
    """The sharded engines on virtual meshes of the one card (every
    position on ``cuda:0``): four shards on one card, so a check and a
    measurement of the sharded code, not of scaling."""
    import dataclasses

    import torch
    from webradio_tpu_torch.entry import dryrun_multichip
    from webradio_tpu_torch.ops.nco import nco_mix_tm_fast
    from webradio_tpu_torch.parallel import sharded as tsh
    from webradio_tpu_torch.parallel import sharded_channelized as tsc
    from webradio_tpu_torch.pipeline import channelized as ch
    from webradio_tpu_torch.pipeline import frontend as tfe
    from webradio_tpu_torch.pipeline import state as tstate
    from webradio_tpu_torch.pipeline import stream

    t_start = time.perf_counter()
    out = {}
    c = WIDE_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=dev)
    blocks = tone_blocks(SHARDED_BLOCKS, seed=13)
    mesh = virtual_mesh(2, 2)
    nd_local = cfg.chan_frames // 2
    if not tsc._tm_uses_kernel(cfg, nd_local, c // 2, params):
        raise AssertionError("the (2, 2) mesh's shards do not take #1")
    ref, _, _ = run_pipeline(cfg, params, blocks)
    single_ms = stream_ms(cfg, params, blocks, TIMED_BLOCKS)
    release()
    # graph and eager in turns: graph, eager, eager, graph
    turns = []
    for g in (True, False, False, True):
        turn = sharded_turn(cfg, params, mesh, blocks, g)
        audio = turn.pop("audio")
        if not turns:
            first = audio
            hear_tones("sharded_", cfg, audio, modes, results)
            against(f"sharded (2, 2) vs single card, C={c}", audio, ref,
                    params, results, "sharded_vs_single", SHARDED_BOUND)
        elif not torch.equal(audio, first):
            diff = float((audio - first).abs().max())
            raise AssertionError(f"sharded {'graph' if g else 'eager'} turn "
                                 f"differs from the first graph turn by "
                                 f"{diff:.3e}")
        turns.append(turn)
        fe = turn.pop("fe")
        if len(turns) < 4:
            del fe
            release()
    log(f"  graph against eager at C={c} on (2, 2): audio bit-equal in "
        f"every turn; single card {single_ms:.3f} ms/block")

    # (4, 1): time shards of 2,560 rows, off the JAX kernel's 1,024-row
    # tile, so the JAX rule ran the plain tail there; kernel #1 on each
    # shard now, on graphs and against the eager stages and the single card
    mesh41 = virtual_mesh(4, 1)
    if not tsc._tm_uses_kernel(cfg, cfg.chan_frames // 4, c, params):
        raise AssertionError("the (4, 1) mesh's shards do not take #1")
    runs41 = {}
    for g in (True, False):
        reset_counts()
        audio41, fe41 = sharded_run(cfg, params, mesh41, blocks, g)
        expect_counts(f"sharded (4, 1) {'graph' if g else 'eager'}",
                      fused_tail_audio_tm=4 * len(blocks))
        ms41 = stream_ms(cfg, params, blocks, TIMED_BLOCKS, pipe=fe41)
        runs41[g] = (audio41, ms41, fe41.graph_stats())
        del fe41
        release()
    if not torch.equal(runs41[True][0], runs41[False][0]):
        raise AssertionError("sharded (4, 1): the graphs differ from the "
                             "eager stages")
    against(f"sharded (4, 1) vs single card, C={c}", runs41[True][0], ref,
            params, results, "sharded_41_vs_single", SHARDED_BOUND)
    log(f"  (4, 1) on graphs {runs41[True][1]:.3f} ms/block, eager "
        f"{runs41[False][1]:.3f} (bit-equal), graph {runs41[True][2]}")
    out["mesh_4x1"] = {"graph_ms_per_block": runs41[True][1],
                       "eager_ms_per_block": runs41[False][1],
                       "graph": runs41[True][2],
                       "launches_per_block": 4}
    del ref, first, audio, runs41, audio41
    # the halo recompute timed alone on one shard
    p0 = fe.mesh.local_positions[0]
    prm = fe._placed[p0]
    iq0 = torch.from_numpy(blocks[0][:, :BLOCK_FRAMES // 2]).to(dev)
    y2, _, _ = ch._channelize_tm(cfg, prm, fe.state[p0].pfb_hist, iq0,
                                 split=False)
    phase = fe.state[p0].nco_phase
    # the recompute's own device time (its ~50 small launches cost the
    # host more than the card, so CUDA events around them read the host)
    rprof = device_profile(lambda i: tsc._tail_rows(
        cfg, prm, nco_mix_tm_fast, y2, phase, c // 2), 20)
    expect_kernel_events("halo recompute window", rprof, 20)
    recompute_ms = rprof["busy"]
    busy = statistics.median(t["busy_ms_per_block"] for t in turns
                             if t["graph"]["replays"])
    share = 4 * recompute_ms / busy if busy else None
    log(f"  the halo recompute: {recompute_ms:.4f} device ms a shard "
        f"({rprof['kernels'] / 20:.0f} kernels), {4 * recompute_ms:.4f} a "
        f"block" + (f" ({100 * share:.2f}% of the graphs' busy)"
                    if share else ""))
    modes_of = ["graph" if t["graph"]["replays"] else "eager" for t in turns]
    out.update(channels=c, mesh=[2, 2], single_ms_per_block=single_ms,
               turns=[dict(t, mode=m) for t, m in zip(turns, modes_of)],
               sharded_ms_per_block={
                   m: [t["back_to_back_ms"] for t, n in zip(turns, modes_of)
                       if n == m] for m in ("graph", "eager")},
               recompute_ms_per_shard=recompute_ms, recompute_share=share)
    del fe, y2, iq0

    # u8exact at the full width, on 8-bit-grid blocks
    cfg_u = dataclasses.replace(cfg, pfb_precision="u8exact")
    params_u = ch.make_channelized_params(cfg_u, ifs, 80_000, 8_000, modes,
                                          device=dev)
    ub = u8_blocks(4, seed=14)
    ref_u, _, _ = run_pipeline(cfg_u, params_u, ub)
    reset_counts()
    audio_u, _ = sharded_run(cfg_u, params_u, mesh, ub)
    expect_counts("sharded u8exact", fused_tail_audio_tm=4 * len(ub))
    against(f"sharded u8exact vs single card, C={c}", audio_u, ref_u,
            params_u, results, "sharded_u8exact_vs_single", SHARDED_BOUND)
    del audio_u, ref_u, params_u

    # path (b)'s 9.6 kHz audio on a (1, 2) mesh: kernel #2 per shard
    cfg_b = ch.ChannelizedConfig(num_channels=MAIN_CHANNELS,
                                 audio_rate=9_600, block_frames=256_000)
    ifs_b, modes_b = slot_controls(MAIN_CHANNELS)
    params_b = ch.make_channelized_params(cfg_b, ifs_b, 80_000, 8_000,
                                          modes_b, device=dev)
    blocks_b = tone_blocks(4, seed=4, block_frames=cfg_b.block_frames)
    ref_b, _, _ = run_pipeline(cfg_b, params_b, blocks_b)
    reset_counts()
    audio_b, _ = sharded_run(cfg_b, params_b, virtual_mesh(1, 2), blocks_b)
    expect_counts("sharded (b) (1, 2)", fused_tail_tm=2 * len(blocks_b))
    hear_tones("sharded_b_", cfg_b, audio_b, modes_b, results)
    against("sharded (b) vs single card", audio_b, ref_b, params_b, results,
            "sharded_b_vs_single", SHARDED_BOUND)

    # (the per-channel body, slots off the shared FIR kernels, is
    # phase_sharded_channel's)

    # the direct engine at the entry's C=16 against FrontEndPipeline
    cfg_d = tstate.ChainConfig(num_channels=16, block_frames=BLOCK_FRAMES)
    ifs_d = [0, 100_000] + [(i - 8) * 100_000 for i in range(2, 16)]
    modes_d = ["AM", "FM"] + ["USB", "LSB", "AM", "FM"] * 3 + ["USB", "LSB"]
    params_d = tstate.make_receiver_params(cfg_d, ifs_d, 80_000, 8_000,
                                           modes_d, device=dev)
    blocks_d = tone_blocks(4, seed=15)
    pipe = tfe.FrontEndPipeline(cfg_d, params_d)
    ref_d = torch.cat([pipe.process_host_sync(b)[0].clone()
                       for b in blocks_d], dim=1)
    got_d = {}
    for g in (True, False):
        fe_d = tsh.ShardedFrontEnd(cfg_d, params_d, virtual_mesh(2, 2),
                                   graph=g)
        got_d[g] = torch.cat([fe_d.process(b)[0].full() for b in blocks_d],
                             dim=1)
        if g and fe_d.graph_stats()["replays"] != len(blocks_d) - 1:
            raise AssertionError(f"direct sharded graphs: "
                                 f"{fe_d.graph_stats()}")
    if not torch.equal(got_d[True], got_d[False]):
        raise AssertionError("the direct sharded engine's graphs differ from "
                             "its eager stages")
    against("direct sharded (2, 2) on graphs vs FrontEndPipeline, C=16",
            got_d[True].T.cpu(), ref_d.T.cpu(), params_d.rx, results,
            "sharded_direct_vs_single", SHARDED_BOUND)

    # run_capture_sharded against run_capture_channelized and its eager
    # loop; a second call replays the kept front end's graphs
    cap = tone_blocks(SHARDED_BLOCKS + 1, seed=16)
    iq = torch.from_numpy(np.concatenate(
        cap[:-1] + [cap[-1][:, :BLOCK_FRAMES // 3]], axis=1)).to(dev)
    tsc.KEPT.clear()
    reset_counts()
    _, audio_s, latest_s = tsc.run_capture_sharded(cfg, params, mesh, iq)
    torch.cuda.synchronize()
    expect_counts("run_capture_sharded",
                  fused_tail_audio_tm=4 * SHARDED_BLOCKS)
    capture_ms = {}
    for g in (True, False):
        t0 = time.perf_counter()
        _, again, _ = tsc.run_capture_sharded(cfg, params, mesh, iq, graph=g)
        torch.cuda.synchronize()
        capture_ms["graph" if g else "eager"] = (
            1e3 * (time.perf_counter() - t0) / SHARDED_BLOCKS)
        if not torch.equal(again, audio_s):
            raise AssertionError(f"run_capture_sharded (graph={g}) differs "
                                 f"from its first call")
        del again
    (kept,) = [f for k, f in tsc.KEPT.entries.items() if k[2]]
    if kept.graph_stats()["captures"] != 1 or kept.graph_stats()[
            "replays"] != 2 * SHARDED_BLOCKS - 1:
        raise AssertionError(f"the kept front end captured again: "
                             f"{kept.graph_stats()}")
    del kept
    tsc.KEPT.clear()
    _, audio_1, latest_1 = stream.run_capture_channelized(cfg, params, iq)
    stream.KEPT.clear()
    if audio_s.shape != audio_1.shape or latest_s.shape != latest_1.shape:
        raise AssertionError("run_capture_sharded's shapes")
    against("run_capture_sharded vs run_capture_channelized",
            audio_s.T.cpu(), audio_1.T.cpu(), params, results,
            "capture_sharded_vs_single", SHARDED_BOUND)
    lat = float((latest_s - latest_1).abs().max() / latest_1.abs().max())
    if not lat <= 1e-5:
        raise AssertionError(f"latest spectra differ by {lat:.2e} of peak")
    log(f"  run_capture_sharded, second call (kept front end) ms/block: "
        f"{capture_ms}; bit-equal to its eager loop")
    out["capture_ms_per_block"] = capture_ms
    del audio_s, audio_1, iq

    # the dry run on a 4-position virtual mesh: the kernels on the card
    reset_counts()
    errs = dryrun_multichip(4, devices=[dev] * 4)
    # #1 twice single-card at C=4 (the card's rule takes it at any width)
    # and at C=256, and four shards twice at C=256; #4 four shards twice at
    # C=4: that run's time shards of 320 rows hold no Toeplitz tile, so
    # they take the per-channel body, on #4 since it was ported to the
    # sharded engine (they ran the plain stage body before)
    expect_counts("dryrun_multichip(4)", fused_tail_audio_tm=12,
                  fused_receiver_tail=8)
    log(f"  dryrun_multichip(4): {json.dumps(errs)}")
    out["dryrun"] = errs
    out["wall_s"] = time.perf_counter() - t_start
    log(f"  sharded phase: {out['wall_s']:.1f} s")
    results["sharded"] = out


SHARDED_CHANNEL_BLOCKS = 4  # blocks through each per-channel sharded run


def phase_sharded_channel(dev, results, kernels):
    """The sharded engine's per-channel body on kernel #4 (slots whose
    bandwidths differ), on virtual meshes of the one card:

    - (2, 2) at C=1,024, one 40 kHz slot: #4 once a shard a block, graph
      and eager bit-equal, against the single card's #4 fallback (3e-6,
      the FM flip rule), tones heard;
    - (4, 1) at C=16,384 with the server's mixed bandwidths (one 12.5 kHz
      slot): #4 at the shards' shape (2,560 rows: a partial last chunk)
      against its plain version and timed; the body on graphs, #4 four
      times a block, against the single card's #4 fallback, and the plain
      stage body (``tail_kernel="xla"``) on graphs, both ms/block;
    - one live front end on graphs at C=1,024 on (2, 2) goes uniform ->
      mixed -> uniform (#1, #4, #1 on every shard), its history converted
      at each switch: the audio and, after every block, the carried
      history (in the single card's domain) within 3e-6 and 1e-6 of a unit
      peak of a single-card pipeline's through the same switches."""
    import dataclasses

    import torch
    from webradio_tpu_torch.ops import tail
    from webradio_tpu_torch.parallel import sharded_channelized as tsc
    from webradio_tpu_torch.pipeline import channelized as ch

    t_start = time.perf_counter()
    out = {}
    n = SHARDED_CHANNEL_BLOCKS
    # ---- (2, 2) at C=1,024
    c = MAIN_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    ifs, modes = slot_controls(c)
    ifbw = [80_000, 40_000] + [80_000] * (c - 2)
    params = ch.make_channelized_params(cfg, ifs, ifbw, 8_000, modes,
                                        device=dev)
    blocks = tone_blocks(n, seed=18)
    mesh = virtual_mesh(2, 2)
    reset_counts()
    ref, _, _ = run_pipeline(cfg, params, blocks)
    expect_counts("single card, one 40 kHz slot", fused_receiver_tail=n)
    body = {}
    for g in (True, False):
        reset_counts()
        body[g] = sharded_run(cfg, params, mesh, blocks, g)
        expect_counts(f"sharded per-channel body (2, 2) "
                      f"{'graph' if g else 'eager'}",
                      fused_receiver_tail=4 * n)
    fe = body[True][1]
    if (fe.time_major or not fe.carries_raw() or fe.plain_tail is not None
            or fe.graph_stats()["replays"] != n - 1):
        raise AssertionError(f"the per-channel body on graphs: "
                             f"{fe.graph_stats()}, plain {fe.plain_tail}")
    if not torch.equal(body[True][0], body[False][0]):
        raise AssertionError("the per-channel body's graphs differ from its "
                             "eager stages")
    hear_tones("sharded_channel_", cfg, body[True][0], modes, results)
    against(f"sharded per-channel body (2, 2) on graphs vs the single "
            f"card's #4 fallback, C={c}", body[True][0], ref, params,
            results, "sharded_stage_vs_single", SHARDED_BOUND)
    del body, fe, ref
    release()

    # ---- (4, 1) at C=16,384, the server's mixed bandwidths
    cw = WIDE_CHANNELS
    cfg_w = ch.ChannelizedConfig(num_channels=cw, block_frames=BLOCK_FRAMES)
    ifs_w, modes_w, ifbw_w = mixed_controls(cw)
    params_w = ch.make_channelized_params(cfg_w, ifs_w, ifbw_w, 8_000,
                                          modes_w, device=dev)
    blocks_w = tone_blocks(n, seed=19)
    nd_local = cfg_w.chan_frames // 4
    # #4 at the shards' shape against its plain version
    rng = np.random.default_rng(20)
    u = lambda *s: torch.from_numpy(
        rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(dev)
    step = params_w.residual_step
    args = (u(2, cw, nd_local), torch.from_numpy(
        rng.integers(0, 2**31, cw)).to(dev), step, params_w.chan_coeff,
        params_w.mode, u(2, cw, 63), u(2, cw))
    got = tail.fused_receiver_tail(*args)
    torch.cuda.synchronize()
    ref4 = tail.fused_receiver_tail_ref(*args)
    names = ("audio", "raw_hist", "demod_prev", "power")
    bounds = dict(BOUNDS, audio=BOUNDS["audio_hist"], raw_hist=0.0)
    devs = compare(f"#4 at a (4, 1) shard's shape (nd={nd_local}, C={cw})",
                   names, bounds, (got[0].T, *got[1:]),
                   (ref4[0].T, *ref4[1:]), params_w.mode == 1, RAW_FM_STEP,
                   raw=("audio",))
    shard_ms = cuda_ms(lambda: tail.fused_receiver_tail(*args), 10)
    shard_plain_ms = cuda_ms(lambda: tail.fused_receiver_tail_ref(*args), 2)
    bound, by = roofline(tail_flops(nd_local, cw, 64), io_bytes(args, got))
    log(f"  #4 at nd={nd_local}, C={cw}: {shard_ms:.4f} ms (plain "
        f"{shard_plain_ms:.4f}, bound {bound:.4f} ms by {by})")
    out["kernel4_shard"] = {"nd": nd_local, "channels": cw, "ms": shard_ms,
                            "plain_ms": shard_plain_ms, "bound_ms": bound,
                            "bound_by": by, "max_abs_err": devs["worst"]}
    del args, got, ref4
    reset_counts()
    ref_w, _, _ = run_pipeline(cfg_w, params_w, blocks_w)
    expect_counts(f"single card C={cw} mixed", fused_receiver_tail=n)
    single_ms = stream_ms(cfg_w, params_w, blocks_w, n)
    runs = {}
    for name, conf in (("kernel", cfg_w),
                       ("plain", dataclasses.replace(cfg_w,
                                                     tail_kernel="xla"))):
        reset_counts()
        audio_w, fe_w = sharded_run(conf, params_w, virtual_mesh(4, 1),
                                    blocks_w)
        if name == "kernel":
            expect_counts(f"sharded (4, 1) C={cw} mixed, #4",
                          fused_receiver_tail=4 * n)
            kernels["fused_receiver_tail"]["launches_sharded"] = 4 * n
            if not fe_w.carries_raw() or fe_w.plain_tail is not None:
                raise AssertionError("(4, 1): the shards do not take #4")
        else:
            expect_counts(f"sharded (4, 1) C={cw} mixed, plain stage body")
        ms_w = stream_ms(conf, params_w, blocks_w, 2 * n, pipe=fe_w)
        runs[name] = (audio_w, ms_w, fe_w.graph_stats())
        del fe_w
        release()
    against(f"sharded (4, 1) per-channel body vs the single card's #4 "
            f"fallback, C={cw}", runs["kernel"][0], ref_w, params_w,
            results, "sharded_channel_41_vs_single", SHARDED_BOUND)
    against(f"sharded (4, 1) #4 body vs the plain stage body, C={cw}",
            runs["kernel"][0], runs["plain"][0], params_w, results,
            "sharded_channel_41_vs_plain")
    log(f"  (4, 1) C={cw} mixed bandwidths on graphs: #4 body "
        f"{runs['kernel'][1]:.3f} ms/block, plain stage body "
        f"{runs['plain'][1]:.3f}; single card (#4 fallback) "
        f"{single_ms:.3f}; graphs {runs['kernel'][2]}")
    out["mesh_4x1_mixed"] = {
        "channels": cw, "kernel_ms_per_block": runs["kernel"][1],
        "plain_ms_per_block": runs["plain"][1],
        "single_card_ms_per_block": single_ms,
        "graph": runs["kernel"][2], "launches_per_block": 4}
    del runs, ref_w, audio_w, params_w
    release()

    # ---- a live switch on the sharded engine, against the single card's
    ifs_s, modes_s, ifbw_s = mixed_controls(c)
    uniform = ch.make_channelized_params(cfg, ifs_s, 80_000, 8_000, modes_s,
                                         device=dev)
    mixed = ch.make_channelized_params(cfg, ifs_s, ifbw_s, 8_000, modes_s,
                                       device=dev)
    blocks_s = tone_blocks(3 * SWITCH_BLOCKS, seed=34)
    fe = tsc.ShardedChannelizedFrontEnd(cfg, uniform, mesh)
    pipe = ch.ChannelizedPipeline(cfg, uniform)
    reset_counts()
    audio, ref, hist_err, raw, peak = [], [], [], [], 1.0
    for k, b in enumerate(blocks_s):
        if k and k % SWITCH_BLOCKS == 0:
            new = mixed if k == SWITCH_BLOCKS else uniform
            fe.update_params(new)
            pipe.update_params(new)
        a = fe.process_host(b)
        if a is not None:
            audio.append(a[0].full().T.cpu())
        r = pipe.process_host(b)
        if r is not None:
            ref.append(r[0].cpu())
        got_h = fe.gathered_state().chan_hist
        ref_h = pipe.state.chan_hist
        peak = max(peak, float(ref_h.abs().max()))
        hist_err.append(float((got_h - ref_h).abs().max()))
        raw.append(fe.carries_raw())
    for src, dst in ((fe, audio), (pipe, ref)):
        last = src.flush()
        dst.append((last[0].full().T if src is fe else last[0]).cpu())
    launches = {k: f.launches for k, f in tail_wrappers().items()
                if f.launches}
    s = SWITCH_BLOCKS
    want = {"fused_tail_audio_tm": (4 + 1) * 2 * s,
            "fused_receiver_tail": (4 + 1) * s}
    if raw != [False] * s + [True] * s + [False] * s or launches != want:
        raise AssertionError(f"sharded switch: raw {raw}, launches "
                             f"{launches}, expected {want}")
    log(f"  sharded switch: carried history against the single card's "
        f"after each block (peak {peak:.3f}): "
        + ", ".join(f"{e:.2e}" for e in hist_err))
    if not max(hist_err) <= 1e-6 * peak:
        raise AssertionError(f"sharded switch: the carried history is "
                             f"{max(hist_err):.3e} off the single card's")
    against("sharded uniform -> mixed -> uniform vs the single card's",
            torch.cat(audio), torch.cat(ref), uniform, results,
            "sharded_switch_vs_single", SHARDED_BOUND)
    out["switch"] = {"hist_err_per_block": hist_err, "launches": launches,
                     "graph": fe.graph_stats()}
    del fe, pipe
    out["wall_s"] = time.perf_counter() - t_start
    log(f"  sharded per-channel phase: {out['wall_s']:.1f} s")
    results["sharded_channel"] = out


def phase_accuracy(dev, results):
    """``bench_torch.py --accuracy`` on the card (C=128, 33 SNRs against
    the float64 reference) through kernel #1 (once a step, 33 launches) and
    through the plain tail (``tail_kernel="xla"``): every key of #1 at
    least the JAX law's less 0.5 dB (``bench_torch.JAX_LAW_SNR_DB``, the
    tier rule) and within 0.5 dB of the plain tail's."""
    import bench_torch

    t0 = time.perf_counter()
    reset_counts()
    acc = bench_torch.accuracy(dev)
    steps = 3 * len(bench_torch.ACCURACY_PAIRS)
    expect_counts("--accuracy through #1", fused_tail_audio_tm=steps)
    reset_counts()
    plain = bench_torch.accuracy(dev, tail_kernel="xla")
    expect_counts("--accuracy through the plain tail")
    keys = sorted(bench_torch.JAX_LAW_SNR_DB)
    off_plain = {k: [acc[k], plain[k]] for k in keys
                 if acc[k] < plain[k] - bench_torch.LAW_SLACK_DB}
    log(f"  --accuracy ({time.perf_counter() - t0:.1f} s), #1 / plain / "
        f"JAX law (dB): " + ", ".join(
            f"{k} {acc[k]} / {plain[k]} / {bench_torch.JAX_LAW_SNR_DB[k]}"
            for k in keys))
    results["accuracy"] = {"kernel": acc, "plain": plain}
    if acc["below_jax_law"] or off_plain:
        raise AssertionError(f"--accuracy through #1: below the JAX law "
                             f"less {bench_torch.LAW_SLACK_DB} dB "
                             f"{acc['below_jax_law']}, below the plain "
                             f"tail's less 0.5 dB {off_plain}")


def phase_multihost(results):
    """``RadioApp`` with a multihost sharded tuner in this process: a
    process group of one on NCCL (the control broadcast and the gathers run
    NCCL on the card) and a (1, 4) virtual mesh of the card (the server's
    ``visible_devices`` replaced in-process), capacity MULTIHOST_CHANNELS:
    each shard holds 512 channels and takes kernel #1."""
    import tempfile

    import torch
    import torch.distributed as dist
    from webradio_tpu_torch import app as tapp
    from webradio_tpu_torch.parallel import mesh as pmesh
    from webradio_tpu_torch.radio import Receiver

    t_start = time.perf_counter()
    saved = pmesh.visible_devices
    pmesh.visible_devices = lambda device=None: [torch.device(CARD)] * 4
    rdv = tempfile.mkdtemp(prefix="webradio_pg_")
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "distributed": {"coordinator": f"file://{rdv}/rendezvous",
                        "num_processes": 1, "process_id": 0,
                        "backend": MULTIHOST_BACKEND},
        "tuners": [{"driver": "tone", "centre_frequency": 124_325_000,
                    "sample_rate": SAMPLE_RATE, "block_frames": BLOCK_FRAMES,
                    "capacity": MULTIHOST_CHANNELS, "engine": "sharded",
                    "multihost": True}],
        "receivers": [
            {"tuner": 0, "if_frequency": 100_000, "demodulator": "FM"},
            {"tuner": 0, "if_frequency": 0, "demodulator": "AM"}],
    }
    reset_counts()
    app = tapp.RadioApp(config)
    out = {}
    try:
        if not app.start():
            raise AssertionError("the multihost server did not start")
        fe = app.front_ends[0]
        port = app.server.port
        mesh = fe.pipeline.mesh
        log(f"  up: process group {dist.get_backend()} of "
            f"{dist.get_world_size()}, mesh {mesh.shape}, "
            f"{type(fe.tuner.source).__name__}")
        if (dist.get_backend() != MULTIHOST_BACKEND or mesh.shape !=
                {"time": 1, "chan": 4}):
            raise AssertionError("not NCCL on a (1, 4) mesh")
        warm = 1  # _start_multihost's zero block

        def wait_blocks(n):
            deadline = time.monotonic() + 30
            while fe.block_count < n:
                if time.monotonic() > deadline or app.failed is not None:
                    raise AssertionError(f"multihost pump: {app.failed}")
                time.sleep(0.02)

        wait_blocks(5)
        served_from, drops0 = fe.block_count, PumpWatch.dropped(fe)
        t_served = time.monotonic()
        # fill every slot in one round: a burst the blob carries in
        # several NCCL broadcasts, applied as one slot scatter
        ifs, modes = slot_controls(MULTIHOST_CHANNELS)
        t0 = time.perf_counter()
        for i in range(2, MULTIHOST_CHANNELS):
            rx = Receiver()
            rx.update(if_frequency=ifs[i], demodulator=modes[i])
            rx.set_front_end(fe)
        round0 = fe._mh_round
        wait_blocks(fe.block_count + 3)
        log(f"  {MULTIHOST_CHANNELS - 2} receivers attached in "
            f"{1e3 * (time.perf_counter() - t0):.0f} ms; rounds "
            f"{round0} -> {fe._mh_round}")
        st, body = http_call(port, "POST", "/receivers", {
            "tuner": f"/tuners/{fe.uuid}", "if_frequency": 50_000,
            "demodulator": "AM"})
        log(f"  POST past capacity: {st} {body[:120]!r}")
        if st != 409:
            raise AssertionError(f"POST past capacity answered {st}")
        st, body = http_call(port, "GET", "/status")
        status = json.loads(body)["front_ends"][fe.uuid]
        if st != 200 or status["channel_capacity"] != MULTIHOST_CHANNELS:
            raise AssertionError(f"/status: {st} {status}")
        http_call(port, "GET", f"/tuners/{fe.uuid}/waterfall")  # turn on
        wait_blocks(fe.block_count + 3)
        check_waterfall(port, fe, results)
        fm_rx, am_rx = app.receivers[:2]
        hear_all(port, {"FM": (fm_rx.uuid, 440.0)}, 48_000, results,
                 "multihost_")
        st, _ = http_call(port, "PUT", f"/receivers/{fm_rx.uuid}",
                          {"if_frequency": 0, "demodulator": "AM"})
        if st not in (200, 204):
            raise AssertionError(f"PUT answered {st}")
        wait_blocks(fe.block_count + 3)
        hear_all(port, {"retuned AM": (fm_rx.uuid, 1_000.0)}, 48_000,
                 results, "multihost_")
        while time.monotonic() < t_served + MULTIHOST_SECONDS:
            time.sleep(0.05)
        blocks = fe.block_count - served_from
        elapsed = time.monotonic() - t_served
        drops = PumpWatch.dropped(fe) - drops0
        samples = fe.step_samples
        step_ms = fe.trace.latest("step_ns") / 1e6
        served = fe.block_count
        graphs = fe.pipeline.graph_stats()
        nodes = fe.pipeline.graph_kernels_per_block()
    finally:
        app.close()
        pmesh.visible_devices = saved
        if dist.is_initialized():
            dist.destroy_process_group()
    launches = tail_wrappers()["fused_tail_audio_tm"].launches
    log(f"  served {blocks} blocks in {elapsed:.2f} s (throughput "
        f"{blocks * BLOCK_MS / 1e3 / elapsed:.3f}), {drops} dropped; last "
        f"step {step_ms:.2f} ms on the card ({samples} blocks read); "
        f"kernel #1 launches {launches} for {fe.block_count} blocks + "
        f"{warm} warm")
    log(f"  graphs: {graphs}, {nodes} kernel nodes a block")
    if drops:
        raise AssertionError(f"the multihost pump dropped {drops} blocks")
    # the warm captured once; every block served since was replays
    if graphs["captures"] != 1 or graphs["replays"] < served:
        raise AssertionError(f"the multihost pump's blocks were not graph "
                             f"replays of one capture: {graphs} for "
                             f"{served} blocks")
    if launches != 4 * (fe.block_count + warm):
        raise AssertionError("kernel #1 did not run on every shard of every "
                             "block")
    out.update(channels=MULTIHOST_CHANNELS, blocks=blocks,
               elapsed_s=elapsed, drops=drops, launches=launches,
               throughput=blocks * BLOCK_MS / 1e3 / elapsed,
               last_step_ms=step_ms, graph=graphs,
               wall_s=time.perf_counter() - t_start)
    log(f"  multihost phase: {out['wall_s']:.1f} s")
    results["multihost"] = out


def spawn(role: str, url: str, rank: int):
    return subprocess.Popen(
        [sys.executable, __file__, "--worker", role, url, str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(procs, timeout):
    """Each process's output; a process still running at ``timeout`` is
    killed (and says so)."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n(killed at the timeout)"
        outs.append(out)
    return outs


def phase_two_process(results):
    """Two processes on the one card: first NCCL with two ranks on one
    card (expected to be refused), then the sharded step over gloo with
    staged halos, each rank two positions of a global (2, 2) mesh at
    C=TWO_PROC_CHANNELS, its gathered audio held to the single-card step,
    and then the live app on both at C=TWO_PROC_APP_CHANNELS, for a few
    seconds, started so that the ranks' source rings drop unequal numbers
    of blocks: the ranks must serve the same source block every round
    (rank 0's FM tone within TONE_TOLERANCE_HZ)."""
    import tempfile
    import threading

    t_start = time.perf_counter()
    rdv = tempfile.mkdtemp(prefix="webradio_pg_")
    out = {}
    # NCCL with two ranks on one card, beside the gloo step (its own
    # rendezvous)
    nccl = [spawn("nccl", f"file://{rdv}/nccl", r) for r in range(2)]
    step = [spawn("step", f"file://{rdv}/step", r) for r in range(2)]
    nccl_out = finish(nccl, 60)
    step_out = finish(step, TWO_PROC_TIMEOUT_S)
    seen = []
    for r, text in enumerate(nccl_out):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("NCCL_REFUSED", "NCCL_ACCEPTED"))]
        note = lines[0] if lines else text.strip().splitlines()[-1:]
        log(f"  NCCL, two ranks on one card, rank {r}: {note}")
        seen.append(str(note))
    out["nccl_two_ranks_one_card"] = seen
    records = []
    for r, (p, text) in enumerate(zip(step, step_out)):
        lines = [ln for ln in text.splitlines() if ln.startswith("TWO_PROC ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"two-process step, rank {r}: rc "
                                 f"{p.returncode}\n{text[-3000:]}")
        rec = json.loads(lines[0].split(" ", 1)[1])
        log(f"  two-process step, rank {r}: {json.dumps(rec)}")
        # 3 + 8 blocks: one warm, then replays of one capture
        if rec["graph"]["captures"] != 1 or rec["graph"]["replays"] != 10:
            raise AssertionError(f"two-process step, rank {r}: graphs "
                                 f"{rec['graph']}")
        records.append(rec)
    out["step"] = records

    # the live app on both ranks
    app = [spawn("app", f"file://{rdv}/app", r) for r in range(2)]
    logs = [[], []]

    def read(p, sink):
        for ln in p.stdout:
            sink.append(ln)

    readers = [threading.Thread(target=read, args=(p, sink), daemon=True)
               for p, sink in zip(app, logs)]
    for t in readers:
        t.start()

    def follower_after(done):
        """Rank 1's first record whose rounds reach rank 0's last one."""
        last = max(r for r, _ in done["served"])
        for ln in list(logs[1]):
            if ln.startswith("FOLLOWER "):
                rec = json.loads(ln.split(" ", 1)[1])
                if rec["served"] and max(r for r, _ in rec["served"]) >= last:
                    return rec
        return None

    try:
        deadline = time.monotonic() + TWO_PROC_TIMEOUT_S
        done = follower = None
        while time.monotonic() < deadline:
            ok = [ln for ln in logs[0] if ln.startswith("TWO_PROC_APP ")]
            if ok:
                done = json.loads(ok[0].split(" ", 1)[1])
                follower = follower_after(done)
                if follower is not None:
                    break
            if any(p.poll() is not None for p in app):
                break
            time.sleep(0.1)
    finally:
        for p in app:  # both serve on until killed
            if p.poll() is None:
                p.kill()
        for p in app:
            p.wait(timeout=30)
        for t in readers:
            t.join(timeout=10)
    if done is None or follower is None:
        raise AssertionError("the two-process app did not come up:\n"
                             + "".join(logs[0])[-2500:] + "\n"
                             + "".join(logs[1])[-2500:])
    ranks = (done, follower)
    for r, rec in enumerate(ranks):
        log(f"  two-process app, rank {r}: source ring dropped "
            f"{rec['ring_dropped']}, passed over {rec['skipped']} "
            f"(drops since start {rec['drops']}); served {rec['served'][-1]}"
            f" (round, block index); kernel #1 launches {rec['launches']} "
            f"for {rec['blocks']}-{rec['blocks_after']} blocks + 1 warm; "
            f"graphs {rec['graph']}; {rec['source']}")
    log(f"  two-process app: C={done['channels']}, rank 0 heard "
        f"{done['tone_hz']:.2f} Hz, throughput {done['throughput']:.3f}, "
        f"{done['listened_drops']} dropped while it listened, last "
        f"step {done['last_step_ms']:.2f} ms on the card")
    if abs(done["tone_hz"] - 440.0) > TONE_TOLERANCE_HZ:
        raise AssertionError(f"the two-process app's rank 0 heard "
                             f"{done['tone_hz']:.2f} Hz, not 440")
    if done["listened_drops"]:
        raise AssertionError(f"the two-process app dropped "
                             f"{done['listened_drops']} blocks while rank 0 "
                             f"listened")
    # the uneven start took effect: the rings dropped unequal numbers of
    # blocks, so the ranks' own next blocks were different source blocks
    if done["ring_dropped"] == follower["ring_dropped"]:
        raise AssertionError(f"the ranks' source rings dropped the same "
                             f"{done['ring_dropped']} blocks: the uneven "
                             f"start did not take effect")
    mine = dict(map(tuple, done["served"]))
    common = [(r, i) for r, i in follower["served"] if r in mine]
    if len(common) < TWO_PROC_SERVED_SHOWN // 2 or any(
            mine[r] != i for r, i in common):
        raise AssertionError(f"the ranks served different source blocks: "
                             f"rank 0 {done['served']}, rank 1 "
                             f"{follower['served']}")
    for r, rec in enumerate(ranks):
        if rec["graph"]["captures"] != 1 or not rec["graph"]["replays"]:
            raise AssertionError(f"the two-process app's blocks were not "
                                 f"graph replays on rank {r}: {rec['graph']}")
        # two shards a rank take kernel #1 (each holds C/2 >= 512
        # channels), once a block and at the warm
        if not (2 * (rec["blocks"] + 1) <= rec["launches"]
                <= 2 * (rec["blocks_after"] + 2)):
            raise AssertionError(f"kernel #1 did not run on both shards of "
                                 f"every block on rank {r}: {rec}")
    out["app"] = dict(done, follower=follower)
    out["wall_s"] = time.perf_counter() - t_start
    log(f"  two-process phase: {out['wall_s']:.1f} s")
    results["two_process"] = out


def worker_nccl(url: str, rank: int) -> None:
    """One of two NCCL ranks on ``cuda:0``: one all-reduce, and what NCCL
    said."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=url, world_size=2,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    x = torch.ones(1, device="cuda:0")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print("NCCL_ACCEPTED", float(x), flush=True)
    except Exception as e:
        print("NCCL_REFUSED", type(e).__name__,
              " | ".join(str(e).split("\n"))[:400], flush=True)


def worker_step(url: str, rank: int) -> None:
    """One gloo rank of the two-process step: two positions of a global
    (2, 2) mesh on ``cuda:0`` at C=TWO_PROC_CHANNELS (kernel #1 per shard),
    this rank's half of each block ingested; the audio gathered from both
    ranks held to the single-card step. Then the multihost round's
    agreement (``multihost.agree_index``, one all-reduce) is timed."""
    import torch
    from webradio_tpu_torch.parallel import multihost
    from webradio_tpu_torch.parallel.mesh import make_mesh
    from webradio_tpu_torch.parallel.sharded_channelized import (
        ShardedChannelizedFrontEnd,
    )
    from webradio_tpu_torch.pipeline import channelized as ch

    multihost.init_distributed(url, 2, rank, backend="gloo")
    c = TWO_PROC_CHANNELS
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK_FRAMES)
    ifs, modes = slot_controls(c)
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device="cpu")
    mesh = make_mesh(2, 2, [CARD] * 2)
    lo, hi = multihost.host_time_slice(cfg.block_frames, mesh)
    blocks = tone_blocks(3, seed=17)
    fe = ShardedChannelizedFrontEnd(cfg, params, mesh)
    reset_counts()
    got = []
    for b in blocks:
        audio, _ = fe.process(multihost.make_global_block(
            b[:, lo:hi], cfg.block_frames, mesh))
        got.append(multihost.gather_to_host(audio.fetch_rows(range(c)),
                                            dim=-1))
    launches = tail_wrappers()["fused_tail_audio_tm"].launches
    single = ch.ChannelizedPipeline(
        cfg, ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=CARD))
    ref = [single.process_host_sync(b)[0].cpu() for b in blocks]
    got = torch.from_numpy(np.concatenate(got, axis=1)).T
    ref = torch.cat(ref)
    fm = params.mode == 1
    err, flips, fm_max = audio_mismatch(got, ref, fm,
                                        float(params.audio_coeff.abs().max()),
                                        SHARDED_BOUND)
    t0 = time.perf_counter()
    for i in range(8):
        fe.process(multihost.make_global_block(
            blocks[i % 3][:, lo:hi], cfg.block_frames, mesh))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 8
    t0 = time.perf_counter()
    for i in range(AGREE_CALLS):
        multihost.agree_index(i, False)
    agree_ms = 1e3 * (time.perf_counter() - t0) / AGREE_CALLS
    print("TWO_PROC " + json.dumps({
        "rank": rank, "rows": [lo, hi], "launches": launches,
        "max_audio_err": err, "fm_max": fm_max, "fm_flips": flips,
        "peak": float(ref.abs().max()), "ms_per_block": ms,
        "agree_ms": agree_ms,
        "staged": fe.comm.staged, "segmented": fe.segmented,
        "graph": fe.graph_stats()}), flush=True)


def app_record(fe) -> dict:
    """What a rank of the two-process app reports: its blocks, its source's
    ring drops, the blocks its rounds passed over, every drop together,
    kernel #1's launches (a block count read before and after them), its
    graphs, and the (round, source block index) of its last rounds."""
    b0 = fe.block_count
    launches = tail_wrappers()["fused_tail_audio_tm"].launches
    return {"blocks": b0, "blocks_after": fe.block_count,
            "ring_dropped": getattr(fe.tuner.source, "dropped_blocks", 0),
            "skipped": fe.skipped_blocks, "drops": PumpWatch.dropped(fe),
            "launches": launches, "graph": fe.pipeline.graph_stats(),
            "mesh": fe.pipeline.mesh.shape,
            "source": type(fe.tuner.source).__name__,
            "served": list(fe.served)[-TWO_PROC_SERVED_SHOWN:]}


def worker_app(url: str, rank: int) -> None:
    """One rank of the live two-process app: a multihost sharded tone tuner
    at C=TWO_PROC_APP_CHANNELS over gloo, two positions of ``cuda:0`` per
    rank, started unevenly (TWO_PROC_SKEW_S, TWO_PROC_SHALLOW_RING) so the
    ranks' source rings drop different numbers of blocks before the first
    round. Rank 0 hears its FM receiver over HTTP and prints
    ``TWO_PROC_APP``; rank 1 prints ``FOLLOWER`` every ten blocks (both
    :func:`app_record`). Both serve until killed."""
    import torch
    from webradio_tpu_torch import app as tapp
    from webradio_tpu_torch.parallel import mesh as pmesh

    pmesh.visible_devices = lambda device=None: [torch.device(CARD)] * 2
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "distributed": {"coordinator": url, "num_processes": 2,
                        "process_id": rank, "backend": "gloo"},
        "tuners": [{"driver": "tone", "centre_frequency": 124_325_000,
                    "sample_rate": SAMPLE_RATE, "block_frames": BLOCK_FRAMES,
                    "capacity": TWO_PROC_APP_CHANNELS, "engine": "sharded",
                    "multihost": True}],
        "receivers": [{"tuner": 0, "if_frequency": 100_000,
                       "demodulator": "FM"}],
    }
    app = tapp.RadioApp(config)
    app.build()  # the process group (a rendezvous) and the front end
    fe = app.front_ends[0]
    if rank == 0:
        fe.tuner.source.ring_blocks = TWO_PROC_SHALLOW_RING
    else:
        time.sleep(TWO_PROC_SKEW_S)
        start = fe.tuner.start

        def late_start():
            ok = start()
            time.sleep(TWO_PROC_SKEW_S)
            return ok

        fe.tuner.start = late_start
    reset_counts()
    if not app.start():
        raise SystemExit("the app did not start")
    if rank != 0:
        last = 0
        while app.failed is None:
            if fe.block_count >= last + 10:
                last = fe.block_count
                print("FOLLOWER", json.dumps(app_record(fe)), flush=True)
            time.sleep(0.05)
        raise SystemExit(f"rank 1 failed: {app.failed}")
    while fe.block_count < 5:
        if app.failed is not None:
            raise SystemExit(f"rank 0 failed: {app.failed}")
        time.sleep(0.05)
    t0, b0, d0 = time.monotonic(), fe.block_count, PumpWatch.dropped(fe)
    tone = hear(app.server.port, app.receivers[0].uuid, 48_000, seconds=1.0)
    dt = time.monotonic() - t0
    rec = app_record(fe)
    print("TWO_PROC_APP " + json.dumps(dict(
        rec, tone_hz=tone, channels=TWO_PROC_APP_CHANNELS,
        throughput=(rec["blocks"] - b0) * BLOCK_MS / 1e3 / dt,
        listened_drops=rec["drops"] - d0,
        last_step_ms=fe.trace.latest("step_ns") / 1e6)), flush=True)
    while app.failed is None:
        time.sleep(0.2)
    raise SystemExit(f"rank 0 failed: {app.failed}")


WORKERS = {"nccl": worker_nccl, "step": worker_step, "app": worker_app}


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


def release():
    """Between phases: collect the reference cycles a phase left (an app's
    threads and front ends hold their own), so that no collection lands
    inside a later phase's timed or drop-counted stretch, and hand the
    cached memory back to the card. A dropped pipeline needs neither to
    free its buffers and its graphs' pool: ``phase_graph`` holds that with
    the collector off."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--worker"]:  # a process of the two-process phase
        role, url, rank = sys.argv[2:5]
        WORKERS[role](url, int(rank))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    import faulthandler

    # a run that outlasts 900 s dumps every thread's stack to stderr
    faulthandler.dump_traceback_later(900)
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
    log("== each block as one CUDA graph replay, against the eager step")
    phase_graph(dev, results)
    release()
    log("== the other paths through process_host")
    paths = phase_other_paths(dev, results, kernels, main_run)
    del main_run
    log("== timing of the other paths")
    phase_path_timing(dev, results, paths)
    del paths
    release()
    log(f"== widths {', '.join(map(str, WIDTHS))}: kernel #1 against the "
        f"plain tail; kernel #2 at C={CHANRATE_WIDTH}, 9.6 kHz")
    phase_widths(dev, results)
    log("== a live switch: uniform -> mixed -> uniform bandwidths")
    phase_switch(dev, results)
    release()
    log("== the filterbank tiers (C=1024, C=16384) and their kernel variants")
    phase_tiers(dev, results, kernels)
    release()
    log(f"== the headline topology: C={HEADLINE_CHANNELS}, "
        f"{', '.join(HEADLINE_TIERS)}")
    phase_headline(dev, results)
    release()
    log(f"== the bench: bench_torch --parity, sweep points at C="
        f"{BENCH_POINT_CHANNELS} and C={PAST_2_31_CHANNELS} (past 2^31)")
    phase_bench(dev, results)
    log("== bench_torch --accuracy through kernel #1 and the plain tail")
    phase_accuracy(dev, results)
    release()
    clocks = nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    log(f"  after timing: sm clock, max sm clock, power draw, temp = "
        f"{clocks}")
    results["after_timing_smi"] = clocks
    log(f"== offline: run_capture_channelized (C={WIDE_CHANNELS}) and "
        f"run_capture (C=16)")
    phase_offline(dev, results)
    release()
    log("== the CLI: demod_cli on a 1 s capture, both engines")
    phase_cli(results)
    log("== the entry: entry()'s step on the card against the CPU")
    phase_entry(dev, results)
    log("== the server: RadioApp over HTTP")
    phase_server(results)
    log("== the clocks: a live pump's /profile trace, host against card")
    phase_clocks(results)
    log("== the soundcard tuner on a libpulse-simple stand-in")
    phase_soundcard(results)
    log(f"== sharded: (2, 2) virtual mesh of the card at C={WIDE_CHANNELS}, "
        f"(1, 2) at 9.6 kHz, the direct engine, run_capture_sharded, "
        f"dryrun_multichip(4)")
    phase_sharded(dev, results, kernels)
    release()
    log(f"== sharded per-channel body on kernel #4: (2, 2) at C="
        f"{MAIN_CHANNELS}, (4, 1) at C={WIDE_CHANNELS} against the plain "
        f"stage body, a live uniform -> mixed -> uniform switch")
    phase_sharded_channel(dev, results, kernels)
    release()
    log(f"== multihost: RadioApp on NCCL (one process), C="
        f"{MULTIHOST_CHANNELS} on a (1, 4) virtual mesh")
    phase_multihost(results)
    log("== two processes on the card: NCCL's two ranks on one card, the "
        "sharded step over gloo, the live app")
    phase_two_process(results)

    tm = "webradio_tpu_torch/csrc/tail_tm.cu"
    meta = {
        "fused_tail_audio_tm": (tm, "webradio_tpu/ops/pallas_tail_tm.py:736"),
        "fused_tail_tm": (tm, "webradio_tpu/ops/pallas_tail_tm.py:372"),
        "fused_pfb_tail_audio_tm": (tm,
                                    "webradio_tpu/ops/pallas_tail_tm.py:904"),
        "fused_receiver_tail": ("webradio_tpu_torch/csrc/tail.cu",
                                "webradio_tpu/ops/pallas_tail.py:141"),
        # the tiers' variants (a bfloat16 product; #3's lossy products)
        "fused_tail_audio_tm[bf16]": (
            tm, "webradio_tpu/ops/pallas_tail_tm.py:736"),
        "fused_tail_tm[bf16]": (tm, "webradio_tpu/ops/pallas_tail_tm.py:372"),
        "fused_pfb_tail_audio_tm[default]": (
            tm, "webradio_tpu/ops/pallas_tail_tm.py:904"),
        "fused_pfb_tail_audio_tm[high]": (
            tm, "webradio_tpu/ops/pallas_tail_tm.py:904"),
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
