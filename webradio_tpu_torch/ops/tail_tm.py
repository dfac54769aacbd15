"""Fused time-major receiver tails: mix + shaping FIR + demod (+ audio FIR,
+ the filterbank product in front).

Port of ``webradio_tpu.ops.pallas_tail_tm``: :func:`fused_tail_audio_tm`,
:func:`fused_tail_tm` (no audio FIR: channel-rate audio) and
:func:`fused_pfb_tail_audio_tm` (the filterbank product made inside the
kernel from the im2col frames). For CUDA tensors each launches its
hand-written Hopper kernel from ``csrc/tail_tm.cu`` (design notes at the
top of that file); for tensors on the CPU it runs its ``*_ref``, the plain
torch version of the same function, which the CPU tests hold against the
JAX package and ``chip_smoke.py`` holds the kernel against on the card.

Semantics are the JAX kernel's: the cross-block shaping-FIR state is the
MIXED-domain input tail, the squelch power is the block-mean post-shaping
FIR ``|y|^2``, and the FM law keeps the reference's ``atan2(ii, qq)``
order. Two LO laws: ``fast=False`` is the reference's 16-bit table law;
``fast=True`` is the full 31-bit angle per sample (the TPU kernel's
factored phasor approximates that same angle; the CUDA kernels take it
exactly for the first two rows of every 16 and rotate by the exact phasors
of 2, 4, .., 14 steps, ~2e-7 from it).

Every ``precision`` tier is computed to float32 accuracy here: "hx5", "hx4"
and "high" name TPU MXU pass counts and have no Hopper meaning yet. The
kernels make the shaping FIR on the tensor cores as a three-term TF32 split
(``ops.precision.matmul_tf32x3`` is its plain emulation,
``ops.nco.nco_mix_tm_rotated`` that of the ``fast`` LO), the decimating
audio FIR likewise where the decimation is 5
(``ops.fir.fir_decimate_banded_tf32x3_tm``; a float32 FMA loop for any
other), and the filterbank product as float32 FMA chains in tap order; the
plain versions stay true float32.

The filterbank tiers (``ops.channelizer``) reach the kernels two ways. The
packed product of the "bf16" tier is bfloat16: :func:`fused_tail_audio_tm`
and :func:`fused_tail_tm` take it as it is (the kernels upcast at load,
exactly; the plain versions take ``.float()`` of it), so every bound of the
float32 product holds unchanged. :func:`fused_pfb_tail_audio_tm` makes the
product at "highest", "default" or "high" (the JAX kernel's tiers; "u8exact"
and "bf16" need the packed product): the two lossy tiers on the bf16 tensor
cores from the host-split weights, and the plain version at the same law
(``ops.channelizer.pfb_product``).
"""

from __future__ import annotations

import torch

from .channelizer import pfb_product
from .demod import demodulate_tm
from .fir import fir_decimate_toeplitz_tm, taps_of
from .launches import count_launch
from .nco import nco_mix_tm, nco_mix_tm_exact

#: the JAX kernel's channel tile, which the CPU's selection rule keeps
#: (``pipeline.channelized.tm_kernel_rule``); the CUDA kernels take any
#: channel count
CHAN_TILE = 128
#: channels per CUDA block; the fused filterbank kernel stages whole
#: blocks of weight columns, so its channel count is a multiple
BLOCK_CHANNELS = 64
#: rows per kernel chunk, one tensor-core tile (nd must be a multiple)
CHUNK_ROWS = 16
#: rows per in-kernel filterbank product (the fused-filterbank kernel's nd
#: and time tile must be multiples)
PFB_GROUP_ROWS = 64
#: taps per staged slice of that product (2 K_p must be a multiple)
PFB_SLICE_TAPS = 16
#: time-tile rows per CUDA block: a multiple of CHUNK_ROWS (of
#: PFB_GROUP_ROWS for the fused filterbank) and at least 2K = 128 (the halo
#: recompute starts 2K rows before the tile; K rows without the audio FIR).
#: Taller tiles recompute less halo; 640 keeps the card's SMs filled at
#: 1,024 channels (see :func:`tile_rows_for`)
TILE_ROWS = 640
#: blocks from which a taller tile still fills the card (132 SMs, up to
#: three resident blocks each) over a few waves
MIN_BLOCKS = 1024
#: the only tap count the kernel is built for (firdesign.FIR_LENGTH)
KERNEL_TAPS = 64
#: channels per kernel warp: a warp orders its channels by demod law
#: (:func:`law_sorted_columns`)
WARP_CHANNELS = 16
PRECISIONS = ("highest", "hx5", "hx4", "high")
#: the filterbank tiers :func:`fused_pfb_tail_audio_tm` makes, by the
#: kernel's tier code
PFB_TIERS = {"highest": 0, "default": 1, "high": 2}


def tile_rows_for(nd: int, channels: int) -> int:
    """Time-tile height of the two audio-fused kernels: 2,560 rows where
    that still gives MIN_BLOCKS blocks (one per 64 channels and tile), else
    TILE_ROWS. Wide configurations have blocks to spare and save the halo
    recompute (20% of the rows at 640, 5% at 2,560)."""
    rows = 4 * TILE_ROWS
    if -(-channels // BLOCK_CHANNELS) * -(-nd // rows) >= MIN_BLOCKS:
        return rows
    return TILE_ROWS


def law_sorted_columns(mode) -> list[int]:
    """Column order of one kernel warp's :data:`WARP_CHANNELS` channels,
    as ``csrc/tail_tm.cu`` builds it: entry ``col`` is the channel (0..15)
    whose samples sit in column ``col``.

    One kernel instruction demodulates the columns of one class (columns
    ``cc, cc + 4, cc + 8, cc + 12``), so the order makes a class share a
    demod law where it can: the channels are sorted by law (stable; any
    value outside 0..3 counts as 3, the kernel's default law) and sorted
    entries ``4 cc .. 4 cc + 3`` go to class ``cc``. Where every class is
    uniform as the channels stand (one law on every slot, laws cycling with
    period 4), the order is the identity. It decides only where a channel
    sits in the warp, never what is computed for it.

    The last warp of a channel count that is not a multiple of 16 is
    partial: ``mode`` then holds its 1..15 live channels, and the kernel's
    channels past the count (``len(mode)`` .. 15) sort as law 3.
    """
    key = [m if 0 <= m <= 3 else 3 for m in (int(m) for m in mode)]
    n = WARP_CHANNELS
    if not 0 < len(key) <= n:
        raise ValueError(f"a warp holds 1 to {n} channels, got {len(key)}")
    key += [3] * (n - len(key))
    if all(key[j] == key[j & 3] for j in range(n)):
        return list(range(n))
    order = sorted(range(n), key=lambda j: key[j])  # sorted() is stable
    cols = [0] * n
    for pos, j in enumerate(order):
        cols[4 * (pos & 3) + (pos >> 2)] = j
    return cols


def _split(ci_planes, cq_planes, packed):
    if packed:
        c = ci_planes.shape[1] // 2
        return ci_planes[:, :c], ci_planes[:, c:], c
    return ci_planes, cq_planes, ci_planes.shape[1]


def shape_demod_tm(mi, mq, w_toep, mode, chan_hist_i, chan_hist_q,
                   demod_prev):
    """The plain tail from mixed ``[nd, C]`` planes to channel-rate audio:
    shaping FIR (both planes through one banded matmul), demod and squelch
    power, in true float32. Returns what :func:`fused_tail_tm` returns."""
    c = mi.shape[1]
    y2, h2 = fir_decimate_toeplitz_tm(
        torch.cat([mi, mq], dim=1), w_toep, 1,
        torch.cat([chan_hist_i, chan_hist_q], dim=1),
    )
    yi, yq = y2[:, :c], y2[:, c:]
    audio, new_prev = demodulate_tm(yi, yq, mode, demod_prev)
    power = (yi * yi + yq * yq).sum(dim=0) * (1.0 / yi.shape[0])
    return audio, h2[:, :c], h2[:, c:], new_prev, power


def tail_after_mix_tm(
    mi, mq, w_toep, audio_toep, decimation, mode, chan_hist_i, chan_hist_q,
    demod_prev, audio_hist,
):
    """:func:`shape_demod_tm` and the decimating audio FIR. Returns what
    :func:`fused_tail_audio_tm` returns."""
    audio, hist_i, hist_q, new_prev, power = shape_demod_tm(
        mi, mq, w_toep, mode, chan_hist_i, chan_hist_q, demod_prev)
    audio48, new_ahist = fir_decimate_toeplitz_tm(
        audio, audio_toep, decimation, audio_hist
    )
    return audio48, hist_i, hist_q, new_prev, new_ahist, power


def _mixed(ci_planes, cq_planes, phase0, phase_step, packed, fast):
    xi, xq, _ = _split(ci_planes, cq_planes, packed)
    mix = nco_mix_tm_exact if fast else nco_mix_tm
    return mix(xi.float(), xq.float(), phase0, phase_step)


def fused_tail_audio_tm_ref(
    ci_planes, cq_planes, phase0, phase_step, w_toep, audio_toep,
    decimation, mode, chan_hist_i, chan_hist_q, demod_prev, audio_hist,
    precision="highest", packed=False, fast=False, mode_set=None,
):
    """Plain torch version of :func:`fused_tail_audio_tm` (same arguments,
    same returns): the exact LO mix, then :func:`tail_after_mix_tm`."""
    mi, mq = _mixed(ci_planes, cq_planes, phase0, phase_step, packed, fast)
    return tail_after_mix_tm(mi, mq, w_toep, audio_toep, decimation, mode,
                             chan_hist_i, chan_hist_q, demod_prev,
                             audio_hist)


def fused_tail_tm_ref(
    ci_planes, cq_planes, phase0, phase_step, w_toep, mode, chan_hist_i,
    chan_hist_q, demod_prev, precision="highest", packed=False, fast=False,
    mode_set=None,
):
    """Plain torch version of :func:`fused_tail_tm` (same arguments, same
    returns): the exact LO mix, then :func:`shape_demod_tm`."""
    mi, mq = _mixed(ci_planes, cq_planes, phase0, phase_step, packed, fast)
    return shape_demod_tm(mi, mq, w_toep, mode, chan_hist_i, chan_hist_q,
                          demod_prev)


def fused_pfb_tail_audio_tm_ref(
    frames, pfb_weights, phase0, phase_step, w_toep, audio_toep, decimation,
    mode, chan_hist_i, chan_hist_q, demod_prev, audio_hist,
    precision="highest", packed=True, fast=False, pfb_precision="highest",
    mode_set=None, pfb_weights_split=None,
):
    """Plain torch version of :func:`fused_pfb_tail_audio_tm` (same
    arguments, same returns): the filterbank product at the tier's law
    (``ops.channelizer.pfb_product``; true float32 for "highest"), then
    :func:`fused_tail_audio_tm_ref` on the packed product."""
    y2 = pfb_product(frames, pfb_weights,
                     _weights_split(pfb_weights, pfb_weights_split,
                                    pfb_precision), pfb_precision)
    return fused_tail_audio_tm_ref(
        y2, y2, phase0, phase_step, w_toep, audio_toep, decimation, mode,
        chan_hist_i, chan_hist_q, demod_prev, audio_hist, packed=True,
        fast=fast)


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _reversed_kernel(name, w, decimation, dev):
    """Column 0 of a banded weight matrix: the reversed kernel."""
    if w.device != dev or w.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {dev}")
    k = taps_of(w, decimation)
    if k != KERNEL_TAPS:
        raise ValueError(f"the kernel is built for {KERNEL_TAPS}-tap "
                         f"shaping and audio FIRs, {name} has {k}")
    return w[:k, 0].contiguous()


def shape_refusal(nd: int, c: int, decimation: int = 1,
                  taps: int = KERNEL_TAPS, pfb: bool = False,
                  bf16: bool = False) -> str | None:
    """Why the time-major kernels cannot take these shapes, or None: the
    CUDA kernels' own test, which the wrappers raise with and the card's
    selection rule reads (``pipeline.channelized.tm_kernel_rule``).
    ``pfb`` is the fused filterbank kernel, ``bf16`` a bfloat16 product.
    Any channel count passes (a partial last block of 64); rows come in
    chunks of :data:`CHUNK_ROWS` (product groups of
    :data:`PFB_GROUP_ROWS` for the fused filterbank)."""
    rows = PFB_GROUP_ROWS if pfb else CHUNK_ROWS
    if taps != KERNEL_TAPS:
        return (f"the kernel is built for {KERNEL_TAPS}-tap shaping and "
                f"audio FIRs, not {taps}")
    if c < 1:
        return f"channels {c} must be at least 1"
    if pfb and c % BLOCK_CHANNELS:
        return (f"channels {c} must be a multiple of {BLOCK_CHANNELS} for "
                "the fused filterbank")
    if bf16 and c % 4:
        return f"channels {c} of a bfloat16 product must be a multiple of 4"
    if decimation < 1 or nd % decimation or nd % rows:
        return (f"nd={nd} must be a multiple of the decimation {decimation}"
                f" and of {rows}")
    return None


def _check_common(dev, nd, c, d, tile_rows, halo, phase0, phase_step, mode,
                  chan_hist_i, chan_hist_q, demod_prev, audio_hist=None,
                  rows=CHUNK_ROWS, bf16=False):
    k = KERNEL_TAPS
    why = shape_refusal(nd, c, d, pfb=rows == PFB_GROUP_ROWS, bf16=bf16)
    if why:
        raise ValueError(why)
    if tile_rows % rows or tile_rows < halo:
        raise ValueError(f"tile_rows={tile_rows} must be a multiple of "
                         f"{rows} and at least {halo}")
    carries = [
        ("phase0", phase0, torch.int64, (c,)),
        ("phase_step", phase_step, torch.int64, (c,)),
        ("mode", mode, torch.int32, (c,)),
        ("chan_hist_i", chan_hist_i, torch.float32, (k - 1, c)),
        ("chan_hist_q", chan_hist_q, torch.float32, (k - 1, c)),
        ("demod_prev", demod_prev, torch.float32, (2, c)),
    ]
    if audio_hist is not None:
        carries.append(("audio_hist", audio_hist, torch.float32, (k - 1, c)))
    for name, x, dt, shape in carries:
        _check(name, x, dt, shape, dev)


def _planes(ci_planes, cq_planes, packed):
    """Check the product planes, float32 or (the "bf16" tier) bfloat16;
    returns ``(nd, c, xi ptr, xq ptr, row stride in elements, 1 for
    bfloat16 else 0)``."""
    dev = ci_planes.device
    nd = ci_planes.shape[0]
    c = ci_planes.shape[1] // 2 if packed else ci_planes.shape[1]
    dt = ci_planes.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ci_planes has dtype {dt}, expected float32 or "
                        "bfloat16")
    _check("ci_planes", ci_planes, dt, (nd, 2 * c if packed else c), dev)
    xi = ci_planes.data_ptr()
    in_bf16 = int(dt == torch.bfloat16)
    if in_bf16 and xi % 8:
        raise ValueError("a bfloat16 product must be 8-byte aligned")
    if packed:
        # Q starts C elements into a row of 2C
        return nd, c, xi, xi + ci_planes.element_size() * c, 2 * c, in_bf16
    _check("cq_planes", cq_planes, dt, (nd, c), dev)
    if in_bf16 and cq_planes.data_ptr() % 8:
        raise ValueError("a bfloat16 product must be 8-byte aligned")
    return nd, c, xi, cq_planes.data_ptr(), c, in_bf16


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _launch_audio(wrapper, entry, lead, dev, nd, c, phase0, phase_step,
                  w_toep, audio_toep, decimation, mode, chan_hist_i,
                  chan_hist_q, demod_prev, audio_hist, fast, tile_rows,
                  variant, rows=CHUNK_ROWS, bf16=False):
    """Launch an audio-fused kernel through the library's ``entry`` and
    count it on ``wrapper``; ``lead`` is the entry point's leading
    arguments, the product planes or the frames and weights; ``variant``
    the product's type (1: bfloat16, also ``bf16``) or the filterbank
    tier's code; ``rows`` is the row granule of ``nd`` and ``tile_rows``."""
    from . import _build

    d = int(decimation)
    k = KERNEL_TAPS
    h_shape = _reversed_kernel("w_toep", w_toep, 1, dev)
    h_audio = _reversed_kernel("audio_toep", audio_toep, d, dev)
    _check_common(dev, nd, c, d, tile_rows, 2 * k, phase0, phase_step, mode,
                  chan_hist_i, chan_hist_q, demod_prev, audio_hist, rows,
                  bf16)
    n_tiles = -(-nd // tile_rows)
    audio48 = _empty(dev, nd // d, c)
    hist_i, hist_q, ahist = (_empty(dev, k - 1, c) for _ in range(3))
    new_prev = _empty(dev, 2, c)
    power_part = _empty(dev, n_tiles, c)
    power = _empty(dev, c)

    lib = _build.load_library()
    code = getattr(lib, entry)(
        *lead, phase0.data_ptr(), phase_step.data_ptr(),
        h_shape.data_ptr(), h_audio.data_ptr(), mode.data_ptr(),
        chan_hist_i.data_ptr(), chan_hist_q.data_ptr(),
        demod_prev.data_ptr(), audio_hist.data_ptr(), audio48.data_ptr(),
        hist_i.data_ptr(), hist_q.data_ptr(), new_prev.data_ptr(),
        ahist.data_ptr(), power_part.data_ptr(), power.data_ptr(),
        nd, c, k, d, tile_rows, int(bool(fast)), variant, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, f"{wrapper.__name__} kernel launch")
    count_launch(wrapper)
    return audio48, hist_i, hist_q, new_prev, ahist, power


def _launch(ci_planes, cq_planes, phase0, phase_step, w_toep, audio_toep,
            decimation, mode, chan_hist_i, chan_hist_q, demod_prev,
            audio_hist, packed, fast, tile_rows):
    nd, c, xi, xq, row_stride, in_bf16 = _planes(ci_planes, cq_planes,
                                                 packed)
    return _launch_audio(
        fused_tail_audio_tm, "webradio_tail_tm_launch",
        (xi, xq, row_stride), ci_planes.device, nd, c,
        phase0, phase_step, w_toep, audio_toep, decimation, mode,
        chan_hist_i, chan_hist_q, demod_prev, audio_hist, fast, tile_rows,
        in_bf16, bf16=bool(in_bf16))


def _weights_split(pfb_weights, pfb_weights_split, pfb_precision):
    """The split weights a lossy tier reads as ``[2, 2K_p, 2C]``; None for
    "highest"."""
    if pfb_precision == "highest":
        return None
    if pfb_weights_split is None:
        raise ValueError(f"the {pfb_precision!r} tier reads the split "
                         "weights (pfb_weights_split), which are absent")
    return pfb_weights_split.reshape(2, pfb_weights.shape[0], -1)


def _launch_pfb(frames, pfb_weights, phase0, phase_step, w_toep, audio_toep,
                decimation, mode, chan_hist_i, chan_hist_q, demod_prev,
                audio_hist, fast, tile_rows, pfb_precision="highest",
                pfb_weights_split=None):
    dev = frames.device
    nd, kp2 = frames.shape
    c = pfb_weights.shape[-1] // 2
    _check("frames", frames, torch.float32, (nd, kp2), dev)
    _check("pfb_weights", pfb_weights, torch.float32, (kp2, 2 * c), dev)
    if kp2 % PFB_SLICE_TAPS:
        raise ValueError(f"the frames' width {kp2} must be a multiple of "
                         f"{PFB_SLICE_TAPS}")
    split = _weights_split(pfb_weights, pfb_weights_split, pfb_precision)
    if split is None:
        w_hi = w_lo = pfb_weights
    else:
        _check("pfb_weights_split", split, torch.bfloat16, (2, kp2, 2 * c),
               dev)
        w_hi, w_lo = split[0], split[1]
    if any(t.data_ptr() % 16 for t in (frames, w_hi, w_lo)):
        raise ValueError("frames and the weights must be 16-byte aligned")
    return _launch_audio(
        fused_pfb_tail_audio_tm, "webradio_pfb_tail_tm_launch",
        (frames.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), kp2), dev, nd,
        c, phase0, phase_step, w_toep, audio_toep, decimation, mode,
        chan_hist_i, chan_hist_q, demod_prev, audio_hist, fast, tile_rows,
        PFB_TIERS[pfb_precision], rows=PFB_GROUP_ROWS)


def _launch_chanrate(ci_planes, cq_planes, phase0, phase_step, w_toep, mode,
                     chan_hist_i, chan_hist_q, demod_prev, packed, fast,
                     tile_rows):
    from . import _build

    dev = ci_planes.device
    k = KERNEL_TAPS
    nd, c, xi, xq, row_stride, in_bf16 = _planes(ci_planes, cq_planes,
                                                 packed)
    h_shape = _reversed_kernel("w_toep", w_toep, 1, dev)
    _check_common(dev, nd, c, 1, tile_rows, k, phase0, phase_step, mode,
                  chan_hist_i, chan_hist_q, demod_prev, bf16=bool(in_bf16))
    n_tiles = -(-nd // tile_rows)
    audio = _empty(dev, nd, c)
    hist_i, hist_q = _empty(dev, k - 1, c), _empty(dev, k - 1, c)
    new_prev = _empty(dev, 2, c)
    power_part = _empty(dev, n_tiles, c)
    power = _empty(dev, c)

    lib = _build.load_library()
    code = lib.webradio_tail_tm_chanrate_launch(
        xi, xq, row_stride, phase0.data_ptr(), phase_step.data_ptr(),
        h_shape.data_ptr(), mode.data_ptr(), chan_hist_i.data_ptr(),
        chan_hist_q.data_ptr(), demod_prev.data_ptr(), audio.data_ptr(),
        hist_i.data_ptr(), hist_q.data_ptr(), new_prev.data_ptr(),
        power_part.data_ptr(), power.data_ptr(),
        nd, c, k, tile_rows, int(bool(fast)), in_bf16, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "fused_tail_tm kernel launch")
    count_launch(fused_tail_tm)
    return audio, hist_i, hist_q, new_prev, power


def _route(x: torch.Tensor, precision: str) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version (CPU
    tensors); any other device raises."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"no tail kernel for device {x.device}")
    return False


def fused_tail_audio_tm(
    ci_planes: torch.Tensor,
    cq_planes: torch.Tensor,
    phase0: torch.Tensor,
    phase_step: torch.Tensor,
    w_toep: torch.Tensor,
    audio_toep: torch.Tensor,
    decimation: int,
    mode: torch.Tensor,
    chan_hist_i: torch.Tensor,
    chan_hist_q: torch.Tensor,
    demod_prev: torch.Tensor,
    audio_hist: torch.Tensor,
    precision: str = "highest",
    packed: bool = False,
    fast: bool = False,
    mode_set: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """Residual NCO mix, shaping FIR, demod, squelch power and decimating
    audio FIR over time-major planes, in one pass.

    Args (the JAX function's):
      ci_planes / cq_planes: ``[nd, C]`` float32 selected-bin planes; with
        ``packed=True`` both are the same ``[nd, 2C]`` filterbank product
        (columns ``[:C]`` I, ``[C:]`` Q), read in place. Bfloat16 (the
        "bf16" tier's stored product) is read as it is and upcast.
      phase0 / phase_step: ``[C]`` int64 holding the uint32 NCO phase of
        this block's first sample and the per-sample step.
      w_toep / audio_toep: banded weights (``ops.fir.toeplitz_weights``) of
        the shared shaping (decimation 1) and audio kernels; only column 0,
        the reversed kernel, is read by the CUDA kernel.
      decimation: channel-rate to audio-rate ratio ``D``.
      mode: ``[C]`` int32 demod law (``ops.demod.MODES``).
      chan_hist_i / chan_hist_q: ``[K-1, C]`` mixed-domain input tails.
      demod_prev: ``[2, C]`` previous shaped sample (FM lag).
      audio_hist: ``[K-1, C]`` demod-audio tail for the audio FIR.
      precision: a ``ChannelizedConfig.fir_precision`` name; all hold
        float32 accuracy.
      fast: full-angle LO instead of the 16-bit table law.
      mode_set: accepted for signature parity; the kernel switches on
        ``mode`` per channel at run time.

    Returns ``(audio48 [nd // D, C], new_hist_i, new_hist_q,
    new_demod_prev, new_audio_hist, power [C])``.

    CUDA tensors go to the kernel (``fused_tail_audio_tm.launches`` counts
    each launch); CPU tensors to :func:`fused_tail_audio_tm_ref`.
    """
    args = (ci_planes, cq_planes, phase0, phase_step, w_toep, audio_toep,
            decimation, mode, chan_hist_i, chan_hist_q, demod_prev,
            audio_hist)
    if _route(ci_planes, precision):
        nd, width = ci_planes.shape
        return _launch(*args, packed, fast,
                       tile_rows_for(nd, width // 2 if packed else width))
    return fused_tail_audio_tm_ref(*args, precision=precision,
                                   packed=packed, fast=fast)


def fused_tail_tm(
    ci_planes: torch.Tensor,
    cq_planes: torch.Tensor,
    phase0: torch.Tensor,
    phase_step: torch.Tensor,
    w_toep: torch.Tensor,
    mode: torch.Tensor,
    chan_hist_i: torch.Tensor,
    chan_hist_q: torch.Tensor,
    demod_prev: torch.Tensor,
    precision: str = "highest",
    packed: bool = False,
    fast: bool = False,
    mode_set: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """:func:`fused_tail_audio_tm` without the audio FIR: residual NCO mix,
    shaping FIR, demod and squelch power, with the demodulated audio
    written at the channel rate. Port of
    ``webradio_tpu.ops.pallas_tail_tm.fused_tail_tm``; the arguments are
    those of :func:`fused_tail_audio_tm` less ``audio_toep``,
    ``decimation`` and ``audio_hist``.

    Returns ``(audio [nd, C], new_hist_i, new_hist_q, new_demod_prev,
    power [C])``.

    CUDA tensors go to the kernel (``fused_tail_tm.launches`` counts each
    launch); CPU tensors to :func:`fused_tail_tm_ref`.
    """
    args = (ci_planes, cq_planes, phase0, phase_step, w_toep, mode,
            chan_hist_i, chan_hist_q, demod_prev)
    if _route(ci_planes, precision):
        return _launch_chanrate(*args, packed, fast, TILE_ROWS)
    return fused_tail_tm_ref(*args, precision=precision, packed=packed,
                             fast=fast)


def fused_pfb_tail_audio_tm(
    frames: torch.Tensor,
    pfb_weights: torch.Tensor,
    phase0: torch.Tensor,
    phase_step: torch.Tensor,
    w_toep: torch.Tensor,
    audio_toep: torch.Tensor,
    decimation: int,
    mode: torch.Tensor,
    chan_hist_i: torch.Tensor,
    chan_hist_q: torch.Tensor,
    demod_prev: torch.Tensor,
    audio_hist: torch.Tensor,
    precision: str = "highest",
    packed: bool = True,
    fast: bool = False,
    pfb_precision: str = "highest",
    mode_set: tuple | None = None,
    pfb_weights_split: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor]:
    """:func:`fused_tail_audio_tm` with the polyphase filterbank product
    made inside the kernel, so the packed ``[nd, 2C]`` product never
    reaches device memory. Port of
    ``webradio_tpu.ops.pallas_tail_tm.fused_pfb_tail_audio_tm``.

    Args in place of the product planes:
      frames: ``[nd, 2 K_p]`` float32 im2col frames
        (``ops.channelizer.pfb_frames_tm``).
      pfb_weights: ``[2 K_p, 2 C]`` float32 packed filterbank weights
        (``bin_weights_for_channels`` reshaped): columns ``[:C]`` make
        mixed I, ``[C:]`` mixed Q.
      pfb_precision: "highest" (float32 accuracy: true float32 in the plain
        version, float32 FMA chains in the kernel), "default" or "high"
        (the ``ops.channelizer`` laws; bf16 tensor cores in the kernel).
        "u8exact" and "bf16" raise, as the JAX configuration refuses them
        for this kernel.
      pfb_weights_split: the lossy tiers' bfloat16 hi/lo weights,
        ``[2, 2K_p, 2, C]`` (``ChannelizedParams.pfb_weights_split``) or
        ``[2, 2K_p, 2C]``; required at "default" and "high".
      packed: accepted for signature parity; frames are packed by nature.

    Returns what :func:`fused_tail_audio_tm` returns.

    CUDA tensors go to the kernel (``fused_pfb_tail_audio_tm.launches``
    counts each launch); CPU tensors to
    :func:`fused_pfb_tail_audio_tm_ref`.
    """
    if pfb_precision not in PFB_TIERS:
        raise ValueError(f"the fused filterbank makes the {tuple(PFB_TIERS)}"
                         f" products, not {pfb_precision!r} (which needs "
                         "the packed product)")
    if pfb_weights.shape[0] != frames.shape[1]:
        raise ValueError("frames/weights contraction mismatch")
    args = (frames, pfb_weights, phase0, phase_step, w_toep, audio_toep,
            decimation, mode, chan_hist_i, chan_hist_q, demod_prev,
            audio_hist)
    if _route(frames, precision):
        return _launch_pfb(
            *args, fast,
            tile_rows_for(frames.shape[0], pfb_weights.shape[1] // 2),
            pfb_precision, pfb_weights_split)
    return fused_pfb_tail_audio_tm_ref(
        *args, precision=precision, fast=fast, pfb_precision=pfb_precision,
        pfb_weights_split=pfb_weights_split)


fused_tail_audio_tm.launches = 0
fused_tail_tm.launches = 0
fused_pfb_tail_audio_tm.launches = 0
