"""Fused time-major receiver tail: mix + shaping FIR + demod + audio FIR.

Port of ``webradio_tpu.ops.pallas_tail_tm.fused_tail_audio_tm``. For CUDA
tensors :func:`fused_tail_audio_tm` launches the hand-written Hopper kernel
``csrc/tail_tm.cu`` (design notes at the top of that file); for tensors on
the CPU it runs :func:`fused_tail_audio_tm_ref`, the plain torch version of
the same function, which the CPU tests hold against the JAX package and
``chip_smoke.py`` holds the kernel against on the card.

Semantics are the JAX kernel's: the cross-block shaping-FIR state is the
MIXED-domain input tail, the squelch power is the block-mean post-shaping
FIR ``|y|^2``, and the FM law keeps the reference's ``atan2(ii, qq)``
order. Two LO laws: ``fast=False`` is the reference's 16-bit table law;
``fast=True`` evaluates the full 31-bit angle per sample (the TPU kernel's
factored phasor approximates that same angle).

Every ``precision`` tier is computed in float32 here: "hx5", "hx4" and
"high" name TPU MXU pass counts and have no Hopper meaning yet.
"""

from __future__ import annotations

import torch

from .demod import demodulate_tm
from .fir import fir_decimate_toeplitz_tm, taps_of
from .nco import nco_mix_tm, nco_mix_tm_exact

#: channels per kernel tile; the JAX kernel's rule, kept so the same
#: channel counts are accepted by both packages
CHAN_TILE = 128
#: rows per kernel chunk (nd must be a multiple)
CHUNK_ROWS = 16
#: time-tile rows per CUDA block: a multiple of CHUNK_ROWS and at least
#: 2K = 128 (the halo recompute starts 2K rows before the tile)
TILE_ROWS = 640
#: the only tap count the kernel is built for (firdesign.FIR_LENGTH)
KERNEL_TAPS = 64
PRECISIONS = ("highest", "hx5", "hx4", "high")


def _split(ci_planes, cq_planes, packed):
    if packed:
        c = ci_planes.shape[1] // 2
        return ci_planes[:, :c], ci_planes[:, c:], c
    return ci_planes, cq_planes, ci_planes.shape[1]


def tail_after_mix_tm(
    mi, mq, w_toep, audio_toep, decimation, mode, chan_hist_i, chan_hist_q,
    demod_prev, audio_hist,
):
    """The plain tail from mixed ``[nd, C]`` planes on: shaping FIR (both
    planes through one banded matmul), demod, squelch power and decimating
    audio FIR, in true float32. Returns what :func:`fused_tail_audio_tm`
    returns."""
    c = mi.shape[1]
    y2, h2 = fir_decimate_toeplitz_tm(
        torch.cat([mi, mq], dim=1), w_toep, 1,
        torch.cat([chan_hist_i, chan_hist_q], dim=1),
    )
    yi, yq = y2[:, :c], y2[:, c:]
    audio, new_prev = demodulate_tm(yi, yq, mode, demod_prev)
    power = (yi * yi + yq * yq).sum(dim=0) * (1.0 / yi.shape[0])
    audio48, new_ahist = fir_decimate_toeplitz_tm(
        audio, audio_toep, decimation, audio_hist
    )
    return audio48, h2[:, :c], h2[:, c:], new_prev, new_ahist, power


def fused_tail_audio_tm_ref(
    ci_planes, cq_planes, phase0, phase_step, w_toep, audio_toep,
    decimation, mode, chan_hist_i, chan_hist_q, demod_prev, audio_hist,
    precision="highest", packed=False, fast=False, mode_set=None,
):
    """Plain torch version of :func:`fused_tail_audio_tm` (same arguments,
    same returns): the exact LO mix, then :func:`tail_after_mix_tm`."""
    xi, xq, _ = _split(ci_planes, cq_planes, packed)
    mix = nco_mix_tm_exact if fast else nco_mix_tm
    mi, mq = mix(xi.float(), xq.float(), phase0, phase_step)
    return tail_after_mix_tm(mi, mq, w_toep, audio_toep, decimation, mode,
                             chan_hist_i, chan_hist_q, demod_prev,
                             audio_hist)


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


def _launch(ci_planes, cq_planes, phase0, phase_step, w_toep, audio_toep,
            decimation, mode, chan_hist_i, chan_hist_q, demod_prev,
            audio_hist, packed, fast, tile_rows):
    from . import _build

    dev = ci_planes.device
    d = int(decimation)
    nd = ci_planes.shape[0]
    c = ci_planes.shape[1] // 2 if packed else ci_planes.shape[1]
    k = taps_of(w_toep, 1)
    if c % CHAN_TILE:
        raise ValueError(f"channels {c} must be a multiple of {CHAN_TILE}")
    if k != KERNEL_TAPS or taps_of(audio_toep, d) != k:
        raise ValueError(f"the kernel is built for {KERNEL_TAPS}-tap "
                         f"shaping and audio FIRs, got {k} and "
                         f"{taps_of(audio_toep, d)}")
    if d < 1 or nd % d or nd % CHUNK_ROWS:
        raise ValueError(f"nd={nd} must be a multiple of the decimation "
                         f"{d} and of {CHUNK_ROWS}")
    if tile_rows % CHUNK_ROWS or tile_rows < 2 * k:
        raise ValueError(f"tile_rows={tile_rows} must be a multiple of "
                         f"{CHUNK_ROWS} and at least {2 * k}")
    width = 2 * c if packed else c
    _check("ci_planes", ci_planes, torch.float32, (nd, width), dev)
    if not packed:
        _check("cq_planes", cq_planes, torch.float32, (nd, c), dev)
    for name, x, dt, shape in (
        ("phase0", phase0, torch.int64, (c,)),
        ("phase_step", phase_step, torch.int64, (c,)),
        ("mode", mode, torch.int32, (c,)),
        ("chan_hist_i", chan_hist_i, torch.float32, (k - 1, c)),
        ("chan_hist_q", chan_hist_q, torch.float32, (k - 1, c)),
        ("demod_prev", demod_prev, torch.float32, (2, c)),
        ("audio_hist", audio_hist, torch.float32, (k - 1, c)),
    ):
        _check(name, x, dt, shape, dev)
    for name, w in (("w_toep", w_toep), ("audio_toep", audio_toep)):
        if w.device != dev or w.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")

    # column 0 of a banded weight matrix holds the reversed kernel
    h_shape = w_toep[:k, 0].contiguous()
    h_audio = audio_toep[:k, 0].contiguous()
    n_tiles = -(-nd // tile_rows)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=dev)
    audio48 = empty(nd // d, c)
    hist_i, hist_q, ahist = empty(k - 1, c), empty(k - 1, c), empty(k - 1, c)
    new_prev = empty(2, c)
    power_part = empty(n_tiles, c)
    power = empty(c)
    xi = ci_planes.data_ptr()
    if packed:
        # Q starts C floats (4 bytes each) into a row of 2C floats
        xq, row_stride = xi + 4 * c, 2 * c
    else:
        xq, row_stride = cq_planes.data_ptr(), c

    lib = _build.load_library()
    code = lib.webradio_tail_tm_launch(
        xi, xq, row_stride, phase0.data_ptr(), phase_step.data_ptr(),
        h_shape.data_ptr(), h_audio.data_ptr(), mode.data_ptr(),
        chan_hist_i.data_ptr(), chan_hist_q.data_ptr(),
        demod_prev.data_ptr(), audio_hist.data_ptr(), audio48.data_ptr(),
        hist_i.data_ptr(), hist_q.data_ptr(), new_prev.data_ptr(),
        ahist.data_ptr(), power_part.data_ptr(), power.data_ptr(),
        nd, c, k, d, tile_rows, int(bool(fast)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "fused_tail_audio_tm kernel launch")
    fused_tail_audio_tm.launches += 1
    return audio48, hist_i, hist_q, new_prev, ahist, power


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
        (columns ``[:C]`` I, ``[C:]`` Q), read in place.
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
      precision: a ``ChannelizedConfig.fir_precision`` name; all are fp32.
      fast: full-angle LO instead of the 16-bit table law.
      mode_set: accepted for signature parity; the kernel switches on
        ``mode`` per channel at run time.

    Returns ``(audio48 [nd // D, C], new_hist_i, new_hist_q,
    new_demod_prev, new_audio_hist, power [C])``.

    CUDA tensors go to the kernel (``fused_tail_audio_tm.launches`` counts
    each launch); CPU tensors to :func:`fused_tail_audio_tm_ref`.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    args = (ci_planes, cq_planes, phase0, phase_step, w_toep, audio_toep,
            decimation, mode, chan_hist_i, chan_hist_q, demod_prev,
            audio_hist)
    if ci_planes.device.type == "cuda":
        return _launch(*args, packed, fast, TILE_ROWS)
    if ci_planes.device.type != "cpu":
        raise ValueError(f"no tail kernel for device {ci_planes.device}")
    return fused_tail_audio_tm_ref(*args, precision=precision,
                                   packed=packed, fast=fast)


fused_tail_audio_tm.launches = 0
