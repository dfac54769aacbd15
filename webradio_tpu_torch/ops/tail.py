"""Fused time-minor receiver tail: mix + per-channel shaping FIR + demod.

Port of ``webradio_tpu.ops.pallas_tail.fused_receiver_tail``, the tail of
the channelized step's per-channel fallback (``use_pallas_tail=True``):
planes ``[2, C, nd]`` with time as the minor axis, per-channel FIR
coefficients, the table-law LO only. For CUDA tensors
:func:`fused_receiver_tail` launches the hand-written Hopper kernel
``csrc/tail.cu`` (design notes at the top of that file); for tensors on the
CPU it runs :func:`fused_receiver_tail_ref`, the plain torch version.

The cross-block FIR state is the RAW (pre-mix) input tail, not the mixed
tail of the unfused chain: history samples are re-mixed at negative sample
indices, whose phase ``(phase0 + n * step) mod 2^31`` the uint32 wrap gives
exactly. A state is therefore not carried between this tail and any other.
"""

from __future__ import annotations

import torch

from .demod import demodulate
from .fir import fir_decimate
from .launches import count_launch
from .nco import PHASE_MASK, nco_mix
from .tail_tm import KERNEL_TAPS, _check, _empty

#: samples per CUDA block (the JAX kernel's time chunk too); a block of
#: samples that is not whole chunks ends in a shorter one. The kernel runs
#: one block per channel, so any channel count passes (the JAX kernel's
#: 8-channel tile is a Pallas tile)
TIME_CHUNK = 1024
#: nd must be a multiple (a kernel thread makes 8 outputs, 16-byte stores)
#: and at least the FIR's length (the new history is the block's last K-1)
TIME_ROWS = 16


def shape_refusal(nd: int, taps: int) -> str | None:
    """Why the kernel cannot take these shapes, or None: the CUDA
    kernel's own test, which the wrapper raises with and the card's
    selection rule reads (``pipeline.channelized.tail_branch``, and on
    each time shard ``parallel.sharded_channelized``). The JAX kernel
    takes whole chunks of :data:`TIME_CHUNK`; this one any multiple of
    :data:`TIME_ROWS` (the time shards of a stock block hold 2,560 rows on
    a (4, 1) mesh)."""
    if taps != KERNEL_TAPS:
        return (f"the kernel is built for {KERNEL_TAPS}-tap shaping FIRs, "
                f"got {taps}")
    if nd < taps or nd % TIME_ROWS or -(-nd // TIME_CHUNK) > 65_535:
        return (f"block {nd} must be a multiple of {TIME_ROWS}, at least "
                f"the {taps} taps")
    return None


def fused_receiver_tail_ref(chan_in, phase0, phase_step, chan_coeff, mode,
                            raw_hist, demod_prev):
    """Plain torch version of :func:`fused_receiver_tail` (same arguments,
    same returns): ``nco_mix`` over raw history plus block, starting at
    sample ``-(K-1)``, then ``fir_decimate`` with per-channel coefficients,
    ``demodulate`` and the block-mean power."""
    k = chan_coeff.shape[-1]
    nd = chan_in.shape[-1]
    # phase of sample -(K-1): int64 two's complement & mask is mod 2^31
    start = (phase0 - (k - 1) * phase_step) & PHASE_MASK
    mixed = nco_mix(torch.cat([raw_hist, chan_in], dim=-1), start,
                    phase_step)
    shaped, _ = fir_decimate(mixed[..., k - 1:], chan_coeff, 1,
                             mixed[..., :k - 1])
    audio, new_prev = demodulate(shaped, mode, demod_prev)
    power = (shaped[0] * shaped[0] + shaped[1] * shaped[1]).sum(dim=-1) * (
        1.0 / nd)
    return audio, chan_in[:, :, nd - (k - 1):].contiguous(), new_prev, power


def _launch(chan_in, phase0, phase_step, chan_coeff, mode, raw_hist,
            demod_prev):
    from . import _build

    dev = chan_in.device
    _, c, nd = chan_in.shape
    k = chan_coeff.shape[-1]
    why = shape_refusal(nd, k)
    if why:
        raise ValueError(why)
    for name, x, dt, shape in (
        ("chan_in", chan_in, torch.float32, (2, c, nd)),
        ("phase0", phase0, torch.int64, (c,)),
        ("phase_step", phase_step, torch.int64, (c,)),
        ("chan_coeff", chan_coeff, torch.float32, (c, k)),
        ("mode", mode, torch.int32, (c,)),
        ("raw_hist", raw_hist, torch.float32, (2, c, k - 1)),
        ("demod_prev", demod_prev, torch.float32, (2, c)),
    ):
        _check(name, x, dt, shape, dev)
    audio = _empty(dev, c, nd)
    new_prev = _empty(dev, 2, c)
    power_part = _empty(dev, -(-nd // TIME_CHUNK), c)
    power = _empty(dev, c)

    lib = _build.load_library()
    code = lib.webradio_receiver_tail_launch(
        chan_in.data_ptr(), phase0.data_ptr(), phase_step.data_ptr(),
        chan_coeff.data_ptr(), mode.data_ptr(), raw_hist.data_ptr(),
        demod_prev.data_ptr(), audio.data_ptr(), new_prev.data_ptr(),
        power_part.data_ptr(), power.data_ptr(), nd, c, k, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "fused_receiver_tail kernel launch")
    count_launch(fused_receiver_tail)
    return audio, chan_in[:, :, nd - (k - 1):].contiguous(), new_prev, power


def fused_receiver_tail(
    chan_in: torch.Tensor,
    phase0: torch.Tensor,
    phase_step: torch.Tensor,
    chan_coeff: torch.Tensor,
    mode: torch.Tensor,
    raw_hist: torch.Tensor,
    demod_prev: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused mix, shaping FIR and demod over ``[2, C, nd]`` selected-bin
    planes.

    Args (the JAX function's):
      chan_in: ``[2, C, nd]`` float32; ``nd`` a multiple of
        :data:`TIME_ROWS`, any ``C``.
      phase0 / phase_step: ``[C]`` int64 holding the uint32 residual NCO
        phase of this block's first sample and the per-sample step.
      chan_coeff: ``[C, K]`` float32 design-order coefficients.
      mode: ``[C]`` int32 demod law.
      raw_hist: ``[2, C, K-1]`` float32, the RAW input tail of the previous
        block.
      demod_prev: ``[2, C]`` float32 previous shaped sample (FM lag).

    Returns ``(audio [C, nd], new_raw_hist, new_demod_prev, power [C])``
    with ``power`` the block-mean post-shaping-FIR magnitude squared.

    CUDA tensors go to the kernel (``fused_receiver_tail.launches`` counts
    each launch); CPU tensors to :func:`fused_receiver_tail_ref`.
    """
    why = shape_refusal(chan_in.shape[2], KERNEL_TAPS)
    if why:
        raise ValueError(why)
    args = (chan_in, phase0, phase_step, chan_coeff, mode, raw_hist,
            demod_prev)
    if chan_in.device.type == "cuda":
        return _launch(*args)
    if chan_in.device.type != "cpu":
        raise ValueError(f"no tail kernel for device {chan_in.device}")
    return fused_receiver_tail_ref(*args)


fused_receiver_tail.launches = 0
