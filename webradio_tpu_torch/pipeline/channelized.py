"""Channelized front-end: shared polyphase filterbank + per-channel tail.

Port of ``webradio_tpu.pipeline.channelized`` — the serving step the
server's block pump runs once per block from 16 receivers up:

  1. spectrum: a windowed DFT per ``fft_size`` frames (``ops.spectrum``);
  2. filterbank: im2col frames and one ``[nd, 2K_p] x [2K_p, 2C]`` GEMM
     to the packed ``[nd, 2C]`` product at the configuration's
     ``pfb_precision`` tier (``ops.channelizer``: true float32, or a law on
     bfloat16 operands; the "bf16" tier stores the product as bfloat16,
     which kernels #1 and #2 read as it is and the plain tails as
     ``.float()``);
  3. receiver tail: residual NCO mix, 64-tap shaping FIR, demod, squelch
     power and the decimating audio FIR. Every branch of the JAX step on
     one device is here, with a Hopper kernel wherever the same
     configuration selects a Pallas kernel in the JAX package:
     ``ops.tail_tm.fused_tail_audio_tm`` on the packed product (the main
     path), ``ops.tail_tm.fused_pfb_tail_audio_tm`` on the im2col frames
     (``tail_kernel="pallas_pfb"``), ``ops.tail_tm.fused_tail_tm`` plus the
     Toeplitz audio FIR where the audio decimation admits no audio time
     tile (``audio_rate=9_600``), and for slots whose bandwidths differ the
     per-channel fallback, through ``ops.tail.fused_receiver_tail`` or
     plain;
  4. squelch and gain scale.

Which tail runs (:func:`tail_branch`): on a CUDA device every tail that a
ported kernel computes runs that kernel, at any channel count, unless
``tail_kernel="xla"`` asks for the plain tail (the way to read the plain
side on the card) or the kernel refuses the shapes (a FIR length other
than 64), which the pipeline says when it is built (``plain_tail``). On the
CPU the JAX package's rule picks the branch exactly (the time-major kernel
from :data:`PALLAS_TM_AUTO_THRESHOLD` channels on its Pallas tiles, the
per-channel kernel under ``use_pallas_tail``), and each kernel's plain
version computes it, which is what the CPU tests hold against JAX.

Layouts are the JAX package's, so states and parameters carry over
(``webradio_tpu_torch.convert``). The control plane is here too:
``scatter_params_slots``, ``grow_channelized_state`` and the catch-up path
``ChannelizedPipeline.process_host_many``.

State: the functional :func:`channelized_step` returns a new state, as the
JAX step does. ``ChannelizedPipeline`` keeps its state in persistent buffers
and copies each step's carries into them in place where the JAX package
donates the state to its jitted step (``donate_argnames=("state",)``); on
the card the step, its H2D copy and its outputs run as one captured CUDA
graph per block (``pipeline.graph``). The kernels' fresh carry outputs are
copied back, never aliased with the carries they read.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import require_cuda
from ..ops.channelizer import (
    assign_bins,
    bin_weights_for_channels,
    design_prototype,
    pfb_channelize_direct,
    pfb_channelize_direct_tm,
    pfb_frames_tm,
    split_weights_u8,
)
from ..ops.demod import MODES, demodulate
from ..ops.fir import (
    fir_decimate_toeplitz_tm,
    fir_dispatch,
    maybe_toeplitz_weights,
)
from ..ops.firdesign import FIR_LENGTH, design_lowpass_fir_cached
from ..ops.nco import (
    PHASE_MASK,
    nco_advance,
    nco_mix,
    nco_mix_tm,
    nco_mix_tm_fast,
    nco_phase_step,
    nco_unmix,
)
from ..ops.spectrum import DEFAULT_FFT_SIZE, spectrum_accumulate, spectrum_db
from ..ops.tail import fused_receiver_tail
from ..ops.tail import shape_refusal as channel_shape_refusal
from ..ops.tail_tm import (
    CHAN_TILE,
    fused_pfb_tail_audio_tm,
    fused_tail_audio_tm,
    fused_tail_tm,
    tail_after_mix_tm,
)
from ..ops.tail_tm import shape_refusal as tm_shape_refusal
from .frontend import HostPipeline, squelch_scale
from .state import _squelch_array, expand_controls

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ChannelizedConfig:
    """Static shape of a channelized front-end (the JAX package's fields
    and validation).

    ``fir_precision`` accepts all four names; the port computes each as
    float32 (hx5, hx4 and high are TPU MXU pass counts). ``tail_kernel``
    "xla" runs the plain tails on every device; on the card "auto" and
    "pallas" take the kernels at every width, and on the CPU (the JAX
    rule) "auto" takes the time-major kernel from
    :data:`PALLAS_TM_AUTO_THRESHOLD` channels and "pallas" always;
    "pallas_pfb" is "pallas" with the filterbank product made inside the
    kernel. ``use_pallas_tail`` takes the per-channel (time-minor) branch
    through its kernel on every device (on the card that branch takes it
    anyway); ``chan_hist`` then carries the RAW pre-mix tail
    (:func:`carries_raw`). ``pfb_precision`` picks the filterbank product's law
    (``ops.channelizer``); "pallas_pfb" takes "highest", "default" and
    "high" (the kernel makes the product), as in the JAX package.
    """

    sample_rate: int = 2_400_000
    channel_rate: int = 240_000
    audio_rate: int = 48_000
    block_frames: int = 102_400
    num_channels: int = 1
    taps_per_phase: int = 16
    fir_length: int = FIR_LENGTH
    fft_size: int = DEFAULT_FFT_SIZE
    use_pallas_tail: bool = False
    fast_nco: bool = True
    fir_precision: str = "highest"
    tail_kernel: str = "auto"
    pfb_precision: str = "highest"
    fir_design: str = "reference"

    _FIR_PRECISIONS = ("highest", "hx5", "hx4", "high")
    _TAIL_KERNELS = ("auto", "xla", "pallas", "pallas_pfb")
    _PFB_PRECISIONS = ("default", "high", "highest", "u8exact", "bf16")

    def __post_init__(self):
        if self.sample_rate % self.channel_rate:
            raise ValueError("sample_rate must be a multiple of channel_rate")
        if self.channel_rate % self.audio_rate:
            raise ValueError("channel_rate must be a multiple of audio_rate")
        if self.block_frames % self.fft_size:
            raise ValueError("block_frames must be a multiple of fft_size")
        if self.block_frames % (self.num_bins * self.audio_decim):
            raise ValueError(
                "block_frames must be a multiple of num_bins * audio_decim"
            )
        if self.fir_precision not in self._FIR_PRECISIONS:
            raise ValueError(
                f"fir_precision must be one of {self._FIR_PRECISIONS}"
            )
        if self.tail_kernel not in self._TAIL_KERNELS:
            raise ValueError(
                f"tail_kernel must be one of {self._TAIL_KERNELS}"
            )
        if self.pfb_precision not in self._PFB_PRECISIONS:
            raise ValueError(
                f"pfb_precision must be one of {self._PFB_PRECISIONS}"
            )
        if self.tail_kernel == "pallas_pfb" and self.pfb_precision in (
                "u8exact", "bf16"):
            raise ValueError(
                "tail_kernel='pallas_pfb' does not implement the "
                f"{self.pfb_precision} law (it never materializes the "
                "packed product); use the default packed path"
            )
        if self.fir_design not in ("reference", "sinc"):
            raise ValueError("fir_design must be 'reference' or 'sinc'")

    @property
    def num_bins(self) -> int:
        return self.sample_rate // self.channel_rate

    @property
    def audio_decim(self) -> int:
        return self.channel_rate // self.audio_rate

    @property
    def proto_taps(self) -> int:
        return self.num_bins * self.taps_per_phase

    @property
    def chan_frames(self) -> int:
        return self.block_frames // self.num_bins

    @property
    def audio_frames(self) -> int:
        return self.chan_frames // self.audio_decim

    @property
    def block_seconds(self) -> float:
        return self.block_frames / self.sample_rate


class ChannelizedParams(NamedTuple):
    pfb_weights: torch.Tensor  # [2 K_p, 2, C] float32
    residual_step: torch.Tensor  # [C] int64 holding uint32 (channel rate)
    chan_coeff: torch.Tensor  # [C, K] float32 (decim-1 shaping FIR)
    audio_coeff: torch.Tensor  # [C, K] float32
    mode: torch.Tensor  # [C] int32
    af_gain: torch.Tensor  # [C] float32 — linear audio gain
    squelch: torch.Tensor  # [C] float32 — gate threshold (dB; NaN = off)
    #: shared banded weights, present iff every channel shares the kernel
    chan_toep: torch.Tensor | None = None  # [span1, T1] float32
    audio_toep: torch.Tensor | None = None  # [span2, T2] float32
    #: host-split bfloat16 hi/lo filterbank weights ([2, 2K_p, 2, C], see
    #: ops.channelizer.split_weights_u8), present iff cfg.pfb_precision is
    #: not "highest": u8exact and high read both halves, default and bf16
    #: (and kernel #3 at default) the hi half. The JAX package keeps them
    #: for u8exact only and splits in its kernels; here the split is made
    #: once per parameter set
    pfb_weights_split: torch.Tensor | None = None


class ChannelizedState(NamedTuple):
    pfb_hist: torch.Tensor  # [2, K_p - 1] float32
    nco_phase: torch.Tensor  # [C] int64 holding uint32 (residual)
    #: [2, C, K - 1] float32: the mixed-domain tail, or the RAW selected-bin
    #: tail where the per-channel kernel runs (:func:`carries_raw`)
    chan_hist: torch.Tensor
    demod_prev: torch.Tensor  # [2, C] float32
    audio_hist: torch.Tensor  # [C, K - 1] float32


def make_channelized_params(
    cfg: ChannelizedConfig,
    if_hz,
    if_bandwidth_hz,
    af_bandwidth_hz,
    mode,
    af_gain_db=0,
    squelch_db=None,
    actual_sample_rate=None,
    device: torch.device | str | None = None,
) -> ChannelizedParams:
    """Build parameters on ``device`` (None: the CUDA device, and an error
    where there is none) from per-receiver control values (scalars or
    length-``num_channels`` sequences); the host-side design is the JAX
    package's, value for value."""
    if device is None:
        device = require_cuda()
    c = cfg.num_channels
    ifs, ifbws, afbws, modes, gains, squelches = expand_controls(
        c, if_hz, if_bandwidth_hz, af_bandwidth_hz, mode, af_gain_db,
        squelch_db)
    if not (len(ifs) == len(ifbws) == len(afbws) == len(modes) == c):
        raise ValueError("parameter lists must match num_channels")

    fs = int(actual_sample_rate) if actual_sample_rate else cfg.sample_rate
    proto = design_prototype(cfg.sample_rate, cfg.num_bins, cfg.taps_per_phase)
    bin_idx, residual = assign_bins(ifs, fs, cfg.num_bins)
    weights = bin_weights_for_channels(proto, cfg.num_bins, bin_idx)
    # residual step at the channel rate fs/D: (r*D) * 2^31 / fs exactly
    steps = np.array(
        [nco_phase_step(int(r) * cfg.num_bins, fs) for r in residual],
        dtype=np.int64,
    )
    chan = np.stack(
        [design_lowpass_fir_cached(bw, cfg.channel_rate, cfg.fir_length,
                                   cfg.fir_design)
         for bw in ifbws]
    )
    audio = np.stack(
        [design_lowpass_fir_cached(bw, cfg.channel_rate, cfg.fir_length,
                                   cfg.fir_design)
         for bw in afbws]
    )
    mode_idx = np.array(
        [MODES.index(m) if isinstance(m, str) else int(m) for m in modes],
        dtype=np.int32,
    )
    gain = np.power(10.0, np.array(gains, np.float32) / 20.0).astype(
        np.float32)

    def dev(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(device)

    return ChannelizedParams(
        pfb_weights=dev(weights),
        pfb_weights_split=(split_weights_u8(weights).to(device)
                           if cfg.pfb_precision != "highest" else None),
        residual_step=dev(steps),
        chan_coeff=dev(chan),
        audio_coeff=dev(audio),
        mode=dev(mode_idx),
        af_gain=dev(gain),
        squelch=dev(_squelch_array(squelches)),
        chan_toep=dev(maybe_toeplitz_weights(chan, 1, cfg.chan_frames)),
        audio_toep=dev(maybe_toeplitz_weights(audio, cfg.audio_decim,
                                              cfg.audio_frames)),
    )


def scatter_params_slots(params: ChannelizedParams, idx,
                         sub: ChannelizedParams) -> ChannelizedParams:
    """Apply a control write for a FEW slots without re-shipping the whole
    parameter set: only the dirty slots' columns travel to the device
    (``sub`` is :func:`make_channelized_params` at width ``len(idx)``, on
    any device) and an indexed assignment updates the resident tensors.

    Unlike the JAX function this writes IN PLACE (the filterbank weights
    are the largest resident tensor; no second copy is made) and returns
    ``params`` itself. The shared Toeplitz matrices are left as they are:
    the fast path only applies while every channel still shares the FIR
    kernels, which the caller checks.
    """
    dev = params.pfb_weights.device
    idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    params.pfb_weights[:, :, idx] = sub.pfb_weights.to(dev)
    if params.pfb_weights_split is not None:
        params.pfb_weights_split[:, :, :, idx] = sub.pfb_weights_split.to(dev)
    for name in ("residual_step", "chan_coeff", "audio_coeff", "mode",
                 "af_gain", "squelch"):
        getattr(params, name)[idx] = getattr(sub, name).to(dev)
    return params


def init_channelized_state(
    cfg: ChannelizedConfig, device: torch.device | str | None = None
) -> ChannelizedState:
    """Zero state on ``device`` (None: the CUDA device, and an error where
    there is none)."""
    if device is None:
        device = require_cuda()
    c, k, kp = cfg.num_channels, cfg.fir_length, cfg.proto_taps
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return ChannelizedState(
        pfb_hist=z(2, kp - 1),
        nco_phase=torch.zeros(c, dtype=torch.int64, device=device),
        chan_hist=z(2, c, k - 1),
        demod_prev=z(2, c),
        audio_hist=z(c, k - 1),
    )


def grow_channelized_state(state: ChannelizedState,
                           new_channels: int) -> ChannelizedState:
    """Carry state across a capacity growth: the shared filterbank history
    is width-independent; per-channel carries pad with init zeros, which
    are zeros in either history domain. Valid across the plain and kernel
    time-major tails (both carry the MIXED FIR tail, so a width-driven
    "auto" flip keeps the carry meaningful); a growth that moves between
    the mixed and the raw domain converts first
    (:meth:`ChannelizedPipeline.state_for`)."""
    pad = new_channels - int(state.nco_phase.shape[0])
    if pad < 0:
        raise ValueError("capacity can only grow")
    if pad == 0:
        return state
    return ChannelizedState(
        pfb_hist=state.pfb_hist,
        nco_phase=F.pad(state.nco_phase, (0, pad)),
        chan_hist=F.pad(state.chan_hist, (0, 0, 0, pad)),
        demod_prev=F.pad(state.demod_prev, (0, pad)),
        audio_hist=F.pad(state.audio_hist, (0, 0, 0, pad)),
    )


def mode_set_of(modes) -> tuple[int, ...]:
    """Sorted distinct mode ids of a mode array. Accepted by the step for
    signature parity: the CUDA kernel switches on each channel's mode at
    run time, so no mode set is compiled in."""
    if isinstance(modes, torch.Tensor):
        modes = modes.cpu().numpy()
    return tuple(sorted({int(m) for m in np.asarray(modes).ravel()}))


#: channel count from which "auto" takes the fused tail kernel on the CPU:
#: the JAX package's value (a v5e crossover of Pallas against XLA's
#: fusions), kept so the CPU selects as the JAX package does. On the card
#: the other side of the choice is the plain reference, so the kernel
#: serves at every width
PALLAS_TM_AUTO_THRESHOLD = 512
#: the JAX kernels' time tile; the CPU's rule wants nd a multiple for any
#: time-major kernel branch (the CUDA kernels take rows in 16s)
SELECT_TIME_TILE = 1024


def on_card(x: torch.Tensor) -> bool:
    """Whether the card's selection applies to a step whose tensors sit
    where ``x`` does: on a CUDA device every tail that a ported kernel
    computes runs that kernel; elsewhere the JAX package's rule picks the
    branch and each kernel's plain version computes it. (A CPU test
    replaces this function to run the card's choice through the plain
    versions.)"""
    return x.device.type == "cuda"


def tm_kernel_refusal(cfg: ChannelizedConfig, nd: int, c: int,
                      params) -> str | None:
    """Why the time-major kernel that a step (or a shard) of ``nd`` rows
    and ``c`` channels would launch refuses its shapes, or None (the
    kernel's own test, ``ops.tail_tm.shape_refusal``)."""
    pfb = (cfg.tail_kernel == "pallas_pfb"
           and _audio_time_tile(nd, cfg.audio_decim,
                                params.chan_toep.shape[1]) > 0)
    return tm_shape_refusal(nd, c, cfg.audio_decim, cfg.fir_length, pfb=pfb,
                            bf16=cfg.pfb_precision == "bf16" and not pfb)


def tm_kernel_rule(cfg: ChannelizedConfig, nd: int, c: int, params) -> bool:
    """Whether the time-major tail of a step, or of a shard, over ``nd``
    rows and ``c`` channels runs a kernel; the one rule of the single-card
    step and of each shard (``parallel.sharded_channelized``). On the card:
    unless ``tail_kernel="xla"`` or the kernel refuses the shapes. On the
    CPU: the JAX package's ``_use_pallas_tm`` on the same sizes."""
    if cfg.tail_kernel == "xla" or params.chan_toep is None:
        return False
    if on_card(params.mode):
        return tm_kernel_refusal(cfg, nd, c, params) is None
    if cfg.tail_kernel == "auto" and c < PALLAS_TM_AUTO_THRESHOLD:
        return False
    return (
        nd % SELECT_TIME_TILE == 0
        and c % CHAN_TILE == 0
        and SELECT_TIME_TILE % params.chan_toep.shape[1] == 0
    )


def _use_kernel_tm(cfg: ChannelizedConfig, nd: int, params) -> bool:
    """Whether the single-card step's time-major tail runs a kernel
    (:func:`tm_kernel_rule` at the full width)."""
    return tm_kernel_rule(cfg, nd, cfg.num_channels, params)


def _use_tm(cfg: ChannelizedConfig, nd: int, params) -> bool:
    """Whether the step takes the time-major tail (every slot shares the
    FIR kernels and the blocks hold whole Toeplitz tiles) rather than the
    per-channel fallback: the JAX package's rule on every device."""
    return (
        not cfg.use_pallas_tail
        and params.chan_toep is not None
        and params.audio_toep is not None
        and nd % params.chan_toep.shape[1] == 0
        and (nd // cfg.audio_decim) % params.audio_toep.shape[1] == 0
    )


def _use_kernel_channel(cfg: ChannelizedConfig, nd: int, params) -> bool:
    """Whether the per-channel fallback runs its kernel
    (``ops.tail.fused_receiver_tail``): under ``use_pallas_tail`` on every
    device (its wrapper raises where it refuses the shapes), and on the
    card unless ``tail_kernel="xla"`` or the kernel refuses them."""
    if cfg.use_pallas_tail:
        return True
    return (on_card(params.mode) and cfg.tail_kernel != "xla"
            and channel_shape_refusal(nd, cfg.fir_length) is None)


def tail_branch(cfg: ChannelizedConfig, params) -> tuple[bool, bool]:
    """``(time_major, kernel)``: the tail a step of these parameters runs,
    the time-major one or the per-channel fallback, through a kernel or
    plain."""
    nd = cfg.chan_frames
    if _use_tm(cfg, nd, params):
        return True, _use_kernel_tm(cfg, nd, params)
    return False, _use_kernel_channel(cfg, nd, params)


def carries_raw(cfg: ChannelizedConfig, params) -> bool:
    """Whether a step of these parameters carries the RAW selected-bin
    history in ``chan_hist`` (the per-channel kernel re-mixes it) rather
    than the mixed one (every other tail)."""
    return tail_branch(cfg, params) == (False, True)


def tail_refusal(cfg: ChannelizedConfig, params) -> str | None:
    """On the card, why a step of these parameters runs a plain tail that
    ``tail_kernel`` does not ask for (a kernel refuses the shapes), else
    None; None on the CPU, where the JAX rule decides."""
    if not on_card(params.mode) or cfg.tail_kernel == "xla":
        return None
    nd = cfg.chan_frames
    if _use_tm(cfg, nd, params):
        why = tm_kernel_refusal(cfg, nd, cfg.num_channels, params)
        return why and f"time-major tail kernel: {why}"
    if cfg.use_pallas_tail:
        return None  # asked for by name: its wrapper raises, nothing is plain
    why = channel_shape_refusal(nd, cfg.fir_length)
    return why and f"per-channel tail kernel: {why}"


def switch_hist_domain(chan_hist: torch.Tensor, nco_phase: torch.Tensor,
                       residual_step: torch.Tensor,
                       to_raw: bool) -> torch.Tensor:
    """``chan_hist [2, C, K-1]`` carried into the other history domain.

    The mixed tail is the raw one mixed at the table law (the per-channel
    branch's LO, the kernel's and the plain fallback's alike, whatever
    ``fast_nco`` says) at the ``K-1`` samples before the block whose first
    sample has phase ``nco_phase``: ``to_raw`` turns it back with the LO
    itself. The per-channel kernel re-mixes a raw history with exactly
    these phasors (``ops.tail.fused_receiver_tail_ref``), so across a
    switch it shapes the history that the plain fallback would have read,
    and the time-major tail after it reads what the plain fallback would
    have carried. ``residual_step`` is the one the raw history is mixed
    with: the new parameters' going to the kernel, the old ones' coming
    from it."""
    k1 = chan_hist.shape[-1]
    step = residual_step[:chan_hist.shape[1]]
    start = (nco_phase - k1 * step) & PHASE_MASK
    return (nco_unmix if to_raw else nco_mix)(chan_hist, start, step)


def _audio_time_tile(nd: int, d: int, fir_tile: int) -> int:
    """The JAX audio kernels' time tile (largest multiple of
    ``lcm(fir_tile, d)`` <= 2048 dividing ``nd``; 0 if none). A 0 sends
    the step to the channel-rate-audio kernel ``fused_tail_tm`` followed
    by the Toeplitz audio FIR, also under ``tail_kernel="pallas_pfb"``."""
    base = fir_tile * d // math.gcd(fir_tile, d)
    best = 0
    m = base
    while m <= 2048:
        if nd % m == 0:
            best = m
        m += base
    return best


def _channelize_tm(cfg, params, pfb_hist, iq, split):
    """The wideband stage at the configuration's tier (the JAX package's
    ``_channelize_tm``, which off the TPU runs u8exact at HIGHEST; here
    every tier computes its own law on every device)."""
    return pfb_channelize_direct_tm(
        iq, params.pfb_weights, cfg.num_bins, pfb_hist, split=split,
        precision=cfg.pfb_precision,
        weights_split=params.pfb_weights_split)


def _channelized_step(cfg, params, state, iq, time_major):
    spectra = spectrum_accumulate(iq, cfg.fft_size)
    nco_phase = nco_advance(state.nco_phase, params.residual_step,
                            cfg.chan_frames)
    nd = iq.shape[-1] // cfg.num_bins
    d = cfg.audio_decim
    c = cfg.num_channels

    # ---- preferred path: the time-major tail on the filterbank product
    if _use_tm(cfg, nd, params):
        if _use_kernel_tm(cfg, nd, params):
            has_tile = _audio_time_tile(nd, d, params.chan_toep.shape[1])
            lo = (state.nco_phase, params.residual_step)
            carries = (state.chan_hist[0].T.contiguous(),
                       state.chan_hist[1].T.contiguous(), state.demod_prev)
            if cfg.tail_kernel == "pallas_pfb" and has_tile:
                # the filterbank product is made inside the kernel from
                # the im2col frames and never reaches device memory
                frames, pfb_hist = pfb_frames_tm(
                    iq, cfg.proto_taps, cfg.num_bins, state.pfb_hist)
                audio, hist_i, hist_q, demod_prev, ahist, power = (
                    fused_pfb_tail_audio_tm(
                        frames,
                        params.pfb_weights.reshape(2 * cfg.proto_taps, 2 * c),
                        *lo, params.chan_toep, params.audio_toep, d,
                        params.mode, *carries,
                        state.audio_hist.T.contiguous(),
                        precision=cfg.fir_precision, fast=cfg.fast_nco,
                        pfb_precision=cfg.pfb_precision,
                        pfb_weights_split=params.pfb_weights_split,
                    ))
            else:
                # the packed product, bfloat16 under the "bf16" tier: the
                # kernels read it as it is
                y2, _, pfb_hist = _channelize_tm(cfg, params, state.pfb_hist,
                                                 iq, split=False)
                if has_tile:
                    audio, hist_i, hist_q, demod_prev, ahist, power = (
                        fused_tail_audio_tm(
                            y2, y2, *lo, params.chan_toep, params.audio_toep,
                            d, params.mode, *carries,
                            state.audio_hist.T.contiguous(),
                            precision=cfg.fir_precision, packed=True,
                            fast=cfg.fast_nco,
                        ))
                else:
                    # no audio time tile: channel-rate audio from the
                    # kernel, then the Toeplitz audio FIR
                    audio_tm, hist_i, hist_q, demod_prev, power = (
                        fused_tail_tm(
                            y2, y2, *lo, params.chan_toep, params.mode,
                            *carries, precision=cfg.fir_precision,
                            packed=True, fast=cfg.fast_nco,
                        ))
                    audio, ahist = fir_decimate_toeplitz_tm(
                        audio_tm, params.audio_toep, d, state.audio_hist.T)
        else:
            ci, cq, pfb_hist = _channelize_tm(cfg, params, state.pfb_hist,
                                              iq, split=True)
            # the plain tail computes in float32 (the "bf16" tier's product
            # is bfloat16)
            mix_tm = nco_mix_tm_fast if cfg.fast_nco else nco_mix_tm
            mi, mq = mix_tm(ci.float(), cq.float(), state.nco_phase,
                            params.residual_step)
            audio, hist_i, hist_q, demod_prev, ahist, power = (
                tail_after_mix_tm(
                    mi, mq, params.chan_toep, params.audio_toep, d,
                    params.mode, state.chan_hist[0].T, state.chan_hist[1].T,
                    state.demod_prev, state.audio_hist.T,
                ))
        # squelch gate on the post-shaping-FIR (in-band) mean |y|^2
        scale = squelch_scale(power, params.af_gain, params.squelch)
        if time_major:
            audio = audio * scale[None, :]  # stays [audio_frames, C]
        else:
            audio = audio.T * scale[:, None]  # [C, audio_frames]
        return ChannelizedState(
            pfb_hist=pfb_hist,
            nco_phase=nco_phase,
            chan_hist=torch.stack([hist_i.T, hist_q.T]),
            demod_prev=demod_prev,
            audio_hist=ahist.T,
        ), audio, spectra

    # ---- per-channel fallback (slots whose bandwidths differ, or
    # use_pallas_tail): time-minor float32 planes [2, C, nd] at any tier,
    # channel-major carries
    chan_in, pfb_hist = pfb_channelize_direct(
        iq, params.pfb_weights, cfg.num_bins, state.pfb_hist,
        precision=cfg.pfb_precision, weights_split=params.pfb_weights_split)
    if _use_kernel_channel(cfg, nd, params):
        # chan_hist carries the RAW selected-bin tail here
        audio_if, chan_hist, demod_prev, power = fused_receiver_tail(
            chan_in, state.nco_phase, params.residual_step,
            params.chan_coeff, params.mode, state.chan_hist.contiguous(),
            state.demod_prev.contiguous(),
        )
    else:
        mixed = nco_mix(chan_in, state.nco_phase, params.residual_step)
        shaped, chan_hist = fir_dispatch(
            mixed, params.chan_coeff, params.chan_toep, 1, state.chan_hist)
        audio_if, demod_prev = demodulate(shaped, params.mode,
                                          state.demod_prev)
        power = (shaped[0] ** 2 + shaped[1] ** 2).mean(dim=-1)  # [C]
    audio, audio_hist = fir_dispatch(
        audio_if, params.audio_coeff, params.audio_toep, d, state.audio_hist)
    audio = audio * squelch_scale(power, params.af_gain,
                                  params.squelch)[:, None]
    if time_major:
        audio = audio.T  # the serving layout, one small transpose
    return ChannelizedState(
        pfb_hist=pfb_hist,
        nco_phase=nco_phase,
        chan_hist=chan_hist,
        demod_prev=demod_prev,
        audio_hist=audio_hist,
    ), audio, spectra


def channelized_step(
    cfg: ChannelizedConfig,
    params: ChannelizedParams,
    state: ChannelizedState,
    iq: torch.Tensor,
    mode_set: tuple | None = None,
) -> tuple[ChannelizedState, torch.Tensor, torch.Tensor]:
    """One block ``iq [2, block_frames]`` through spectrum + filterbank +
    every receiver tail: ``(state, audio [C, audio_frames], spectra
    [2, blocks, fft_size])``. ``mode_set`` is accepted for signature
    parity (see :func:`mode_set_of`)."""
    return _channelized_step(cfg, params, state, iq, False)


def channelized_step_serving(
    cfg: ChannelizedConfig,
    params: ChannelizedParams,
    state: ChannelizedState,
    iq: torch.Tensor,
    mode_set: tuple | None = None,
) -> tuple[ChannelizedState, torch.Tensor, torch.Tensor]:
    """Serving variant: ``(state, audio [audio_frames, C], latest
    spectrum row in dB [fft_size])``. Audio stays time-major, the tail's
    native layout; serving consumers gather a few channel columns."""
    new_state, audio, spectra = _channelized_step(cfg, params, state, iq,
                                                  True)
    return new_state, audio, spectrum_db(spectra[:, -1, :])


class ChannelizedPipeline(HostPipeline):
    """The channelized engine's pipeline: :func:`channelized_step_serving`
    behind the double-buffered :class:`.frontend.HostPipeline` interface
    (the JAX pipeline's); per-block audio ``[audio_frames, C]``.

    ``plain_tail`` is :func:`tail_refusal` of the parameters it serves
    (logged when it is built and where a parameter set changes it). Where
    a new parameter set moves the step between the raw and the mixed
    history domain (on the card, a bandwidth leaving or rejoining the
    shared FIR kernels moves it between the per-channel kernel and the
    time-major tail), :meth:`update_params` converts the carried history
    (:func:`switch_hist_domain`)."""

    audio_time_major = True

    def __init__(self, cfg: ChannelizedConfig, params: ChannelizedParams,
                 graph: bool = True):
        super().__init__(cfg, params, params.pfb_weights.device, graph)
        self.plain_tail = None
        self._note_tail()

    def _init_state(self) -> ChannelizedState:
        return init_channelized_state(self.cfg, self.device)

    def _block(self, iq):
        return _channelized_step(self.cfg, self.params, self.state, iq, True)

    def _note_tail(self) -> None:
        why = tail_refusal(self.cfg, self.params)
        if why and why != self.plain_tail:
            log.warning("channelized pipeline (%d channels): the tail runs "
                        "plain on %s: %s", self.cfg.num_channels, self.device,
                        why)
        self.plain_tail = why

    def carries_raw(self) -> bool:
        """Whether the step carries the RAW history (:func:`carries_raw`)."""
        return carries_raw(self.cfg, self.params)

    def state_for(self, other: "ChannelizedPipeline") -> ChannelizedState:
        """This pipeline's state with its history in the domain that
        ``other``'s step carries (a growth hands it so to the wider
        pipeline); ``other`` is at least as wide."""
        raw = self.carries_raw()
        if raw == other.carries_raw():
            return self.state
        step = (self.params if raw else other.params).residual_step
        return self.state._replace(chan_hist=switch_hist_domain(
            self.state.chan_hist, self.state.nco_phase, step, not raw))

    def update_params(self, params) -> None:
        """:meth:`.frontend.HostPipeline.update_params`, with the carried
        history converted where the new parameters move the step between
        the raw and the mixed domain."""
        old, was_raw = self.params, self.carries_raw()
        super().update_params(params)
        if self.params is old:
            return  # the same layout, so the same branch
        if self.carries_raw() != was_raw:
            step = (old if was_raw else self.params).residual_step
            self.state.chan_hist.copy_(switch_hist_domain(
                self.state.chan_hist, self.state.nco_phase, step,
                not was_raw))
        self._note_tail()

    def update_params_slots(self, idx, sub: ChannelizedParams,
                            mode_set: tuple | None = None) -> None:
        """Incremental control write: a device-side scatter of the dirty
        slots' columns (:func:`scatter_params_slots`), IN PLACE. The caller
        must not run it while a step that reads these parameters is being
        dispatched on another thread. ``mode_set`` is accepted for
        signature parity (see :func:`mode_set_of`). The addresses stay, so
        a captured graph goes on serving (no recapture)."""
        self.params = scatter_params_slots(self.params, idx, sub)
