"""Channelized front-end: shared polyphase filterbank + per-channel tail.

Port of ``webradio_tpu.pipeline.channelized`` — the serving step the
server's block pump runs once per block from 16 receivers up:

  1. spectrum: a windowed DFT per ``fft_size`` frames (``ops.spectrum``);
  2. filterbank: im2col frames and one ``[nd, 2K_p] x [2K_p, 2C]`` float32
     matmul to the packed ``[nd, 2C]`` product (``ops.channelizer``);
  3. receiver tail: residual NCO mix, 64-tap shaping FIR, demod, squelch
     power and the decimating audio FIR — the Hopper kernel
     (``ops.tail_tm.fused_tail_audio_tm``) when the same configuration
     selects the Pallas kernel in the JAX package, else the plain torch
     chain (the JAX package's XLA-form branch);
  4. squelch and gain scale.

Layouts are the JAX package's, so states and parameters carry over
(``webradio_tpu_torch.convert``). Left out of this slice, each raising
NotImplementedError that names its ROADMAP.md item: the per-channel FIR
fallback (slots with differing bandwidths), ``use_pallas_tail``,
``tail_kernel="pallas_pfb"``, every ``pfb_precision`` but "highest",
the channel-rate-audio kernel branch, ``process_host_many`` /
``scan_serving``, ``scatter_params_slots`` and ``grow_channelized_state``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.channelizer import (
    assign_bins,
    bin_weights_for_channels,
    design_prototype,
    pfb_channelize_direct_tm,
)
from ..ops.demod import MODES
from ..ops.fir import maybe_toeplitz_weights
from ..ops.firdesign import FIR_LENGTH, design_lowpass_fir_cached
from ..ops.nco import nco_advance, nco_mix_tm, nco_mix_tm_fast, nco_phase_step
from ..ops.spectrum import DEFAULT_FFT_SIZE, spectrum_accumulate, spectrum_db
from ..ops.tail_tm import CHAN_TILE, fused_tail_audio_tm, tail_after_mix_tm
from .frontend import squelch_scale
from .state import _squelch_array


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to webradio_tpu_torch yet "
        f"(ROADMAP.md, still to port: {item})"
    )


@dataclasses.dataclass(frozen=True)
class ChannelizedConfig:
    """Static shape of a channelized front-end (the JAX package's fields
    and validation).

    ``fir_precision`` accepts all four names; the port computes each as
    float32 (hx5, hx4 and high are TPU MXU pass counts). ``tail_kernel``
    "auto" takes the kernel from :data:`PALLAS_TM_AUTO_THRESHOLD` channels,
    "pallas" always, "xla" never.
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
        if self.use_pallas_tail:
            raise _not_ported("use_pallas_tail (the legacy time-minor tail)",
                              "TPU kernel #4 fused_receiver_tail")
        if self.tail_kernel == "pallas_pfb":
            raise _not_ported("tail_kernel='pallas_pfb'",
                              "TPU kernel #3 fused_pfb_tail_audio_tm")
        if self.pfb_precision != "highest":
            raise _not_ported(f"pfb_precision={self.pfb_precision!r}",
                              "the pfb tiers")

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
    #: the u8exact tier's split weights; always None in this slice
    pfb_weights_split: torch.Tensor | None = None


class ChannelizedState(NamedTuple):
    pfb_hist: torch.Tensor  # [2, K_p - 1] float32
    nco_phase: torch.Tensor  # [C] int64 holding uint32 (residual)
    chan_hist: torch.Tensor  # [2, C, K - 1] float32, mixed-domain tail
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
    device: torch.device | str = "cpu",
) -> ChannelizedParams:
    """Build parameters on ``device`` from per-receiver control values
    (scalars or length-``num_channels`` sequences); the host-side design
    is the JAX package's, value for value."""
    c = cfg.num_channels

    def expand(v):
        return list(v) if hasattr(v, "__len__") and not isinstance(v, str) else [v] * c

    ifs = expand(if_hz)
    ifbws = expand(if_bandwidth_hz)
    afbws = expand(af_bandwidth_hz)
    modes = expand(mode)
    gains = expand(af_gain_db)
    squelches = expand(squelch_db)
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


def scatter_params_slots(params, idx, sub):
    """Incremental control write of a few slots (not ported yet)."""
    raise _not_ported("scatter_params_slots",
                      "process_host_many, grow and scatter")


def init_channelized_state(
    cfg: ChannelizedConfig, device: torch.device | str = "cpu"
) -> ChannelizedState:
    c, k, kp = cfg.num_channels, cfg.fir_length, cfg.proto_taps
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return ChannelizedState(
        pfb_hist=z(2, kp - 1),
        nco_phase=torch.zeros(c, dtype=torch.int64, device=device),
        chan_hist=z(2, c, k - 1),
        demod_prev=z(2, c),
        audio_hist=z(c, k - 1),
    )


def grow_channelized_state(state, new_channels):
    """Carry state across a capacity growth (not ported yet)."""
    raise _not_ported("grow_channelized_state",
                      "process_host_many, grow and scatter")


def mode_set_of(modes) -> tuple[int, ...]:
    """Sorted distinct mode ids of a mode array. Accepted by the step for
    signature parity: the CUDA kernel switches on each channel's mode at
    run time, so no mode set is compiled in."""
    if isinstance(modes, torch.Tensor):
        modes = modes.cpu().numpy()
    return tuple(sorted({int(m) for m in np.asarray(modes).ravel()}))


#: channel count from which "auto" takes the fused tail kernel — the JAX
#: package's value, kept so the same configurations select the kernel in
#: both packages (the H100 crossover is not measured yet)
PALLAS_TM_AUTO_THRESHOLD = 512
#: the JAX kernels' time tile; nd must be a multiple for the kernel branch
#: (the selection rule is mirrored, the CUDA kernel itself tiles freely)
SELECT_TIME_TILE = 1024


def _use_kernel_tm(cfg: ChannelizedConfig, nd: int, params) -> bool:
    """Whether the fused tail kernel applies (the JAX package's
    ``_use_pallas_tm`` rule)."""
    if cfg.tail_kernel == "xla":
        return False
    if cfg.tail_kernel == "auto" and cfg.num_channels < PALLAS_TM_AUTO_THRESHOLD:
        return False
    return (
        params.chan_toep is not None
        and nd % SELECT_TIME_TILE == 0
        and cfg.num_channels % CHAN_TILE == 0
        and SELECT_TIME_TILE % params.chan_toep.shape[1] == 0
    )


def _audio_time_tile(nd: int, d: int, fir_tile: int) -> int:
    """The JAX audio kernel's time tile (largest multiple of
    ``lcm(fir_tile, d)`` <= 2048 dividing ``nd``; 0 if none). Without one
    the JAX package takes its channel-rate-audio kernel instead."""
    base = fir_tile * d // math.gcd(fir_tile, d)
    best = 0
    m = base
    while m <= 2048:
        if nd % m == 0:
            best = m
        m += base
    return best


def _channelized_step(cfg, params, state, iq, time_major):
    spectra = spectrum_accumulate(iq, cfg.fft_size)
    nco_phase = nco_advance(state.nco_phase, params.residual_step,
                            cfg.chan_frames)
    nd = iq.shape[-1] // cfg.num_bins
    d = cfg.audio_decim

    use_tm = (
        params.chan_toep is not None
        and params.audio_toep is not None
        and nd % params.chan_toep.shape[1] == 0
        and (nd // d) % params.audio_toep.shape[1] == 0
    )
    if not use_tm:
        raise _not_ported(
            "the per-channel FIR fallback (slots whose bandwidths differ)",
            "the per-channel fallback branch")
    if _use_kernel_tm(cfg, nd, params):
        if not _audio_time_tile(nd, d, params.chan_toep.shape[1]):
            raise _not_ported("the channel-rate-audio tail kernel",
                              "TPU kernel #2 fused_tail_tm")
        y2, _, pfb_hist = pfb_channelize_direct_tm(
            iq, params.pfb_weights, cfg.num_bins, state.pfb_hist, split=False)
        audio, hist_i, hist_q, demod_prev, ahist, power = fused_tail_audio_tm(
            y2, y2, state.nco_phase, params.residual_step,
            params.chan_toep, params.audio_toep, d, params.mode,
            state.chan_hist[0].T.contiguous(),
            state.chan_hist[1].T.contiguous(),
            state.demod_prev, state.audio_hist.T.contiguous(),
            precision=cfg.fir_precision, packed=True, fast=cfg.fast_nco,
        )
    else:
        ci, cq, pfb_hist = pfb_channelize_direct_tm(
            iq, params.pfb_weights, cfg.num_bins, state.pfb_hist, split=True)
        mix_tm = nco_mix_tm_fast if cfg.fast_nco else nco_mix_tm
        mi, mq = mix_tm(ci, cq, state.nco_phase, params.residual_step)
        audio, hist_i, hist_q, demod_prev, ahist, power = tail_after_mix_tm(
            mi, mq, params.chan_toep, params.audio_toep, d, params.mode,
            state.chan_hist[0].T, state.chan_hist[1].T, state.demod_prev,
            state.audio_hist.T,
        )
    chan_hist = torch.stack([hist_i.T, hist_q.T])
    # squelch gate on the post-shaping-FIR (in-band) mean |y|^2
    scale = squelch_scale(power, params.af_gain, params.squelch)
    if time_major:
        audio = audio * scale[None, :]  # stays [audio_frames, C]
    else:
        audio = audio.T * scale[:, None]  # [C, audio_frames]
    new_state = ChannelizedState(
        pfb_hist=pfb_hist,
        nco_phase=nco_phase,
        chan_hist=chan_hist,
        demod_prev=demod_prev,
        audio_hist=ahist.T,
    )
    return new_state, audio, spectra


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


class ChannelizedPipeline:
    """Stateful wrapper with the JAX pipeline's double-buffered host
    interface.

    :meth:`process_host` copies a ``[2, N]`` float32 numpy block through a
    pinned staging buffer to the device without blocking, runs the serving
    step on the current CUDA stream and returns the PREVIOUS block's
    ``(audio [audio_frames, C], latest_db [fft_size])`` as device tensors
    (None on the first call); :meth:`flush` returns the last block. Two
    staging buffers alternate, and a buffer is refilled only after the
    copy that last read it has finished.

    PyTorch compiles nothing, so there is no mode-set warm: a parameter
    change, including a new demod law, takes effect at the next block.
    """

    #: per-block process_host audio orientation (as in the JAX pipeline)
    audio_time_major = True

    def __init__(self, cfg: ChannelizedConfig, params: ChannelizedParams):
        self.cfg = cfg
        self.params = params
        self.device = params.pfb_weights.device
        self.state = init_channelized_state(cfg, self.device)
        self._pending = None
        self._staging: list[torch.Tensor] = []
        self._copied: list[torch.cuda.Event | None] = [None, None]
        self._slot = 0

    def update_params(self, params: ChannelizedParams) -> None:
        self.params = params

    def update_params_slots(self, idx, sub, mode_set) -> None:
        scatter_params_slots(self.params, idx, sub)

    def _to_device(self, iq_planes: np.ndarray) -> torch.Tensor:
        host = np.ascontiguousarray(iq_planes, dtype=np.float32)
        if self.device.type != "cuda":
            return torch.from_numpy(host).to(self.device)
        if not self._staging:
            self._staging = [torch.empty(host.shape, dtype=torch.float32,
                                         pin_memory=True) for _ in range(2)]
        slot = self._slot
        self._slot ^= 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copy has finished
        buf = self._staging[slot]
        buf.numpy()[...] = host
        iq = torch.empty(host.shape, dtype=torch.float32, device=self.device)
        iq.copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._copied[slot] = event
        return iq

    def process_host(self, iq_planes: np.ndarray):
        iq = self._to_device(iq_planes)
        self.state, audio, latest_db = channelized_step_serving(
            self.cfg, self.params, self.state, iq)
        result = self._pending
        self._pending = (audio, latest_db)
        return result

    def process_host_many(self, blocks: np.ndarray):
        """Catch-up path over a backlog of blocks (not ported yet)."""
        raise _not_ported("process_host_many / scan_serving",
                          "process_host_many, grow and scatter")

    def flush(self):
        result = self._pending
        self._pending = None
        return result

    def process_host_sync(self, iq_planes: np.ndarray):
        out = self.process_host(iq_planes)
        tail = self.flush()
        return tail if out is None else out

    def reset(self) -> None:
        self.state = init_channelized_state(self.cfg, self.device)
        self._pending = None
