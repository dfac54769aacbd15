"""Parameters and state of the direct front-end step (port of
``webradio_tpu.pipeline.state``).

Control-plane values (tuning, passbands, modes) are *parameters*: tensors
recomputed host-side on REST writes and passed into the next block's step.
Cross-block DSP state is the exact set of carries the reference keeps
(SURVEY §5): FIR histories, NCO phase, FM previous sample. Layouts are the
JAX package's; the uint32 NCO phase and step are int64 tensors holding the
same value (see ``ops/nco.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import require_cuda
from ..ops.demod import MODES
from ..ops.fir import maybe_toeplitz_weights
from ..ops.firdesign import FIR_LENGTH, design_lowpass_fir_cached
from ..ops.nco import nco_phase_step
from ..ops.spectrum import DEFAULT_FFT_SIZE


def _squelch_array(values) -> np.ndarray:
    """Squelch thresholds -> float32, with None (gate disabled) as NaN —
    the in-device "no squelch" sentinel of
    :func:`webradio_tpu_torch.pipeline.frontend.squelch_scale`."""
    return np.array(
        [np.nan if v is None else float(v) for v in values], np.float32
    )


def expand_controls(c: int, *values) -> list[list]:
    """Each control value as a length-``c`` list (a scalar repeats)."""
    def expand(v):
        if hasattr(v, "__len__") and not isinstance(v, str):
            return list(v)
        return [v] * c
    return [expand(v) for v in values]


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static shape of one direct front-end's chain (the JAX package's
    fields and validation). Defaults mirror the reference topology: 2.4
    Msps front end, 240 ksps channel rate, 48 ksps audio
    (src/radio.cxx:78-82, src/main.cxx:74-75)."""

    sample_rate: int = 2_400_000
    channel_rate: int = 240_000
    audio_rate: int = 48_000
    block_frames: int = 102_400  # IQ frames per step (main.cxx:75 / 2 ch)
    num_channels: int = 1
    fir_length: int = FIR_LENGTH
    fft_size: int = DEFAULT_FFT_SIZE
    use_overlap_save: bool = False
    #: FIR design law: "reference" (lowpass.cxx:164-197, with its
    #: integer-division cutoff quirk) or "sinc"
    fir_design: str = "reference"

    def __post_init__(self):
        if self.fir_design not in ("reference", "sinc"):
            raise ValueError("fir_design must be 'reference' or 'sinc'")
        if self.sample_rate % self.channel_rate:
            raise ValueError("sample_rate must be a multiple of channel_rate")
        if self.channel_rate % self.audio_rate:
            raise ValueError("channel_rate must be a multiple of audio_rate")
        if self.block_frames % self.fft_size:
            raise ValueError("block_frames must be a multiple of fft_size")
        if self.block_frames % (self.chan_decim * self.audio_decim):
            raise ValueError(
                "block_frames must be a multiple of the total decimation "
                f"({self.chan_decim * self.audio_decim}) so every stage's "
                "output grid stays block-aligned"
            )

    @property
    def chan_decim(self) -> int:
        return self.sample_rate // self.channel_rate

    @property
    def audio_decim(self) -> int:
        return self.channel_rate // self.audio_rate

    @property
    def chan_frames(self) -> int:
        return self.block_frames // self.chan_decim

    @property
    def audio_frames(self) -> int:
        return self.chan_frames // self.audio_decim

    @property
    def block_seconds(self) -> float:
        return self.block_frames / self.sample_rate


class ReceiverParams(NamedTuple):
    """Per-channel control parameters, ``[C, ...]``."""

    phase_step: torch.Tensor  # [C] int64 holding uint32 (sample rate)
    chan_coeff: torch.Tensor  # [C, K] float32 — channel FIR
    audio_coeff: torch.Tensor  # [C, K] float32 — audio FIR
    mode: torch.Tensor  # [C] int32 — demodulator law
    af_gain: torch.Tensor  # [C] float32 — linear audio gain
    squelch: torch.Tensor  # [C] float32 — gate threshold (dB; NaN = off)
    #: banded weights (ops.fir.toeplitz_weights), present iff every channel
    #: shares the kernel; None -> the per-channel multiply-add form
    chan_toep: torch.Tensor | None = None
    audio_toep: torch.Tensor | None = None


class ReceiverState(NamedTuple):
    """Per-channel cross-block carries; IQ carries are planes ``[2, ...]``."""

    nco_phase: torch.Tensor  # [C] int64 holding uint32
    chan_hist: torch.Tensor  # [2, C, K-1] float32
    demod_prev: torch.Tensor  # [2, C] float32
    audio_hist: torch.Tensor  # [C, K-1] float32


class FrontEndParams(NamedTuple):
    rx: ReceiverParams


class FrontEndState(NamedTuple):
    rx: ReceiverState


def make_receiver_params(
    cfg: ChainConfig,
    if_hz,
    if_bandwidth_hz,
    af_bandwidth_hz,
    mode,
    af_gain_db=0,
    squelch_db=None,
    actual_sample_rate=None,
    device: torch.device | str | None = None,
) -> FrontEndParams:
    """Parameters on ``device`` (None: the CUDA device, and an error where
    there is none) from per-receiver control values (scalars or
    length-``num_channels`` sequences). The host-side design is the JAX
    package's, value for value; ``actual_sample_rate`` pins the NCO plan to
    the rate the hardware really runs at (rtlsdrtuner.cxx:226-228)."""
    if device is None:
        device = require_cuda()
    c = cfg.num_channels
    ifs, ifbws, afbws, modes, gains, squelches = expand_controls(
        c, if_hz, if_bandwidth_hz, af_bandwidth_hz, mode, af_gain_db,
        squelch_db)
    if not (len(ifs) == len(ifbws) == len(afbws) == len(modes) == c):
        raise ValueError("parameter lists must match num_channels")

    fs = int(actual_sample_rate) if actual_sample_rate else cfg.sample_rate
    steps = np.array([nco_phase_step(f, fs) for f in ifs], np.int64)
    chan = np.stack([
        design_lowpass_fir_cached(bw, cfg.sample_rate, cfg.fir_length,
                                  cfg.fir_design) for bw in ifbws])
    audio = np.stack([
        design_lowpass_fir_cached(bw, cfg.channel_rate, cfg.fir_length,
                                  cfg.fir_design) for bw in afbws])
    mode_idx = np.array(
        [MODES.index(m) if isinstance(m, str) else int(m) for m in modes],
        np.int32)
    gain = np.power(10.0, np.array(gains, np.float32) / 20.0).astype(
        np.float32)

    def dev(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(device)

    return FrontEndParams(rx=ReceiverParams(
        phase_step=dev(steps),
        chan_coeff=dev(chan),
        audio_coeff=dev(audio),
        mode=dev(mode_idx),
        af_gain=dev(gain),
        squelch=dev(_squelch_array(squelches)),
        chan_toep=dev(maybe_toeplitz_weights(chan, cfg.chan_decim,
                                             cfg.chan_frames)),
        audio_toep=dev(maybe_toeplitz_weights(audio, cfg.audio_decim,
                                              cfg.audio_frames)),
    ))


def grow_state(state: FrontEndState, new_channels: int) -> FrontEndState:
    """Carry DSP state across a capacity growth: existing channels keep
    their carries bit for bit, new slots start from zeros (the reference's
    analog: a live connect never restarts running blocks,
    dspblock.cxx:57-91)."""
    rx = state.rx
    pad = new_channels - int(rx.nco_phase.shape[0])
    if pad < 0:
        raise ValueError("capacity can only grow")
    if pad == 0:
        return state
    return FrontEndState(rx=ReceiverState(
        nco_phase=F.pad(rx.nco_phase, (0, pad)),
        chan_hist=F.pad(rx.chan_hist, (0, 0, 0, pad)),
        demod_prev=F.pad(rx.demod_prev, (0, pad)),
        audio_hist=F.pad(rx.audio_hist, (0, 0, 0, pad)),
    ))


def init_state(cfg: ChainConfig,
               device: torch.device | str | None = None) -> FrontEndState:
    """Zero state on ``device`` (None: the CUDA device, and an error where
    there is none)."""
    if device is None:
        device = require_cuda()
    c, k = cfg.num_channels, cfg.fir_length
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return FrontEndState(rx=ReceiverState(
        nco_phase=torch.zeros(c, dtype=torch.int64, device=device),
        chan_hist=z(2, c, k - 1),
        demod_prev=z(2, c),
        audio_hist=z(c, k - 1),
    ))
