"""The direct front-end step: spectrum + every receiver channel mixed,
filtered and demodulated from the wideband block (port of
``webradio_tpu.pipeline.frontend``), and the double-buffered host interface
both engines share.

Signal representation: IQ as float32 real planes ``[2, ..., N]``. The
direct engine runs no hand-written kernel (the JAX step reaches no Pallas
call either): a per-channel NCO mix of the whole block, the decimating
channel FIR, the demodulator and the decimating audio FIR, each a plain
torch function of ``ops``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.demod import demodulate
from ..ops.fir import fir_dispatch, overlap_save_decimate
from ..ops.nco import nco_advance, nco_mix
from ..ops.spectrum import spectrum_accumulate, spectrum_db
from .state import (
    ChainConfig,
    FrontEndParams,
    FrontEndState,
    ReceiverState,
    init_state,
)


def squelch_scale(power: torch.Tensor, af_gain: torch.Tensor,
                  squelch_db: torch.Tensor) -> torch.Tensor:
    """Linear audio scale ``[C]`` from AF gain and the power-squelch gate.

    ``squelch_db`` is the per-channel gate threshold in dB relative to
    full-scale mean IQ power; NaN disables the gate. Any finite value gates
    for real, unlike the reference, which surfaces the field but never
    applies it (receiverhandler.cxx:118-119).
    """
    power_db = 10.0 * torch.log10(torch.clamp(power, min=1e-30))
    gate = torch.isnan(squelch_db) | (power_db >= squelch_db)
    return af_gain * gate.to(torch.float32)


def frontend_step(
    cfg: ChainConfig,
    params: FrontEndParams,
    state: FrontEndState,
    iq: torch.Tensor,
) -> tuple[FrontEndState, torch.Tensor, torch.Tensor]:
    """One block ``iq [2, block_frames]`` through spectrum + every receiver:
    ``(state, audio [C, audio_frames], spectra [2, blocks, fft_size])``
    (spectra row -1 is the reference's latest frame,
    spectrumsink.cxx:107-117)."""
    rxp, rxs = params.rx, state.rx
    spectra = spectrum_accumulate(iq, cfg.fft_size)
    mixed = nco_mix(iq[:, None, :], rxs.nco_phase, rxp.phase_step)
    nco_phase = nco_advance(rxs.nco_phase, rxp.phase_step, cfg.block_frames)

    def fir(x, coeff, toep, decim, hist):
        if cfg.use_overlap_save:
            return overlap_save_decimate(x, coeff, decim, hist)
        return fir_dispatch(x, coeff, toep, decim, hist)

    chan, chan_hist = fir(mixed, rxp.chan_coeff, rxp.chan_toep,
                          cfg.chan_decim, rxs.chan_hist)
    audio_if, demod_prev = demodulate(chan, rxp.mode, rxs.demod_prev)
    audio, audio_hist = fir(audio_if, rxp.audio_coeff, rxp.audio_toep,
                            cfg.audio_decim, rxs.audio_hist)
    # AF gain and the power squelch over the channel's mean post-filter
    # IQ power for the block
    power = (chan[0] ** 2 + chan[1] ** 2).mean(dim=-1)  # [C]
    audio = audio * squelch_scale(power, rxp.af_gain, rxp.squelch)[:, None]
    return FrontEndState(rx=ReceiverState(
        nco_phase=nco_phase,
        chan_hist=chan_hist,
        demod_prev=demod_prev,
        audio_hist=audio_hist,
    )), audio, spectra


def frontend_step_serving(
    cfg: ChainConfig,
    params: FrontEndParams,
    state: FrontEndState,
    iq: torch.Tensor,
) -> tuple[FrontEndState, torch.Tensor, torch.Tensor]:
    """Serving variant: ``(state, audio [C, audio_frames], latest spectrum
    row in dB [fft_size])`` (spectrumsink.cxx:125-142)."""
    new_state, audio, spectra = frontend_step(cfg, params, state, iq)
    return new_state, audio, spectrum_db(spectra[:, -1, :])


class HostPipeline:
    """The double-buffered host interface of both engines' pipelines.

    :meth:`process_host` copies a ``[2, N]`` float32 numpy block through a
    pinned staging buffer to the device without blocking, runs the serving
    step on the current CUDA stream and returns the PREVIOUS call's
    ``(audio, latest_db [fft_size])`` as device tensors (None on the first
    call); :meth:`flush` returns the last one. :meth:`process_host_many`
    does the same for a backlog ``[k, 2, N]`` (audio ``[k, C,
    audio_frames]``). Two staging buffers per input shape alternate, and a
    buffer is refilled only after the copy that last read it has finished.
    Not thread-safe: one pump thread drives it.

    PyTorch compiles nothing, so there is no warm-up of parameter variants
    or demod-law sets: any parameter change takes effect at the next block.
    """

    #: per-block process_host audio orientation: ``[audio_frames, C]``
    #: when True, else ``[C, audio_frames]``
    audio_time_major = False

    def __init__(self, cfg, params, device: torch.device):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.state = self._init_state()
        self._pending = None
        #: per input shape: [two pinned buffers, their last copies' events,
        #: the slot to fill next]
        self._staging: dict[tuple, list] = {}

    def _init_state(self):
        raise NotImplementedError

    def _serving_step(self, iq: torch.Tensor):
        """``(state, audio, latest_db)`` of one block on the device."""
        raise NotImplementedError

    def update_params(self, params) -> None:
        self.params = params

    def _to_device(self, iq_planes: np.ndarray) -> torch.Tensor:
        host = np.ascontiguousarray(iq_planes, dtype=np.float32)
        if self.device.type != "cuda":
            return torch.from_numpy(host).to(self.device)
        stage = self._staging.get(host.shape)
        if stage is None:
            stage = self._staging[host.shape] = [
                [torch.empty(host.shape, dtype=torch.float32,
                             pin_memory=True) for _ in range(2)],
                [None, None], 0]
        bufs, copied, slot = stage
        stage[2] = slot ^ 1
        if copied[slot] is not None:
            # its last copy has finished. On the one stream that copy came
            # after the step of three blocks back, so this wait also bounds
            # the dispatch queue: the host never runs more than about three
            # steps ahead of the card.
            copied[slot].synchronize()
        bufs[slot].numpy()[...] = host
        iq = torch.empty(host.shape, dtype=torch.float32, device=self.device)
        iq.copy_(bufs[slot], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        copied[slot] = event
        return iq

    def _swap_pending(self, audio, latest_db):
        result = self._pending
        self._pending = (audio, latest_db)
        return result

    def process_host(self, iq_planes: np.ndarray):
        iq = self._to_device(iq_planes)
        self.state, audio, latest_db = self._serving_step(iq)
        return self._swap_pending(audio, latest_db)

    def process_host_many(self, blocks: np.ndarray):
        """Catch-up path: a ``[k, 2, block_frames]`` backlog goes to the
        device as ONE pinned copy and through
        :func:`..stream.scan_serving`. Same double-buffered contract as
        :meth:`process_host`; the previous result handed back may hold
        per-block audio or ``[k, C, audio_frames]``."""
        from .stream import scan_serving

        self.state, audio, latest_db = scan_serving(
            self.cfg, self.params, self.state, self._to_device(blocks))
        return self._swap_pending(audio, latest_db)

    def flush(self):
        result = self._pending
        self._pending = None
        return result

    def process_host_sync(self, iq_planes: np.ndarray):
        out = self.process_host(iq_planes)
        tail = self.flush()
        return tail if out is None else out

    def reset(self) -> None:
        self.state = self._init_state()
        self._pending = None


class FrontEndPipeline(HostPipeline):
    """The direct engine's pipeline: :func:`frontend_step_serving` behind
    the :class:`HostPipeline` interface; audio ``[C, audio_frames]``."""

    def __init__(self, cfg: ChainConfig, params: FrontEndParams):
        super().__init__(cfg, params, params.rx.phase_step.device)

    def _init_state(self) -> FrontEndState:
        return init_state(self.cfg, self.device)

    def _serving_step(self, iq):
        return frontend_step_serving(self.cfg, self.params, self.state, iq)
