"""The direct front-end step over a ``(time, chan)`` mesh (port of
``webradio_tpu.parallel.sharded``), and the placement of values on a
mesh's positions that both sharded engines share.

The single-card step (:func:`..pipeline.frontend.frontend_step`) runs per
shard with explicit halo exchange:

* channel axis: params, state and outputs ``[C, ...]`` split over
  ``chan``, with no communication;
* time axis: the wideband block ``[2, N]`` splits over ``time``. Each time
  shard needs from its left neighbour exactly the reference's carries
  (lowpass.cxx:133-142, demodulator.cxx:110-111): ``K-1`` mixed input
  frames (channel-FIR history), the last channel-rate sample (FM
  discriminator) and ``K-1`` demodulated samples (audio-FIR history), each
  moved by :meth:`.comm.Comm.shift_right`; shard 0 takes the carried block
  state. The NCO phase is computed, not moved: ``(phase0 + shard_start *
  step) mod 2^31``. The spectrum has no carry (whole FFT groups per
  shard).

The next block's carries are the last time shard's
(:meth:`.comm.Comm.from_last`), and the squelch gate reads the whole
block's power (:meth:`.comm.Comm.mean_time`). Outputs stay on the
positions that computed them (:class:`ShardedAudio`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.demod import demodulate
from ..ops.fir import fir_dispatch, overlap_save_decimate
from ..ops.nco import PHASE_MASK, nco_advance, nco_mix
from ..ops.spectrum import spectrum_accumulate
from ..pipeline.frontend import squelch_scale
from ..pipeline.state import (
    ChainConfig,
    FrontEndParams,
    FrontEndState,
    ReceiverParams,
    ReceiverState,
    init_state,
)
from .comm import Comm
from .mesh import Mesh

#: the channel axis of each field (None: replicated on every position)
RECEIVER_PARAMS_AXES = ReceiverParams(
    phase_step=0, chan_coeff=0, audio_coeff=0, mode=0, af_gain=0, squelch=0,
    chan_toep=None, audio_toep=None)
RECEIVER_STATE_AXES = ReceiverState(nco_phase=0, chan_hist=1, demod_prev=1,
                                    audio_hist=0)


# ---- placement -----------------------------------------------------------
def place(nt, axes, mesh: Mesh, c_local: int) -> dict:
    """A named tuple of tensors cut by channel shard onto each local
    position's device (``axes`` names each field's channel axis); positions
    of one column on one device share one copy."""
    made = {}
    out = {}
    for p in mesh.local_positions:
        c, dev = p % mesh.chan, mesh.devices[p]
        key = (c, str(dev))
        if key not in made:
            c0 = c * c_local
            made[key] = type(nt)(*(
                None if x is None else
                (x if ax is None else x.narrow(ax, c0, c_local).contiguous()
                 ).to(dev)
                for x, ax in zip(nt, axes)))
        out[p] = made[key]
    return out


def gather_columns(placed: dict, axes, mesh: Mesh, device) -> tuple:
    """The named tuple again, whole, on ``device``: the columns of this
    rank's first time row joined on their channel axes."""
    row = mesh.local_rows[0]
    cols = [placed[row * mesh.chan + c] for c in range(mesh.chan)]
    first = cols[0]
    return type(first)(*(
        None if x is None else
        (x.to(device) if ax is None else
         torch.cat([col[i].to(device) for col in cols], dim=ax))
        for i, (x, ax) in enumerate(zip(first, axes))))


def place_block(planes, mesh: Mesh, block_frames: int) -> dict:
    """This rank's time slice of a block (``[2, frames]`` float32 numpy or
    tensor, from its first local row's first frame) cut into time shards on
    each local position's device."""
    n_local = block_frames // mesh.time
    rows = mesh.local_rows
    if planes.shape[-1] != n_local * len(rows):
        raise ValueError(f"{planes.shape[-1]} frames for {len(rows)} time "
                         f"shards of {n_local}")
    if isinstance(planes, np.ndarray):
        planes = torch.from_numpy(np.ascontiguousarray(planes, np.float32))
    made, out = {}, {}
    for p in mesh.local_positions:
        t, dev = p // mesh.chan, mesh.devices[p]
        key = (t, str(dev))
        if key not in made:
            i = rows.index(t)
            made[key] = planes[:, i * n_local:(i + 1) * n_local].contiguous(
            ).to(dev, non_blocking=dev.type == "cuda")
        out[p] = made[key]
    return out


def _wait(devices) -> None:
    for dev in {d for d in devices if d.type == "cuda"}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()


class ShardedAudio:
    """The audio of one block, or of a catch-up's blocks, as the shards
    made it: one piece per block and local position, on that position's
    device, ``[c_local, af_local]`` or (``time_major``) ``[af_local,
    c_local]``. Nothing joins the pieces on one device unless asked
    (:meth:`full`); the server fetches the subscribed rows only
    (:meth:`fetch_rows`)."""

    def __init__(self, mesh: Mesh, blocks: list, time_major: bool):
        self.mesh = mesh
        self.blocks = blocks
        self.time_major = time_major
        piece = blocks[0][mesh.local_positions[0]]
        self.c_local, self.af_local = (
            piece.shape[::-1] if time_major else piece.shape)
        self.channels = self.c_local * mesh.chan

    def fetch_rows(self, rows) -> np.ndarray:
        """This rank's time shards of the channels ``rows`` on the host:
        ``[k, af]`` for one block, ``[blocks, k, af]`` for several. One
        ``index_select`` and one copy into pinned memory per piece, then one
        wait per device."""
        m = self.mesh
        by_col: dict[int, list] = {}
        for k, r in enumerate(rows):
            by_col.setdefault(r // self.c_local, []).append(
                (k, r % self.c_local))
        n_rows = len(m.local_rows)
        out = np.empty((len(self.blocks), len(rows),
                        n_rows * self.af_local), np.float32)
        copies, devs = [], []
        for b, pieces in enumerate(self.blocks):
            for i, t in enumerate(m.local_rows):
                for c, picks in by_col.items():
                    piece = pieces[t * m.chan + c]
                    src = piece.T if self.time_major else piece
                    idx = torch.tensor([j for _, j in picks],
                                       device=piece.device)
                    sel = src.index_select(0, idx)
                    cuda = sel.device.type == "cuda"
                    host = torch.empty(sel.shape, dtype=sel.dtype,
                                       pin_memory=cuda)
                    host.copy_(sel, non_blocking=cuda)
                    copies.append((b, i, [k for k, _ in picks], host))
                    devs.append(sel.device)
        _wait(devs)
        af = self.af_local
        for b, i, ks, host in copies:
            out[b, ks, i * af:(i + 1) * af] = host.numpy()
        return out[0] if len(self.blocks) == 1 else out

    def write_into(self, out: torch.Tensor, block: int = 0) -> None:
        """Copy one block's audio, this rank's time shards, into ``out``
        ``[C, af]`` (any device)."""
        m, af = self.mesh, self.af_local
        for i, t in enumerate(m.local_rows):
            for c in range(m.chan):
                piece = self.blocks[block][t * m.chan + c]
                out[c * self.c_local:(c + 1) * self.c_local,
                    i * af:(i + 1) * af] = (
                    piece.T if self.time_major else piece).to(out.device)

    def full(self, device=None) -> torch.Tensor:
        """This rank's audio joined on ``device`` (default: the first
        piece's): ``[C, af]``, or ``[blocks, C, af]`` for several blocks."""
        first = self.blocks[0][self.mesh.local_positions[0]]
        device = device or first.device
        out = torch.empty((len(self.blocks), self.channels,
                           len(self.mesh.local_rows) * self.af_local),
                          dtype=first.dtype, device=device)
        for b in range(len(self.blocks)):
            self.write_into(out[b], b)
        return out[0] if len(self.blocks) == 1 else out


def gather_spectra(spectra: dict, mesh: Mesh, device) -> torch.Tensor:
    """This rank's time shards' spectra ``[2, groups, fft]`` joined in time
    on ``device`` (``spectra`` holds one entry per local time row, at the
    row's channel-0 position)."""
    return torch.cat([spectra[t * mesh.chan].to(device)
                      for t in mesh.local_rows], dim=1)


# ---- the direct engine ---------------------------------------------------
def _shard_body(cfg: ChainConfig, mesh: Mesh, comm: Comm, params: dict,
                state: dict, iq: dict):
    c_n = mesh.chan
    n_local = cfg.block_frames // mesh.time
    k = cfg.fir_length
    pos = mesh.local_positions
    rxp = {p: params[p].rx for p in pos}
    rxs = {p: state[p].rx for p in pos}

    def fir(x, coeff, toep, decim, hist):
        if cfg.use_overlap_save:
            return overlap_save_decimate(x, coeff, decim, hist)
        return fir_dispatch(x, coeff, toep, decim, hist)

    spectra = {p: spectrum_accumulate(iq[p], cfg.fft_size)
               for p in pos if p % c_n == 0}
    # NCO: closed-form start phase per shard, no communication
    mixed = {}
    for p in pos:
        start = (p // c_n) * n_local
        phase = (rxs[p].nco_phase + start * rxp[p].phase_step) & PHASE_MASK
        mixed[p] = nco_mix(iq[p][:, None, :], phase, rxp[p].phase_step)

    # channel FIR: history halo = the left neighbour's last K-1 mixed frames
    halo = comm.shift_right({p: [mixed[p][:, :, -(k - 1):]] for p in pos})
    chan, chan_hist = {}, {}
    for p in pos:
        hist = rxs[p].chan_hist if halo[p] is None else halo[p][0]
        chan[p], chan_hist[p] = fir(mixed[p], rxp[p].chan_coeff,
                                    rxp[p].chan_toep, cfg.chan_decim, hist)

    # demod: the previous-sample halo at the channel rate
    halo = comm.shift_right({p: [chan[p][:, :, -1]] for p in pos})
    audio_if, prev = {}, {}
    for p in pos:
        before = rxs[p].demod_prev if halo[p] is None else halo[p][0]
        audio_if[p], prev[p] = demodulate(chan[p], rxp[p].mode, before)

    # audio FIR: history halo at the channel rate
    halo = comm.shift_right({p: [audio_if[p][:, -(k - 1):]] for p in pos})
    audio, audio_hist, power = {}, {}, {}
    for p in pos:
        hist = rxs[p].audio_hist if halo[p] is None else halo[p][0]
        audio[p], audio_hist[p] = fir(audio_if[p], rxp[p].audio_coeff,
                                      rxp[p].audio_toep, cfg.audio_decim,
                                      hist)
        power[p] = [(chan[p][0] ** 2 + chan[p][1] ** 2).mean(dim=-1)]

    # the whole block's gate power, so every time shard of a channel gates
    # as the single-card step does
    power = comm.mean_time(power)
    new = comm.from_last({p: [chan_hist[p], prev[p], audio_hist[p]]
                          for p in pos})
    new_state = {}
    for p in pos:
        audio[p] = audio[p] * squelch_scale(
            power[p][0], rxp[p].af_gain, rxp[p].squelch)[:, None]
        new_state[p] = FrontEndState(rx=ReceiverState(
            nco_phase=nco_advance(rxs[p].nco_phase, rxp[p].phase_step,
                                  cfg.block_frames),
            chan_hist=new[p][0], demod_prev=new[p][1],
            audio_hist=new[p][2]))
    return new_state, audio, spectra


def check_direct_mesh(cfg: ChainConfig, mesh: Mesh) -> None:
    """The JAX package's shape checks of the direct sharded step."""
    if cfg.block_frames % (mesh.time * cfg.fft_size):
        raise ValueError("time shards must hold whole FFT groups")
    n_local = cfg.block_frames // mesh.time
    if n_local % (cfg.chan_decim * cfg.audio_decim):
        raise ValueError("time shards must hold whole decimation groups")
    if n_local < cfg.fir_length:
        raise ValueError("time shards shorter than the FIR halo")
    if cfg.num_channels % mesh.chan:
        raise ValueError("num_channels must divide over chan shards")


def sharded_frontend_step(cfg: ChainConfig, mesh: Mesh,
                          comm: Comm | None = None):
    """The sharded direct step for a mesh: ``step(params, state, iq) ->
    (state, audio, spectra)`` over values placed on the mesh's local
    positions (:func:`place`, :func:`place_block`): audio per position
    ``[c_local, af_local]``, spectra per time row ``[2, groups, fft]``."""
    check_direct_mesh(cfg, mesh)
    comm = comm or Comm(mesh)

    def step(params, state, iq):
        return _shard_body(cfg, mesh, comm, params, state, iq)

    return step


def _place_params(params: FrontEndParams, mesh: Mesh, c_local: int):
    return {p: FrontEndParams(rx=rx) for p, rx in place(
        params.rx, RECEIVER_PARAMS_AXES, mesh, c_local).items()}


class ShardedFrontEnd:
    """Mesh-aware counterpart of ``FrontEndPipeline``: ``process(iq)`` runs
    one block (``[2, frames]`` of this rank's time slice, numpy or tensor)
    and returns ``(ShardedAudio, spectra [2, groups, fft])``."""

    def __init__(self, cfg: ChainConfig, params: FrontEndParams, mesh: Mesh,
                 comm: Comm | None = None):
        self.cfg = cfg
        self.mesh = mesh
        self.c_local = cfg.num_channels // mesh.chan
        self.device = mesh.devices[mesh.local_positions[-1]]
        self._step = sharded_frontend_step(cfg, mesh, comm)
        self.update_params(params)
        self.reset()

    def update_params(self, params: FrontEndParams) -> None:
        self.params = params
        self._placed = _place_params(params, self.mesh, self.c_local)

    def reset(self) -> None:
        zero = init_state(self.cfg, "cpu").rx
        self.state = {p: FrontEndState(rx=rx) for p, rx in place(
            zero, RECEIVER_STATE_AXES, self.mesh, self.c_local).items()}

    def gathered_state(self, device=None) -> FrontEndState:
        """The carried state, whole, on ``device`` (default: the front
        end's)."""
        rx = {p: s.rx for p, s in self.state.items()}
        return FrontEndState(rx=gather_columns(
            rx, RECEIVER_STATE_AXES, self.mesh, device or self.device))

    def process(self, iq):
        if not isinstance(iq, dict):
            iq = place_block(iq, self.mesh, self.cfg.block_frames)
        self.state, audio, spectra = self._step(self._placed, self.state, iq)
        return (ShardedAudio(self.mesh, [audio], time_major=False),
                gather_spectra(spectra, self.mesh, self.device))
