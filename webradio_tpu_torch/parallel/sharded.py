"""The direct front-end step over a ``(time, chan)`` mesh (port of
``webradio_tpu.parallel.sharded``), and what both sharded engines share:
the placement of values on a mesh's positions, their audio
(:class:`ShardedAudio`) and their host pipeline (:class:`ShardedPipeline`,
each block a round of CUDA graph replays, ``parallel.graphs``).

The single-card step (:func:`..pipeline.frontend.frontend_step`) runs per
shard with explicit halo exchange:

* channel axis: params, state and outputs ``[C, ...]`` split over
  ``chan``, with no communication;
* time axis: the wideband block ``[2, N]`` splits over ``time``. Each time
  shard needs from its left neighbour exactly the reference's carries
  (lowpass.cxx:133-142, demodulator.cxx:110-111): ``K-1`` mixed input
  frames (channel-FIR history), the last channel-rate sample (FM
  discriminator) and ``K-1`` demodulated samples (audio-FIR history), each
  moved by :meth:`.comm.Comm.shift_right_into`; shard 0 takes the carried
  block state. The NCO phase is computed, not moved: ``(phase0 +
  shard_start * step) mod 2^31``. The spectrum has no carry (whole FFT
  groups per shard).

The next block's carries are the last time shard's
(:meth:`.comm.Comm.from_last_into`), and the squelch gate reads the whole
block's power (:meth:`.comm.Comm.mean_time_into`). Outputs stay on the
positions that computed them (:class:`ShardedAudio`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.demod import demodulate
from ..ops.fir import fir_dispatch, overlap_save_decimate
from ..ops.nco import PHASE_MASK, nco_advance, nco_mix
from ..ops.spectrum import spectrum_accumulate, spectrum_db
from ..pipeline.frontend import HostPipeline, SelectedRows, squelch_scale
from ..pipeline.graph import CudaStepGraph, carry, fields, layout, same_shapes
from ..pipeline.state import (
    ChainConfig,
    FrontEndParams,
    FrontEndState,
    ReceiverParams,
    ReceiverState,
    init_state,
)
from .comm import Comm
from .graphs import BlockProgram, Local, Move
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


def distinct(placed: dict) -> list[int]:
    """One position for each distinct placed value (positions of one
    column on one device share theirs)."""
    seen, out = set(), []
    for p, value in placed.items():
        key = tuple(t.data_ptr() for t in fields(value) if t is not None)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def gather_columns(placed: dict, axes, mesh: Mesh, device) -> tuple:
    """The named tuple again, whole, on ``device`` (a copy of its own):
    the columns of this rank's first time row joined on their channel
    axes."""
    row = mesh.local_rows[0]
    cols = [placed[row * mesh.chan + c] for c in range(mesh.chan)]
    first = cols[0]
    return type(first)(*(
        None if x is None else
        (x.to(device, copy=True) if ax is None else
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


class ShardedAudio:
    """The audio of one block, or of a catch-up's blocks, as the shards
    made it: one piece per block and local position, on that position's
    device, ``[c_local, af_local]`` or (``time_major``) ``[af_local,
    c_local]``. Nothing joins the pieces on one device unless asked
    (:meth:`full`); the server takes the subscribed rows only
    (:meth:`select_rows`, :meth:`fetch_rows`)."""

    def __init__(self, mesh: Mesh, blocks: list, time_major: bool):
        self.mesh = mesh
        self.blocks = blocks
        self.time_major = time_major
        piece = blocks[0][mesh.local_positions[0]]
        self.c_local, self.af_local = (
            piece.shape[::-1] if time_major else piece.shape)
        self.channels = self.c_local * mesh.chan

    def select_rows(self, rows, ready=None) -> SelectedRows:
        """The channels ``rows``, copied out of the pieces on their devices
        (behind the block's ``ready`` events where given, the
        :attr:`..pipeline.frontend.Outputs.ready` of its cards:
        :class:`..pipeline.frontend.SelectedRows`), each piece's rows
        filling their places of this rank's time shards."""
        m, af = self.mesh, self.af_local
        by_col: dict[int, list] = {}
        for k, r in enumerate(rows):
            by_col.setdefault(r // self.c_local, []).append(
                (k, r % self.c_local))
        one = len(self.blocks) == 1
        pieces = []
        for b, block in enumerate(self.blocks):
            for i, t in enumerate(m.local_rows):
                for c, picks in by_col.items():
                    place = ([k for k, _ in picks], slice(i * af,
                                                          (i + 1) * af))
                    pieces.append((block[t * m.chan + c],
                                   [j for _, j in picks],
                                   place if one else (b, *place)))
        shape = (len(rows), len(m.local_rows) * af)
        return SelectedRows(pieces, self.time_major,
                            shape if one else (len(self.blocks), *shape),
                            ready)

    def fetch_rows(self, rows) -> np.ndarray:
        """This rank's time shards of the channels ``rows`` on the host,
        gathered on the current streams: ``[k, af]`` for one block,
        ``[blocks, k, af]`` for several."""
        return self.select_rows(rows).to_host()

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


# ---- the host pipeline of both engines -----------------------------------
def _copied_into(placed: dict, new: dict) -> dict:
    """``new`` copied into ``placed`` (once per distinct value) where every
    position has the same layout, and ``placed`` kept; else ``new``."""
    if not all(same_shapes(placed[p], new[p]) for p in new):
        return new
    for p in distinct(placed):
        carry(placed[p], new[p])
    return placed


class ShardedPipeline(HostPipeline):
    """A sharded engine on :class:`..pipeline.frontend.HostPipeline`'s
    contract (``process_host``, ``process_host_many``, ``flush``,
    ``process_host_sync``, ``reset``, ``load_state``, ``update_params``),
    plus :meth:`process`. Per-block audio is a :class:`ShardedAudio`;
    ``latest_db`` is this rank's last time shard's last spectrum row.
    ``device`` is the device of this rank's last position. The block's
    :attr:`step_events` are recorded by its run, each card's around its own
    replays (:meth:`.graphs.BlockProgram.run`).

    The parameters and state are placed per position once and kept in
    those tensors: a parameter set of the same layout is copied into them
    (:meth:`update_params`), the carries are written into the state's
    (:meth:`load_state` copies too). Each block is a
    :class:`.graphs.BlockProgram` round on one of two slots: on the card
    the graph replays of its stages (one graph a block where every local
    position is on one device and no process group runs the moves, else
    a graph a device and segment with the moves between replays:
    ``segmented``), on the CPU or with ``graph=False`` the stages run
    eagerly. The audio pieces and spectra handed back for a block are the
    slot's outputs, rewritten two blocks on: a caller that keeps them
    longer copies them. A program is made anew where :meth:`graph_key`
    changes (the configuration, the body, the address of a placed
    parameter or state tensor); its first block is an eager warm, then
    both slots are captured. ``graph_stats()`` counts what the graphs did
    over every device (one replay a block, its kernels summed over the
    round's graphs)."""

    def __init__(self, cfg, params, mesh: Mesh, comm: Comm | None = None,
                 graph: bool = True, _segmented: bool | None = None):
        self.mesh = mesh
        self.c_local = cfg.num_channels // mesh.chan
        self.comm = comm or Comm(mesh)
        devices = {mesh.devices[p] for p in mesh.local_positions}
        #: a graph a device and segment, the moves between replays (else
        #: one graph a block); a test may force it
        self.segmented = (len(devices) > 1 or self.comm.grouped
                          if _segmented is None else _segmented)
        #: the distinct devices of this rank's positions, in order
        self.devices = sorted(devices, key=lambda d: (d.type, d.index or 0))
        self._streams: dict = {}
        self._program: BlockProgram | None = None
        self._last = mesh.local_rows[-1] * mesh.chan
        super().__init__(cfg, params, mesh.devices[mesh.local_positions[-1]],
                         graph)
        self._placed = self._place_params(params)

    def _place_params(self, params) -> dict:
        raise NotImplementedError

    def _stages(self) -> list:
        raise NotImplementedError

    # ---- parameters and state --------------------------------------
    def update_params(self, params) -> None:
        """Take a whole new parameter set (on any device) at the next
        block: each shard's columns copied into its placed tensors where
        the layout is the same, else placed anew (the next block captures
        again)."""
        self._placed = _copied_into(self._placed, self._place_params(params))
        self.params = params

    def load_state(self, state: dict) -> None:
        """Carry a placed state in: copied into the persistent buffers
        where it has their shapes, else taking their place."""
        self.state = _copied_into(self.state, state)

    # ---- graphs -------------------------------------------------------
    def graphed(self) -> bool:
        return self.use_graph and (
            all(d.type == "cuda" for d in self.devices)
            or self.graph_class is not CudaStepGraph)

    def graph_key(self) -> tuple:
        pos = self.mesh.local_positions
        return (self.cfg, self.mesh, self.time_major, self.segmented,
                layout(tuple(self._placed[p] for p in pos)),
                layout(tuple(self.state[p] for p in pos)))

    def graph_kernels_per_block(self) -> int:
        return self._program.kernels_per_block if self._program else 0

    def cards(self) -> list:
        return [d for d in self.devices if d.type == "cuda"]

    @property
    def launched(self) -> tuple:
        """The host's stamps of the last block's first and last card's
        launch (:attr:`.graphs.BlockProgram.launched`); zeros before the
        first block."""
        return self._program.launched if self._program else (0, 0)

    def capture_stream(self, dev: torch.device):
        """The side stream of ``dev`` that warms and captures (None on the
        CPU)."""
        if dev not in self._streams:
            self._streams[dev] = (torch.cuda.Stream(dev)
                                  if dev.type == "cuda" else None)
        return self._streams[dev]

    # ---- blocks --------------------------------------------------------
    def _run(self, block) -> dict:
        """One block (this rank's ``[2, frames]``, numpy or tensor, or a
        block placed on the mesh) through the program of the current key:
        the slot's outputs (``audio`` and ``spectra`` per position,
        ``latest`` and ``latest_db`` at this rank's last time row)."""
        key = self.graph_key()
        if self._program is None or self._program.key != key:
            self._program = BlockProgram(self, key, self._stages(),
                                         self.graphed(), self.segmented)
        program = self._program
        return program.run(self, program.fill(self, block))

    def process(self, iq):
        """One block -> ``(ShardedAudio, spectra [2, groups, fft])``."""
        out = self._run(iq)
        return (ShardedAudio(self.mesh, [out["audio"]], self.time_major),
                gather_spectra(out["spectra"], self.mesh, self.device))

    def process_host(self, iq_planes):
        """``iq_planes``: this rank's ``[2, frames]`` float32 (numpy), or a
        block placed on the mesh (``multihost.make_global_block``)."""
        out = self._run(iq_planes)
        return self._swap_pending(
            ShardedAudio(self.mesh, [out["audio"]], self.time_major),
            out["latest_db"][self._last])

    def process_host_many(self, blocks):
        """Catch-up: ``[k, 2, frames]`` block by block; the audio handed
        back holds the ``k`` blocks, each a copy of its own (a slot's
        outputs are rewritten two blocks on)."""
        kept = []
        for block in blocks:
            out = self._run(block)
            kept.append({p: a.clone() for p, a in out["audio"].items()})
        return self._swap_pending(
            ShardedAudio(self.mesh, kept, self.time_major),
            out["latest_db"][self._last])


# ---- the stages both bodies share ----------------------------------------
def shift(name: str) -> Move:
    """The move of halo ``name``: each position's left neighbour's."""
    def fn(ws):
        ws.comm.shift_right_into(ws.sent(name), ws.recv(name))
    return Move(fn)


def _gate_and_carry_moves(ws) -> None:
    ws.comm.mean_time_into(ws.sent("power"), ws.recv("power"))
    ws.comm.from_last_into(ws.sent("carries"), ws.recv("carries"))


#: the whole block's squelch power and the last time shard's carries
FINISH_MOVE = Move(_gate_and_carry_moves)


def spectra_out(ws, p: int, iq: torch.Tensor) -> None:
    """A time row's spectra into the slot's outputs, and at this rank's
    last row the latest row, raw and in dB."""
    spectra = spectrum_accumulate(iq, ws.cfg.fft_size)
    ws.output("spectra", p, spectra)
    if p == ws.mesh.local_rows[-1] * ws.mesh.chan:
        raw = spectra[:, -1, :]
        ws.output("latest", p, raw)
        ws.output("latest_db", p, spectrum_db(raw))


def gated_audio_out(ws, pos, rx, time_major: bool) -> None:
    """Each position's audio, gated on the whole block's power, into the
    slot's outputs (``rx`` picks the receiver fields of a parameter
    set)."""
    power = ws.recv("power")
    for p in pos:
        prm = rx(ws.params[p])
        scale = squelch_scale(power[p][0], prm.af_gain, prm.squelch)
        ws.output("audio", p, ws.audio[p] * (scale[None, :] if time_major
                                             else scale[:, None]))


def fir_stages(rx, fir, chan_decim) -> list:
    """The stages after the mix that the direct body and the channelized
    stage body share, each halo moved from its materialized output: the
    channel FIR (``chan_decim(cfg)``; the shaping FIR), the demodulator
    and the audio FIR on ``ws.mixed`` into ``ws.audio``, with the power
    and the carries ``ws.carries_head + [chan_hist, prev, audio_hist]``
    sent. ``rx`` picks the receiver fields of a parameter set or state;
    ``fir(cfg, x, coeff, toep, decim, hist)``."""
    def channel(ws, pos):
        cfg = ws.cfg
        for p in pos:
            prm, st = rx(ws.params[p]), rx(ws.state[p])
            halo = ws.recv("mixed").get(p)
            ws.chan[p], ws.chan_hist[p] = fir(
                cfg, ws.mixed[p], prm.chan_coeff, prm.chan_toep,
                chan_decim(cfg), st.chan_hist if halo is None else halo[0])
            ws.send("chan", p, [ws.chan[p][:, :, -1]])

    def demod(ws, pos):
        k = ws.cfg.fir_length
        for p in pos:
            prm, st = rx(ws.params[p]), rx(ws.state[p])
            halo = ws.recv("chan").get(p)
            ws.audio_if[p], ws.prev[p] = demodulate(
                ws.chan[p], prm.mode,
                st.demod_prev if halo is None else halo[0])
            ws.send("audio_if", p, [ws.audio_if[p][:, -(k - 1):]])

    def audio(ws, pos):
        cfg = ws.cfg
        for p in pos:
            prm, st = rx(ws.params[p]), rx(ws.state[p])
            halo = ws.recv("audio_if").get(p)
            ws.audio[p], audio_hist = fir(
                cfg, ws.audio_if[p], prm.audio_coeff, prm.audio_toep,
                cfg.audio_decim, st.audio_hist if halo is None else halo[0])
            chan = ws.chan[p]
            ws.send("power", p, [(chan[0] ** 2 + chan[1] ** 2).mean(dim=-1)])
            ws.send("carries", p, ws.carries_head.get(p, []) + [
                ws.chan_hist[p], ws.prev[p], audio_hist])

    return [shift("mixed"), Local(channel), shift("chan"), Local(demod),
            shift("audio_if"), Local(audio), FINISH_MOVE]


# ---- the direct engine ---------------------------------------------------
def _direct_fir(cfg, x, coeff, toep, decim, hist):
    if cfg.use_overlap_save:
        return overlap_save_decimate(x, coeff, decim, hist)
    return fir_dispatch(x, coeff, toep, decim, hist)


def _direct_mix(ws, pos):
    """The spectrum and each position's NCO mix (closed-form start phase
    per shard, no communication)."""
    cfg, m = ws.cfg, ws.mesh
    n_local = cfg.block_frames // m.time
    k = cfg.fir_length
    for p in pos:
        rxp, rxs, iq = ws.params[p].rx, ws.state[p].rx, ws.iq[p]
        if p % m.chan == 0:
            spectra_out(ws, p, iq)
        start = (p // m.chan) * n_local
        phase = (rxs.nco_phase + start * rxp.phase_step) & PHASE_MASK
        ws.mixed[p] = nco_mix(iq[:, None, :], phase, rxp.phase_step)
        ws.send("mixed", p, [ws.mixed[p][:, :, -(k - 1):]])


def _direct_finish(ws, pos):
    """Gate every shard on the whole block's power; the next block's
    carries (the last time shard's) into the state, once per copy."""
    gated_audio_out(ws, pos, lambda x: x.rx, time_major=False)
    new = ws.recv("carries")
    for p in distinct({p: ws.state[p] for p in pos}):
        rxs, rxp = ws.state[p].rx, ws.params[p].rx
        chan_hist, prev, audio_hist = new[p]
        carry(rxs, ReceiverState(
            nco_phase=nco_advance(rxs.nco_phase, rxp.phase_step,
                                  ws.cfg.block_frames),
            chan_hist=chan_hist, demod_prev=prev, audio_hist=audio_hist))


DIRECT_STAGES = ([Local(_direct_mix)]
                 + fir_stages(lambda x: x.rx, _direct_fir,
                              lambda cfg: cfg.chan_decim)
                 + [Local(_direct_finish)])


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


class ShardedFrontEnd(ShardedPipeline):
    """Mesh-aware counterpart of ``FrontEndPipeline`` (the stages of
    :data:`DIRECT_STAGES`): ``process(iq)`` runs one block (``[2, frames]``
    of this rank's time slice, numpy or tensor) and returns
    ``(ShardedAudio, spectra [2, groups, fft])``; audio pieces ``[c_local,
    af_local]``."""

    def __init__(self, cfg: ChainConfig, params: FrontEndParams, mesh: Mesh,
                 comm: Comm | None = None, graph: bool = True,
                 _segmented: bool | None = None):
        check_direct_mesh(cfg, mesh)
        super().__init__(cfg, params, mesh, comm, graph, _segmented)

    def _place_params(self, params: FrontEndParams) -> dict:
        return {p: FrontEndParams(rx=rx) for p, rx in place(
            params.rx, RECEIVER_PARAMS_AXES, self.mesh,
            self.c_local).items()}

    def _init_state(self) -> dict:
        zero = init_state(self.cfg, "cpu").rx
        return {p: FrontEndState(rx=rx) for p, rx in place(
            zero, RECEIVER_STATE_AXES, self.mesh, self.c_local).items()}

    def _stages(self) -> list:
        return DIRECT_STAGES

    def gathered_state(self, device=None) -> FrontEndState:
        """The carried state, whole, on ``device`` (default: the front
        end's)."""
        rx = {p: s.rx for p, s in self.state.items()}
        return FrontEndState(rx=gather_columns(
            rx, RECEIVER_STATE_AXES, self.mesh, device or self.device))
