"""The channelized front end over a ``(time, chan)`` mesh: the shared
filterbank and the receiver tails per shard (port of
``webradio_tpu.parallel.sharded_channelized``).

* ``chan`` axis: receivers are data-parallel. Every channel shard reads its
  own columns of the filterbank weights (``pfb_weights[..., c0:c1]`` and,
  at every lossy tier, ``pfb_weights_split[..., c0:c1]``), residual steps,
  FIR banks and demod state, with no communication; it recomputes the
  filterbank product for its channels on its time slice rather than
  receiving bins. The shared Toeplitz bands and the filterbank history are
  replicated.
* ``time`` axis: the wideband block splits in time; left-neighbour halos
  move by :meth:`.comm.Comm.shift_right_into`, exactly the carries the
  single-card step keeps between blocks: ``K_p - 1`` raw input samples
  (filterbank history, moved from the block's input before anything is
  computed), ``K - 1`` mixed channel-rate samples (shaping-FIR history),
  one channel-rate sample (FM discriminator) and ``K - 1`` demodulated
  samples (audio-FIR history). The residual NCO needs no communication:
  its phase at a shard boundary is ``(phase0 + shard_start * step) mod
  2^31``.

Two bodies, as in the JAX package, each a list of stages
(``parallel.graphs``). The time-major body (:data:`TM_STAGES`) recomputes
the three tail halos from the shard's last ``2K - 1`` product rows and
then runs the single-card time-major tail on the shard: kernel #1
(``ops.tail_tm.fused_tail_audio_tm``), or kernel #2 (``fused_tail_tm``)
and the Toeplitz audio FIR where the local block admits no audio time
tile, wherever the single-card step's rule selects it on the shard's
LOCAL sizes (:func:`_tm_uses_kernel`: on the card at every width, on the
CPU the JAX package's per-shard rule), else the plain tail. Its
halos move in one exchange, so the body is two segments of work on a card
between three moves. The stage body (:data:`STAGE_STAGES`) serves shards
whose slots do not share one FIR kernel, stage by stage with an exchange
between stages, plain on every device: neither body calls kernel #3 or #4
(the JAX package's sharded engine has no per-channel kernel branch either;
the per-channel kernel's raw history across time shards needs a design of
its own). On the card a front end whose tails run plain says why in
``plain_tail``, and in the log when it is built.

The next block's carries are the last time shard's
(:meth:`.comm.Comm.from_last_into`), and the squelch gate reads the whole
block's post-shaping power (:meth:`.comm.Comm.mean_time_into`). A law or
parameter change applies at the next block: nothing is compiled, and a
parameter set of the same layout is copied into the placed tensors, so no
graph is captured again (the JAX front end rebuilds its step on a new
demod law).
"""

from __future__ import annotations

import logging

import torch

from ..ops.channelizer import pfb_channelize_direct
from ..ops.demod import demodulate_tm
from ..ops.fir import fir_decimate_toeplitz_tm, fir_dispatch
from ..ops.nco import (
    PHASE_MASK,
    nco_advance,
    nco_mix,
    nco_mix_tm,
    nco_mix_tm_fast,
)
from ..ops.precision import full_fp32
from ..ops.tail_tm import (
    fused_tail_audio_tm,
    fused_tail_tm,
    tail_after_mix_tm,
)
from ..pipeline import channelized as _ch
from ..pipeline.channelized import (
    ChannelizedConfig,
    ChannelizedParams,
    ChannelizedState,
    _audio_time_tile,
    _channelize_tm,
    init_channelized_state,
    scatter_params_slots,
)
from ..pipeline.graph import Kept, carry, clone_tree, shapes
from .comm import Comm
from .graphs import Local, Move
from .mesh import Mesh
from .sharded import (
    FINISH_MOVE,
    ShardedAudio,
    ShardedPipeline,
    distinct,
    fir_stages,
    gated_audio_out,
    gather_columns,
    place,
    shift,
    spectra_out,
)

#: the channel axis of each field (None: replicated on every position)
PARAMS_AXES = ChannelizedParams(
    pfb_weights=2, residual_step=0, chan_coeff=0, audio_coeff=0, mode=0,
    af_gain=0, squelch=0, chan_toep=None, audio_toep=None,
    pfb_weights_split=3)
STATE_AXES = ChannelizedState(pfb_hist=None, nco_phase=0, chan_hist=1,
                              demod_prev=1, audio_hist=0)

log = logging.getLogger(__name__)


def _tail_rows(cfg, prm, mix_tm, y2, phase, c_local):
    """The shard's last ``2K - 1`` product rows, mixed (``[2K-1, C]``
    each), their last ``K`` shaped rows and the last ``K - 1`` demodulated
    samples: every halo the right neighbour needs, recomputed here with the
    main tail's LO law."""
    k = cfg.fir_length
    t_rows = 2 * k - 1
    nd = y2.shape[0]
    rows = y2[nd - t_rows:].float()  # a bfloat16 product upcasts here
    phase_t = (phase + (nd - t_rows) * prm.residual_step) & PHASE_MASK
    mt_i, mt_q = mix_tm(rows[:, :c_local], rows[:, c_local:], phase_t,
                        prm.residual_step)
    # shaped[-K:] via one small banded matmul: w_tail [2K-1, K] from the
    # shared kernel (chan_toep column 0 holds the reversed coefficients)
    rev = prm.chan_toep[:k, 0]
    j = torch.arange(k, device=rev.device)
    w_tail = torch.zeros((t_rows, k), dtype=torch.float32,
                         device=rev.device)
    w_tail[(j[:, None] + j[None, :]).reshape(-1), j.repeat(k)] = (
        rev.repeat_interleave(k))  # w_tail[j + m, m] = rev[j]
    with full_fp32():
        st_i = w_tail.T @ mt_i  # [K, C_local]: shaped rows nd-K .. nd-1
        st_q = w_tail.T @ mt_q
    audio_tail, _ = demodulate_tm(st_i[1:], st_q[1:], prm.mode,
                                  torch.stack([st_i[0], st_q[0]]))
    return (mt_i[t_rows - (k - 1):], mt_q[t_rows - (k - 1):],
            torch.stack([st_i[-1], st_q[-1]]), audio_tail)


def _tm_uses_kernel(cfg: ChannelizedConfig, nd_local: int, c_local: int,
                    params) -> bool:
    """Per-shard twin of ``pipeline.channelized._use_kernel_tm``: the one
    rule (``pipeline.channelized.tm_kernel_rule``) on the shard's local
    sizes (on the CPU the JAX package's ``_tm_uses_pallas``)."""
    return _ch.tm_kernel_rule(cfg, nd_local, c_local, params)


def _tm_body_eligible(cfg: ChannelizedConfig, t_shards: int,
                      params: ChannelizedParams) -> bool:
    """Can the time-major body run these shapes?"""
    if params.chan_toep is None or params.audio_toep is None:
        return False
    nd_local = cfg.block_frames // t_shards // cfg.num_bins
    if nd_local < 2 * cfg.fir_length - 1:
        return False
    return (
        nd_local % params.chan_toep.shape[1] == 0
        and (nd_local // cfg.audio_decim) % params.audio_toep.shape[1] == 0
    )


def check_channelized_mesh(cfg: ChannelizedConfig, mesh: Mesh) -> None:
    """The JAX package's shape checks of the sharded channelized step."""
    if cfg.block_frames % (mesh.time * cfg.fft_size):
        raise ValueError("time shards must hold whole FFT groups")
    n_local = cfg.block_frames // mesh.time
    if n_local % (cfg.num_bins * cfg.audio_decim):
        raise ValueError("time shards must hold whole decimation groups")
    if n_local < cfg.proto_taps:
        raise ValueError("time shards shorter than the filterbank halo")
    if cfg.num_channels % mesh.chan:
        raise ValueError("num_channels must divide over chan shards")


# ---- the stages --------------------------------------------------------
def _pfb_halo(ws) -> None:
    """The filterbank history of each position past time shard 0: its
    left neighbour's last ``K_p - 1`` input frames, moved from the block's
    input (fixed buffers: a move between replays may read them)."""
    kp = ws.cfg.proto_taps
    ws.comm.shift_right_into(
        {p: [x[:, -(kp - 1):]] for p, x in ws.iq.items()}, ws.recv("pfb"))


def _pfb_hist(ws, p):
    halo = ws.recv("pfb").get(p)
    return ws.state[p].pfb_hist if halo is None else halo[0]


def _tm_filterbank(ws, pos):
    """The spectrum, the packed filterbank product (bfloat16 under
    "bf16"), and the tail halos recomputed from its last rows with the main
    tail's LO law (so the histories a shard receives are what its
    neighbour's tail computed)."""
    cfg, m = ws.cfg, ws.mesh
    nd_local = cfg.block_frames // m.time // cfg.num_bins
    c_local = cfg.num_channels // m.chan
    mix_tm = nco_mix_tm_fast if cfg.fast_nco else nco_mix_tm
    for p in pos:
        prm, st, iq = ws.params[p], ws.state[p], ws.iq[p]
        if p % m.chan == 0:
            spectra_out(ws, p, iq)
        ws.y2[p], _, pfb_tail = _channelize_tm(cfg, prm, _pfb_hist(ws, p),
                                               iq, split=False)
        start = (p // m.chan) * nd_local
        ws.phase[p] = (st.nco_phase + start * prm.residual_step) & PHASE_MASK
        tails = _tail_rows(cfg, prm, mix_tm, ws.y2[p], ws.phase[p], c_local)
        mt_i, mt_q, prev, audio_tail = tails
        ws.send("tails", p, list(tails))
        # the next block's carries, should this be the last time shard
        ws.send("carries", p, [pfb_tail, torch.stack([mt_i.T, mt_q.T]),
                               prev, audio_tail.T])


def _tm_tail(ws, pos):
    """The single-card time-major tail on each shard, its histories the
    carried state at time shard 0 and the moved halos after."""
    cfg, m = ws.cfg, ws.mesh
    nd_local = cfg.block_frames // m.time // cfg.num_bins
    c_local = cfg.num_channels // m.chan
    d = cfg.audio_decim
    mix_tm = nco_mix_tm_fast if cfg.fast_nco else nco_mix_tm
    for p in pos:
        prm, st, y2 = ws.params[p], ws.state[p], ws.y2[p]
        halo = ws.recv("tails").get(p)
        if halo is None:
            hist_i, hist_q = st.chan_hist[0].T, st.chan_hist[1].T
            prev, audio_hist = st.demod_prev, st.audio_hist.T
        else:
            hist_i, hist_q, prev, audio_hist = halo
        # copies of the carried histories: a kernel never reads a history
        # buffer that the carries write
        hist_i, hist_q = hist_i.contiguous(), hist_q.contiguous()
        audio_hist = audio_hist.contiguous()
        lo = (ws.phase[p], prm.residual_step)
        if _tm_uses_kernel(cfg, nd_local, c_local, prm):
            if _audio_time_tile(nd_local, d, prm.chan_toep.shape[1]):
                ws.audio[p], _, _, _, _, pw = fused_tail_audio_tm(
                    y2, y2, *lo, prm.chan_toep, prm.audio_toep, d,
                    prm.mode, hist_i, hist_q, prev, audio_hist,
                    precision=cfg.fir_precision, packed=True,
                    fast=cfg.fast_nco)
            else:
                audio_tm, _, _, _, pw = fused_tail_tm(
                    y2, y2, *lo, prm.chan_toep, prm.mode, hist_i,
                    hist_q, prev, precision=cfg.fir_precision, packed=True,
                    fast=cfg.fast_nco)
                ws.audio[p], _ = fir_decimate_toeplitz_tm(
                    audio_tm, prm.audio_toep, d, audio_hist)
        else:
            yf = y2.float()
            mi, mq = mix_tm(yf[:, :c_local], yf[:, c_local:], *lo)
            ws.audio[p], _, _, _, _, pw = tail_after_mix_tm(
                mi, mq, prm.chan_toep, prm.audio_toep, d, prm.mode, hist_i,
                hist_q, prev, audio_hist)
        ws.send("power", p, [pw])


def _stage_filterbank(ws, pos):
    """The stage body's spectrum, filterbank product (time-minor planes)
    and residual mix."""
    cfg, m = ws.cfg, ws.mesh
    nd_local = cfg.block_frames // m.time // cfg.num_bins
    k = cfg.fir_length
    for p in pos:
        prm, st, iq = ws.params[p], ws.state[p], ws.iq[p]
        if p % m.chan == 0:
            spectra_out(ws, p, iq)
        chan_in, pfb_tail = pfb_channelize_direct(
            iq, prm.pfb_weights, cfg.num_bins, _pfb_hist(ws, p),
            precision=cfg.pfb_precision,
            weights_split=prm.pfb_weights_split)  # [2, C_local, nd_local]
        start = (p // m.chan) * nd_local
        phase = (st.nco_phase + start * prm.residual_step) & PHASE_MASK
        ws.mixed[p] = nco_mix(chan_in, phase, prm.residual_step)
        ws.send("mixed", p, [ws.mixed[p][:, :, -(k - 1):]])
        ws.carries_head[p] = [pfb_tail]


def _finish(time_major: bool):
    def fn(ws, pos):
        """Gate every shard on the whole block's power; the next block's
        carries (the last time shard's) into the state, once per copy."""
        gated_audio_out(ws, pos, lambda x: x, time_major)
        new = ws.recv("carries")
        for p in distinct({p: ws.state[p] for p in pos}):
            st = ws.state[p]
            pfb_hist, chan_hist, prev, audio_hist = new[p]
            carry(st, ChannelizedState(
                pfb_hist=pfb_hist,
                nco_phase=nco_advance(st.nco_phase,
                                      ws.params[p].residual_step,
                                      ws.cfg.chan_frames),
                chan_hist=chan_hist, demod_prev=prev,
                audio_hist=audio_hist))
    return Local(fn)


#: the time-major body: the filterbank with the recomputed halos, one
#: exchange, the tails, the gate and the carries
TM_STAGES = [Move(_pfb_halo), Local(_tm_filterbank), shift("tails"),
             Local(_tm_tail), FINISH_MOVE, _finish(time_major=True)]
#: the stage body: each halo taken from its materialized output
STAGE_STAGES = ([Move(_pfb_halo), Local(_stage_filterbank)]
                + fir_stages(lambda x: x, lambda cfg, *a: fir_dispatch(*a),
                             lambda cfg: 1)
                + [_finish(time_major=False)])


def _select(sub: ChannelizedParams, cols: list[int]) -> ChannelizedParams:
    """Columns ``cols`` of a slot-write's parameters."""
    idx = torch.tensor(cols, dtype=torch.int64)
    return ChannelizedParams(*(
        None if x is None or ax is None else
        x.index_select(ax, idx.to(x.device))
        for x, ax in zip(sub, PARAMS_AXES)))


class ShardedChannelizedFrontEnd(ShardedPipeline):
    """Mesh-aware counterpart of ``ChannelizedPipeline``, on
    :class:`.sharded.ShardedPipeline` (each block a round of graph replays
    on the card), with ``update_params_slots``, a per-shard slot scatter.
    ``time_major`` says which body runs (audio pieces ``[af_local,
    c_local]``, else ``[c_local, af_local]``); it is decided per
    parameter set, as the JAX package decides per call."""

    def __init__(self, cfg: ChannelizedConfig, params: ChannelizedParams,
                 mesh: Mesh, comm: Comm | None = None, graph: bool = True,
                 _segmented: bool | None = None):
        check_channelized_mesh(cfg, mesh)
        super().__init__(cfg, params, mesh, comm, graph, _segmented)
        why = self.plain_tail
        if why:
            log.warning("sharded channelized front end (%d channels, mesh "
                        "%dx%d): the tails run plain on the card: %s",
                        cfg.num_channels, mesh.time, mesh.chan, why)

    @property
    def plain_tail(self) -> str | None:
        """On the card, why the shards' tails run plain although
        ``tail_kernel`` does not ask for it, else None (on the CPU the JAX
        rule decides)."""
        prm = self._placed[self.mesh.local_positions[0]]
        if not _ch.on_card(prm.mode) or self.cfg.tail_kernel == "xla":
            return None
        if not self.time_major:
            return ("the per-channel body of the sharded engine has no "
                    "kernel yet")
        nd_local = (self.cfg.block_frames // self.mesh.time
                    // self.cfg.num_bins)
        why = _ch.tm_kernel_refusal(self.cfg, nd_local, self.c_local, prm)
        return why and f"time-major tail kernel on each shard: {why}"

    @property
    def time_major(self) -> bool:
        any_params = self._placed[self.mesh.local_positions[0]]
        return _tm_body_eligible(self.cfg, self.mesh.time, any_params)

    def _stages(self) -> list:
        return TM_STAGES if self.time_major else STAGE_STAGES

    def _place_params(self, params: ChannelizedParams) -> dict:
        return place(params, PARAMS_AXES, self.mesh, self.c_local)

    def update_params_slots(self, idx, sub: ChannelizedParams) -> None:
        """A control write for a few slots: ``sub`` holds their columns (on
        any device); each shard scatters the columns it owns, in place
        (``pipeline.channelized.scatter_params_slots``), and so does the
        whole parameter set this front end was given."""
        idx = list(idx)
        self.params = scatter_params_slots(self.params, idx, sub)
        done = set()
        for p in self.mesh.local_positions:
            prm = self._placed[p]
            if id(prm) in done or prm.pfb_weights.data_ptr() == (
                    self.params.pfb_weights.data_ptr()):
                continue  # one copy per column and device; or the whole set
            done.add(id(prm))
            c0 = (p % self.mesh.chan) * self.c_local
            mine = [j for j, i in enumerate(idx)
                    if c0 <= i < c0 + self.c_local]
            if mine:
                scatter_params_slots(prm, [idx[j] - c0 for j in mine],
                                     _select(sub, mine))

    def _init_state(self):
        zero = init_channelized_state(self.cfg, "cpu")
        return place(zero, STATE_AXES, self.mesh, self.c_local)

    def gathered_state(self, device=None) -> ChannelizedState:
        """The carried state, whole, on ``device`` (default: the front
        end's)."""
        return gather_columns(self.state, STATE_AXES, self.mesh,
                              device or self.device)


#: the front ends kept between offline runs, by configuration, mesh and
#: parameter layout
KEPT = Kept(2)


def run_capture_sharded(cfg: ChannelizedConfig, params: ChannelizedParams,
                        mesh: Mesh, iq: torch.Tensor,
                        state: ChannelizedState | None = None,
                        graph: bool = True):
    """Demodulate a whole recorded capture on a mesh: the sharded
    counterpart of ``pipeline.stream.run_capture_channelized``, with its
    contract. ``iq [2, total_frames]`` (truncated to whole blocks;
    ValueError on less than one) goes block by block through a
    :class:`ShardedChannelizedFrontEnd`: on the card one copy into its
    graphs' device inputs and the round of replays a block (one replay on
    a mesh of one card), then each block's audio and latest spectrum row
    copied into one output made before the loop on ``iq``'s device:
    ``(final_state, audio [C, total_audio], latest [n_blocks, 2,
    fft_size])``. ``state``: the carried state to start from (None: the
    init state; not written). ``graph=False`` runs the stages eagerly.
    The front end (its graphs, its placed copy of the parameters) is kept
    for a later call of the same configuration, mesh and parameter layout,
    which copies its parameters and state into it instead of warming and
    capturing again. One process drives every position."""
    bf, af = cfg.block_frames, cfg.audio_frames
    n_blocks = iq.shape[-1] // bf
    if n_blocks == 0:
        raise ValueError("capture shorter than one block")
    key = (cfg, mesh, graph, shapes(params))
    fe = KEPT.take(key)
    if fe is None:
        fe = ShardedChannelizedFrontEnd(cfg, clone_tree(params), mesh,
                                        graph=graph)
    else:
        fe.update_params(params)
    fe.load_state(place(state if state is not None
                        else init_channelized_state(cfg, "cpu"),
                        STATE_AXES, mesh, fe.c_local))
    audio = torch.empty((cfg.num_channels, n_blocks * af),
                        dtype=torch.float32, device=iq.device)
    latest = torch.empty((n_blocks, 2, cfg.fft_size), dtype=torch.float32,
                         device=iq.device)
    for b in range(n_blocks):
        out = fe._run(iq[:, b * bf:(b + 1) * bf])
        ShardedAudio(mesh, [out["audio"]], fe.time_major).write_into(
            audio[:, b * af:(b + 1) * af])
        latest[b].copy_(out["latest"][fe._last])
    final = fe.gathered_state(iq.device)
    KEPT.put(key, fe)
    return final, audio, latest
