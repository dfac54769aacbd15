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
  move by :meth:`.comm.Comm.shift_right`, exactly the carries the
  single-card step keeps between blocks: ``K_p - 1`` raw input samples
  (filterbank history), ``K - 1`` mixed channel-rate samples
  (shaping-FIR history), one channel-rate sample (FM discriminator) and
  ``K - 1`` demodulated samples (audio-FIR history). The residual NCO
  needs no communication: its phase at a shard boundary is
  ``(phase0 + shard_start * step) mod 2^31``.

Two bodies, as in the JAX package. The time-major body
(:func:`_shard_body_tm`) recomputes the three tail halos from the shard's
last ``2K - 1`` product rows and then runs the single-card time-major
tail on the shard: kernel #1 (``ops.tail_tm.fused_tail_audio_tm``), or
kernel #2 (``fused_tail_tm``) and the Toeplitz audio FIR where the local
block admits no audio time tile, wherever the JAX package's per-shard rule
selects its Pallas kernel (:func:`_tm_uses_kernel` on the LOCAL sizes),
else the plain tail. The stage body (:func:`_shard_body`) serves shards
whose slots do not share one FIR kernel, stage by stage with an exchange
between stages. Neither calls kernel #3 or #4 (as in JAX).

The next block's carries are the last time shard's
(:meth:`.comm.Comm.from_last`), and the squelch gate reads the whole
block's post-shaping power (:meth:`.comm.Comm.mean_time`). A law or
parameter change applies at the next block: nothing is compiled, so
nothing is rebuilt (the JAX front end rebuilds its step on a new demod
law).
"""

from __future__ import annotations

import torch

from ..ops.channelizer import pfb_channelize_direct
from ..ops.demod import demodulate, demodulate_tm
from ..ops.fir import fir_decimate_toeplitz_tm, fir_dispatch
from ..ops.nco import (
    PHASE_MASK,
    nco_advance,
    nco_mix,
    nco_mix_tm,
    nco_mix_tm_fast,
)
from ..ops.precision import full_fp32
from ..ops.spectrum import spectrum_accumulate, spectrum_db
from ..ops.tail_tm import (
    CHAN_TILE,
    fused_tail_audio_tm,
    fused_tail_tm,
    tail_after_mix_tm,
)
from ..pipeline.channelized import (
    PALLAS_TM_AUTO_THRESHOLD,
    SELECT_TIME_TILE,
    ChannelizedConfig,
    ChannelizedParams,
    ChannelizedState,
    _audio_time_tile,
    _channelize_tm,
    init_channelized_state,
    scatter_params_slots,
)
from ..pipeline.frontend import HostPipeline, squelch_scale
from .comm import Comm
from .mesh import Mesh
from .sharded import (
    ShardedAudio,
    gather_columns,
    gather_spectra,
    place,
    place_block,
)

#: the channel axis of each field (None: replicated on every position)
PARAMS_AXES = ChannelizedParams(
    pfb_weights=2, residual_step=0, chan_coeff=0, audio_coeff=0, mode=0,
    af_gain=0, squelch=0, chan_toep=None, audio_toep=None,
    pfb_weights_split=3)
STATE_AXES = ChannelizedState(pfb_hist=None, nco_phase=0, chan_hist=1,
                              demod_prev=1, audio_hist=0)


def _filterbank_halo(cfg, mesh, comm, state, iq):
    """The filterbank history of each position: the carried one at time
    shard 0, the left neighbour's last ``K_p - 1`` input frames after."""
    kp = cfg.proto_taps
    pos = mesh.local_positions
    halo = comm.shift_right({p: [iq[p][:, -(kp - 1):]] for p in pos})
    return {p: state[p].pfb_hist if halo[p] is None else halo[p][0]
            for p in pos}


def _shard_body(cfg: ChannelizedConfig, mesh: Mesh, comm: Comm, params,
                state, iq):
    """The stage body: each stage's halo taken from its materialized
    output (time-minor planes, the per-channel FIRs)."""
    c_n = mesh.chan
    nd_local = cfg.block_frames // mesh.time // cfg.num_bins
    k = cfg.fir_length
    pos = mesh.local_positions
    spectra = {p: spectrum_accumulate(iq[p], cfg.fft_size)
               for p in pos if p % c_n == 0}
    pfb_hist = _filterbank_halo(cfg, mesh, comm, state, iq)
    mixed, pfb_tail = {}, {}
    for p in pos:
        prm, st = params[p], state[p]
        chan_in, pfb_tail[p] = pfb_channelize_direct(
            iq[p], prm.pfb_weights, cfg.num_bins, pfb_hist[p],
            precision=cfg.pfb_precision,
            weights_split=prm.pfb_weights_split)  # [2, C_local, nd_local]
        start = (p // c_n) * nd_local
        phase = (st.nco_phase + start * prm.residual_step) & PHASE_MASK
        mixed[p] = nco_mix(chan_in, phase, prm.residual_step)

    # shaping FIR (decimation 1): channel-rate history halo
    halo = comm.shift_right({p: [mixed[p][:, :, -(k - 1):]] for p in pos})
    shaped, chan_hist = {}, {}
    for p in pos:
        hist = state[p].chan_hist if halo[p] is None else halo[p][0]
        shaped[p], chan_hist[p] = fir_dispatch(
            mixed[p], params[p].chan_coeff, params[p].chan_toep, 1, hist)

    # demod: the previous-sample halo
    halo = comm.shift_right({p: [shaped[p][:, :, -1]] for p in pos})
    audio_if, prev = {}, {}
    for p in pos:
        before = state[p].demod_prev if halo[p] is None else halo[p][0]
        audio_if[p], prev[p] = demodulate(shaped[p], params[p].mode, before)

    # audio FIR: history halo
    halo = comm.shift_right({p: [audio_if[p][:, -(k - 1):]] for p in pos})
    audio, audio_hist, power = {}, {}, {}
    for p in pos:
        hist = state[p].audio_hist if halo[p] is None else halo[p][0]
        audio[p], audio_hist[p] = fir_dispatch(
            audio_if[p], params[p].audio_coeff, params[p].audio_toep,
            cfg.audio_decim, hist)
        power[p] = [(shaped[p][0] ** 2 + shaped[p][1] ** 2).mean(dim=-1)]
    return _finish(cfg, comm, params, state, audio, power, spectra,
                   {p: [pfb_tail[p], chan_hist[p], prev[p], audio_hist[p]]
                    for p in pos}, time_major=False)


def _finish(cfg, comm, params, state, audio, power, spectra, tails,
            time_major):
    """Gate every shard on the whole block's power and take the next
    block's carries from the last time shard."""
    power = comm.mean_time(power)
    new = comm.from_last(tails)
    new_state = {}
    for p, prm in params.items():
        scale = squelch_scale(power[p][0], prm.af_gain, prm.squelch)
        audio[p] = audio[p] * (scale[None, :] if time_major
                               else scale[:, None])
        pfb_hist, chan_hist, prev, audio_hist = new[p]
        new_state[p] = ChannelizedState(
            pfb_hist=pfb_hist,
            nco_phase=nco_advance(state[p].nco_phase, prm.residual_step,
                                  cfg.chan_frames),
            chan_hist=chan_hist, demod_prev=prev, audio_hist=audio_hist)
    return new_state, audio, spectra


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


def _shard_body_tm(cfg: ChannelizedConfig, mesh: Mesh, comm: Comm, params,
                   state, iq):
    """The time-major body: the single-card time-major tail per shard,
    with the tail halos recomputed from each shard's last rows and moved in
    one exchange, so no stage waits on another's halo."""
    c_n = mesh.chan
    nd_local = cfg.block_frames // mesh.time // cfg.num_bins
    c_local = cfg.num_channels // c_n
    k, d = cfg.fir_length, cfg.audio_decim
    pos = mesh.local_positions
    # the halo recompute mixes with the main tail's law, so the histories
    # a shard receives are what its neighbour's tail computed
    mix_tm = nco_mix_tm_fast if cfg.fast_nco else nco_mix_tm
    spectra = {p: spectrum_accumulate(iq[p], cfg.fft_size)
               for p in pos if p % c_n == 0}
    pfb_hist = _filterbank_halo(cfg, mesh, comm, state, iq)
    y2, pfb_tail, phase, tails = {}, {}, {}, {}
    for p in pos:
        prm, st = params[p], state[p]
        # the packed [nd_local, 2 C_local] product (bfloat16 under "bf16")
        y2[p], _, pfb_tail[p] = _channelize_tm(cfg, prm, pfb_hist[p], iq[p],
                                               split=False)
        start = (p // c_n) * nd_local
        phase[p] = (st.nco_phase + start * prm.residual_step) & PHASE_MASK
        tails[p] = _tail_rows(cfg, prm, mix_tm, y2[p], phase[p], c_local)

    halo = comm.shift_right({p: list(tails[p]) for p in pos})
    audio, power = {}, {}
    for p in pos:
        prm, st = params[p], state[p]
        if halo[p] is None:
            hist_i, hist_q = st.chan_hist[0].T, st.chan_hist[1].T
            prev, audio_hist = st.demod_prev, st.audio_hist.T
        else:
            hist_i, hist_q, prev, audio_hist = halo[p]
        hist_i, hist_q = hist_i.contiguous(), hist_q.contiguous()
        audio_hist = audio_hist.contiguous()
        lo = (phase[p], prm.residual_step)
        if _tm_uses_kernel(cfg, nd_local, c_local, prm):
            if _audio_time_tile(nd_local, d, prm.chan_toep.shape[1]):
                audio[p], _, _, _, _, pw = fused_tail_audio_tm(
                    y2[p], y2[p], *lo, prm.chan_toep, prm.audio_toep, d,
                    prm.mode, hist_i, hist_q, prev, audio_hist,
                    precision=cfg.fir_precision, packed=True,
                    fast=cfg.fast_nco)
            else:
                audio_tm, _, _, _, pw = fused_tail_tm(
                    y2[p], y2[p], *lo, prm.chan_toep, prm.mode, hist_i,
                    hist_q, prev, precision=cfg.fir_precision, packed=True,
                    fast=cfg.fast_nco)
                audio[p], _ = fir_decimate_toeplitz_tm(
                    audio_tm, prm.audio_toep, d, audio_hist)
        else:
            yf = y2[p].float()
            mi, mq = mix_tm(yf[:, :c_local], yf[:, c_local:], *lo)
            audio[p], _, _, _, _, pw = tail_after_mix_tm(
                mi, mq, prm.chan_toep, prm.audio_toep, d, prm.mode, hist_i,
                hist_q, prev, audio_hist)
        power[p] = [pw]
    # the next block's carries: the last shard's recomputed tails
    carries = {}
    for p in pos:
        mt_i, mt_q, prev, audio_tail = tails[p]
        carries[p] = [pfb_tail[p], torch.stack([mt_i.T, mt_q.T]), prev,
                      audio_tail.T]
    return _finish(cfg, comm, params, state, audio, power, spectra, carries,
                   time_major=True)


def _tm_uses_kernel(cfg: ChannelizedConfig, nd_local: int, c_local: int,
                    params) -> bool:
    """Per-shard twin of ``pipeline.channelized._use_kernel_tm`` (the JAX
    package's ``_tm_uses_pallas``): the kernel rule on the shard's local
    sizes."""
    if cfg.tail_kernel == "xla":
        return False
    if cfg.tail_kernel == "auto" and c_local < PALLAS_TM_AUTO_THRESHOLD:
        return False
    return (
        params.chan_toep is not None
        and nd_local % SELECT_TIME_TILE == 0
        and c_local % CHAN_TILE == 0
        and SELECT_TIME_TILE % params.chan_toep.shape[1] == 0
    )


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


def sharded_channelized_step(cfg: ChannelizedConfig, mesh: Mesh,
                             comm: Comm | None = None):
    """The sharded channelized step for a mesh: ``step(params, state, iq)
    -> (state, audio, spectra)`` over values placed on the mesh's local
    positions (``sharded.place``, ``sharded.place_block``): audio per
    position ``[af_local, c_local]`` from the time-major body, ``[c_local,
    af_local]`` from the stage body (``step.time_major`` after a call says
    which), spectra per time row. No demod law is compiled in, so unlike
    the JAX function it takes no ``mode_set``."""
    check_channelized_mesh(cfg, mesh)
    comm = comm or Comm(mesh)

    def step(params, state, iq):
        any_params = params[mesh.local_positions[0]]
        step.time_major = _tm_body_eligible(cfg, mesh.time, any_params)
        body = _shard_body_tm if step.time_major else _shard_body
        return body(cfg, mesh, comm, params, state, iq)

    step.time_major = None
    return step


def _select(sub: ChannelizedParams, cols: list[int]) -> ChannelizedParams:
    """Columns ``cols`` of a slot-write's parameters."""
    idx = torch.tensor(cols, dtype=torch.int64)
    return ChannelizedParams(*(
        None if x is None or ax is None else
        x.index_select(ax, idx.to(x.device))
        for x, ax in zip(sub, PARAMS_AXES)))


class ShardedChannelizedFrontEnd(HostPipeline):
    """Mesh-aware counterpart of ``ChannelizedPipeline``, on
    :class:`..pipeline.frontend.HostPipeline`'s contract
    (``process_host``, ``process_host_many``, ``flush``,
    ``process_host_sync``, ``reset``, ``update_params``, and
    ``update_params_slots``, a per-shard slot scatter). Per-block audio is
    a :class:`.sharded.ShardedAudio`; ``latest_db`` is this rank's last
    time shard's last spectrum row. ``device`` is the device of this
    rank's last time shard, where the host block is staged.

    It overrides ``process_host`` and ``process_host_many`` and stays
    eager: no CUDA graph is captured (one graph and one launching thread
    per card are not made yet)."""

    def __init__(self, cfg: ChannelizedConfig, params: ChannelizedParams,
                 mesh: Mesh, comm: Comm | None = None):
        self.mesh = mesh
        self.c_local = cfg.num_channels // mesh.chan
        self.comm = comm or Comm(mesh)
        self._step = sharded_channelized_step(cfg, mesh, comm=self.comm)
        super().__init__(cfg, params, mesh.devices[mesh.local_positions[-1]])
        self.update_params(params)

    # ---- parameters and state --------------------------------------
    def update_params(self, params: ChannelizedParams) -> None:
        """Take a whole new parameter set (on any device) at the next
        block: each shard gets its columns."""
        self.params = params
        self._placed = place(params, PARAMS_AXES, self.mesh, self.c_local)

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

    # ---- blocks --------------------------------------------------------
    def _run(self, iq):
        if not isinstance(iq, dict):
            if not isinstance(iq, torch.Tensor):
                iq = self._to_device(iq)  # pinned staging, as one card's
            iq = place_block(iq, self.mesh, self.cfg.block_frames)
        self.state, audio, spectra = self._step(self._placed, self.state, iq)
        return audio, spectra

    def process(self, iq):
        """One block (this rank's ``[2, frames]``, numpy or tensor, or a
        placed block) -> ``(ShardedAudio, spectra [2, groups, fft])``."""
        audio, spectra = self._run(iq)
        return (ShardedAudio(self.mesh, [audio], self._step.time_major),
                gather_spectra(spectra, self.mesh, self.device))

    def _latest_db(self, spectra):
        last = self.mesh.local_rows[-1] * self.mesh.chan
        return spectrum_db(spectra[last][:, -1, :])

    def process_host(self, iq_planes):
        """``iq_planes``: this rank's ``[2, frames]`` float32 (numpy), or a
        block placed on the mesh (``multihost.make_global_block``)."""
        audio, spectra = self._run(iq_planes)
        return self._swap_pending(
            ShardedAudio(self.mesh, [audio], self._step.time_major),
            self._latest_db(spectra))

    def process_host_many(self, blocks):
        """Catch-up: ``[k, 2, frames]`` through the step block by block; the
        audio handed back holds the ``k`` blocks."""
        outs = []
        for block in blocks:
            audio, spectra = self._run(block)
            outs.append(audio)
        return self._swap_pending(
            ShardedAudio(self.mesh, outs, self._step.time_major),
            self._latest_db(spectra))


def run_capture_sharded(cfg: ChannelizedConfig, params: ChannelizedParams,
                        mesh: Mesh, iq: torch.Tensor,
                        state: ChannelizedState | None = None):
    """Demodulate a whole recorded capture on a mesh: the sharded
    counterpart of ``pipeline.stream.run_capture_channelized``, with its
    contract. ``iq [2, total_frames]`` (truncated to whole blocks;
    ValueError on less than one) goes through the sharded step block by
    block, and each block's audio and latest spectrum row are copied into
    one output made before the loop on ``iq``'s device: ``(final_state,
    audio [C, total_audio], latest [n_blocks, 2, fft_size])``. ``state``:
    the carried state to start from (None: the init state). One process
    drives every position."""
    bf, af = cfg.block_frames, cfg.audio_frames
    n_blocks = iq.shape[-1] // bf
    if n_blocks == 0:
        raise ValueError("capture shorter than one block")
    fe = ShardedChannelizedFrontEnd(cfg, params, mesh)
    if state is not None:
        fe.state = place(state, STATE_AXES, mesh, fe.c_local)
    audio = torch.empty((cfg.num_channels, n_blocks * af),
                        dtype=torch.float32, device=iq.device)
    latest = torch.empty((n_blocks, 2, cfg.fft_size), dtype=torch.float32,
                         device=iq.device)
    last = mesh.local_rows[-1] * mesh.chan
    for b in range(n_blocks):
        pieces, spectra = fe._run(iq[:, b * bf:(b + 1) * bf])
        ShardedAudio(mesh, [pieces], fe._step.time_major).write_into(
            audio[:, b * af:(b + 1) * af])
        latest[b] = spectra[last][:, -1, :].to(iq.device)
    return fe.gathered_state(iq.device), audio, latest
