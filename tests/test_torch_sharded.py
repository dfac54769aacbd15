"""The port's sharded engines (``webradio_tpu_torch.parallel``) against the
JAX package's, case for case with ``tests/test_sharded.py``.

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``); the
port's meshes repeat the CPU device (``["cpu"] * n``). Blocks come from the
port's tone source (AM and FM carriers plus noise, made from a seed), so
every law's audio is far from zero (a non-trivial peak is asserted: the
silent-FIR trap of ROADMAP.md). Bounds: sharded against single-device
audio 3e-6 (``tests/test_sharded.py:69``) with the FM flip rule of PERF.md
§2, carries 1e-6 (the raw FM demod tail under its rule); the port against
the JAX package 1e-5 as in ``tests/test_torch_direct.py``; where the JAX
test states its own bound the port keeps it (time-major body against the
stage body 3e-4, the kernel tail against the plain one 1e-5, spectra
2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_direct import (
    _assert_state_close,
    assert_audio_close,
    assert_raw_fm_close,
)
from tests.test_torch_radio import capture, registries  # noqa: F401
from webradio_tpu import parallel as jpar
from webradio_tpu.parallel import multihost as jmh
from webradio_tpu.parallel import sharded_channelized as jsc
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu.pipeline import state as jstate
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops.tail_tm import CHAN_TILE
from webradio_tpu_torch.parallel import mesh as tmesh
from webradio_tpu_torch.parallel import multihost as tmh
from webradio_tpu_torch.parallel import sharded as tsh
from webradio_tpu_torch.parallel import sharded_channelized as tsc
from webradio_tpu_torch.pipeline import channelized as tch
from webradio_tpu_torch.pipeline import frontend as tfe
from webradio_tpu_torch.pipeline import state as tstate

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
RATES = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR)
SHARDED_BOUND = 3e-6
IFS = [100_000, 0, -150_000, 25_000]
MODES = ["FM", "AM", "USB", "LSB"]
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-150_000.0, "FM", 700.0), (230_000.0, "AM", 1_300.0))


def _blocks(k, seed=0, block=BF, noise=0.3):
    src = ToneSource(carriers=CARRIERS, noise=noise, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = FS, block, False
    out = []
    for _ in range(k):
        z = src.read_block()
        out.append(np.stack([z.real, z.imag]).astype(np.float32))
    return out


def _cpu_mesh(t, c):
    return tmesh.make_mesh(t, c, devices=["cpu"] * (t * c))


def _fm(params_mode):
    return np.asarray(params_mode) == 1


# ---- the direct engine ----------------------------------------------------
DIRECT = dict(RATES, block_frames=BF, num_channels=4)


def _direct_params(cfg, squelch_db=None, ifbw=(80_000, 80_000, 40_000,
                                               80_000)):
    return (jstate.make_receiver_params(
                jstate.ChainConfig(**DIRECT), IFS, list(ifbw), 8_000, MODES,
                squelch_db=squelch_db),
            tstate.make_receiver_params(
                cfg, IFS, list(ifbw), 8_000, MODES, squelch_db=squelch_db,
                device="cpu"))


@pytest.mark.parametrize("tshape", [(1, 4), (2, 2), (4, 2), (2, 4), (8, 1)])
def test_sharded_matches_single_device(tshape):
    t, c = tshape
    cfg = tstate.ChainConfig(**DIRECT)
    pj, pt = _direct_params(cfg)
    flip = float(pt.rx.audio_coeff.abs().max())
    fm = _fm(pt.rx.mode)
    jfe = jpar.ShardedFrontEnd(jstate.ChainConfig(**DIRECT), pj,
                               jpar.make_mesh(t, c))
    fe = tsh.ShardedFrontEnd(cfg, pt, _cpu_mesh(t, c))
    state = tstate.init_state(cfg, "cpu")
    for iq in _blocks(2):
        audio, spectra = fe.process(iq)
        got = audio.full().numpy()
        state, ref, ref_spec = tfe.frontend_step(cfg, pt, state,
                                                 torch.from_numpy(iq))
        assert got.shape == (4, cfg.audio_frames)
        assert np.abs(got).max() > 1e-2  # not zeros against zeros
        assert_audio_close(got, ref.numpy(), fm, flip, SHARDED_BOUND)
        np.testing.assert_allclose(spectra.numpy(), ref_spec.numpy(),
                                   rtol=0, atol=2e-3)
        ja, _ = jfe.process(jnp.asarray(iq))
        assert_audio_close(got, np.asarray(ja), fm, flip)
    carried = fe.gathered_state()
    np.testing.assert_array_equal(carried.rx.nco_phase.numpy(),
                                  state.rx.nco_phase.numpy())
    np.testing.assert_allclose(carried.rx.chan_hist.numpy(),
                               state.rx.chan_hist.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(carried.rx.demod_prev.numpy(),
                               state.rx.demod_prev.numpy(), rtol=0,
                               atol=1e-6)
    assert_raw_fm_close(carried.rx.audio_hist.numpy(),
                        state.rx.audio_hist.numpy(), fm)
    _assert_state_close(carried, jfe.state, fm)


@pytest.mark.parametrize("squelch_db", [-10, -3])
def test_sharded_squelch_whole_block_power(squelch_db):
    """The gate reads the WHOLE block's power: a burst confined to the
    first of four time shards opens (or mutes) every shard as the
    single-card step does."""
    cfg = tstate.ChainConfig(**DIRECT)
    pj, pt = _direct_params(cfg, squelch_db=squelch_db, ifbw=[80_000] * 4)
    iq = _blocks(1, noise=0.05)[0]
    iq[:, BF // 4:] = 0.0  # the burst lives only in shard 0 of 4
    _, ref, _ = tfe.frontend_step(cfg, pt, tstate.init_state(cfg, "cpu"),
                                  torch.from_numpy(iq))
    audio, _ = tsh.ShardedFrontEnd(cfg, pt, _cpu_mesh(4, 1)).process(iq)
    fm = _fm(pt.rx.mode)
    flip = float(pt.rx.audio_coeff.abs().max())
    assert_audio_close(audio.full().numpy(), ref.numpy(), fm, flip,
                       SHARDED_BOUND)
    ja, _ = jpar.ShardedFrontEnd(jstate.ChainConfig(**DIRECT), pj,
                                 jpar.make_mesh(4, 1)).process(
                                     jnp.asarray(iq))
    assert_audio_close(audio.full().numpy(), np.asarray(ja), fm, flip)
    # the gate decided the same way for every slot: open or shut
    open_j = np.abs(np.asarray(ja)).max(axis=1) > 0
    np.testing.assert_array_equal(
        np.abs(audio.full().numpy()).max(axis=1) > 0, open_j)


def test_mesh_shape_heuristic():
    assert tmesh.mesh_shape_for(8, 8, 102_400) == (1, 8)
    t, c = tmesh.mesh_shape_for(8, 4, 102_400)
    assert t * c == 8 and c <= 4
    assert tmesh.mesh_shape_for(4, 1, 102_400) == (4, 1)
    # the JAX package's factorization on a grid of shapes
    for n in (1, 2, 3, 4, 6, 8, 16):
        for ch in (1, 2, 4, 16, 2_048, 16_384):
            for frames in (10_240, 16_384, 102_400, 256_000):
                try:
                    want = jpar.mesh_shape_for(n, ch, frames)
                except ValueError:
                    with pytest.raises(ValueError):
                        tmesh.mesh_shape_for(n, ch, frames)
                    continue
                assert tmesh.mesh_shape_for(n, ch, frames) == want


class TestMultihost:
    """The multi-process helpers in one process (no process group)."""

    def test_init_noop_without_coordinator(self, monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        assert tmh.init_distributed() is False
        assert jmh.init_distributed() is False
        assert tmesh.world() == (0, 1)

    def test_host_slice_and_global_block(self):
        mesh = _cpu_mesh(4, 2)
        n = 4096
        lo, hi = tmh.host_time_slice(n, mesh)
        assert (lo, hi) == (0, n) == jmh.host_time_slice(
            n, jpar.make_mesh(4, 2))
        local = np.random.default_rng(0).standard_normal(
            (2, hi - lo)).astype(np.float32)
        g = tmh.make_global_block(local, n, mesh)
        assert sorted(g) == list(range(8))
        for p, piece in g.items():
            t = p // 2
            np.testing.assert_array_equal(
                piece.numpy(), local[:, t * 1024:(t + 1) * 1024])
        np.testing.assert_array_equal(
            np.asarray(jmh.make_global_block(local, n,
                                             jpar.make_mesh(4, 2))),
            np.concatenate([g[2 * t].numpy() for t in range(4)], axis=1))
        # the degenerate collectives are the identity
        assert tmh.broadcast_blob(b"abc") == b"abc"
        np.testing.assert_array_equal(tmh.gather_to_host(local), local)

    def test_sharded_step_consumes_global_block(self):
        kw = dict(RATES, block_frames=BF, num_channels=4)
        ifs = [0, 10_000, -10_000, 128_000]
        cfg = tch.ChannelizedConfig(**kw)
        params = tch.make_channelized_params(cfg, ifs, 80_000, 8_000, "FM",
                                             device="cpu")
        mesh = _cpu_mesh(2, 4)
        fe = tsc.ShardedChannelizedFrontEnd(cfg, params, mesh)
        local = _blocks(1)[0]
        audio, spectra = fe.process(tmh.make_global_block(
            local, cfg.block_frames, mesh))
        assert (audio.channels, audio.full().shape[1]) == (
            4, cfg.audio_frames)
        jfe = jsc.ShardedChannelizedFrontEnd(
            jch.ChannelizedConfig(**kw),
            jch.make_channelized_params(jch.ChannelizedConfig(**kw), ifs,
                                        80_000, 8_000, "FM"),
            jpar.make_mesh(2, 4))
        ja, _ = jfe.process(jmh.make_global_block(local, cfg.block_frames,
                                                  jpar.make_mesh(2, 4)))
        assert np.abs(np.asarray(ja)).max() > 1e-2
        assert_audio_close(audio.full().numpy(), np.asarray(ja),
                           np.ones(4, bool),
                           float(params.audio_coeff.abs().max()))


# ---- the channelized engine ---------------------------------------------
def _channelized(c, **kw):
    kw = dict(RATES, block_frames=BF, num_channels=c, **kw)
    ifs = [i * 11_000 - 40_000 for i in range(c)]
    modes = ["FM", "AM", "USB", "LSB"] * (c // 4)
    args = (ifs, 80_000, 8_000, modes)
    ckw = dict(squelch_db=[None, -200.0, 1000.0, -15.0] * (c // 4))
    cfg_j, cfg_t = jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)
    return (cfg_j, cfg_t, jch.make_channelized_params(cfg_j, *args, **ckw),
            tch.make_channelized_params(cfg_t, *args, **ckw, device="cpu"))


def test_tm_shard_body_matches_stage_body(monkeypatch):
    """The time-major body (recomputed halos, the fused tail's plain
    version) against the stage body on the same parameters and state over
    carried blocks; each against the JAX package's same body."""
    cfg_j, cfg, pj, pt = _channelized(8)
    assert tsc._tm_body_eligible(cfg, 2, pt)
    blocks = _blocks(2)
    fm = _fm(pt.mode)
    flip = float(pt.audio_coeff.abs().max())

    def run(mod, fe):
        return [fe.process(b if mod is tsc else jnp.asarray(b))
                for b in blocks]

    fe_tm = tsc.ShardedChannelizedFrontEnd(cfg, pt, _cpu_mesh(2, 4))
    out_tm = run(tsc, fe_tm)
    jtm = jsc.ShardedChannelizedFrontEnd(cfg_j, pj, jpar.make_mesh(2, 4))
    jout_tm = run(jsc, jtm)
    monkeypatch.setattr(tsc, "_tm_body_eligible", lambda *a: False)
    monkeypatch.setattr(jsc, "_tm_body_eligible", lambda *a: False)
    fe_st = tsc.ShardedChannelizedFrontEnd(cfg, pt, _cpu_mesh(2, 4))
    out_st = run(tsc, fe_st)
    jst = jsc.ShardedChannelizedFrontEnd(cfg_j, pj, jpar.make_mesh(2, 4))
    jout_st = run(jsc, jst)

    for (a_tm, s_tm), (a_st, s_st), (j_tm, _), (j_st, _) in zip(
            out_tm, out_st, jout_tm, jout_st):
        got_tm, got_st = a_tm.full().numpy(), a_st.full().numpy()
        assert np.abs(got_tm).max() > 1e-2
        np.testing.assert_allclose(got_tm, got_st, rtol=0, atol=3e-4)
        np.testing.assert_allclose(s_tm.numpy(), s_st.numpy(), rtol=0,
                                   atol=1e-3)
        assert_audio_close(got_tm, np.asarray(j_tm), fm, flip)
        assert_audio_close(got_st, np.asarray(j_st), fm, flip)
    st_tm, st_st = fe_tm.gathered_state(), fe_st.gathered_state()
    for name in tch.ChannelizedState._fields:
        np.testing.assert_allclose(
            getattr(st_tm, name).double().numpy(),
            getattr(st_st, name).double().numpy(), rtol=0, atol=2e-4,
            err_msg=name)


def _carrier_blocks(c_ifs, n_blocks, block, seed=5):
    """Noise plus a strong carrier at every FM channel's IF (the FM
    discriminator far from its branch cuts, as in the JAX test)."""
    rng = np.random.default_rng(seed)
    n = n_blocks * block
    t = np.arange(n, dtype=np.float64) / FS
    sig = 0.1 * (rng.standard_normal((2, n)) +
                 0.3 * rng.standard_normal((2, n)))
    for f in c_ifs[::4]:
        ph = 2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)
        sig[0] += np.cos(ph)
        sig[1] += np.sin(ph)
    sig = sig.astype(np.float32)
    return [sig[:, i * block:(i + 1) * block] for i in range(n_blocks)]


def test_sharded_kernel_tail_matches_plain_body():
    """The kernel-routed shard body (``tail_kernel="pallas"`` with c_local
    = CHAN_TILE and nd_local = 1,024 on a (2, 2) mesh: kernel #1 per shard
    on the card, its plain version here) against the plain-tail body over
    three carried blocks (the plain body is held to the JAX package's in
    ``test_tm_shard_body_matches_stage_body``). Carries come from the same
    recompute in both bodies, so they are equal bit for bit."""
    t_shards, c_shards = 2, 2
    c = c_shards * CHAN_TILE
    block = t_shards * (FS // CR) * 1_024
    ifs = [(i * 7_001 - 400_000) % 512_000 - 256_000 for i in range(c)]
    modes = ["FM", "AM", "USB", "LSB"] * (c // 4)
    sq = [None, -200.0, 1000.0, -15.0] * (c // 4)

    def make(tail):
        kw = dict(RATES, block_frames=block, num_channels=c, fast_nco=False,
                  tail_kernel=tail)
        cfg = tch.ChannelizedConfig(**kw)
        return cfg, tch.make_channelized_params(
            cfg, ifs, 80_000, 8_000, modes, squelch_db=sq, device="cpu")

    cfg_k, params_k = make("pallas")
    cfg_x, params_x = make("xla")
    nd_local = block // t_shards // (FS // CR)
    assert tsc._tm_body_eligible(cfg_k, t_shards, params_k)
    assert tsc._tm_uses_kernel(cfg_k, nd_local, c // c_shards, params_k)
    assert not tsc._tm_uses_kernel(cfg_x, nd_local, c // c_shards, params_x)
    blocks = _carrier_blocks(ifs, 3, block)
    fe_k = tsc.ShardedChannelizedFrontEnd(cfg_k, params_k,
                                          _cpu_mesh(t_shards, c_shards))
    fe_x = tsc.ShardedChannelizedFrontEnd(cfg_x, params_x,
                                          _cpu_mesh(t_shards, c_shards))
    for i, b in enumerate(blocks):
        (a_k, s_k), (a_x, s_x) = fe_k.process(b), fe_x.process(b)
        got_k, got_x = a_k.full().numpy(), a_x.full().numpy()
        assert np.abs(got_k).max() > 1e-2
        np.testing.assert_allclose(got_k, got_x, rtol=0, atol=1e-5,
                                   err_msg=f"block {i}")
        np.testing.assert_allclose(s_k.numpy(), s_x.numpy(), rtol=0,
                                   atol=1e-3)
    for f_k, f_x in zip(fe_k.gathered_state(), fe_x.gathered_state()):
        torch.testing.assert_close(f_k, f_x, rtol=0, atol=0)


def _u8_block(rng, block=BF):
    raw = rng.integers(0, 256, (2, block)).astype(np.float32)
    return (raw - 128.0) / 128.0


def test_sharded_u8exact_params_route():
    """pfb_precision="u8exact": the split weights are cut by channel shard
    and the sharded audio equals the single-device step's."""
    kw = dict(RATES, block_frames=BF, num_channels=8,
              pfb_precision="u8exact")
    cfg = tch.ChannelizedConfig(**kw)
    ifs = [((i % 8) - 4) * 100_000 for i in range(8)]
    params = tch.make_channelized_params(cfg, ifs, 80_000, 8_000, "FM",
                                         device="cpu")
    assert params.pfb_weights_split is not None
    iq = _u8_block(np.random.default_rng(1))
    audio, _ = tsc.ShardedChannelizedFrontEnd(
        cfg, params, _cpu_mesh(2, 4)).process(iq)
    _, ref, _ = tch.channelized_step(cfg, params,
                                     tch.init_channelized_state(cfg, "cpu"),
                                     torch.from_numpy(iq))
    assert np.abs(ref.numpy()).max() > 1e-2
    assert_audio_close(audio.full().numpy(), ref.numpy(), np.ones(8, bool),
                       float(params.audio_coeff.abs().max()), SHARDED_BOUND)


@pytest.mark.parametrize("tier", ["u8exact", "default", "high", "bf16"])
def test_every_lossy_tier_reads_its_own_split_weights_by_shard(tier):
    """Every lossy tier carries ``pfb_weights_split`` ``[2, 2K_p, 2, C]``
    in the port; each channel shard reads its own columns, and the sharded
    step at the tier equals the single-device step at the tier."""
    cfg_j, cfg, pj, pt = _channelized(8, pfb_precision=tier)
    mesh = _cpu_mesh(2, 4)
    fe = tsc.ShardedChannelizedFrontEnd(cfg, pt, mesh)
    for p in mesh.local_positions:
        c0 = (p % 4) * 2
        torch.testing.assert_close(fe._placed[p].pfb_weights_split,
                                   pt.pfb_weights_split[..., c0:c0 + 2],
                                   rtol=0, atol=0)
        torch.testing.assert_close(fe._placed[p].pfb_weights,
                                   pt.pfb_weights[..., c0:c0 + 2],
                                   rtol=0, atol=0)
    rng = np.random.default_rng(2)
    state = tch.init_channelized_state(cfg, "cpu")
    fm = _fm(pt.mode)
    flip = float(pt.audio_coeff.abs().max())
    for _ in range(2):
        iq = _u8_block(rng)
        audio, _ = fe.process(iq)
        state, ref, _ = tch.channelized_step(cfg, pt, state,
                                             torch.from_numpy(iq))
        assert np.abs(ref.numpy()).max() > 1e-2
        assert_audio_close(audio.full().numpy(), ref.numpy(), fm, flip,
                           SHARDED_BOUND)


def test_a_law_change_applies_at_the_next_block_without_a_rebuild():
    """A new demod law (and a retune) takes effect at the next block, on
    the same placed tensors and so the same graphs (the JAX front end
    rebuilds its step on a new law set), exactly as on the single-device
    pipeline; so does a slot scatter."""
    _, cfg, _, pt = _channelized(8)
    fe = tsc.ShardedChannelizedFrontEnd(cfg, pt, _cpu_mesh(2, 4))
    one = tch.ChannelizedPipeline(cfg, pt)
    key = fe.graph_key()
    blocks = _blocks(3)
    flip = float(pt.audio_coeff.abs().max())

    def both(b):
        a, _ = fe.process_host_sync(b)
        r, _ = one.process_host_sync(b)
        return a.full().numpy(), r.numpy().T

    both(blocks[0])
    ifs = [i * 11_000 - 40_000 for i in range(8)]
    new = tch.make_channelized_params(cfg, ifs, 80_000, 8_000, ["USB"] * 8,
                                      device="cpu")
    fe.update_params(new)
    one.update_params(new)
    got, ref = both(blocks[1])
    assert fe.graph_key() == key
    assert np.abs(ref).max() > 1e-2
    assert_audio_close(got, ref, np.zeros(8, bool), flip, SHARDED_BOUND)
    # a slot write: slots 2 and 5 (two shards) to FM at other IFs
    sub_cfg = tch.ChannelizedConfig(**{**cfg.__dict__, "num_channels": 2})
    sub = tch.make_channelized_params(sub_cfg, [100_000, -150_000], 80_000,
                                      8_000, "FM", device="cpu")
    fe.update_params_slots([2, 5], sub)
    one.update_params_slots([2, 5], sub)
    got, ref = both(blocks[2])
    assert_audio_close(got, ref, _fm(one.params.mode), flip, SHARDED_BOUND)
    for p in fe.mesh.local_positions:
        c0 = (p % 4) * 2
        torch.testing.assert_close(fe._placed[p].residual_step,
                                   one.params.residual_step[c0:c0 + 2])


# ---- the sharded engine in the server's pump ------------------------------
def test_sharded_engine_serves_like_jax(capture, registries, monkeypatch):
    """``engine="sharded"`` through ``FrontEnd.run_once`` block by block
    (no pump thread, no deadline): the port's front end over a (time=2,
    chan=4) mesh of the CPU against the JAX package's over its 8 virtual
    devices, the rows each hands its receivers' sinks compared, a PUT
    between blocks (a slot scatter in the port, applied on the next
    block), and the AM receiver's 1 kHz heard. The port's counterpart of
    ``test_app_topologies.py::test_sharded_engine_live``."""
    from tests import test_torch_radio as tr
    from webradio_tpu import radio as jradio
    from webradio_tpu.io import tuner as jtuner
    from webradio_tpu_torch import radio as tradio
    from webradio_tpu_torch.io import tuner as ttuner

    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 8)
    fj, sinks_j = tr._front_end(jradio, jtuner, capture, 4, engine="sharded")
    ft, sinks_t = tr._front_end(tradio, ttuner, capture, 4, engine="sharded",
                                device="cpu")
    assert isinstance(ft.pipeline, tsc.ShardedChannelizedFrontEnd)
    assert ft.pipeline.mesh.shape == dict(fj.pipeline.mesh.shape) == {
        "time": 2, "chan": 4}
    rx_j = list(fj.receivers.values())
    rx_t = list(ft.receivers.values())
    for k in range(7):
        if k == 3:
            for rxs in (rx_j, rx_t):
                assert rxs[2].update(if_frequency=-100_000,
                                     demodulator="LSB")
        block = fj.tuner.read_block()
        np.testing.assert_array_equal(block, ft.tuner.read_block())
        dbj = tr._pump(jradio, fj, block)
        dbt = tr._pump(tradio, ft, block)
        tr._assert_db_close(dbt, dbj)
    flip = float(ft.pipeline.params.audio_coeff.abs().max())
    for i, (sj, st) in enumerate(zip(sinks_j, sinks_t)):
        assert len(sj.rows) == len(st.rows) == 6  # double-buffered: 7 - 1
        got, ref = np.stack(st.rows), np.stack(sj.rows)
        assert np.abs(ref).max() > 1e-2, i
        fm = np.full(got.shape[0], tr.RECEIVERS[i]["demodulator"] == "FM")
        assert_audio_close(got, ref, fm, flip)
    am = np.concatenate(sinks_t[0].rows[1:])  # past the first fill
    spec = np.abs(np.fft.rfft((am - am.mean()) * np.hanning(am.size)))
    assert abs(np.argmax(spec) * AR / am.size - 1_000) < 30
