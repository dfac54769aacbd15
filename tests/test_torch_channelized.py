"""The port's channelized serving step against the JAX package's.

Both packages build their parameters from the same control values, and the
JAX ones are also carried over through ``webradio_tpu_torch.convert``. The
blocks come from the repo's tone source (AM and FM carriers across the
band plus noise), so the audio is far from zero; three blocks carry every
piece of state. The JAX step runs its Pallas tail in interpret mode; on the
CPU the port's step runs the plain torch tail.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from webradio_tpu.io.source import ToneSource
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu_torch import convert
from webradio_tpu_torch.ops import tail_tm
from webradio_tpu_torch.pipeline import channelized as tch

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

BLOCK, C = 51_200, 128
IFS = [int(f) for f in np.linspace(-900_000, 900_000, C)]
MODES = [("AM", "FM", "USB", "LSB")[i % 4] for i in range(C)]
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-450_000.0, "FM", 700.0), (700_000.0, "AM", 1_300.0))


def _blocks(n, seed=0):
    src = ToneSource(carriers=CARRIERS, noise=0.5, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, BLOCK, False
    for _ in range(n):
        z = src.read_block()
        yield np.stack([z.real, z.imag]).astype(np.float32)


def _configs(**kw):
    kw = {"block_frames": BLOCK, "num_channels": C, **kw}
    return jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)


def _assert_params_equal(a, b):
    for f in tch.ChannelizedParams._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("tail_kernel,fast_nco", [
    ("pallas", True), ("pallas", False), ("xla", True),
])
def test_serving_step_matches_jax(tail_kernel, fast_nco):
    cfg_j, cfg_t = _configs(tail_kernel=tail_kernel, fast_nco=fast_nco)
    pj = jch.make_channelized_params(cfg_j, IFS, 80_000, 8_000, MODES)
    pt = tch.make_channelized_params(cfg_t, IFS, 80_000, 8_000, MODES)
    # once by each package, and once carried over from the JAX params
    _assert_params_equal(pt, convert.params_from_numpy(
        jax.tree.map(np.asarray, pj)))
    sj = jch.init_channelized_state(cfg_j)
    st = convert.state_from_numpy(jax.tree.map(np.asarray, sj))
    for iq in _blocks(3):
        sj, aj, dbj = jch.channelized_step_serving(cfg_j, pj, sj,
                                                   jnp.asarray(iq))
        st, at, dbt = tch.channelized_step_serving(cfg_t, pt, st,
                                                   torch.from_numpy(iq))
        aj, dbj = np.asarray(aj), np.asarray(dbj)
        assert at.shape == aj.shape == (cfg_t.audio_frames, C)
        assert np.abs(aj).max() > 1e-2  # not zeros against zeros
        np.testing.assert_allclose(at.numpy(), aj, rtol=0, atol=1e-5)
        # bins above -100 dB and within 60 dB of the strongest: a float32
        # 512-term DFT sum is off by ~1e-7 of the strongest bin, which is
        # 1e-3 dB only that far below it
        live = (dbj > -100.0) & (dbj > dbj.max() - 60.0)
        assert live.sum() > 400
        np.testing.assert_allclose(dbt.numpy()[live], dbj[live], rtol=0,
                                   atol=1e-3)
    # the carried state agrees too: NCO phase exactly, the rest to float32
    sj = jax.tree.map(np.asarray, sj)
    np.testing.assert_array_equal(st.nco_phase.numpy(),
                                  sj.nco_phase.astype(np.int64))
    np.testing.assert_array_equal(st.pfb_hist.numpy(), sj.pfb_hist)
    for f in ("chan_hist", "demod_prev", "audio_hist"):
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(sj, f),
                                   rtol=0, atol=1e-5)


def test_channel_major_step_is_the_serving_audio_transposed():
    _, cfg = _configs(tail_kernel="pallas")
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES)
    iq = torch.from_numpy(next(_blocks(1)))
    s0 = tch.init_channelized_state(cfg)
    _, audio_cm, spectra = tch.channelized_step(cfg, p, s0, iq)
    _, audio_tm, db = tch.channelized_step_serving(cfg, p, s0, iq)
    torch.testing.assert_close(audio_cm, audio_tm.T, rtol=0, atol=0)
    assert spectra.shape == (2, BLOCK // 512, 512) and db.shape == (512,)


def test_squelch_gates_against_the_slot_power():
    # slots 0 (AM) and 2 (USB) both sit on the AM carrier at IF 0. A
    # threshold far above the slot's power (+60 dB) mutes slot 0; one far
    # below it (-200 dB) passes slot 2 unchanged.
    squelch = [None] * C
    squelch[0], squelch[2] = 60.0, -200.0
    ifs = list(IFS)
    ifs[0], ifs[2] = 0, 0
    cfg_j, cfg_t = _configs(tail_kernel="pallas")
    pj = jch.make_channelized_params(cfg_j, ifs, 80_000, 8_000, MODES,
                                     squelch_db=squelch)
    pt = tch.make_channelized_params(cfg_t, ifs, 80_000, 8_000, MODES,
                                     squelch_db=squelch)
    open_ = tch.make_channelized_params(cfg_t, ifs, 80_000, 8_000, MODES)
    sj = jch.init_channelized_state(cfg_j)
    st = so = tch.init_channelized_state(cfg_t)
    for iq in _blocks(2, seed=3):
        sj, aj, _ = jch.channelized_step_serving(cfg_j, pj, sj,
                                                 jnp.asarray(iq))
        st, at, _ = tch.channelized_step_serving(cfg_t, pt, st,
                                                 torch.from_numpy(iq))
        so, ao, _ = tch.channelized_step_serving(cfg_t, open_, so,
                                                 torch.from_numpy(iq))
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0,
                                   atol=1e-5)
        assert not at[:, 0].any() and ao[:, 0].abs().max() > 1e-2
        torch.testing.assert_close(at[:, 2], ao[:, 2], rtol=0, atol=0)
        assert ao[:, 2].abs().max() > 0


def test_process_host_double_buffer_contract():
    _, cfg = _configs(tail_kernel="pallas")
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES)
    pipe = tch.ChannelizedPipeline(cfg, p)
    ref = tch.ChannelizedPipeline(cfg, p)
    blocks = list(_blocks(3, seed=5))
    assert pipe.process_host(blocks[0]) is None  # nothing pending yet
    out = pipe.process_host(blocks[1])
    first = ref.process_host_sync(blocks[0])
    torch.testing.assert_close(out[0], first[0], rtol=0, atol=0)
    torch.testing.assert_close(out[1], first[1], rtol=0, atol=0)
    assert pipe.process_host(blocks[2]) is not None
    last = pipe.flush()  # the last block, then nothing
    assert last[0].shape == (cfg.audio_frames, C)
    assert pipe.flush() is None
    pipe.reset()
    assert pipe.process_host(blocks[0]) is None
    torch.testing.assert_close(pipe.flush()[0], first[0], rtol=0, atol=0)


@pytest.mark.parametrize("knob", [
    dict(use_pallas_tail=True), dict(tail_kernel="pallas_pfb"),
    dict(pfb_precision="u8exact"), dict(pfb_precision="bf16"),
    dict(pfb_precision="default"),
])
def test_unported_config_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tch.ChannelizedConfig(block_frames=BLOCK, num_channels=C, **knob)


def test_unported_paths_raise():
    _, cfg = _configs(tail_kernel="pallas")
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES)
    s = tch.init_channelized_state(cfg)
    iq = torch.from_numpy(next(_blocks(1)))
    # slots whose bandwidths differ need the per-channel FIR fallback
    mixed = tch.make_channelized_params(
        cfg, IFS, [80_000] * (C - 1) + [12_500], 8_000, MODES)
    assert mixed.chan_toep is None
    with pytest.raises(NotImplementedError, match="per-channel fallback"):
        tch.channelized_step_serving(cfg, mixed, s, iq)
    # an audio decimation with no audio-kernel time tile (D=25) takes the
    # JAX package's channel-rate-audio kernel, which is not ported
    _, odd = _configs(tail_kernel="pallas", block_frames=256_000,
                      audio_rate=9_600)
    assert tch._audio_time_tile(odd.chan_frames, odd.audio_decim, 128) == 0
    with pytest.raises(NotImplementedError, match="fused_tail_tm"):
        tch.channelized_step_serving(
            odd, tch.make_channelized_params(odd, IFS, 80_000, 8_000, MODES),
            tch.init_channelized_state(odd),
            torch.zeros(2, odd.block_frames))
    with pytest.raises(NotImplementedError, match="scatter"):
        tch.scatter_params_slots(p, [0], p)
    with pytest.raises(NotImplementedError, match="grow"):
        tch.grow_channelized_state(s, 2 * C)
    pipe = tch.ChannelizedPipeline(cfg, p)
    with pytest.raises(NotImplementedError, match="process_host_many"):
        pipe.process_host_many(np.zeros((2, 2, BLOCK), np.float32))
    with pytest.raises(NotImplementedError, match="scatter"):
        pipe.update_params_slots([0], p, (0,))
    with pytest.raises(NotImplementedError):
        convert.params_from_numpy(p._replace(pfb_weights_split=p.pfb_weights))


def test_auto_selects_the_kernel_where_jax_selects_pallas():
    for c, expect in ((256, False), (512, True), (1_024, True)):
        kw = dict(block_frames=BLOCK, num_channels=c)
        cfg_j = jch.ChannelizedConfig(**kw)
        cfg_t = tch.ChannelizedConfig(**kw)
        pj = jch.make_channelized_params(cfg_j, 0, 80_000, 8_000, "FM")
        pt = tch.make_channelized_params(cfg_t, 0, 80_000, 8_000, "FM")
        nd = cfg_t.chan_frames
        assert jch._use_pallas_tm(cfg_j, nd, pj) is expect
        assert tch._use_kernel_tm(cfg_t, nd, pt) is expect
    assert tch.PALLAS_TM_AUTO_THRESHOLD == jch.PALLAS_TM_AUTO_THRESHOLD
    assert tail_tm.CHAN_TILE == 128
    modes = np.array([3, 1, 1, 0], np.int32)
    assert tch.mode_set_of(torch.from_numpy(modes)) == jch.mode_set_of(modes)
