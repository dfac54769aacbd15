"""The port's direct engine (``pipeline/state.py``, ``pipeline/frontend.py``,
``ops.fir.overlap_save_decimate`` and ``scan_serving`` for a ``ChainConfig``)
against the JAX package's on the same inputs.

The blocks come from the port's tone source (AM and FM carriers plus noise,
made from a seed), so the audio is far from zero; two or three blocks carry
every piece of state. Bounds: audio 1e-5 (FM slots under the branch-cut
flip rule of PERF.md §2), spectrum 1e-3 dB on bins within 60 dB of the
block's peak, carries 1e-6, except the FM slots' raw demod tail in
``audio_hist`` (the angle is ill-conditioned where shaped samples are near
zero: whole-turn flips removed, at most 1e-4 of them above 1e-5, none above
1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webradio_tpu import ops as jops
from webradio_tpu.pipeline import frontend as jfe
from webradio_tpu.pipeline import state as jstate
from webradio_tpu.pipeline import stream as jstream
from webradio_tpu_torch import convert
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import fir as tfir
from webradio_tpu_torch.pipeline import frontend as tfe
from webradio_tpu_torch.pipeline import state as tstate
from webradio_tpu_torch.pipeline import stream as tstream

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
KW = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR, block_frames=BF,
          num_channels=4)
IFS = [0, 100_000, -150_000, 230_000]
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-150_000.0, "FM", 700.0), (230_000.0, "AM", 1_300.0))
AUDIO_BOUND, CARRY_BOUND = 1e-5, 1e-6
MAX_FLIP_FRACTION, RAW_FM_MAX = 1e-4, 1e-3


def _blocks(k, seed=0):
    src = ToneSource(carriers=CARRIERS, noise=0.3, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = FS, BF, False
    out = []
    for _ in range(k):
        z = src.read_block()
        out.append(np.stack([z.real, z.imag]).astype(np.float32))
    return np.stack(out)


def assert_audio_close(got, ref, fm, flip_step, bound=AUDIO_BOUND):
    """``got``/``ref`` ``[C, t]``: every non-FM row within ``bound``; on FM
    rows a sample may exceed it only by a branch-cut flip of the FM law
    (at most two audio taps, on at most MAX_FLIP_FRACTION of them)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert err[~fm].max(initial=0.0) <= bound
    fm_err = err[fm]
    if fm_err.size:
        assert (fm_err > bound).sum() <= max(1, MAX_FLIP_FRACTION
                                             * fm_err.size)
        assert fm_err.max() <= 2 * flip_step + bound


def assert_raw_fm_close(got, ref, fm):
    """Raw demod rows ``[C, t]``: non-FM rows within the carry bound; FM
    rows with whole-turn flips removed, at most MAX_FLIP_FRACTION above
    1e-5 and none above RAW_FM_MAX."""
    err = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    assert np.abs(err[~fm]).max(initial=0.0) <= CARRY_BOUND
    e = err[fm]
    e = np.abs(e - np.round(e))
    if e.size:
        assert (e > 1e-5).sum() <= max(1, MAX_FLIP_FRACTION * e.size)
        assert e.max() <= RAW_FM_MAX


def _assert_db_close(dbt, dbj):
    dbt, dbj = np.asarray(dbt), np.asarray(dbj)
    live = dbj > dbj.max() - 60.0  # a float32 DFT: see ROADMAP §3 (b)
    np.testing.assert_allclose(dbt[live], dbj[live], rtol=0, atol=1e-3)


def _params(cfg_j, cfg_t, ifbw, modes):
    args = (IFS, ifbw, 8_000, modes, [0, 3, -2, 6])
    return (jstate.make_receiver_params(cfg_j, *args),
            tstate.make_receiver_params(cfg_t, *args, device="cpu"))


def _assert_state_close(st, sj, fm):
    sj = jax.tree.map(np.asarray, sj).rx
    st = st.rx
    np.testing.assert_array_equal(st.nco_phase.numpy(),
                                  sj.nco_phase.astype(np.int64))
    np.testing.assert_allclose(st.chan_hist.numpy(), sj.chan_hist, rtol=0,
                               atol=CARRY_BOUND)
    np.testing.assert_allclose(st.demod_prev.numpy(), sj.demod_prev, rtol=0,
                               atol=CARRY_BOUND)
    assert_raw_fm_close(st.audio_hist.numpy(), sj.audio_hist, fm)


@pytest.mark.parametrize("fir_design,ifbw", [
    ("reference", 80_000),  # every slot shares a kernel: Toeplitz FIRs
    ("sinc", [80_000, 80_000, 40_000, 80_000]),  # per-channel FIRs
])
@pytest.mark.parametrize("use_overlap_save", [False, True])
@pytest.mark.parametrize("law", ["AM", "FM", "USB", "LSB"])
def test_frontend_step_matches_jax(law, use_overlap_save, fir_design, ifbw):
    kw = dict(KW, use_overlap_save=use_overlap_save, fir_design=fir_design)
    cfg_j, cfg_t = jstate.ChainConfig(**kw), tstate.ChainConfig(**kw)
    modes = [law] * 4
    pj, pt = _params(cfg_j, cfg_t, ifbw, modes)
    assert (pt.rx.chan_toep is None) == (not isinstance(ifbw, int))
    sj = jstate.init_state(cfg_j)
    st = convert.frontend_state_from_numpy(jax.tree.map(np.asarray, sj),
                                           device="cpu")
    fm = np.array([law == "FM"] * 4)
    flip_step = float(pt.rx.audio_coeff.abs().max())
    for iq in _blocks(2):
        sj, aj, spj = jfe.frontend_step(cfg_j, pj, sj, jnp.asarray(iq))
        st, at, spt = tfe.frontend_step(cfg_t, pt, st, torch.from_numpy(iq))
        aj = np.asarray(aj)
        assert at.shape == aj.shape == (4, cfg_t.audio_frames)
        assert np.abs(aj).max() > 1e-2  # the silent-FIR trap: not zeros
        assert_audio_close(at.numpy(), aj, fm, flip_step)
        assert spt.shape == spj.shape
        _assert_db_close(jops.spectrum_db(spj[:, -1, :]),
                         tfe.spectrum_db(spt[:, -1, :]))
        _assert_state_close(st, sj, fm)


def test_frontend_step_serving_is_the_step_with_its_latest_db_row():
    cfg = tstate.ChainConfig(**KW)
    _, pt = _params(jstate.ChainConfig(**KW), cfg, 80_000,
                    ["AM", "FM", "USB", "LSB"])
    iq = torch.from_numpy(_blocks(1)[0])
    s0 = tstate.init_state(cfg, "cpu")
    s1, a1, spectra = tfe.frontend_step(cfg, pt, s0, iq)
    s2, a2, db = tfe.frontend_step_serving(cfg, pt, s0, iq)
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    torch.testing.assert_close(db, tfe.spectrum_db(spectra[:, -1, :]),
                               rtol=0, atol=0)
    assert db.shape == (cfg.fft_size,)


@pytest.mark.parametrize("fir_design", ["reference", "sinc"])
@pytest.mark.parametrize("ifbw,afbw", [
    (80_000, 8_000),
    ([80_000, 12_500, 80_000, 40_000], 8_000),
    (80_000, [8_000, 4_000, 8_000, 8_000]),
])
def test_make_receiver_params_matches_jax(fir_design, ifbw, afbw):
    kw = dict(KW, fir_design=fir_design)
    cfg_j, cfg_t = jstate.ChainConfig(**kw), tstate.ChainConfig(**kw)
    args = (IFS, ifbw, afbw, ["AM", "FM", "USB", "LSB"], [0, 6, -3, 1],
            [None, -30.0, 0.0, 5.0])
    pj = jax.tree.map(np.asarray, jstate.make_receiver_params(
        cfg_j, *args, actual_sample_rate=FS + 7))
    pt = tstate.make_receiver_params(cfg_t, *args, actual_sample_rate=FS + 7,
                                     device="cpu")
    carried = convert.frontend_params_from_numpy(pj, device="cpu")
    for name in tstate.ReceiverParams._fields:
        a, b, c = getattr(pj.rx, name), getattr(pt.rx, name), getattr(
            carried.rx, name)
        assert (a is None) == (b is None) == (c is None), name
        if a is None:
            continue
        want = a.astype(np.int64) if name == "phase_step" else a
        np.testing.assert_array_equal(b.numpy(), want)
        torch.testing.assert_close(b, c, rtol=0, atol=0, equal_nan=True)
    shared = isinstance(ifbw, int) and isinstance(afbw, int)
    assert (pt.rx.chan_toep is not None) == isinstance(ifbw, int)
    assert (pt.rx.audio_toep is not None) == isinstance(afbw, int)
    assert shared or pt.rx.chan_toep is None or pt.rx.audio_toep is None


def test_make_receiver_params_rejects_mismatched_lists():
    cfg = tstate.ChainConfig(**KW)
    with pytest.raises(ValueError, match="num_channels"):
        tstate.make_receiver_params(cfg, [0, 1], 80_000, 8_000, "AM",
                                    device="cpu")


def test_chain_config_validates_like_jax():
    for bad in (dict(sample_rate=1_000_000, channel_rate=300_000),
                dict(block_frames=1000), dict(fir_design="kaiser")):
        with pytest.raises(ValueError):
            jstate.ChainConfig(**bad)
        with pytest.raises(ValueError):
            tstate.ChainConfig(**bad)
    cfg = tstate.ChainConfig(**KW)
    assert (cfg.chan_decim, cfg.audio_decim, cfg.chan_frames,
            cfg.audio_frames) == (8, 4, 2_048, 512)


def test_grow_state_matches_jax():
    cfg_j, cfg_t = jstate.ChainConfig(**KW), tstate.ChainConfig(**KW)
    pj, pt = _params(cfg_j, cfg_t, 80_000, ["AM", "FM", "USB", "LSB"])
    iq = _blocks(1)[0]
    sj, _, _ = jfe.frontend_step(cfg_j, pj, jstate.init_state(cfg_j),
                                 jnp.asarray(iq))
    sj = jax.tree.map(np.asarray, sj)
    st = convert.frontend_state_from_numpy(sj, device="cpu")
    gj = jax.tree.map(np.asarray, jstate.grow_state(sj, 8))
    gt = tstate.grow_state(st, 8)
    for name in tstate.ReceiverState._fields:
        want = getattr(gj.rx, name)
        np.testing.assert_array_equal(getattr(gt.rx, name).numpy(),
                                      want.astype(getattr(gt.rx, name)
                                                  .numpy().dtype))
    assert gt.rx.chan_hist.shape == (2, 8, 63)
    assert float(gt.rx.chan_hist[:, 4:].abs().max()) == 0.0
    assert tstate.grow_state(st, 4) is st
    with pytest.raises(ValueError, match="only grow"):
        tstate.grow_state(st, 2)


def test_scan_serving_matches_jax_and_k_steps():
    cfg_j, cfg_t = jstate.ChainConfig(**KW), tstate.ChainConfig(**KW)
    modes = ["FM", "AM", "USB", "LSB"]
    pj, pt = _params(cfg_j, cfg_t, 80_000, modes)
    blocks = _blocks(3, seed=4)
    sj, aj, dbj = jstream.scan_serving(cfg_j, pj, jstate.init_state(cfg_j),
                                       jnp.asarray(blocks))
    st, at, dbt = tstream.scan_serving(cfg_t, pt,
                                       tstate.init_state(cfg_t, "cpu"),
                                       torch.from_numpy(blocks))
    aj = np.asarray(aj)
    assert at.shape == aj.shape == (3, 4, cfg_t.audio_frames)
    assert np.abs(aj).max() > 1e-2
    fm = np.array([m == "FM" for m in modes])
    flip_step = float(pt.rx.audio_coeff.abs().max())
    for k in range(3):
        assert_audio_close(at[k].numpy(), aj[k], fm, flip_step)
    _assert_db_close(dbt, dbj)
    _assert_state_close(st, sj, fm)
    # the same as k sequential steps, exactly
    s1 = tstate.init_state(cfg_t, "cpu")
    for k, iq in enumerate(blocks):
        s1, a1, _ = tfe.frontend_step(cfg_t, pt, s1, torch.from_numpy(iq))
        torch.testing.assert_close(a1, at[k], rtol=0, atol=0)
    for name in tstate.ReceiverState._fields:
        torch.testing.assert_close(getattr(s1.rx, name),
                                   getattr(st.rx, name), rtol=0, atol=0)


def test_frontend_pipeline_host_contract():
    cfg = tstate.ChainConfig(**KW)
    _, pt = _params(jstate.ChainConfig(**KW), cfg, 80_000,
                    ["AM", "FM", "USB", "LSB"])
    blocks = _blocks(3)
    pipe = tfe.FrontEndPipeline(cfg, pt)
    assert not pipe.time_major and pipe.device.type == "cpu"
    assert pipe.process_host(blocks[0]) is None
    first = pipe.process_host_many(blocks[1:])
    last = pipe.flush()
    assert pipe.flush() is None
    s = tstate.init_state(cfg, "cpu")
    s, a0, db0 = tfe.frontend_step_serving(cfg, pt, s,
                                           torch.from_numpy(blocks[0]))
    torch.testing.assert_close(first[0], a0, rtol=0, atol=0)
    torch.testing.assert_close(first[1], db0, rtol=0, atol=0)
    _, audio, db = tstream.scan_serving(cfg, pt, s,
                                        torch.from_numpy(blocks[1:]))
    torch.testing.assert_close(last[0], audio, rtol=0, atol=0)
    assert last[0].shape == (2, 4, cfg.audio_frames)
    pipe.reset()
    out = pipe.process_host_sync(blocks[0])
    torch.testing.assert_close(out[0], a0, rtol=0, atol=0)


@pytest.mark.parametrize("decimation,shape,per_channel", [
    (8, (2, 4, BF), True),
    (4, (4, BF // 8), True),
    (1, (3, 4_096), False),
])
def test_overlap_save_matches_jax_and_direct_form(decimation, shape,
                                                  per_channel):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    hist = rng.standard_normal(shape[:-1] + (63,)).astype(np.float32)
    rows = shape[-2] if per_channel else 1
    coeff = rng.standard_normal((rows, 64)).astype(np.float32) / 8
    if not per_channel:
        coeff = coeff[0]
    yj, hj = jops.overlap_save_decimate(jnp.asarray(x), jnp.asarray(coeff),
                                        decimation, jnp.asarray(hist))
    yt, ht = tfir.overlap_save_decimate(torch.from_numpy(x),
                                        torch.from_numpy(coeff), decimation,
                                        torch.from_numpy(hist))
    assert yt.shape == tuple(np.asarray(yj).shape)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    yd, _ = tfir.fir_decimate(torch.from_numpy(x), torch.from_numpy(coeff),
                              decimation, torch.from_numpy(hist))
    np.testing.assert_allclose(yt.numpy(), yd.numpy(), rtol=0, atol=1e-5)


def test_convert_round_trips_the_direct_engine():
    cfg_j = jstate.ChainConfig(**KW)
    pj, _ = _params(cfg_j, tstate.ChainConfig(**KW), 80_000,
                    ["AM", "FM", "USB", "LSB"])
    sj, _, _ = jfe.frontend_step(cfg_j, pj, jstate.init_state(cfg_j),
                                 jnp.asarray(_blocks(1)[0]))
    for nt, fn in ((pj, convert.frontend_params_from_numpy),
                   (sj, convert.frontend_state_from_numpy)):
        host = jax.tree.map(np.asarray, nt)
        got = fn(host, device="cpu")
        back = type(got.rx)(*(None if t is None else t.numpy()
                              for t in got.rx))
        for name in got.rx._fields:
            a, b = getattr(host.rx, name), getattr(back, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(b, a.astype(b.dtype))
                assert b.dtype in (np.int64, np.int32, np.float32)
    with pytest.raises(TypeError, match="float32"):
        bad = jax.tree.map(np.asarray, sj)
        bad = bad._replace(rx=bad.rx._replace(
            chan_hist=bad.rx.chan_hist.astype(np.float64)))
        convert.frontend_state_from_numpy(bad, device="cpu")
