"""The port's channelized serving step against the JAX package's.

Both packages build their parameters from the same control values, and the
JAX ones are also carried over through ``webradio_tpu_torch.convert``. The
blocks come from the port's tone source (AM and FM carriers across the
band plus noise), so the audio is far from zero; two or three blocks carry
every piece of state. The JAX step runs its Pallas tails in interpret mode;
on the CPU the port's step runs the plain torch tails. Every branch of the
step is covered: the packed kernel path, the plain time-major chain, the
fused-filterbank path, the channel-rate-audio path (9.6 kHz audio) and the
per-channel fallback with and without its kernel; then the control plane
(slot scatter, capacity growth, catch-up scan) against the JAX functions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from webradio_tpu.pipeline import channelized as jch
from webradio_tpu.pipeline import stream as jstream
from webradio_tpu_torch import convert
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import tail, tail_tm
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


def _blocks(n, seed=0, block=BLOCK):
    src = ToneSource(carriers=CARRIERS, noise=0.5, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, block, False
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
    pt = tch.make_channelized_params(cfg_t, IFS, 80_000, 8_000, MODES,
                                     device="cpu")
    # once by each package, and once carried over from the JAX params
    _assert_params_equal(pt, convert.params_from_numpy(
        jax.tree.map(np.asarray, pj), device="cpu"))
    sj = jch.init_channelized_state(cfg_j)
    st = convert.state_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")
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
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES,
                                    device="cpu")
    iq = torch.from_numpy(next(_blocks(1)))
    s0 = tch.init_channelized_state(cfg, "cpu")
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
                                     squelch_db=squelch, device="cpu")
    open_ = tch.make_channelized_params(cfg_t, ifs, 80_000, 8_000, MODES,
                                        device="cpu")
    sj = jch.init_channelized_state(cfg_j)
    st = so = tch.init_channelized_state(cfg_t, "cpu")
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
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES,
                                    device="cpu")
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
    dict(pfb_precision="u8exact"), dict(pfb_precision="bf16"),
    dict(pfb_precision="default"), dict(pfb_precision="high"),
])
def test_unported_config_knobs_raise(knob):
    # the pfb tiers are ported: each builds, with the bfloat16 split
    # weights in its parameters; the fused filterbank still refuses the two
    # tiers that need the packed product, as the JAX configuration does
    _, cfg = _configs(**knob)
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES,
                                    device="cpu")
    assert p.pfb_weights_split.dtype == torch.bfloat16
    assert p.pfb_weights_split.shape == (2, 2 * cfg.proto_taps, 2, C)
    kw = dict(block_frames=BLOCK, num_channels=C, tail_kernel="pallas_pfb",
              **knob)
    if knob["pfb_precision"] in ("u8exact", "bf16"):
        with pytest.raises(ValueError, match="pallas_pfb"):
            jch.ChannelizedConfig(**kw)
        with pytest.raises(ValueError, match="pallas_pfb"):
            tch.ChannelizedConfig(**kw)
    else:
        assert tch.ChannelizedConfig(**kw).pfb_precision == knob[
            "pfb_precision"]


def test_unported_paths_raise():
    # nothing of the step is left unported: a lossy tier whose parameters
    # lack the split weights (a JAX "high" parameter set carries none)
    # raises and names them, and convert carries a split as bfloat16
    _, cfg = _configs(tail_kernel="pallas", pfb_precision="high")
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES,
                                    device="cpu")
    carried = convert.params_from_numpy(p, device="cpu")
    assert torch.equal(carried.pfb_weights_split, p.pfb_weights_split)
    with pytest.raises(ValueError, match="pfb_weights_split"):
        tch.channelized_step_serving(
            cfg, p._replace(pfb_weights_split=None),
            tch.init_channelized_state(cfg, "cpu"), torch.zeros(2, BLOCK))
    with pytest.raises(ValueError, match="pallas_pfb"):
        jch.ChannelizedConfig(block_frames=BLOCK, num_channels=C,
                              tail_kernel="pallas_pfb",
                              pfb_precision="bf16")
    with pytest.raises(ValueError, match="pallas_pfb"):
        tch.ChannelizedConfig(block_frames=BLOCK, num_channels=C,
                              tail_kernel="pallas_pfb",
                              pfb_precision="bf16")


def test_entry_points_default_to_the_card():
    # no device named means the CUDA device; where torch sees none the
    # entry points raise, they never fall back to the CPU
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device here")
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA device"):
        tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tch.init_channelized_state(cfg)
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        convert.params_from_numpy(p)
    with pytest.raises(RuntimeError, match="CUDA device"):
        convert.state_from_numpy(tch.init_channelized_state(cfg, "cpu"))


# ---- the branches beside the main path -----------------------------------
# name -> (config, channels, IF bandwidths, AF bandwidths, kernel wrapper
# the JAX step reaches; the port's launch count must stay put on the CPU)
_FALLBACK = dict(block_frames=102_400, num_channels=16)
BRANCHES = {
    "chanrate_9600": (dict(audio_rate=9_600, block_frames=256_000,
                           tail_kernel="pallas"), 128, 80_000, 8_000,
                      tail_tm.fused_tail_tm),
    "fused_filterbank": (dict(tail_kernel="pallas_pfb"), 128, 80_000, 8_000,
                         tail_tm.fused_pfb_tail_audio_tm),
    "fallback_kernel": (dict(use_pallas_tail=True, **_FALLBACK), 16,
                        [12_500, 80_000] * 8, [9_000, 8_000] * 8,
                        tail.fused_receiver_tail),
    "fallback_plain": (_FALLBACK, 16, [12_500, 80_000] * 8,
                       [9_000, 8_000] * 8, None),
}


def _branch(name, fast_nco=True):
    kw, c, ifbw, afbw, wrapper = BRANCHES[name]
    kw = {"block_frames": BLOCK, "num_channels": c, "fast_nco": fast_nco,
          **kw}
    ifs = [int(f) for f in np.linspace(-900_000, 900_000, c)]
    modes = [("AM", "FM", "USB", "LSB")[i % 4] for i in range(c)]
    cfg_j, cfg_t = jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)
    pj = jch.make_channelized_params(cfg_j, ifs, ifbw, afbw, modes)
    pt = tch.make_channelized_params(cfg_t, ifs, ifbw, afbw, modes,
                                     device="cpu")
    return cfg_j, cfg_t, pj, pt, wrapper


def _fm_flips(got, ref, fm, bound, flip_step):
    """Hold ``got`` to ``ref`` within ``bound``; an FM slot's output may
    exceed it only where a float32 rounding put ``atan2(ii, qq)`` on the
    other side of its branch cut, which moves an output by at most two
    audio taps, on at most 1e-4 of the samples (chip_smoke's rule)."""
    err = np.abs(got - ref)
    assert err[:, ~fm].max() <= bound
    over = err[:, fm] > bound
    assert over.sum() <= 1e-4 * over.size
    assert err[:, fm].max() <= 2 * flip_step + bound
    return int(over.sum())


@pytest.mark.parametrize("fast_nco", [True, False])
@pytest.mark.parametrize("name", list(BRANCHES))
def test_step_branch_matches_jax(name, fast_nco):
    cfg_j, cfg_t, pj, pt, wrapper = _branch(name, fast_nco)
    if name.startswith("fallback"):
        assert pt.chan_toep is None and pj.chan_toep is None
    elif name == "chanrate_9600":
        assert tch._audio_time_tile(cfg_t.chan_frames, cfg_t.audio_decim,
                                    pt.chan_toep.shape[1]) == 0
    launches = wrapper.launches if wrapper else 0
    sj = jch.init_channelized_state(cfg_j)
    st = tch.init_channelized_state(cfg_t, "cpu")
    fm = pt.mode.numpy() == 1
    flip_step = float(pt.audio_coeff.abs().max())
    for iq in _blocks(2, seed=2, block=cfg_t.block_frames):
        sj, aj, _ = jch.channelized_step_serving(cfg_j, pj, sj,
                                                 jnp.asarray(iq))
        st, at, _ = tch.channelized_step_serving(cfg_t, pt, st,
                                                 torch.from_numpy(iq))
        aj = np.asarray(aj)
        assert at.shape == aj.shape == (cfg_t.audio_frames,
                                        cfg_t.num_channels)
        assert np.abs(aj).max() > 1e-2  # not zeros against zeros
        _fm_flips(at.numpy(), aj, fm, 1e-5, flip_step)
    sj = jax.tree.map(np.asarray, sj)
    np.testing.assert_array_equal(st.nco_phase.numpy(),
                                  sj.nco_phase.astype(np.int64))
    np.testing.assert_array_equal(st.pfb_hist.numpy(), sj.pfb_hist)
    # mixed (or, under use_pallas_tail, raw) carries and the FM lag
    assert st.chan_hist.shape == sj.chan_hist.shape
    np.testing.assert_allclose(st.chan_hist.numpy(), sj.chan_hist, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(st.demod_prev.numpy(), sj.demod_prev, rtol=0,
                               atol=1e-6)
    # the demod-audio tail: raw FM rows, so a flip is a whole turn
    assert st.audio_hist.shape == sj.audio_hist.shape
    err = st.audio_hist.numpy() - sj.audio_hist
    err[fm] -= np.round(err[fm])
    assert np.abs(err).max() <= 1e-5
    if wrapper:
        assert wrapper.launches == launches  # CPU tensors: no kernel


def test_fallback_power_gates_like_jax():
    # the fallback's squelch power against the JAX step's: a threshold
    # 0.5 dB under each slot's own power passes audio in both packages,
    # one 0.5 dB over it mutes in both (power rtol 1e-5 is 4e-5 dB)
    cfg_j, cfg_t, pj, pt, _ = _branch("fallback_plain")
    iq = next(_blocks(1, seed=4, block=cfg_t.block_frames))
    chan_in, _ = tch.pfb_channelize_direct(
        torch.from_numpy(iq), pt.pfb_weights, cfg_t.num_bins,
        torch.zeros(2, cfg_t.proto_taps - 1))
    mixed = tch.nco_mix(chan_in, torch.zeros(16, dtype=torch.int64),
                        pt.residual_step)
    shaped, _ = tch.fir_dispatch(mixed, pt.chan_coeff, None, 1,
                                 torch.zeros(2, 16, 63))
    db = 10 * np.log10((shaped[0] ** 2 + shaped[1] ** 2).mean(-1).numpy())
    for offset, muted in ((-0.5, False), (0.5, True)):
        sq = torch.from_numpy((db + offset).astype(np.float32))
        _, at, _ = tch.channelized_step_serving(
            cfg_t, pt._replace(squelch=sq),
            tch.init_channelized_state(cfg_t, "cpu"), torch.from_numpy(iq))
        _, aj, _ = jch.channelized_step_serving(
            cfg_j, pj._replace(squelch=jnp.asarray(sq.numpy())),
            jch.init_channelized_state(cfg_j), jnp.asarray(iq))
        assert bool((at == 0).all()) is muted
        assert bool((np.asarray(aj) == 0).all()) is muted


# ---- control plane --------------------------------------------------------

def test_scatter_params_slots_matches_jax_and_a_full_rebuild():
    cfg_j, cfg_t = _configs()
    pj = jch.make_channelized_params(cfg_j, IFS, 80_000, 8_000, MODES)
    pt = tch.make_channelized_params(cfg_t, IFS, 80_000, 8_000, MODES,
                                     device="cpu")
    idx = [3, 17, 100]
    ifs, modes = list(IFS), list(MODES)
    gains, squelch = [0.0] * C, [None] * C
    for n, i in enumerate(idx):
        ifs[i], modes[i] = 12_345 * (n + 1), ("USB", "FM", "AM")[n]
        gains[i], squelch[i] = 3.0 * n, -40.0 + n
    sub_kw = dict(block_frames=BLOCK, num_channels=len(idx))
    sub_args = ([ifs[i] for i in idx], 80_000, 8_000,
                [modes[i] for i in idx], [gains[i] for i in idx],
                [squelch[i] for i in idx])
    sub_j = jch.make_channelized_params(jch.ChannelizedConfig(**sub_kw),
                                        *sub_args)
    sub_t = tch.make_channelized_params(tch.ChannelizedConfig(**sub_kw),
                                        *sub_args, device="cpu")
    want_j = jch.scatter_params_slots(pj, jnp.asarray(idx, jnp.int32), sub_j)
    pipe = tch.ChannelizedPipeline(cfg_t, pt)
    pipe.update_params_slots(idx, sub_t, (0, 1, 2, 3))
    got = pipe.params
    assert got.pfb_weights is pt.pfb_weights  # written in place
    full = tch.make_channelized_params(cfg_t, ifs, 80_000, 8_000, modes,
                                       gains, squelch, device="cpu")
    _assert_params_equal(got, full)
    _assert_params_equal(got, convert.params_from_numpy(
        jax.tree.map(np.asarray, want_j), device="cpu"))


def test_grow_channelized_state_matches_jax():
    cfg_j, cfg_t = _configs(tail_kernel="pallas")
    pj = jch.make_channelized_params(cfg_j, IFS, 80_000, 8_000, MODES)
    pt = tch.make_channelized_params(cfg_t, IFS, 80_000, 8_000, MODES,
                                     device="cpu")
    iq = next(_blocks(1, seed=6))
    sj, _, _ = jch.channelized_step_serving(
        cfg_j, pj, jch.init_channelized_state(cfg_j), jnp.asarray(iq))
    st, _, _ = tch.channelized_step_serving(
        cfg_t, pt, tch.init_channelized_state(cfg_t, "cpu"),
        torch.from_numpy(iq))
    gj = jax.tree.map(np.asarray, jch.grow_channelized_state(sj, 2 * C))
    gt = tch.grow_channelized_state(st, 2 * C)
    for f in tch.ChannelizedState._fields:
        a, b = getattr(gt, f).numpy(), getattr(gj, f)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b.astype(a.dtype), rtol=0, atol=1e-5)
        assert a.any(), f  # a carried, non-zero state was grown
    # the new slots start from init zeros; the old ones are untouched
    assert not gt.chan_hist[:, C:].any() and not gt.audio_hist[C:].any()
    torch.testing.assert_close(gt.chan_hist[:, :C], st.chan_hist, rtol=0,
                               atol=0)
    assert tch.grow_channelized_state(st, C) is st
    with pytest.raises(ValueError, match="only grow"):
        tch.grow_channelized_state(st, C - 1)


def test_growth_mid_stream_keeps_the_old_slots_audio():
    # a pipeline grown from C to 2C between blocks gives the first C slots
    # the same next block as the ungrown pipeline (same branch: "pallas")
    _, cfg = _configs(tail_kernel="pallas")
    _, wide = _configs(tail_kernel="pallas", num_channels=2 * C)
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES,
                                    device="cpu")
    pw = tch.make_channelized_params(wide, IFS + IFS, 80_000, 8_000,
                                     MODES + MODES, device="cpu")
    b0, b1 = (torch.from_numpy(b) for b in _blocks(2, seed=7))
    s, _, _ = tch.channelized_step_serving(
        cfg, p, tch.init_channelized_state(cfg, "cpu"), b0)
    _, want, _ = tch.channelized_step_serving(cfg, p, s, b1)
    _, got, _ = tch.channelized_step_serving(
        wide, pw, tch.grow_channelized_state(s, 2 * C), b1)
    assert want.abs().max() > 1e-2
    torch.testing.assert_close(got[:, :C], want, rtol=0, atol=1e-6)


def test_process_host_many_matches_jax_scan_and_per_block():
    cfg_j, cfg_t = _configs(tail_kernel="pallas")
    pj = jch.make_channelized_params(cfg_j, IFS, 80_000, 8_000, MODES)
    pt = tch.make_channelized_params(cfg_t, IFS, 80_000, 8_000, MODES,
                                     device="cpu")
    blocks = np.stack(list(_blocks(3, seed=8)))
    sj, aj, dbj = jstream.scan_serving(
        cfg_j, pj, jch.init_channelized_state(cfg_j), jnp.asarray(blocks))
    pipe = tch.ChannelizedPipeline(cfg_t, pt)
    assert pipe.process_host_many(blocks) is None
    audio, db = pipe.flush()
    aj, dbj = np.asarray(aj), np.asarray(dbj)
    assert audio.shape == aj.shape == (3, C, cfg_t.audio_frames)
    assert np.abs(aj).max() > 1e-2
    np.testing.assert_allclose(audio.numpy(), aj, rtol=0, atol=1e-5)
    # bins within 40 dB of the strongest (see the serving-step test: the
    # float32 DFT sum's error is relative to the strongest bin)
    live = dbj > dbj.max() - 40.0
    assert live.sum() > 100
    np.testing.assert_allclose(db.numpy()[live], dbj[live], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(
        pipe.state.nco_phase.numpy(),
        np.asarray(sj.nco_phase).astype(np.int64))
    # the same blocks one at a time: the same state, the audio transposed
    one = tch.ChannelizedPipeline(cfg_t, pt)
    outs = [one.process_host(b) for b in blocks][1:] + [one.flush()]
    for k, (a, _) in enumerate(outs):
        torch.testing.assert_close(a.T, audio[k], rtol=0, atol=0)
    torch.testing.assert_close(outs[-1][1], db, rtol=0, atol=0)
    for f in tch.ChannelizedState._fields:
        torch.testing.assert_close(getattr(one.state, f),
                                   getattr(pipe.state, f), rtol=0, atol=0)
    # the double-buffered contract holds across the two entry points
    assert pipe.process_host(blocks[0]) is None
    prev = pipe.process_host_many(blocks[1:])
    assert prev[0].shape == (cfg_t.audio_frames, C)
    assert pipe.flush()[0].shape == (2, C, cfg_t.audio_frames)


def test_auto_selects_the_kernel_where_jax_selects_pallas():
    for c, expect in ((256, False), (512, True), (1_024, True)):
        kw = dict(block_frames=BLOCK, num_channels=c)
        cfg_j = jch.ChannelizedConfig(**kw)
        cfg_t = tch.ChannelizedConfig(**kw)
        pj = jch.make_channelized_params(cfg_j, 0, 80_000, 8_000, "FM")
        pt = tch.make_channelized_params(cfg_t, 0, 80_000, 8_000, "FM",
                                         device="cpu")
        nd = cfg_t.chan_frames
        assert jch._use_pallas_tm(cfg_j, nd, pj) is expect
        assert tch._use_kernel_tm(cfg_t, nd, pt) is expect
    assert tch.PALLAS_TM_AUTO_THRESHOLD == jch.PALLAS_TM_AUTO_THRESHOLD
    assert tail_tm.CHAN_TILE == 128
    modes = np.array([3, 1, 1, 0], np.int32)
    assert tch.mode_set_of(torch.from_numpy(modes)) == jch.mode_set_of(modes)
