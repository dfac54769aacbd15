"""The filterbank tiers (``pfb_precision``) of the port against the JAX
package's forms of each law.

Each tier is one law on bfloat16 or float32 operands
(``webradio_tpu_torch.ops.channelizer``). The JAX package computes
"default" as one bf16 MXU pass only on a TPU (``jnp.dot`` at
``Precision.DEFAULT`` is float32 on a CPU) and "u8exact" as HIGHEST off the
TPU, so the port is held to the JAX package's *explicit* form of each law,
which any backend computes as written:

- "highest": ``jnp.dot`` at ``Precision.HIGHEST``;
- "u8exact": ``pfb_channelize_direct_tm_u8`` with ``split_weights_u8``;
- "default": ``jnp.dot`` of the two operands cast to bfloat16 with float32
  accumulation;
- "high": ``pallas_tail_tm._band_dot(a, b, Precision.HIGH)``;
- "bf16": the "default" form cast to bfloat16.

The products are held to float32 summation accuracy (both sides multiply
the same bfloat16 values exactly and sum in float32, in their own orders);
the stored bfloat16 product to one bfloat16 step where the two float32 sums
fall on either side of a rounding boundary. End to end (the tier rule,
PERF.md section 2) each tier's audio SNR against a float64 run of the
port's plain ops is at least the JAX law's SNR minus 0.5 dB on the same
input, on two inputs: tones on the 8-bit grid, and carriers plus noise in
float32. The step at every lossy tier is held to the JAX step (its
filterbank stage replaced by the JAX form of the same law) over two
carried blocks with the bounds of ``tests/test_torch_channelized.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from webradio_tpu.ops import channelizer as jchan
from webradio_tpu.ops.pallas_tail_tm import _band_dot
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu_torch import convert
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import channelizer as tchan
from webradio_tpu_torch.ops import fir, firdesign, tail_tm
from webradio_tpu_torch.ops.nco import nco_advance, nco_mix_tm_fast
from webradio_tpu_torch.pipeline import channelized as tch
from webradio_tpu_torch.pipeline.frontend import squelch_scale

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

TIERS = ("highest", "u8exact", "default", "high", "bf16")
LOSSY = TIERS[1:]
BLOCK, C, BINS, KP = 25_600, 64, 10, 160
IFS = [int(f) for f in np.linspace(-900_000, 900_000, C)]
MODES = [("AM", "FM", "USB", "LSB")[i % 4] for i in range(C)]
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-450_000.0, "FM", 700.0), (700_000.0, "AM", 1_300.0))
T = torch.from_numpy


def _blocks(kind, n=2, seed=0, block=BLOCK):
    """``n`` IQ blocks ``[2, block]``: "u8" the tone source's carriers
    quantized as a dongle delivers them, ``(u8 - 128) / 128``; "f32" the
    same carriers plus noise in float32."""
    src = ToneSource(carriers=CARRIERS, noise=0.5 if kind == "f32" else 0.02,
                     seed=seed)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, block, False
    out = []
    for _ in range(n):
        z = src.read_block()
        x = np.stack([z.real, z.imag]).astype(np.float32)
        if kind == "u8":
            u8 = np.clip(np.round(x * 40.0) + 128.0, 0, 255)
            x = ((u8 - 128.0) / 128.0).astype(np.float32)
        out.append(x)
    return out


def _weights(c=C):
    proto = tchan.design_prototype(2_400_000, BINS, 16)
    ifs = np.linspace(-900_000, 900_000, c).astype(np.int64)
    bin_idx, _ = tchan.assign_bins(ifs, 2_400_000, BINS)
    return tchan.bin_weights_for_channels(proto, BINS, bin_idx)


def _jax_product(tier, f2, weights, weights_split):
    """The JAX package's explicit form of a tier's law on frames ``f2``."""
    w2 = weights.reshape(weights.shape[0], -1)
    if tier == "highest":
        return jnp.dot(f2, w2, precision=lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
    if tier == "u8exact":
        kp2 = weights_split.shape[1]
        fb = f2.astype(jnp.bfloat16)
        return jnp.dot(jnp.concatenate([fb, fb], axis=1),
                       weights_split.reshape(2 * kp2, -1),
                       preferred_element_type=jnp.float32)
    if tier == "high":
        return _band_dot(f2, w2, lax.Precision.HIGH)
    y = jnp.dot(f2.astype(jnp.bfloat16), w2.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32)
    return y.astype(jnp.bfloat16) if tier == "bf16" else y


def _jax_law(tier, port_params=None):
    """A stand-in for the JAX step's ``_channelize_tm`` that computes the
    tier's explicit law (the JAX step itself runs u8exact at HIGHEST and
    "default" in float32 on a CPU). With ``port_params`` it hands the JAX
    step the port's own product instead: for the bfloat16-stored tier,
    whose two float32 sums round to different bfloat16 values where they
    straddle a rounding boundary (one bfloat16 step, ~2^-8 of the value),
    so that the step's comparison holds what the step does with the
    product; the law itself is held by :func:`test_law_matches_jax_form`."""
    def channelize(cfg, params, pfb_hist, iq, split):
        if port_params is not None:
            y, _, hist = tchan.pfb_channelize_direct_tm(
                T(np.array(iq)), port_params.pfb_weights, cfg.num_bins,
                T(np.array(pfb_hist)), split=False, precision=tier,
                weights_split=port_params.pfb_weights_split)
            y = jnp.asarray(y.float().numpy()).astype(
                jnp.bfloat16 if y.dtype == torch.bfloat16 else jnp.float32)
            c = cfg.num_channels
            hist = jnp.asarray(hist.numpy())
            return (y, y, hist) if not split else (y[:, :c], y[:, c:], hist)
        if tier == "u8exact":
            return jchan.pfb_channelize_direct_tm_u8(
                iq, params.pfb_weights_split, cfg.num_bins, pfb_hist,
                split=split)
        f2, hist = jchan.pfb_frames_tm(iq, cfg.proto_taps, cfg.num_bins,
                                       pfb_hist)
        y = _jax_product(tier, f2, params.pfb_weights, None)
        c = cfg.num_channels
        return (y, y, hist) if not split else (y[:, :c], y[:, c:], hist)
    return channelize


def _sum_scale(f2, w2):
    """``|f2| @ |w2|`` in float64: the size of each output's terms."""
    return np.abs(np.asarray(f2, np.float64)) @ np.abs(
        np.asarray(w2, np.float64))


# ---- the laws ---------------------------------------------------------------
def test_split_weights_match_jax_bit_for_bit():
    w = _weights()
    got = tchan.split_weights_u8(w)
    want = np.asarray(jchan.split_weights_u8(w).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2 * KP, 2, C)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # hi + lo is w to ~2^-17
    np.testing.assert_allclose(got.float().sum(0).numpy(), w, rtol=2**-16,
                               atol=0)


@pytest.mark.parametrize("tier", TIERS)
def test_law_matches_jax_form(tier):
    w = _weights()
    f2, _ = tchan.pfb_frames_tm(T(_blocks("f32", 1, seed=3)[0]), KP, BINS,
                                torch.zeros(2, KP - 1))
    split = tchan.split_weights_u8(w)
    got = tchan.pfb_product(f2, T(w), split, tier)
    want = _jax_product(tier, jnp.asarray(f2.numpy()), jnp.asarray(w),
                        jchan.split_weights_u8(w))
    assert got.dtype == (torch.bfloat16 if tier == "bf16" else torch.float32)
    assert np.asarray(want).dtype.name == ("bfloat16" if tier == "bf16"
                                           else "float32")
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    scale = _sum_scale(f2.numpy(), w.reshape(2 * KP, 2 * C))
    assert np.abs(want).max() > 1e-2
    if tier == "bf16":
        # one rounding of two float32 sums: equal, or one bfloat16 step
        # apart where the sums straddle a rounding boundary
        diff = np.abs(got - want)
        assert diff.max() <= 2.0**-7 * np.abs(want).max()
        assert (diff <= 2.0**-7 * np.abs(want) + 1e-30).all()
        assert (diff == 0).mean() > 0.999
    else:
        # float32 sums of the same exact products in another order
        assert (np.abs(got - want) <= 2e-6 * scale + 1e-12).all()


def test_u8exact_is_the_highest_product_on_the_8bit_grid():
    # JAX's claim (channelizer.py:252-254): on 8-bit-sourced frames the
    # two-pass split law is float32-accurate, ~2e-6 of the product: what
    # the second-level rounding leaves of each weight (lo rounded to
    # bfloat16, at most 2^-18 of w). Measured here: 2.06e-6 of the peak
    w = _weights()
    iq = _blocks("u8", 1, seed=4)[0]
    assert np.array_equal(np.round(iq * 128), iq * 128)  # on the grid
    f2, _ = tchan.pfb_frames_tm(T(iq), KP, BINS, torch.zeros(2, KP - 1))
    exact = f2.double() @ T(w).double().reshape(2 * KP, 2 * C)
    split = tchan.split_weights_u8(w)
    y8 = tchan.pfb_product(f2, T(w), split, "u8exact").double()
    y32 = tchan.pfb_product(f2, T(w), split, "highest").double()
    peak = float(exact.abs().max())
    assert float((y8 - y32).abs().max()) <= 3e-6 * peak
    assert float((y8 - exact).abs().max()) <= 3e-6 * peak
    # and the one-pass law is not (bfloat16 weights: ~2^-9 of the terms)
    yd = tchan.pfb_product(f2, T(w), split, "default").double()
    assert float((yd - exact).abs().max()) > 1e-4 * peak


def test_full_fp32_pins_the_reduced_precision_switches(monkeypatch):
    matmul = torch.backends.cuda.matmul
    old = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    seen = []
    real = tchan._mm_f32

    def spy(a, b):
        seen.append((matmul.allow_tf32,
                     matmul.allow_bf16_reduced_precision_reduction))
        return real(a, b)

    monkeypatch.setattr(tchan, "_mm_f32", spy)
    f2 = torch.rand(64, 2 * KP)
    split = tchan.split_weights_u8(_weights())
    try:
        matmul.allow_tf32 = True
        matmul.allow_bf16_reduced_precision_reduction = True
        for tier in ("u8exact", "default", "high"):
            tchan.pfb_product(f2, None, split, tier)
        assert seen and all(s == (False, False) for s in seen)
        # restored on the way out
        assert matmul.allow_tf32 is True
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = old


# ---- the tier rule: audio SNR against a float64 chain -----------------------
def _f64_chain(cfg, p, s, iq):
    """One block through the port's plain ops in float64 (the product and
    every tail stage; the LO is the step's float32 law): the yardstick of
    the tier rule. Returns ``(state, audio [audio_frames, C])``."""
    kp, c, dd = cfg.proto_taps, cfg.num_channels, lambda t: t.double()
    f2, pfb_hist = tchan.pfb_frames_tm(dd(iq), kp, cfg.num_bins,
                                       dd(s.pfb_hist))
    y = f2 @ dd(p.pfb_weights).reshape(2 * kp, 2 * c)
    mi, mq = nco_mix_tm_fast(y[:, :c], y[:, c:], s.nco_phase,
                             p.residual_step)
    audio, hi, hq, prev, ahist, power = tail_tm.tail_after_mix_tm(
        mi, mq, dd(p.chan_toep), dd(p.audio_toep), cfg.audio_decim, p.mode,
        dd(s.chan_hist[0].T), dd(s.chan_hist[1].T), dd(s.demod_prev),
        dd(s.audio_hist.T))
    audio = audio * squelch_scale(power, dd(p.af_gain), dd(p.squelch))[None]
    return tch.ChannelizedState(
        pfb_hist, nco_advance(s.nco_phase, p.residual_step, cfg.chan_frames),
        torch.stack([hi.T, hq.T]), prev, ahist.T), audio


def _snr_db(ref, got, cols):
    err = got[:, cols] - ref[:, cols]
    return 10 * np.log10(np.sum(ref[:, cols] ** 2) / np.sum(err ** 2))


def _configs(tier, **kw):
    kw = {"block_frames": BLOCK, "num_channels": C, "pfb_precision": tier,
          **kw}
    return jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("tier", TIERS)
def test_tier_snr_against_float64(tier, kind, monkeypatch):
    monkeypatch.setattr(jch, "_channelize_tm", _jax_law(tier))
    cfg_j, cfg_t = _configs(tier, tail_kernel="xla")
    pj = jch.make_channelized_params(cfg_j, IFS, 80_000, 8_000, MODES)
    pt = tch.make_channelized_params(cfg_t, IFS, 80_000, 8_000, MODES,
                                     device="cpu")
    sj = jch.init_channelized_state(cfg_j)
    st = s64 = tch.init_channelized_state(cfg_t, "cpu")
    got, law, ref = [], [], []
    for iq in _blocks(kind, 2, seed=5):
        sj, aj, _ = jch._channelized_step(cfg_j, pj, sj, jnp.asarray(iq),
                                          None, True)
        st, at, _ = tch.channelized_step_serving(cfg_t, pt, st, T(iq))
        s64, a64 = _f64_chain(cfg_t, pt, s64, T(iq))
        got.append(at.numpy())
        law.append(np.asarray(aj))
        ref.append(a64.numpy())
    got, law, ref = (np.concatenate(x) for x in (got, law, ref))
    assert np.abs(ref).max() > 1e-2  # the silent-FIR trap
    # FM's branch-cut flips are discrete events a power ratio does not
    # weigh; FM slots are held by the step test's flip rule
    cols = np.array([m != "FM" for m in MODES])
    port_snr, jax_snr = _snr_db(ref, got, cols), _snr_db(ref, law, cols)
    assert port_snr >= jax_snr - 0.5, (port_snr, jax_snr)
    # each law where it belongs: float32-accurate, bfloat16x3, one pass
    floor = {"highest": 110, "high": 95, "default": 40, "bf16": 40,
             "u8exact": 110 if kind == "u8" else 40}[tier]
    assert port_snr > floor, port_snr


# ---- the step at every lossy tier against the JAX step ----------------------
def _fm_flips(got, ref, fm, bound, flip_step):
    """``tests/test_torch_channelized.py``'s rule: an FM output may exceed
    ``bound`` only by a branch-cut flip (at most two audio taps, on at most
    1e-4 of the samples)."""
    err = np.abs(got - ref)
    assert err[:, ~fm].max() <= bound
    over = err[:, fm] > bound
    assert over.sum() <= 1e-4 * over.size
    assert err[:, fm].max() <= 2 * flip_step + bound


@pytest.mark.parametrize("tier,tail_kernel,c", [
    ("u8exact", "xla", C), ("default", "xla", C), ("high", "xla", C),
    ("bf16", "xla", C),
    # kernel #1's bfloat16 product: the JAX kernel (interpret mode) and
    # the port's plain tail on .float() of it
    ("bf16", "pallas", 128),
])
def test_step_matches_jax_at_every_tier(tier, tail_kernel, c, monkeypatch):
    block = BLOCK if tail_kernel == "xla" else 51_200
    kw = dict(block_frames=block, num_channels=c, pfb_precision=tier,
              tail_kernel=tail_kernel)
    cfg_j, cfg_t = jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)
    ifs = [int(f) for f in np.linspace(-900_000, 900_000, c)]
    modes = [("AM", "FM", "USB", "LSB")[i % 4] for i in range(c)]
    pj = jch.make_channelized_params(cfg_j, ifs, 80_000, 8_000, modes)
    pt = tch.make_channelized_params(cfg_t, ifs, 80_000, 8_000, modes,
                                     device="cpu")
    monkeypatch.setattr(jch, "_channelize_tm", _jax_law(
        tier, pt if tier == "bf16" else None))
    sj = jch.init_channelized_state(cfg_j)
    st = tch.init_channelized_state(cfg_t, "cpu")
    fm = np.array([m == "FM" for m in modes])
    flip_step = float(pt.audio_coeff.abs().max())
    launches = tail_tm.fused_tail_audio_tm.launches
    for iq in _blocks("u8" if tier == "u8exact" else "f32", 2, seed=6,
                      block=block):
        sj, aj, _ = jch._channelized_step(cfg_j, pj, sj, jnp.asarray(iq),
                                          None, True)
        st, at, _ = tch.channelized_step_serving(cfg_t, pt, st, T(iq))
        aj = np.asarray(aj)
        assert at.shape == aj.shape == (cfg_t.audio_frames, c)
        assert np.abs(aj).max() > 1e-2
        _fm_flips(at.numpy(), aj, fm, 1e-5, flip_step)
    sj = jax.tree.map(np.asarray, sj)
    np.testing.assert_array_equal(st.pfb_hist.numpy(), sj.pfb_hist)
    np.testing.assert_allclose(st.chan_hist.numpy(), sj.chan_hist, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(st.demod_prev.numpy(), sj.demod_prev,
                               rtol=0, atol=1e-6)
    assert tail_tm.fused_tail_audio_tm.launches == launches  # CPU: plain


# ---- parameters: scatter, growth, convert -----------------------------------
def test_scatter_params_slots_with_split_weights_matches_jax():
    cfg_j, cfg_t = _configs("u8exact", tail_kernel="xla")
    base_j = jch.make_channelized_params(cfg_j, IFS, 80_000, 8_000, MODES)
    base_t = tch.make_channelized_params(cfg_t, IFS, 80_000, 8_000, MODES,
                                         device="cpu")
    idx = [3, 17, C - 5]
    ifs2, modes2 = list(IFS), list(MODES)
    for n, i in enumerate(idx):
        ifs2[i], modes2[i] = 12_345 * (n + 1), ("USB", "FM", "AM")[n]
    sub_kw = dict(block_frames=BLOCK, num_channels=len(idx),
                  pfb_precision="u8exact")
    sub_args = ([ifs2[i] for i in idx], 80_000, 8_000,
                [modes2[i] for i in idx])
    sub_j = jch.make_channelized_params(jch.ChannelizedConfig(**sub_kw),
                                        *sub_args)
    sub_t = tch.make_channelized_params(tch.ChannelizedConfig(**sub_kw),
                                        *sub_args, device="cpu")
    got = tch.scatter_params_slots(base_t, idx, sub_t)
    want = jch.scatter_params_slots(base_j, jnp.asarray(idx), sub_j)
    full = tch.make_channelized_params(cfg_t, ifs2, 80_000, 8_000, modes2,
                                       device="cpu")
    np.testing.assert_array_equal(
        got.pfb_weights_split.float().numpy(),
        np.asarray(want.pfb_weights_split.astype(jnp.float32)))
    assert torch.equal(got.pfb_weights_split, full.pfb_weights_split)
    assert torch.equal(got.pfb_weights, full.pfb_weights)


def test_growth_with_split_weights_keeps_the_old_slots_audio():
    # a pipeline grown from C to 2C (the radio's growth: parameters made
    # at the new width, state padded) hears its old slots as before; the
    # split is column-wise, so the wide split's first C columns are the
    # narrow one's
    _, cfg = _configs("high", tail_kernel="xla")
    wide_cfg = tch.ChannelizedConfig(block_frames=BLOCK, num_channels=2 * C,
                                     pfb_precision="high", tail_kernel="xla")
    p = tch.make_channelized_params(cfg, IFS, 80_000, 8_000, MODES,
                                    device="cpu")
    pw = tch.make_channelized_params(wide_cfg, IFS + IFS, 80_000, 8_000,
                                     MODES + MODES, device="cpu")
    assert torch.equal(pw.pfb_weights_split[..., :C], p.pfb_weights_split)
    blocks = _blocks("f32", 3, seed=7)
    s = tch.init_channelized_state(cfg, "cpu")
    for iq in blocks[:2]:
        s, _, _ = tch.channelized_step_serving(cfg, p, s, T(iq))
    _, want, _ = tch.channelized_step_serving(cfg, p, s, T(blocks[2]))
    grown = tch.grow_channelized_state(s, 2 * C)
    _, got, _ = tch.channelized_step_serving(wide_cfg, pw, grown,
                                             T(blocks[2]))
    assert float(want.abs().max()) > 1e-2
    # a GEMM of another width may sum in another order
    fm = np.array([m == "FM" for m in MODES])
    _fm_flips(got[:, :C].numpy(), want.numpy(), fm, 1e-5,
              float(p.audio_coeff.abs().max()))


def test_convert_carries_a_jax_bfloat16_split():
    cfg_j, cfg_t = _configs("u8exact", tail_kernel="xla")
    pj = jax.tree.map(np.asarray,
                      jch.make_channelized_params(cfg_j, IFS, 80_000, 8_000,
                                                  MODES))
    assert pj.pfb_weights_split.dtype.name == "bfloat16"  # ml_dtypes
    got = convert.params_from_numpy(pj, device="cpu")
    want = tch.make_channelized_params(cfg_t, IFS, 80_000, 8_000, MODES,
                                       device="cpu")
    assert got.pfb_weights_split.dtype == torch.bfloat16
    assert torch.equal(got.pfb_weights_split, want.pfb_weights_split)
    with pytest.raises(TypeError, match="bfloat16"):
        convert.params_from_numpy(
            pj._replace(pfb_weights_split=np.zeros(3, np.int16)),
            device="cpu")


def test_fused_filterbank_refuses_the_packed_tiers():
    for tier in ("u8exact", "bf16"):
        for pkg in (jch, tch):
            with pytest.raises(ValueError, match="pallas_pfb"):
                pkg.ChannelizedConfig(block_frames=BLOCK, num_channels=128,
                                      tail_kernel="pallas_pfb",
                                      pfb_precision=tier)
    for tier in ("default", "high"):
        assert tch.ChannelizedConfig(
            block_frames=BLOCK, num_channels=128, tail_kernel="pallas_pfb",
            pfb_precision=tier).pfb_precision == tier


# ---- kernel #3's plain version at "default" and "high" against JAX ----------
@pytest.mark.parametrize("tier", ["default", "high"])
def test_fused_filterbank_plain_version_matches_jax_at_tier(tier):
    """The plain ``fused_pfb_tail_audio_tm`` at a lossy tier against the
    JAX kernel (interpret mode). "high" is the JAX kernel's own HIGH law
    (``_band_dot``); "default", which the JAX kernel computes as one bf16
    pass only on a TPU, is given to it as the HIGHEST product of the
    operands rounded to bfloat16, the same law."""
    from webradio_tpu.ops.pallas_tail_tm import fused_pfb_tail_audio_tm

    c, d, k = 128, 5, 64
    rng = np.random.default_rng(8)
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)
    w = _weights(c).reshape(2 * KP, 2 * c)
    wt = fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000, 240_000),
                              1, 128)
    wa = fir.toeplitz_weights(firdesign.design_lowpass_fir(8_000, 240_000),
                              d, 32)
    phase0 = rng.integers(0, 2**31, c).astype(np.uint32)
    step = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    mode = (np.arange(c) % 4).astype(np.int32)
    carry = (u(k - 1, c), u(k - 1, c), u(2, c), u(k - 1, c))
    iq = _blocks("f32", 1, seed=9, block=BLOCK)[0]
    frames, _ = tchan.pfb_frames_tm(T(iq), KP, BINS, T(u(2, KP - 1)))
    got = tail_tm.fused_pfb_tail_audio_tm(
        frames, T(w), T(phase0.astype(np.int64)), T(step.astype(np.int64)),
        T(wt), T(wa), d, T(mode), *(T(a) for a in carry), fast=True,
        pfb_precision=tier, pfb_weights_split=tchan.split_weights_u8(w))
    if tier == "high":
        jf, jw, prec = frames.numpy(), w, lax.Precision.HIGH
    else:
        jf = frames.bfloat16().float().numpy()
        jw = T(w).bfloat16().float().numpy()
        prec = lax.Precision.HIGHEST
    ref = fused_pfb_tail_audio_tm(
        jnp.asarray(jf), jnp.asarray(jw), jnp.asarray(phase0),
        jnp.asarray(step), jnp.asarray(wt), jnp.asarray(wa), d,
        jnp.asarray(mode), *(jnp.asarray(a) for a in carry), fast=True,
        pfb_precision=prec)
    ref = [np.asarray(a) for a in ref]
    fm = mode == 1
    assert np.abs(ref[0]).max() > 1e-2
    _fm_flips(got[0].numpy(), ref[0], fm, 1e-5, float(np.abs(wa).max()))
    # the mixed carries and the FM lag carry the product's float32 sums
    # (tests/test_torch_pfb_tail.py's 2e-6 for one 320-term sum); "high"
    # adds three such products, each summed in its own order: 4e-6
    for i in (1, 2, 3):
        np.testing.assert_allclose(got[i].numpy(), ref[i], rtol=0, atol=4e-6)
    np.testing.assert_allclose(got[5].numpy(), ref[5], rtol=1e-5, atol=0)
