"""Parity of the PyTorch port's DSP operators with the JAX package.

Every input is made with numpy from a fixed seed and handed to both
packages; each assert states its bound. The host-side designs are numpy in
both packages and must agree bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webradio_tpu import ops as jops
from webradio_tpu.ops import channelizer as jch
from webradio_tpu.ops import firdesign as jfd
from webradio_tpu.ops import nco as jnco
from webradio_tpu.ops.demod import demodulate_tm as j_demodulate_tm
from webradio_tpu.ops.spectrum import spectrum_accumulate as j_spectrum
from webradio_tpu.ops.spectrum import spectrum_db as j_spectrum_db
from webradio_tpu.ops.trig import atan2 as j_atan2
from webradio_tpu_torch.ops import channelizer as tch
from webradio_tpu_torch.ops import fir as tfir
from webradio_tpu_torch.ops import firdesign as tfd
from webradio_tpu_torch.ops import nco as tnco
from webradio_tpu_torch.ops import window as twin
from webradio_tpu_torch.ops.demod import MODES, demodulate_tm
from webradio_tpu_torch.ops.spectrum import spectrum_accumulate, spectrum_db
from webradio_tpu_torch.ops.trig import atan2

T = torch.from_numpy

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))


def _np(x):
    return np.asarray(x)


# ---- host-side designs: bit-identical -----------------------------------

@pytest.mark.parametrize("passband,rate", [
    (4_000, 240_000),  # maxbin truncates to 0: every tap is zero
    (8_000, 240_000), (12_500, 240_000), (80_000, 240_000),
    (600_000, 2_400_000), (200_000, 2_400_000),
])
def test_firdesign_bit_identical(passband, rate):
    ref = jfd.design_lowpass_fir(passband, rate)
    got = tfd.design_lowpass_fir(passband, rate)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32
    if passband == 4_000:
        # the reference design law is silent below 7.5 kHz at 240 kHz
        assert not got.any()
    else:
        assert got.any()
    np.testing.assert_array_equal(
        tfd.design_lowpass_fir_sinc(passband, rate),
        jfd.design_lowpass_fir_sinc(passband, rate))
    for design in ("reference", "sinc"):
        np.testing.assert_array_equal(
            tfd.design_lowpass_fir_cached(passband, rate, design=design),
            jfd.design_lowpass_fir_cached(passband, rate, design=design))


def test_firdesign_constants_and_window():
    assert tfd.FIR_LENGTH == jfd.FIR_LENGTH == 64
    assert sorted(tfd.DESIGNS) == sorted(jfd.DESIGNS)
    for n in (64, 512, 160):
        np.testing.assert_array_equal(twin.hamming(n), jops.hamming(n))
    with pytest.raises(ValueError):
        tfd.design_lowpass_fir_cached(8_000, 240_000, design="bogus")


@pytest.mark.parametrize("decimation,nd_out,k", [
    (1, 10_240, 64), (5, 2_048, 64), (1, 5_120, 64), (5, 1_024, 64),
    (1, 96, 64), (5, 24, 64), (3, 7, 64),
])
def test_toeplitz_bit_identical(decimation, nd_out, k):
    assert (tfir.toeplitz_tile(nd_out, decimation, k)
            == jops.toeplitz_tile(nd_out, decimation, k))
    coeff = jfd.design_lowpass_fir(80_000, 240_000, k)
    tile = jops.toeplitz_tile(nd_out, decimation, k) or 8
    np.testing.assert_array_equal(
        tfir.toeplitz_weights(coeff, decimation, tile),
        jops.toeplitz_weights(coeff, decimation, tile))
    rows = np.stack([coeff] * 4)
    ref = jops.maybe_toeplitz_weights(rows, decimation, nd_out)
    got = tfir.maybe_toeplitz_weights(rows, decimation, nd_out)
    assert (ref is None) == (got is None)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)
    # one differing channel: no shared kernel in either package
    rows[2] = jfd.design_lowpass_fir(8_000, 240_000, k)
    assert tfir.maybe_toeplitz_weights(rows, decimation, nd_out) is None
    assert jops.maybe_toeplitz_weights(rows, decimation, nd_out) is None


@pytest.mark.parametrize("fs,bins,tpp", [
    (2_400_000, 10, 16), (1_024_000, 8, 16), (2_048_000, 16, 8),
])
def test_channelizer_designs_bit_identical(fs, bins, tpp):
    rng = np.random.default_rng(fs)
    proto = tch.design_prototype(fs, bins, tpp)
    np.testing.assert_array_equal(proto, jch.design_prototype(fs, bins, tpp))
    np.testing.assert_array_equal(tch.bin_weights(proto, bins),
                                  jch.bin_weights(proto, bins))
    ifs = rng.integers(-fs // 2, fs // 2, 37)
    ifs[:3] = (0, fs // (2 * bins), -fs // (2 * bins))  # bin-edge ties
    b_t, r_t = tch.assign_bins(ifs, fs, bins)
    b_j, r_j = jch.assign_bins(ifs, fs, bins)
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_array_equal(r_t, r_j)
    assert b_t.dtype == b_j.dtype and r_t.dtype == r_j.dtype
    np.testing.assert_array_equal(
        tch.bin_weights_for_channels(proto, bins, b_t),
        jch.bin_weights_for_channels(proto, bins, b_j))


# ---- NCO: integer phase exact, mixers within 1e-6 ---------------------------

@pytest.mark.parametrize("if_hz,fs", [
    (0, 240_000), (1, 240_000), (-1, 240_000), (99_999, 240_000),
    (-119_999, 240_000), (120_000, 240_000), (-1_200_000, 2_400_000),
    (-7, 3),
])
def test_nco_phase_step_exact(if_hz, fs):
    assert tnco.nco_phase_step(if_hz, fs) == jnco.nco_phase_step(if_hz, fs)


def test_nco_advance_exact_with_negative_steps_and_wrap():
    rng = np.random.default_rng(1)
    c = 257
    phase0 = rng.integers(0, 2**31, c).astype(np.uint32)
    phase0[:3] = (0, 2**31 - 1, 2**31 - 2)  # at the wrap
    steps = np.array(
        [jnco.nco_phase_step(int(f), 240_000)
         for f in rng.integers(-120_000, 120_001, c)], np.uint32)
    steps[:4] = (0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1)  # -1, -2^31, ...
    for n in (0, 1, 10_240, 2**31 + 5, 2**32 - 1):
        ref = _np(jnco.nco_advance(jnp.asarray(phase0), jnp.asarray(steps), n))
        got = tnco.nco_advance(T(phase0.astype(np.int64)),
                               T(steps.astype(np.int64)), n)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("law", ["table", "factored"])
def test_nco_mix_tm(law):
    rng = np.random.default_rng(2)
    n, c = 2_560, 96
    i = rng.uniform(-1, 1, (n, c)).astype(np.float32)
    q = rng.uniform(-1, 1, (n, c)).astype(np.float32)
    p0 = rng.integers(0, 2**31, c).astype(np.uint32)
    st = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    jf, tf = ((jnco.nco_mix_tm, tnco.nco_mix_tm) if law == "table"
              else (jnco.nco_mix_tm_fast, tnco.nco_mix_tm_fast))
    ri, rq = jf(jnp.asarray(i), jnp.asarray(q), jnp.asarray(p0),
                jnp.asarray(st))
    gi, gq = tf(T(i), T(q), T(p0.astype(np.int64)), T(st.astype(np.int64)))
    # float32 sin/cos and mix rounding on |x| < 1.5
    np.testing.assert_allclose(gi.numpy(), _np(ri), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gq.numpy(), _np(rq), rtol=0, atol=1e-6)


def test_nco_mix_tm_exact_is_the_exact_angle():
    rng = np.random.default_rng(3)
    n, c = 512, 32
    i = rng.uniform(-1, 1, (n, c)).astype(np.float32)
    q = rng.uniform(-1, 1, (n, c)).astype(np.float32)
    p0 = rng.integers(0, 2**31, c)
    st = rng.integers(0, 2**32, c)
    gi, gq = tnco.nco_mix_tm_exact(T(i), T(q), T(p0), T(st))
    ph = (p0[None, :] + np.arange(n)[:, None] * st[None, :]) & (2**31 - 1)
    ang = ph * (2 * np.pi / 2**31)
    ei = i * np.cos(ang) + q * np.sin(ang)
    eq = q * np.cos(ang) - i * np.sin(ang)
    # float32 rounding of sin/cos and of the mix, |x| < 1.5
    np.testing.assert_allclose(gi.numpy(), ei, rtol=0, atol=3e-7)
    np.testing.assert_allclose(gq.numpy(), eq, rtol=0, atol=3e-7)


# ---- atan2 and demod ---------------------------------------------------

def test_atan2_within_2e7_with_edges():
    rng = np.random.default_rng(4)
    y = rng.standard_normal(20_000).astype(np.float32)
    x = rng.standard_normal(20_000).astype(np.float32)
    y[:8] = (0, 0, 0, 1, -1, 0, 2.5, -2.5)
    x[:8] = (0, -1, 3, 0, 0, -0.0, 2.5, -2.5)
    got = atan2(T(y), T(x)).numpy()
    ref = _np(j_atan2(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7)
    assert got[0] == 0.0  # atan2(0, 0) = 0
    assert got[1] == np.float32(np.pi)  # atan2(0, -x) = pi
    # and the polynomial is float32-close to the true arctangent, except
    # atan2(0, -0.0): both packages read -0.0 as +0 and give 0, not pi
    assert got[5] == 0.0
    keep = np.arange(y.size) != 5
    np.testing.assert_allclose(got[keep], np.arctan2(y, x)[keep], rtol=0,
                               atol=5e-7)


def test_demodulate_tm_all_modes_carried_lag():
    rng = np.random.default_rng(5)
    n, c = 1_024, 64
    mode = (np.arange(c) % len(MODES)).astype(np.int32)
    prev = rng.standard_normal((2, c)).astype(np.float32)
    jprev, tprev = jnp.asarray(prev), T(prev)
    for _ in range(2):  # the FM lag crosses the block boundary
        i = rng.standard_normal((n, c)).astype(np.float32)
        q = rng.standard_normal((n, c)).astype(np.float32)
        ra, jprev = j_demodulate_tm(jnp.asarray(i), jnp.asarray(q),
                                    jnp.asarray(mode), jprev)
        ga, tprev = demodulate_tm(T(i), T(q), T(mode), tprev)
        # float32 law rounding (sqrt, the atan2 polynomial, i +- q)
        np.testing.assert_allclose(ga.numpy(), _np(ra), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tprev.numpy(), _np(jprev))


# ---- spectrum ----------------------------------------------------------

def test_spectrum_accumulate_and_db():
    rng = np.random.default_rng(6)
    n, f = 8 * 512, 512
    t = np.arange(n) / 2.4e6
    z = (0.5 * np.exp(2j * np.pi * 37_000 * t)
         + 0.25 * np.exp(2j * np.pi * -410_000 * t)
         + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    x = np.stack([z.real, z.imag]).astype(np.float32)
    ref = _np(j_spectrum(jnp.asarray(x), f))
    got = spectrum_accumulate(T(x), f).numpy()
    # float32 512-term sums in two summation orders: 1e-5 relative to the
    # block's largest DFT magnitude
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    db_ref = _np(j_spectrum_db(jnp.asarray(ref[:, -1, :])))
    db_got = spectrum_db(T(got[:, -1, :])).numpy()
    live = db_ref > -100.0
    assert live.all()
    np.testing.assert_allclose(db_got[live], db_ref[live], rtol=0, atol=1e-3)
    # fftshift order: the +37 kHz tone sits just above the centre bin
    assert np.argmax(db_got) == f // 2 + round(37_000 / (2.4e6 / f))


# ---- FIR and filterbank --------------------------------------------------

@pytest.mark.parametrize("decimation,tile,passband", [
    (1, 128, 80_000), (5, 32, 8_000), (5, 64, 8_000), (1, 64, 200_000),
])
def test_fir_decimate_toeplitz_tm_carried_blocks(decimation, tile, passband):
    rng = np.random.default_rng(7 + decimation)
    n, c, k = 2_560, 48, 64
    w = jops.toeplitz_weights(jfd.design_lowpass_fir(passband, 240_000),
                              decimation, tile)
    hist = rng.uniform(-1, 1, (k - 1, c)).astype(np.float32)
    jh, th = jnp.asarray(hist), T(hist)
    for _ in range(2):  # the history carry crosses the block boundary
        x = rng.uniform(-1, 1, (n, c)).astype(np.float32)
        ry, jh = jops.fir_decimate_toeplitz_tm(jnp.asarray(x), jnp.asarray(w),
                                               decimation, jh)
        gy, th = tfir.fir_decimate_toeplitz_tm(T(x), T(w), decimation, th)
        assert gy.shape == (n // decimation, c)
        # float32 64-tap sums of |x| < 1 in two summation orders
        np.testing.assert_allclose(gy.numpy(), _np(ry), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(th.numpy(), _np(jh))


@pytest.mark.parametrize("bins,tpp,c", [(10, 16, 40), (8, 16, 24)])
def test_pfb_frames_and_direct_channelizer(bins, tpp, c):
    rng = np.random.default_rng(8 + bins)
    kp = bins * tpp
    n = 512 * bins
    proto = jch.design_prototype(2_400_000, bins, tpp)
    bidx = rng.integers(0, bins, c)
    w = jch.bin_weights_for_channels(proto, bins, bidx)
    hist = rng.uniform(-1, 1, (2, kp - 1)).astype(np.float32)
    jh, th = jnp.asarray(hist), T(hist)
    for _ in range(2):
        x = rng.uniform(-1, 1, (2, n)).astype(np.float32)
        rf, _ = jch.pfb_frames_tm(jnp.asarray(x), kp, bins, jh)
        gf, _ = tch.pfb_frames_tm(T(x), kp, bins, th)
        np.testing.assert_array_equal(gf.numpy(), _np(rf))  # a pure gather
        ri, rq, jh = jch.pfb_channelize_direct_tm(
            jnp.asarray(x), jnp.asarray(w), bins, jh)
        gi, gq, th = tch.pfb_channelize_direct_tm(T(x), T(w), bins, th)
        # float32 2*K_p-term sums of |x| < 1 against unit-gain weights
        np.testing.assert_allclose(gi.numpy(), _np(ri), rtol=0, atol=1e-5)
        np.testing.assert_allclose(gq.numpy(), _np(rq), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(th.numpy(), _np(jh))
        packed, same, _ = tch.pfb_channelize_direct_tm(
            T(x), T(w), bins, T(hist), split=False)
        assert packed is same and packed.shape == (n // bins, 2 * c)


# ---- the time-minor forms of the per-channel fallback --------------------

@pytest.mark.parametrize("broadcast", [False, True])
def test_nco_mix_time_minor(broadcast):
    rng = np.random.default_rng(20 + broadcast)
    n, c = 2_560, 24
    x = rng.uniform(-1, 1, (2, 1 if broadcast else c, n)).astype(np.float32)
    p0 = rng.integers(0, 2**31, c).astype(np.uint32)
    st = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    ref = jnco.nco_mix(jnp.asarray(x), jnp.asarray(p0), jnp.asarray(st))
    got = tnco.nco_mix(T(x), T(p0.astype(np.int64)), T(st.astype(np.int64)))
    assert got.shape == (2, c, n)
    # float32 sin and mix rounding on |x| < 1.5
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-6)
    # and it is the time-major mix transposed, bit for bit
    if not broadcast:
        gi, gq = tnco.nco_mix_tm(T(x[0].T.copy()), T(x[1].T.copy()),
                                 T(p0.astype(np.int64)),
                                 T(st.astype(np.int64)))
        torch.testing.assert_close(got[0], gi.T, rtol=0, atol=0)
        torch.testing.assert_close(got[1], gq.T, rtol=0, atol=0)


def test_demodulate_time_minor_all_modes_carried_lag():
    from webradio_tpu.ops.demod import demodulate as j_demodulate
    from webradio_tpu_torch.ops.demod import demodulate

    rng = np.random.default_rng(22)
    n, c = 1_024, 32
    mode = (np.arange(c) % len(MODES)).astype(np.int32)
    prev = rng.standard_normal((2, c)).astype(np.float32)
    jprev, tprev = jnp.asarray(prev), T(prev)
    for _ in range(2):  # the FM lag crosses the block boundary
        x = rng.standard_normal((2, c, n)).astype(np.float32)
        ra, jprev = j_demodulate(jnp.asarray(x), jnp.asarray(mode), jprev)
        ga, tprev = demodulate(T(x), T(mode), tprev)
        assert ga.shape == (c, n)
        # float32 law rounding (sqrt, the atan2 polynomial, i +- q)
        np.testing.assert_allclose(ga.numpy(), _np(ra), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tprev.numpy(), _np(jprev))
        assert tprev.is_contiguous()


@pytest.mark.parametrize("decimation", [1, 5])
@pytest.mark.parametrize("shared", [True, False])
def test_fir_decimate_carried_blocks(shared, decimation):
    rng = np.random.default_rng(23 + decimation + shared)
    c, n, k = 12, 2_560, 64
    designs = [jfd.design_lowpass_fir(bw, 240_000) for bw in (12_500, 80_000)]
    coeff = designs[1] if shared else np.stack(
        [designs[i % 2] for i in range(c)])
    hist = rng.uniform(-1, 1, (2, c, k - 1)).astype(np.float32)
    jh, th = jnp.asarray(hist), T(hist)
    for _ in range(2):
        x = rng.uniform(-1, 1, (2, c, n)).astype(np.float32)
        ry, jh = jops.fir_decimate(jnp.asarray(x), jnp.asarray(coeff),
                                   decimation, jh)
        gy, th = tfir.fir_decimate(T(x), T(coeff), decimation, th)
        assert gy.shape == (2, c, n // decimation)
        # 64-term float32 sums of |x| < 1 against unit-gain kernels, tap by
        # tap in the same order
        np.testing.assert_allclose(gy.numpy(), _np(ry), rtol=0, atol=2e-6)
        np.testing.assert_array_equal(th.numpy(), _np(jh))
        assert np.abs(_np(ry)).max() > 0.1
    with pytest.raises(ValueError, match="multiple of the decimation"):
        tfir.fir_decimate(T(x)[..., :-1], T(coeff), 5, th)


@pytest.mark.parametrize("decimation,tile", [(1, 128), (5, 32)])
def test_fir_decimate_toeplitz_time_minor_and_dispatch(decimation, tile):
    rng = np.random.default_rng(25 + decimation)
    c, n, k = 8, 5_120, 64
    h = jfd.design_lowpass_fir(80_000 if decimation == 1 else 8_000, 240_000)
    w = tfir.toeplitz_weights(h, decimation, tile)
    rows = np.tile(h, (c, 1))
    hist = rng.uniform(-1, 1, (c, k - 1)).astype(np.float32)
    jh, th = jnp.asarray(hist), T(hist)
    for _ in range(2):
        x = rng.uniform(-1, 1, (c, n)).astype(np.float32)
        ry, jh2 = jops.fir_decimate_toeplitz(jnp.asarray(x), jnp.asarray(w),
                                             decimation, jh)
        gy, th2 = tfir.fir_decimate_toeplitz(T(x), T(w), decimation, th)
        np.testing.assert_allclose(gy.numpy(), _np(ry), rtol=0, atol=2e-6)
        # the dispatcher takes this form when the shared weights fit...
        dy, dh = tfir.fir_dispatch(T(x), T(rows), T(w), decimation, th)
        torch.testing.assert_close(dy, gy, rtol=0, atol=0)
        jy, _ = jops.fir_dispatch(jnp.asarray(x), jnp.asarray(rows),
                                  jnp.asarray(w), decimation, jh)
        np.testing.assert_allclose(dy.numpy(), _np(jy), rtol=0, atol=2e-6)
        # ...and the per-channel form without them, or on a block that is
        # not whole tiles; both forms agree to float32 rounding
        py, ph = tfir.fir_dispatch(T(x), T(rows), None, decimation, th)
        np.testing.assert_allclose(py.numpy(), gy.numpy(), rtol=0, atol=2e-6)
        odd = n - 5 * 16
        oy, _ = tfir.fir_dispatch(T(x[:, :odd]), T(rows), T(w), decimation,
                                  th)
        ey, _ = tfir.fir_decimate(T(x[:, :odd]), T(rows), decimation, th)
        torch.testing.assert_close(oy, ey, rtol=0, atol=0)
        np.testing.assert_array_equal(th2.numpy(), _np(jh2))
        torch.testing.assert_close(dh, ph, rtol=0, atol=0)
        jh, th = jh2, th2


@pytest.mark.parametrize("bins,tpp,c", [(10, 16, 40), (8, 16, 24)])
def test_pfb_channelize_direct_time_minor(bins, tpp, c):
    rng = np.random.default_rng(28 + bins)
    kp = bins * tpp
    n = 512 * bins
    proto = jch.design_prototype(2_400_000, bins, tpp)
    w = jch.bin_weights_for_channels(proto, bins, rng.integers(0, bins, c))
    hist = rng.uniform(-1, 1, (2, kp - 1)).astype(np.float32)
    jh, th = jnp.asarray(hist), T(hist)
    for _ in range(2):
        x = rng.uniform(-1, 1, (2, n)).astype(np.float32)
        ry, jh = jch.pfb_channelize_direct(jnp.asarray(x), jnp.asarray(w),
                                           bins, jh)
        gy, th = tch.pfb_channelize_direct(T(x), T(w), bins, th)
        assert gy.shape == (2, c, n // bins) and gy.is_contiguous()
        # float32 2*K_p-term sums of |x| < 1 against unit-gain weights
        np.testing.assert_allclose(gy.numpy(), _np(ry), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(th.numpy(), _np(jh))
