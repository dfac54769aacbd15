"""The split-precision tensor-core products of the port's CUDA tails, held
against the JAX package on the CPU.

The CUDA kernels make the shaping FIR as a three-term TF32 product
(``a_lo b_hi + a_hi b_lo + a_hi b_hi``, float32 sums), their ``fast`` LO is
exact on the first two rows of every 16 and rotated between, the decimating
audio FIR at decimation 5 is a banded three-term product too (8 outputs per
40 rows, window 104 rows), and the fused-filterbank kernel's product is a
float32 FMA chain per output, which is what a float32 matmul computes. No
CUDA kernel runs here, so these tests run the plain emulations of that
arithmetic, ``ops.precision.matmul_tf32x3`` (the shaping FIR as 16-row
tiles of the banded Toeplitz matrix times an 80-row window),
``ops.fir.fir_decimate_banded_tf32x3_tm`` and
``ops.nco.nco_mix_tm_rotated``, and feed them through the rest of the plain
tail. The result must stay within the stated bounds of the JAX functions
``fused_tail_tm``, ``fused_tail_audio_tm`` and ``fused_pfb_tail_audio_tm``
(Pallas in interpret mode, filterbank at ``Precision.HIGHEST``): audio
1e-5, mixed carries and FM lag 1e-6 (2e-6 behind the in-kernel filterbank
product), power rtol 1e-5, raw FM rows by the rule of
``tests/test_torch_tail_chanrate.py``. Two carried blocks, one demod law per
case, both LO laws.

A kernel warp orders its 16 channels by demod law
(``ops.tail_tm.law_sorted_columns`` is that rule in Python); section (4)
pins the rule down.

The kernels keep no second copy of the filterbank weights: the packed
``[2 K_p, 2 C]`` operand is a view of ``params.pfb_weights`` and is split
inside the kernel, so a slot scatter or a capacity growth cannot leave a
stale copy behind. The last tests pin that down.
"""

import numpy as np
import pytest
import torch

from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import (
    channelizer,
    demod,
    fir,
    firdesign,
    nco,
    tail_tm,
)
from webradio_tpu_torch.ops.precision import (
    full_fp32,
    matmul_tf32x3,
    round_tf32,
    split_tf32,
    trunc_tf32,
)
from webradio_tpu_torch.pipeline import channelized as ch

K, D, C = 64, 5, 128
CHUNK = tail_tm.CHUNK_ROWS
LAWS = ("AM", "FM", "USB", "LSB")
T = torch.from_numpy

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))


# ---- (1) the split itself

@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e3, 1e30])
def test_split_tf32_is_exact_and_hi_is_a_tf32_value(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = T((rng.standard_normal(50_000) * scale).astype(np.float32))
    hi, lo = split_tf32(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi, round_tf32(x))
    # round to nearest: lo is at most half a TF32 step of x
    assert float((lo.abs() / x.abs()).max()) <= 2.0 ** -11
    # lo has at most 12 significant bits, so reading 11 of them (what a
    # tensor-core operand does) leaves at most 2^-23 of x behind
    left = lo - trunc_tf32(lo)
    assert float((left.abs() / x.abs()).max()) <= 2.0 ** -23
    assert not (trunc_tf32(lo).view(torch.int32) & 0x1FFF).any()


def test_three_term_product_error_follows_the_terms_where_the_sum_cancels():
    """Frames of a strong carrier against windowed filters whose stopband
    holds it: each product cancels to a small share of its terms, as in a
    filterbank slot beside a strong carrier. The three-term product's
    error is relative to the terms, a float32 matmul's to its partial sums,
    so there the split is several times further from the exact product.
    (This is why the fused-filterbank kernel's product is not made so.)"""
    rng = np.random.default_rng(6)
    n, k, cols = 512, 320, 64
    t = np.arange(n)[:, None] + np.arange(k)[None, :]
    a = np.cos(2 * np.pi * 0.31 * t) + 0.01 * rng.standard_normal((n, k))
    window = np.hanning(k)[:, None] / k
    b = window * np.cos(2 * np.pi * np.linspace(0.0, 0.1, cols)[None, :]
                        * np.arange(k)[:, None])
    a, b = T(a.astype(np.float32)), T(b.astype(np.float32))
    exact = a.double() @ b.double()
    terms = a.double().abs() @ b.double().abs()
    assert float(exact.abs().mean() / terms.mean()) < 1e-2  # it cancels
    rms = lambda p: float((p.double() - exact).pow(2).mean().sqrt())
    err32, err3 = rms(a @ b), rms(matmul_tf32x3(a, b))
    assert 2 * err32 <= err3 <= 2.0 ** -22 * float(terms.max())


def test_three_term_product_is_float32_accurate():
    rng = np.random.default_rng(5)
    a = T(rng.uniform(-0.5, 0.5, (64, 320)).astype(np.float32))
    b = T(rng.uniform(-0.5, 0.5, (320, 128)).astype(np.float32))
    exact = a.double() @ b.double()
    err3 = float((matmul_tf32x3(a, b).double() - exact).abs().max())
    err32 = float(((a @ b).double() - exact).abs().max())
    a_hi, b_hi = round_tf32(a), round_tf32(b)
    err1 = float(((a_hi @ b_hi).double() - exact).abs().max())
    assert err3 <= 2 * err32  # as good as a float32 matmul
    assert err1 >= 100 * err3  # and nothing like one TF32 pass


# ---- (2) the kernels' arithmetic through the plain tail, against JAX

def _band_fir_tf32x3(m, h_rev, hist):
    """Shaping FIR of ``m [nd, C]`` as the CUDA body computes it: per
    16-row chunk, ``Y[16, C] = T[16, 80] . window[80, C]`` with the banded
    ``T[r, j] = h_rev[j - r - 1]`` and the window's rows ``n0-64..n0+15``
    (one padding row, the K-1 rows before the chunk, the chunk)."""
    nd, c = m.shape
    band = torch.zeros(CHUNK, K + CHUNK)
    for r in range(CHUNK):
        band[r, r + 1:r + 1 + K] = h_rev
    ext = torch.cat([torch.zeros(1, c), hist, m])  # row i is stream row i-64
    win = ext.unfold(0, K + CHUNK, CHUNK)  # [nd/16, C, 80]
    y = matmul_tf32x3(band, win.transpose(1, 2).contiguous())
    return y.reshape(nd, c)


def _shape_demod_emulated(mi, mq, w, mode, hist_i, hist_q, prev):
    h_rev = w[:K, 0]
    yi = _band_fir_tf32x3(mi, h_rev, hist_i)
    yq = _band_fir_tf32x3(mq, h_rev, hist_q)
    audio, new_prev = demod.demodulate_tm(yi, yq, mode, prev)
    power = (yi * yi + yq * yq).sum(dim=0) * (1.0 / yi.shape[0])
    return audio, mi[-(K - 1):], mq[-(K - 1):], new_prev, power


def _mixed_as_kernel(prod, phase0, step, fast):
    """The packed product mixed as the CUDA body mixes it: the rotated LO
    for ``fast``, else the table law (which the plain version shares)."""
    c = prod.shape[1] // 2
    mix = nco.nco_mix_tm_rotated if fast else nco.nco_mix_tm
    return mix(prod[:, :c], prod[:, c:], phase0, step)


def _assert_raw(got, ref, fm):
    err = got - ref
    err[:, fm] -= np.round(err[:, fm])
    err = np.abs(err)
    if (~fm).any():
        assert err[:, ~fm].max() <= 1e-5
    if fm.any():
        assert (err[:, fm] > 1e-5).sum() <= 1e-4 * err[:, fm].size
        assert err[:, fm].max() <= 1e-3


def _advance(phase, step, n):
    return ((phase.astype(np.int64) + n * step.astype(np.int64))
            & 0x7FFFFFFF).astype(np.uint32)


def _lo(rng):
    return (rng.integers(0, 2**31, C).astype(np.uint32),
            rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("law", LAWS)
def test_banded_tf32x3_shaping_fir_holds_the_chanrate_bounds(law, fast):
    import jax.numpy as jnp
    from webradio_tpu.ops.pallas_tail_tm import fused_tail_tm as j_tail

    nd = 2_048
    rng = np.random.default_rng(100 + 2 * LAWS.index(law) + fast)
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)
    w = fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000, 240_000),
                             1, 128)
    mode = np.full(C, LAWS.index(law), np.int32)
    fm = mode == 1
    phase, step = _lo(rng)
    carry = (u(K - 1, C), u(K - 1, C), u(2, C))
    j_carry = tuple(jnp.asarray(a) for a in carry)
    t_carry = tuple(T(a) for a in carry)
    peak = 0.0
    for _ in range(2):  # every carry crosses the block boundary
        prod = u(nd, 2 * C)
        ref = j_tail(jnp.asarray(prod), jnp.asarray(prod), jnp.asarray(phase),
                     jnp.asarray(step), jnp.asarray(w), jnp.asarray(mode),
                     *j_carry, packed=True, fast=fast)
        ref = [np.asarray(a) for a in ref]
        lo = (T(phase.astype(np.int64)), T(step.astype(np.int64)))
        mi, mq = _mixed_as_kernel(T(prod), *lo, fast)
        got = _shape_demod_emulated(mi, mq, T(w), T(mode), *t_carry)
        audio, hist_i, hist_q, prev, power = (g.numpy() for g in got)
        _assert_raw(audio, ref[0], fm)
        np.testing.assert_allclose(hist_i, ref[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(hist_q, ref[2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(prev, ref[3], rtol=0, atol=1e-6)
        np.testing.assert_allclose(power, ref[4], rtol=1e-5, atol=0)
        peak = max(peak, float(np.abs(ref[0]).max()))
        j_carry = tuple(jnp.asarray(a) for a in ref[1:4])
        t_carry = got[1:4]
        phase = _advance(phase, step, nd)
    assert peak > 1e-2  # a silent FIR would pass every bound above


BLOCK, BINS, TAPS = 25_600, 10, 16
ND, KP = BLOCK // BINS, BINS * TAPS
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-450_000.0, "FM", 700.0), (700_000.0, "AM", 1_300.0))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("law", LAWS)
def test_kernel_arithmetic_holds_the_fused_pfb_bounds(law, fast):
    import jax.numpy as jnp
    from jax import lax
    from webradio_tpu.ops.pallas_tail_tm import (
        fused_pfb_tail_audio_tm as j_tail,
    )

    seed = 200 + 2 * LAWS.index(law) + fast
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)
    proto = channelizer.design_prototype(2_400_000, BINS, TAPS)
    ifs = np.linspace(-900_000, 900_000, C).astype(np.int64)
    bin_idx, _ = channelizer.assign_bins(ifs, 2_400_000, BINS)
    weights = channelizer.bin_weights_for_channels(
        proto, BINS, bin_idx).reshape(2 * KP, 2 * C)
    # noise well above the carriers, so that in every slot the slot's own
    # signal conditions the FM angle and not the rounding of the strong
    # carriers' terms, which differs between any two float32 sums of them
    # (here torch's matmul and XLA's dot; see the cancelling test above)
    src = ToneSource(carriers=CARRIERS, noise=4.0, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, BLOCK, False
    w = fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000, 240_000),
                             1, 128)
    wa = fir.toeplitz_weights(firdesign.design_lowpass_fir(8_000, 240_000),
                              D, 32)
    mode = np.full(C, LAWS.index(law), np.int32)
    fm = mode == 1
    phase, step = _lo(rng)
    carry = (u(K - 1, C), u(K - 1, C), u(2, C), u(K - 1, C))
    j_carry = tuple(jnp.asarray(a) for a in carry)
    t_carry = tuple(T(a) for a in carry)
    pfb_hist = T(u(2, KP - 1))
    peak = 0.0
    for _ in range(2):
        z = src.read_block()
        iq = T(np.stack([z.real, z.imag]).astype(np.float32))
        frames, pfb_hist = channelizer.pfb_frames_tm(iq, KP, BINS, pfb_hist)
        ref = j_tail(jnp.asarray(frames.numpy()), jnp.asarray(weights),
                     jnp.asarray(phase), jnp.asarray(step), jnp.asarray(w),
                     jnp.asarray(wa), D, jnp.asarray(mode), *j_carry,
                     fast=fast, pfb_precision=lax.Precision.HIGHEST)
        ref = [np.asarray(a) for a in ref]
        with full_fp32():  # the kernel's product is the matmul's chain
            y2 = frames @ T(weights)
        lo = (T(phase.astype(np.int64)), T(step.astype(np.int64)))
        mi, mq = _mixed_as_kernel(y2, *lo, fast)
        demod_rows, hist_i, hist_q, prev, power = _shape_demod_emulated(
            mi, mq, T(w), T(mode), *t_carry[:3])
        # the kernel's audio FIR at D=5: the banded three-term product
        a48, ahist = fir.fir_decimate_banded_tf32x3_tm(
            demod_rows, T(wa)[:K, 0], D, t_carry[3])
        np.testing.assert_allclose(a48.numpy(), ref[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(hist_i.numpy(), ref[1], rtol=0, atol=2e-6)
        np.testing.assert_allclose(hist_q.numpy(), ref[2], rtol=0, atol=2e-6)
        np.testing.assert_allclose(prev.numpy(), ref[3], rtol=0, atol=2e-6)
        # the carried demod tail is 63 raw rows
        _assert_raw(ahist.numpy().copy(), ref[4], fm)
        np.testing.assert_allclose(power.numpy(), ref[5], rtol=1e-5, atol=0)
        peak = max(peak, float(np.abs(ref[0]).max()))
        j_carry = tuple(jnp.asarray(a) for a in ref[1:5])
        t_carry = (hist_i, hist_q, prev, ahist)
        phase = _advance(phase, step, ND)
    assert peak > 1e-2  # a silent FIR would pass every bound above


# ---- (3) the kernel's weight operand is the parameters themselves

def _params(c, ifs, modes):
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=BLOCK,
                               tail_kernel="pallas_pfb")
    return cfg, ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                           device="cpu")


def _operand(cfg, params):
    return params.pfb_weights.reshape(2 * cfg.proto_taps,
                                      2 * cfg.num_channels)


@pytest.mark.parametrize("idx", [[0], [3, 17, 100], list(range(64, 128))])
def test_weight_operand_follows_a_slot_scatter(idx):
    ifs = [int(f) for f in np.linspace(-1_000_000, 1_000_000, C)]
    modes = [LAWS[i % 4] for i in range(C)]
    cfg, params = _params(C, ifs, modes)
    before = _operand(cfg, params)
    ifs2, modes2 = list(ifs), list(modes)
    for n, i in enumerate(idx):
        ifs2[i], modes2[i] = 7_000 * (n + 1) - 300_000, LAWS[(i + 1) % 4]
    _, sub = _params(len(idx), [ifs2[i] for i in idx],
                     [modes2[i] for i in idx])
    params = ch.scatter_params_slots(params, idx, sub)
    after = _operand(cfg, params)
    _, fresh = _params(C, ifs2, modes2)
    # the operand is a view of the parameters (no copy to fall behind),
    # laid out as the kernel takes it, and equal to a fresh build
    assert after.data_ptr() == params.pfb_weights.data_ptr()
    assert after.data_ptr() == before.data_ptr()
    assert after.is_contiguous() and after.data_ptr() % 16 == 0
    assert torch.equal(after, _operand(cfg, fresh))
    hi, lo = split_tf32(after)
    fresh_hi, fresh_lo = split_tf32(_operand(cfg, fresh))
    assert torch.equal(hi, fresh_hi) and torch.equal(lo, fresh_lo)
    assert not torch.equal(after[:, idx[0]], torch.zeros(2 * cfg.proto_taps))


@pytest.mark.parametrize("grown", [2 * C, 4 * C])
def test_weight_operand_after_a_capacity_growth(grown):
    ifs = [int(f) for f in np.linspace(-1_000_000, 1_000_000, C)]
    modes = [LAWS[i % 4] for i in range(C)]
    cfg, params = _params(C, ifs, modes)
    pad = grown - C
    wide_cfg, wide = _params(grown, ifs + [0] * pad, modes + ["AM"] * pad)
    state = ch.grow_channelized_state(
        ch.init_channelized_state(cfg, device="cpu"), grown)
    assert state.chan_hist.shape == (2, grown, K - 1)
    narrow, op = _operand(cfg, params), _operand(wide_cfg, wide)
    assert op.data_ptr() == wide.pfb_weights.data_ptr()
    assert op.shape == (2 * cfg.proto_taps, 2 * grown)
    # the old slots' I and Q columns carry over value for value
    assert torch.equal(op[:, :C], narrow[:, :C])
    assert torch.equal(op[:, grown:grown + C], narrow[:, C:])
    assert grown % tail_tm.CHAN_TILE == 0
    assert tail_tm.tile_rows_for(cfg.chan_frames, grown) == tail_tm.TILE_ROWS


# ---- (4) the audio FIR on the tensor cores, and the warp's column order

def _audio_weights():
    w = fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000, 240_000),
                             1, 128)
    wa = fir.toeplitz_weights(firdesign.design_lowpass_fir(8_000, 240_000),
                              D, 32)
    return w, wa


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("law", LAWS)
def test_banded_tf32x3_audio_fir_holds_the_audio_bounds(law, fast):
    """The whole of kernel #1's arithmetic (rotated LO, banded three-term
    shaping FIR, demod, banded three-term audio FIR at D=5) against the JAX
    ``fused_tail_audio_tm``: audio 1e-5 at an audio peak above 1e-2."""
    import jax.numpy as jnp
    from webradio_tpu.ops.pallas_tail_tm import fused_tail_audio_tm as j_tail

    nd = 2_560
    rng = np.random.default_rng(300 + 2 * LAWS.index(law) + fast)
    u = lambda *s: rng.uniform(-0.5, 0.5, s).astype(np.float32)
    w, wa = _audio_weights()
    mode = np.full(C, LAWS.index(law), np.int32)
    fm = mode == 1
    phase, step = _lo(rng)
    carry = (u(K - 1, C), u(K - 1, C), u(2, C), u(K - 1, C))
    j_carry = tuple(jnp.asarray(a) for a in carry)
    t_carry = tuple(T(a) for a in carry)
    peak = 0.0
    for _ in range(2):  # every carry crosses the block boundary
        prod = u(nd, 2 * C)
        ref = j_tail(jnp.asarray(prod), jnp.asarray(prod), jnp.asarray(phase),
                     jnp.asarray(step), jnp.asarray(w), jnp.asarray(wa), D,
                     jnp.asarray(mode), *j_carry, packed=True, fast=fast)
        ref = [np.asarray(a) for a in ref]
        lo = (T(phase.astype(np.int64)), T(step.astype(np.int64)))
        mi, mq = _mixed_as_kernel(T(prod), *lo, fast)
        demod_rows, hist_i, hist_q, prev, power = _shape_demod_emulated(
            mi, mq, T(w), T(mode), *t_carry[:3])
        a48, ahist = fir.fir_decimate_banded_tf32x3_tm(
            demod_rows, T(wa)[:K, 0], D, t_carry[3])
        assert a48.shape == (nd // D, C)
        np.testing.assert_allclose(a48.numpy(), ref[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(hist_i.numpy(), ref[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(hist_q.numpy(), ref[2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(prev.numpy(), ref[3], rtol=0, atol=1e-6)
        _assert_raw(ahist.numpy().copy(), ref[4], fm)
        np.testing.assert_allclose(power.numpy(), ref[5], rtol=1e-5, atol=0)
        peak = max(peak, float(np.abs(ref[0]).max()))
        j_carry = tuple(jnp.asarray(a) for a in ref[1:5])
        t_carry = (hist_i, hist_q, prev, ahist)
        phase = _advance(phase, step, nd)
    assert peak > 1e-2  # a silent FIR would pass every bound above


@pytest.mark.parametrize("d,outputs", [(5, 8), (5, 16), (4, 8), (1, 16)])
def test_banded_audio_fir_emulation_matches_the_toeplitz_fir(d, outputs):
    """The emulation computes the decimating FIR of the plain version, to
    float32 rounding, whatever the tile; its band spans ``(outputs - 1) d +
    K`` rows behind one padding column (139 at 16 outputs and D=5)."""
    rng = np.random.default_rng(31 + d + outputs)
    n = 4 * d * 16
    x = T(rng.uniform(-1, 1, (n, 8)).astype(np.float32))
    hist = T(rng.uniform(-1, 1, (K - 1, 8)).astype(np.float32))
    wa = T(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(8_000, 240_000), d, 64))
    want, want_hist = fir.fir_decimate_toeplitz_tm(x, wa, d, hist)
    got, got_hist = fir.fir_decimate_banded_tf32x3_tm(x, wa[:K, 0], d, hist,
                                                     outputs=outputs)
    assert got.shape == (n // d, 8) and float(want.abs().max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(got_hist, want_hist)
    with pytest.raises(ValueError, match="group"):
        fir.fir_decimate_banded_tf32x3_tm(x[:-d], wa[:K, 0], d, hist,
                                          outputs=outputs)
    with pytest.raises(ValueError, match="history"):
        fir.fir_decimate_banded_tf32x3_tm(x, wa[:K, 0], d, hist[1:],
                                          outputs=outputs)


def _classes(mode, cols):
    return [[mode[cols[4 * t + cc]] for t in range(4)] for cc in range(4)]


@pytest.mark.parametrize("mode", [
    [0] * 16, [1] * 16, [3] * 16,               # one law on every slot
    [0, 1, 2, 3] * 4, [1, 1, 0, 2] * 4,         # period 4
])
def test_column_order_is_the_identity_where_the_classes_are_uniform(mode):
    cols = tail_tm.law_sorted_columns(mode)
    assert cols == list(range(16))
    assert all(len(set(c)) == 1 for c in _classes(mode, cols))


@pytest.mark.parametrize("mode", [
    [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4,      # sorted already
    [3] * 4 + [2] * 4 + [1] * 4 + [0] * 4,
    [1, 0] * 8, [0] * 12 + [1] * 4, [1] * 4 + [0] * 12,
    [0, 1, 2, 3, 3, 2, 1, 0] * 2, [2, 2, 1, 1] * 2 + [0] * 8,
])
def test_column_order_makes_every_class_share_a_law(mode):
    """Law counts that are multiples of four: every column class (the four
    columns one kernel instruction demodulates) comes out uniform."""
    cols = tail_tm.law_sorted_columns(mode)
    assert sorted(cols) == list(range(16))
    assert all(len(set(c)) == 1 for c in _classes(mode, cols))


def test_column_order_is_a_stable_permutation_for_any_mode():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=300, deadline=None, database=None,
              derandomize=True)
    @given(st.lists(st.integers(-2, 7), min_size=16, max_size=16))
    def check(mode):
        cols = tail_tm.law_sorted_columns(mode)
        assert sorted(cols) == list(range(16))  # a permutation
        assert cols == tail_tm.law_sorted_columns(list(mode))  # a function
        key = [m if 0 <= m <= 3 else 3 for m in mode]
        if all(key[j] == key[j % 4] for j in range(16)):
            assert cols == list(range(16))
            return
        # the kernel's form of the rule: a channel's sorted position is the
        # count of channels of lower laws plus that of earlier ones of its
        # own (two population counts of warp ballots)
        by_col = [None] * 16
        for j in range(16):
            pos = (sum(k < key[j] for k in key)
                   + sum(key[i] == key[j] for i in range(j)))
            by_col[4 * (pos % 4) + pos // 4] = j
        assert by_col == cols
        # dealt back in class order the channels are sorted by law, and
        # channels of one law keep their order (stable)
        dealt = [cols[4 * t + cc] for cc in range(4) for t in range(4)]
        assert [key[j] for j in dealt] == sorted(key)
        for a, b in zip(dealt, dealt[1:]):
            assert key[a] < key[b] or a < b
        # a class mixes laws only where one law's run ends inside it: never
        # when every law's count is a multiple of 4
        mixed = sum(len(set(key[j] for j in dealt[4 * cc:4 * cc + 4])) > 1
                    for cc in range(4))
        assert mixed <= len(set(key)) - 1
        if all(key.count(law) % 4 == 0 for law in range(4)):
            assert mixed == 0

    check()
    # a partial last warp: the kernel's channels past the count sort as
    # law 3, the default
    assert (tail_tm.law_sorted_columns([0] * 8)
            == tail_tm.law_sorted_columns([0] * 8 + [3] * 8))
    assert tail_tm.law_sorted_columns([1] * 5) == tail_tm.law_sorted_columns(
        [1] * 5 + [7] * 11)
    for bad in ([], [0] * 17):
        with pytest.raises(ValueError, match="1 to 16 channels"):
            tail_tm.law_sorted_columns(bad)
