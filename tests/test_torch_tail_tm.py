"""The port's fused receiver tail against the JAX package's Pallas kernel.

On the CPU ``webradio_tpu_torch.ops.tail_tm.fused_tail_audio_tm`` runs its
plain torch version; the JAX side runs the Pallas kernel in interpret mode
(as ``tests/test_pallas_tail_tm.py`` does). Two carried blocks, all four
demod laws, both LO laws. The CUDA kernel is compared with the plain
version by the ``cuda``-marked tests, which skip where torch sees no card.
The card's machine has no JAX, so JAX is imported inside the CPU tests
only; there the file runs with ``--noconftest -m cuda`` (README).

Inputs are uniform in [-0.5, 0.5): the level of a carrier of the repo's
tone source through the unit-gain filterbank. The bounds are absolute at
that level. With ``fast=True`` the port evaluates the exact 31-bit LO
angle per sample, while the JAX kernel's factored phasor rounds two
float32 angles (up to ~5e-7 rad), which bounds the mixed-history gap.
"""

import math

import numpy as np
import pytest
import torch

from webradio_tpu_torch.ops import fir, firdesign, tail_tm

ND, C, K, D = 2_560, 128, 64, 5
T = torch.from_numpy

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))


def _setup(seed):
    rng = np.random.default_rng(seed)
    w = fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000, 240_000),
                             1, 128)
    wa = fir.toeplitz_weights(firdesign.design_lowpass_fir(8_000, 240_000),
                              D, 32)
    u = lambda *shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return dict(
        rng=rng, w=w, wa=wa, u=u,
        phase0=rng.integers(0, 2**31, C).astype(np.uint32),
        step=rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32),
        mode=(np.arange(C) % 4).astype(np.int32),
        carry=(u(K - 1, C), u(K - 1, C), u(2, C), u(K - 1, C)),
    )


def _advance(phase, step, n):
    return ((phase.astype(np.int64) + n * step.astype(np.int64))
            & 0x7FFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fast", [True, False])
def test_plain_tail_matches_pallas_kernel(fast, packed):
    import jax.numpy as jnp
    from webradio_tpu.ops.pallas_tail_tm import fused_tail_audio_tm as j_tail

    s = _setup(11 + 2 * fast + packed)
    j_carry = tuple(jnp.asarray(a) for a in s["carry"])
    t_carry = tuple(T(a) for a in s["carry"])
    phase = s["phase0"]
    launches = tail_tm.fused_tail_audio_tm.launches
    for _ in range(2):  # every carry crosses the block boundary
        if packed:
            prod = s["u"](ND, 2 * C)
            j_in = (jnp.asarray(prod),) * 2
            t_in = (T(prod),) * 2
        else:
            ci, cq = s["u"](ND, C), s["u"](ND, C)
            j_in = (jnp.asarray(ci), jnp.asarray(cq))
            t_in = (T(ci), T(cq))
        ref = j_tail(*j_in, jnp.asarray(phase), jnp.asarray(s["step"]),
                     jnp.asarray(s["w"]), jnp.asarray(s["wa"]), D,
                     jnp.asarray(s["mode"]), *j_carry, packed=packed,
                     fast=fast)
        got = tail_tm.fused_tail_audio_tm(
            *t_in, T(phase.astype(np.int64)),
            T(s["step"].astype(np.int64)), T(s["w"]), T(s["wa"]), D,
            T(s["mode"]), *t_carry, packed=packed, fast=fast)
        ref = [np.asarray(a) for a in ref]
        a48, hist_i, hist_q, prev, ahist, power = (g.numpy() for g in got)
        assert a48.shape == (ND // D, C)
        np.testing.assert_allclose(a48, ref[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(hist_i, ref[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(hist_q, ref[2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(prev, ref[3], rtol=0, atol=1e-6)
        np.testing.assert_allclose(ahist, ref[4], rtol=0, atol=1e-5)
        np.testing.assert_allclose(power, ref[5], rtol=1e-5, atol=0)
        assert np.abs(ref[0]).max() > 1e-3  # not zeros against zeros
        j_carry = tuple(jnp.asarray(a) for a in ref[1:5])
        t_carry = got[1:5]
        phase = _advance(phase, s["step"], ND)
    # CPU tensors never reach the kernel
    assert tail_tm.fused_tail_audio_tm.launches == launches


def test_tail_rejects_unknown_precision_and_device():
    s = _setup(3)
    args = [torch.zeros(ND, 2 * C)] * 2 + [
        T(s["phase0"].astype(np.int64)), T(s["step"].astype(np.int64)),
        T(s["w"]), T(s["wa"]), D, T(s["mode"])] + [T(a) for a in s["carry"]]
    with pytest.raises(ValueError, match="precision"):
        tail_tm.fused_tail_audio_tm(*args, precision="bf16x9", packed=True)
    for tier in tail_tm.PRECISIONS:  # every FIR tier is fp32 here
        tail_tm.fused_tail_audio_tm(*args, precision=tier, packed=True)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="no tail kernel"):
        tail_tm.fused_tail_audio_tm(*meta, packed=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [128, 640, ND])
@pytest.mark.parametrize("fast", [True, False])
def test_kernel_matches_plain_version_on_card(cuda_device, fast, tile_rows):
    s = _setup(21 + fast)
    dev = cuda_device
    carry = tuple(T(a).to(dev) for a in s["carry"])
    ref_carry = carry
    phase = s["phase0"]
    for _ in range(2):
        prod = T(s["u"](ND, 2 * C)).to(dev)
        common = (T(phase.astype(np.int64)).to(dev),
                  T(s["step"].astype(np.int64)).to(dev),
                  T(s["w"]).to(dev), T(s["wa"]).to(dev), D,
                  T(s["mode"]).to(dev))
        before = tail_tm.fused_tail_audio_tm.launches
        # the wrapper always tiles by TILE_ROWS; other heights go through
        # its launcher to cover the halo recompute at the tile edges
        got = tail_tm._launch(prod, prod, *common, *carry, True, fast,
                              tile_rows)
        torch.cuda.synchronize()
        assert tail_tm.fused_tail_audio_tm.launches == before + 1
        ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common,
                                              *ref_carry, packed=True,
                                              fast=fast)
        for g, r, atol in zip(got, ref, (1e-5, 1e-6, 1e-6, 1e-6, 1e-5)):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=atol)
        np.testing.assert_allclose(got[5].cpu().numpy(),
                                   ref[5].cpu().numpy(), rtol=1e-5, atol=0)
        carry, ref_carry = got[1:5], ref[1:5]
        phase = _advance(phase, s["step"], ND)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 32, 64, 100, 256, 511])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_at_any_channel_count_on_card(cuda_device, c, bf16):
    """Every width the card's selection sends to the kernel, the partial
    last block of 64 (and a partial warp of 16) included, over two carried
    blocks against the plain version on the same inputs; the "bf16" tier's
    product wants a multiple of 4 channels and refuses 511."""
    rng = np.random.default_rng(c + 7 * bf16)
    dev = cuda_device
    u = lambda *shape: T(rng.uniform(-0.5, 0.5, shape).astype(
        np.float32)).to(dev)
    s = _setup(41)
    step = T(rng.integers(0, 2**32, c)).to(dev)
    phase = T(rng.integers(0, 2**31, c)).to(dev)
    mode = T(rng.integers(0, 4, c).astype(np.int32)).to(dev)
    carry = ref_carry = (u(K - 1, c), u(K - 1, c), u(2, c), u(K - 1, c))
    for _ in range(2):
        prod = u(ND, 2 * c)
        if bf16:
            prod = prod.bfloat16()
        args = (phase, step, T(s["w"]).to(dev), T(s["wa"]).to(dev), D, mode)
        if tail_tm.shape_refusal(ND, c, D, bf16=bf16):
            assert bf16 and c % 4
            with pytest.raises(ValueError):
                tail_tm.fused_tail_audio_tm(prod, prod, *args, *carry,
                                            packed=True, fast=True)
            return
        before = tail_tm.fused_tail_audio_tm.launches
        got = tail_tm.fused_tail_audio_tm(prod, prod, *args, *carry,
                                          packed=True, fast=True)
        torch.cuda.synchronize()
        assert tail_tm.fused_tail_audio_tm.launches == before + 1
        ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *args, *ref_carry,
                                              packed=True, fast=True)
        for g, r, atol in zip(got, ref, (1e-5, 1e-6, 1e-6, 1e-6, 1e-5)):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=atol)
        np.testing.assert_allclose(got[5].cpu().numpy(),
                                   ref[5].cpu().numpy(), rtol=1e-5, atol=0)
        carry, ref_carry = got[1:5], ref[1:5]
        phase = (phase + ND * step) & 0x7FFFFFFF


@pytest.mark.cuda
def test_kernel_separate_planes_and_input_checks_on_card(cuda_device):
    s = _setup(31)
    dev = cuda_device
    ci, cq = (T(s["u"](ND, C)).to(dev) for _ in range(2))
    args = [T(s["phase0"].astype(np.int64)).to(dev),
            T(s["step"].astype(np.int64)).to(dev), T(s["w"]).to(dev),
            T(s["wa"]).to(dev), D, T(s["mode"]).to(dev)]
    carry = [T(a).to(dev) for a in s["carry"]]
    got = tail_tm.fused_tail_audio_tm(ci, cq, *args, *carry, fast=True)
    ref = tail_tm.fused_tail_audio_tm_ref(ci, cq, *args, *carry, fast=True)
    torch.cuda.synchronize()
    for g, r, atol in zip(got, ref, (1e-5, 1e-6, 1e-6, 1e-6, 1e-5)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=0, atol=atol)
    with pytest.raises(ValueError, match="contiguous"):
        tail_tm.fused_tail_audio_tm(ci, cq, *args, carry[0].T.contiguous().T,
                                    *carry[1:])
    with pytest.raises(TypeError, match="dtype"):
        tail_tm.fused_tail_audio_tm(ci, cq, *args[:5], args[5].long(),
                                    *carry)
    # the 128-channel tile is the Pallas kernel's: 100 channels run, a
    # partial last block of 64, on separate planes too
    n = 100
    args_n = [args[0][:n], args[1][:n], *args[2:5], args[5][:n]]
    carry_n = [x[:, :n].contiguous() for x in carry]
    planes_n = (ci[:, :n].contiguous(), cq[:, :n].contiguous())
    got = tail_tm.fused_tail_audio_tm(*planes_n, *args_n, *carry_n, fast=True)
    ref = tail_tm.fused_tail_audio_tm_ref(*planes_n, *args_n, *carry_n,
                                          fast=True)
    torch.cuda.synchronize()
    for g, r, atol in zip(got, ref, (1e-5, 1e-6, 1e-6, 1e-6, 1e-5)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=0, atol=atol)
    short = T(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(80_000, 240_000, 32), 1, 128)).to(dev)
    with pytest.raises(ValueError, match="64-tap"):
        tail_tm.fused_tail_audio_tm(ci, cq, *args[:2], short, *args[3:],
                                    *carry)
    with pytest.raises(ValueError, match="tile_rows"):
        tail_tm._launch(ci, cq, *args, *carry, False, True, 120)


def _card_args(s, dev, d, mode):
    # the plain version's output tile: up to 64 outputs, dividing the
    # block's and holding the K-1 row halo at every decimation
    wa = fir.toeplitz_weights(firdesign.design_lowpass_fir(8_000, 240_000),
                              d, math.gcd(64, ND // d))
    return (T(s["phase0"].astype(np.int64)).to(dev),
            T(s["step"].astype(np.int64)).to(dev), T(s["w"]).to(dev),
            T(wa).to(dev), d, T(np.asarray(mode, np.int32)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [128, 640])
@pytest.mark.parametrize("d", [5, 10, 2, 1])
def test_kernel_at_other_decimations_on_card(cuda_device, d, tile_rows):
    """The audio FIR's FMA groups at the stock decimation 5 (four outputs a
    lane) and at 10, 2 and 1; every output holds the same bounds over two
    carried blocks."""
    s = _setup(41 + d)
    dev = cuda_device
    common = _card_args(s, dev, d, s["mode"])
    carry = ref_carry = tuple(T(a).to(dev) for a in s["carry"])
    for _ in range(2):
        prod = T(s["u"](ND, 2 * C)).to(dev)
        got = tail_tm._launch(prod, prod, *common, *carry, True, True,
                              tile_rows)
        torch.cuda.synchronize()
        ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common,
                                              *ref_carry, packed=True,
                                              fast=True)
        assert got[0].shape == (ND // d, C)
        assert float(ref[0].abs().max()) > 1e-2
        for g, r, atol in zip(got, ref, (1e-5, 1e-6, 1e-6, 1e-6, 1e-5)):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=atol)
        np.testing.assert_allclose(got[5].cpu().numpy(),
                                   ref[5].cpu().numpy(), rtol=1e-5, atol=0)
        carry, ref_carry = got[1:5], ref[1:5]
        common = (common[0] + ND * common[1] & 0x7FFFFFFF, *common[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [128, 640])
@pytest.mark.parametrize("d", [8, 16, 40, 64])
def test_kernel_audio_fir_groups_at_wide_decimations_on_card(cuda_device, d,
                                                             tile_rows):
    """The audio FIR's groups past D=7, where a group of four outputs a
    lane would outrun the 128-row demod ring: three outputs a lane at 8,
    two at 16, one at 40, a group of one output from 50 on. Over two
    carried blocks the audio is within 1e-5 of the plain version off the
    FM slots and, on them, by the flip rule of PERF.md section 2; the
    carries and the power (which the decimation does not touch) by the
    bounds above, but for the carried demod tail: its FM rows are raw
    demod rows (the rule of ``tests/test_torch_tail_split.py``), held at
    the decimations of the test above."""
    s = _setup(41 + d)
    dev = cuda_device
    common = _card_args(s, dev, d, s["mode"])
    fm = s["mode"] == 1
    flip = float(common[3][:K, 0].abs().max())
    carry = ref_carry = tuple(T(a).to(dev) for a in s["carry"])
    for _ in range(2):
        prod = T(s["u"](ND, 2 * C)).to(dev)
        got = tail_tm._launch(prod, prod, *common, *carry, True, True,
                              tile_rows)
        torch.cuda.synchronize()
        ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common,
                                              *ref_carry, packed=True,
                                              fast=True)
        assert got[0].shape == (ND // d, C)
        assert float(ref[0].abs().max()) > 1e-2
        err = (got[0] - ref[0]).abs().cpu().numpy()
        assert err[:, ~fm].max() <= 1e-5
        assert (err[:, fm] > 1e-5).sum() <= 1e-4 * err[:, fm].size
        assert err[:, fm].max() <= 2 * flip + 1e-5
        for g, r, atol in zip(got[1:4], ref[1:4], (1e-6, 1e-6, 1e-6)):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=atol)
        np.testing.assert_allclose(got[5].cpu().numpy(),
                                   ref[5].cpu().numpy(), rtol=1e-5, atol=0)
        carry, ref_carry = got[1:5], ref[1:5]
        common = (common[0] + ND * common[1] & 0x7FFFFFFF, *common[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
def test_kernel_with_mixed_laws_in_a_warp_on_card(cuda_device, fast):
    """Random laws: the warps' column orders are no identity and their
    column classes mix laws."""
    s = _setup(51 + fast)
    dev = cuda_device
    mode = s["rng"].integers(0, 4, C)
    assert any(tail_tm.law_sorted_columns(mode[i:i + 16]) != list(range(16))
               for i in range(0, C, 16))
    common = _card_args(s, dev, D, mode)
    carry = ref_carry = tuple(T(a).to(dev) for a in s["carry"])
    for _ in range(2):
        prod = T(s["u"](ND, 2 * C)).to(dev)
        got = tail_tm._launch(prod, prod, *common, *carry, True, fast, 640)
        torch.cuda.synchronize()
        ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common,
                                              *ref_carry, packed=True,
                                              fast=fast)
        for g, r, atol in zip(got, ref, (1e-5, 1e-6, 1e-6, 1e-6, 1e-5)):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=atol)
        np.testing.assert_allclose(got[5].cpu().numpy(),
                                   ref[5].cpu().numpy(), rtol=1e-5, atol=0)
        carry, ref_carry = got[1:5], ref[1:5]
        common = (common[0] + ND * common[1] & 0x7FFFFFFF, *common[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("c,nd,tile_rows,bf16,fast,laws", [
    (69_632, 5_120, 2_560, False, True, "cycling"),  # the headline's tile
    (16, 2_560, 640, False, True, "cycling"),        # a partial last group
    (1_000, 2_560, 640, False, True, "random"),
    (1_000, 2_560, 640, True, True, "cycling"),      # a bfloat16 product
    (128, 2_560, 640, True, False, "random"),
    (128, 2_560, 128, False, False, "random"),       # mixed laws, 128 tiles
])
def test_warpgroup_body_matches_plain_version_on_card(cuda_device, c, nd,
                                                      tile_rows, bf16, fast,
                                                      laws):
    """The wgmma body (``BODY_WG``) over two carried blocks against the
    plain version: off the FM slots every output within the bounds above;
    on them the audio and the raw demod tail by the flip rule of the wide
    decimations' test (an FM sample near a zero of the shaped signal may
    flip by up to two steps of the audio FIR)."""
    rng = np.random.default_rng(c + nd + 3 * bf16 + fast)
    dev = cuda_device
    u = lambda *shape: T(rng.uniform(-0.5, 0.5, shape).astype(
        np.float32)).to(dev)
    s = _setup(81)
    mode = (np.arange(c) % 4 if laws == "cycling"
            else rng.integers(0, 4, c)).astype(np.int32)
    fm = T(mode == 1).to(dev)
    flip = float(T(s["wa"])[:K, 0].abs().max())
    common = (T(rng.integers(0, 2**31, c)).to(dev),
              T(rng.integers(0, 2**32, c)).to(dev), T(s["w"]).to(dev),
              T(s["wa"]).to(dev), D, T(mode).to(dev))
    carry = ref_carry = (u(K - 1, c), u(K - 1, c), u(2, c), u(K - 1, c))
    for _ in range(2):
        prod = u(nd, 2 * c)
        if bf16:
            prod = prod.bfloat16()
        before = tail_tm.fused_tail_audio_tm.wgmma_launches
        got = tail_tm._launch(prod, prod, *common, *carry, True, fast,
                              tile_rows, tail_tm.BODY_WG)
        torch.cuda.synchronize()
        assert tail_tm.fused_tail_audio_tm.wgmma_launches == before + 1
        ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common,
                                              *ref_carry, packed=True,
                                              fast=fast)
        assert float(ref[0].abs().max()) > 1e-2
        for i in (0, 4):  # audio, raw demod tail
            err = (got[i] - ref[i]).abs()
            assert float(err[:, ~fm].max()) <= 1e-5, i
            if bool(fm.any()):
                efm = err[:, fm]
                assert int((efm > 1e-5).sum()) <= 1e-4 * efm.numel(), i
                assert float(efm.max()) <= 2 * flip + 1e-5, i
        for g, r in zip(got[1:4], ref[1:4]):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[5].cpu().numpy(),
                                   ref[5].cpu().numpy(), rtol=1e-5, atol=0)
        carry, ref_carry = got[1:5], ref[1:5]
        common = (common[0] + nd * common[1] & 0x7FFFFFFF, *common[1:])
        del ref


@pytest.mark.cuda
@pytest.mark.parametrize("body", [tail_tm.BODY_WARP, tail_tm.BODY_WG])
def test_fm_law_on_subnormal_products_on_card(cuda_device, body):
    """Every slot FM on a product of ~4e-19: the FM law's products, and so
    the divisor of its angle, are subnormal (every channel's power is below
    float32's normal range). Each body stays finite (a division by way of
    a flushing reciprocal gives NaN there) and meets the plain version by
    the bounds above, scaled to the level, and on the audio and the raw
    demod tail by the flip rule with a share of 1e-3: at this level the
    products' own rounding (2^-149 apart) moves the plain version, against
    itself on the same inputs at a normal level, by up to 2.4e-5 on up to
    4 of 8,064 raw demod samples, on the CPU."""
    scale = 4e-19
    c, nd = 128, 2_560
    rng = np.random.default_rng(91 + body)
    dev = cuda_device
    u = lambda *shape: T((rng.uniform(-0.5, 0.5, shape) * scale).astype(
        np.float32)).to(dev)
    s = _setup(91)
    flip = float(T(s["wa"])[:K, 0].abs().max())
    common = (T(rng.integers(0, 2**31, c)).to(dev),
              T(rng.integers(0, 2**32, c)).to(dev), T(s["w"]).to(dev),
              T(s["wa"]).to(dev), D,
              torch.ones(c, dtype=torch.int32, device=dev))
    carry = (u(K - 1, c), u(K - 1, c), u(2, c), u(K - 1, c))
    prod = u(nd, 2 * c)
    got = tail_tm._launch(prod, prod, *common, *carry, True, True, 640, body)
    torch.cuda.synchronize()
    ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common, *carry,
                                          packed=True, fast=True)
    assert float(ref[5].max()) < 2.0**-126
    assert float(ref[0].abs().max()) > 1e-2
    for g in got:
        assert bool(torch.isfinite(g).all())
    for i in (0, 4):  # audio, raw demod tail: every slot FM
        err = (got[i] - ref[i]).abs()
        assert int((err > 1e-5).sum()) <= 1e-3 * err.numel(), i
        assert float(err.max()) <= 2 * flip + 1e-5, i
    for g, r in zip(got[1:4], ref[1:4]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got[5].cpu().numpy(), ref[5].cpu().numpy(),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_power_and_carries_do_not_depend_on_the_laws_on_card(cuda_device):
    """The power, the mixed carries and the FM lag are sums and samples
    from before the demod law: whatever laws the slots hold, and so wherever
    the column order puts a channel, they come out bit for bit the same, in
    the same order of summation; and a slot's audio does not depend on the
    laws beside it."""
    s = _setup(61)
    dev = cuda_device
    prod = T(s["u"](ND, 2 * C)).to(dev)
    carry = tuple(T(a).to(dev) for a in s["carry"])
    cycling = np.arange(C) % 4
    runs = {}
    for name, mode in [("cycling", cycling), ("am", np.zeros(C)),
                       ("fm", np.ones(C)), ("lsb", np.full(C, 3)),
                       ("random", s["rng"].integers(0, 4, C))]:
        runs[name] = (mode, tail_tm.fused_tail_audio_tm(
            prod, prod, *_card_args(s, dev, D, mode), *carry, packed=True,
            fast=True))
    torch.cuda.synchronize()
    _, base = runs["cycling"]
    assert float(base[5].min()) > 0
    for name, (mode, got) in runs.items():
        for i in (1, 2, 3, 5):  # hist_i, hist_q, demod_prev, power
            assert torch.equal(got[i], base[i]), (name, i)
        for other, (mode2, got2) in runs.items():
            same = T(mode == mode2).to(dev)
            assert torch.equal(got[0][:, same], got2[0][:, same])
            assert torch.equal(got[4][:, same], got2[4][:, same])


@pytest.mark.cuda
@pytest.mark.parametrize("nd,tile_rows", [(80, 640), (240, 128), (400, 128)])
def test_kernel_short_blocks_on_card(cuda_device, nd, tile_rows):
    """Blocks of a few chunks: the first audio groups read the carried demod
    tail, the last one is cut by the block's end, and with 128-row tiles a
    tile's halo is the whole tile before it and the last tile is ragged."""
    s = _setup(71 + nd)
    dev = cuda_device
    w = fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000, 240_000),
                             1, 80)
    wa = fir.toeplitz_weights(firdesign.design_lowpass_fir(8_000, 240_000),
                              D, 16)
    common = (T(s["phase0"].astype(np.int64)).to(dev),
              T(s["step"].astype(np.int64)).to(dev), T(w).to(dev),
              T(wa).to(dev), D, T(s["mode"]).to(dev))
    carry = ref_carry = tuple(T(a).to(dev) for a in s["carry"])
    for _ in range(3):
        prod = T(s["u"](nd, 2 * C)).to(dev)
        got = tail_tm._launch(prod, prod, *common, *carry, True, True,
                              tile_rows)
        torch.cuda.synchronize()
        ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *common,
                                              *ref_carry, packed=True,
                                              fast=True)
        assert got[0].shape == (nd // D, C)
        for g, r, atol in zip(got, ref, (1e-5, 1e-6, 1e-6, 1e-6, 1e-5)):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=atol)
        np.testing.assert_allclose(got[5].cpu().numpy(),
                                   ref[5].cpu().numpy(), rtol=1e-5, atol=0)
        carry, ref_carry = got[1:5], ref[1:5]
        common = (common[0] + nd * common[1] & 0x7FFFFFFF, *common[1:])


@pytest.mark.cuda
def test_accuracy_rule_through_the_kernel_on_card(cuda_device):
    """``bench_torch.py --accuracy`` (C=128, 33 SNRs against float64)
    through kernel #1, once a step: every key at least the JAX law's less
    0.5 dB (the tier rule, ``bench_torch.JAX_LAW_SNR_DB``) and at least the
    plain tail's (``tail_kernel="xla"``) less 0.5 dB."""
    import bench_torch

    acc = bench_torch.accuracy(cuda_device)
    plain = bench_torch.accuracy(cuda_device, tail_kernel="xla")
    assert acc["kernel_launches"] == 33 and plain["kernel_launches"] == 0
    assert acc["below_jax_law"] == {}
    for key in bench_torch.JAX_LAW_SNR_DB:
        assert acc[key] >= plain[key] - bench_torch.LAW_SLACK_DB, key
