"""The port's channel-rate tail ``fused_tail_tm`` against the JAX package's
Pallas kernel of that name.

On the CPU the port's wrapper runs its plain torch version; the JAX side
runs the Pallas kernel in interpret mode. Two carried blocks, all four demod
laws, both LO laws, packed and separate planes. The CUDA kernel is compared
with the plain version by the ``cuda``-marked tests, which skip where torch
sees no card (run there with ``--noconftest -m cuda``: that machine has no
JAX, so JAX is imported inside the CPU tests only).

Inputs are uniform in [-0.5, 0.5); bounds are absolute at that level (see
``tests/test_torch_tail_tm.py`` for the ``fast=True`` LO gap). The audio is
the raw demod row, so on FM slots a float32 rounding at the ``atan2`` branch
cut is a whole turn and is removed before the comparison. The FM angle is
also ill-conditioned where consecutive shaped samples are small (its error
is the rounding of ``ii, qq`` over ``|y[n]| |y[n-1]|``, and random inputs do
come that close to zero), so on FM slots up to 1e-4 of the samples may
exceed the bound, none by more than 1e-3; every other slot is held to it.
"""

import numpy as np
import pytest
import torch

from webradio_tpu_torch.ops import fir, firdesign, tail_tm

ND, C, K = 2_048, 128, 64
T = torch.from_numpy

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))


def _setup(seed):
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return dict(
        u=u,
        w=fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000, 240_000),
                               1, 128),
        phase0=rng.integers(0, 2**31, C).astype(np.uint32),
        step=rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32),
        mode=(np.arange(C) % 4).astype(np.int32),
        carry=(u(K - 1, C), u(K - 1, C), u(2, C)),
    )


def _advance(phase, step, n):
    return ((phase.astype(np.int64) + n * step.astype(np.int64))
            & 0x7FFFFFFF).astype(np.uint32)


def _assert_raw_audio(got, ref, mode, bound=1e-5):
    err = got - ref
    fm = mode == 1
    err[:, fm] -= np.round(err[:, fm])
    err = np.abs(err)
    assert err[:, ~fm].max() <= bound
    over = err[:, fm] > bound
    assert over.sum() <= 1e-4 * over.size
    assert err[:, fm].max() <= 1e-3


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fast", [True, False])
def test_plain_chanrate_tail_matches_pallas_kernel(fast, packed):
    import jax.numpy as jnp
    from webradio_tpu.ops.pallas_tail_tm import fused_tail_tm as j_tail

    s = _setup(41 + 2 * fast + packed)
    j_carry = tuple(jnp.asarray(a) for a in s["carry"])
    t_carry = tuple(T(a) for a in s["carry"])
    phase = s["phase0"]
    launches = tail_tm.fused_tail_tm.launches
    for _ in range(2):  # every carry crosses the block boundary
        if packed:
            prod = s["u"](ND, 2 * C)
            j_in, t_in = (jnp.asarray(prod),) * 2, (T(prod),) * 2
        else:
            ci, cq = s["u"](ND, C), s["u"](ND, C)
            j_in, t_in = (jnp.asarray(ci), jnp.asarray(cq)), (T(ci), T(cq))
        ref = j_tail(*j_in, jnp.asarray(phase), jnp.asarray(s["step"]),
                     jnp.asarray(s["w"]), jnp.asarray(s["mode"]), *j_carry,
                     packed=packed, fast=fast)
        got = tail_tm.fused_tail_tm(
            *t_in, T(phase.astype(np.int64)), T(s["step"].astype(np.int64)),
            T(s["w"]), T(s["mode"]), *t_carry, packed=packed, fast=fast)
        ref = [np.asarray(a) for a in ref]
        audio, hist_i, hist_q, prev, power = (g.numpy() for g in got)
        assert audio.shape == (ND, C) and len(got) == 5
        _assert_raw_audio(audio, ref[0], s["mode"])
        np.testing.assert_allclose(hist_i, ref[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(hist_q, ref[2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(prev, ref[3], rtol=0, atol=1e-6)
        np.testing.assert_allclose(power, ref[4], rtol=1e-5, atol=0)
        assert np.abs(ref[0]).max() > 1e-3  # not zeros against zeros
        j_carry = tuple(jnp.asarray(a) for a in ref[1:4])
        t_carry = got[1:4]
        phase = _advance(phase, s["step"], ND)
    assert tail_tm.fused_tail_tm.launches == launches  # CPU: no kernel


def test_chanrate_tail_then_audio_fir_is_the_audio_fused_tail():
    # the step's 9.6 kHz-audio branch: fused_tail_tm followed by the
    # Toeplitz audio FIR computes what fused_tail_audio_tm computes
    s = _setup(47)
    d, nd = 5, 2_560  # the port alone: any multiple of the decimation
    wa = T(fir.toeplitz_weights(firdesign.design_lowpass_fir(8_000, 240_000),
                                d, 32))
    prod = T(s["u"](nd, 2 * C))
    ahist = T(s["u"](K - 1, C))
    lo = (T(s["phase0"].astype(np.int64)), T(s["step"].astype(np.int64)))
    carry = tuple(T(a) for a in s["carry"])
    audio, hi, hq, prev, power = tail_tm.fused_tail_tm(
        prod, prod, *lo, T(s["w"]), T(s["mode"]), *carry, packed=True,
        fast=True)
    a48, new_ahist = fir.fir_decimate_toeplitz_tm(audio, wa, d, ahist)
    want = tail_tm.fused_tail_audio_tm(
        prod, prod, *lo, T(s["w"]), wa, d, T(s["mode"]), *carry, ahist,
        packed=True, fast=True)
    for g, r in zip((a48, hi, hq, prev, new_ahist, power), want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_chanrate_tail_rejects_unknown_precision_and_device():
    s = _setup(3)
    args = [torch.zeros(ND, 2 * C)] * 2 + [
        T(s["phase0"].astype(np.int64)), T(s["step"].astype(np.int64)),
        T(s["w"]), T(s["mode"])] + [T(a) for a in s["carry"]]
    with pytest.raises(ValueError, match="precision"):
        tail_tm.fused_tail_tm(*args, precision="bf16x9", packed=True)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no tail kernel"):
        tail_tm.fused_tail_tm(*meta, packed=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [64, 640, ND])
@pytest.mark.parametrize("fast", [True, False])
def test_chanrate_kernel_matches_plain_version_on_card(cuda_device, fast,
                                                       tile_rows):
    s = _setup(51 + fast)
    dev = cuda_device
    carry = ref_carry = tuple(T(a).to(dev) for a in s["carry"])
    phase = s["phase0"]
    for _ in range(2):
        prod = T(s["u"](ND, 2 * C)).to(dev)
        common = (T(phase.astype(np.int64)).to(dev),
                  T(s["step"].astype(np.int64)).to(dev), T(s["w"]).to(dev),
                  T(s["mode"]).to(dev))
        before = tail_tm.fused_tail_tm.launches
        # other tile heights than the wrapper's go through its launcher, to
        # cover the halo recompute at the tile edges
        got = tail_tm._launch_chanrate(prod, prod, *common, *carry, True,
                                       fast, tile_rows)
        torch.cuda.synchronize()
        assert tail_tm.fused_tail_tm.launches == before + 1
        ref = tail_tm.fused_tail_tm_ref(prod, prod, *common, *ref_carry,
                                        packed=True, fast=fast)
        _assert_raw_audio(got[0].cpu().numpy(), ref[0].cpu().numpy(),
                          s["mode"])
        for g, r in zip(got[1:4], ref[1:4]):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                       rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[4].cpu().numpy(),
                                   ref[4].cpu().numpy(), rtol=1e-5, atol=0)
        carry, ref_carry = got[1:4], ref[1:4]
        phase = _advance(phase, s["step"], ND)
    with pytest.raises(ValueError, match="tile_rows"):
        tail_tm._launch_chanrate(prod, prod, *common, *carry, True, fast, 48)


def _edge_case(seed, nd, c, dev):
    """Inputs of any height and width for the tiling's edge cases; the
    banded weights use a 64-row tile so the plain version takes any
    multiple of 64 rows (the kernel reads only the reversed kernel)."""
    rng = np.random.default_rng(seed)
    u = lambda *shape: T(rng.uniform(-0.5, 0.5, shape).astype(
        np.float32)).to(dev)
    w = T(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(80_000, 240_000), 1, 64)).to(dev)
    phase = T(rng.integers(0, 2**31, c)).to(dev)
    step = T(rng.integers(0, 2**32, c)).to(dev)
    mode = T((np.arange(c) % 4).astype(np.int32)).to(dev)
    return u(nd, 2 * c), (phase, step, w, mode), (u(K - 1, c), u(K - 1, c),
                                                  u(2, c))


@pytest.mark.cuda
@pytest.mark.parametrize("nd,c,tile_rows", [
    (64, 128, 64),         # one chunk group: a single tile of four chunks
    (192, 128, 640),       # one tile taller than the block
    (2_048, 128, 720),     # ragged last tile (720, 720, 608)
    (2_048, 128, 1_936),   # last tile of 112 rows: shorter than two halos
    (256, 16_384, 64),     # the wide grid: 256 channel groups, K-row tiles
    (192, 16, 640),        # one partial block: a warp of 16, three idle
    (2_048, 100, 720),     # a partial last block of 36 channels
    (256, 511, 64),        # a partial last warp of 15 channels
])
def test_chanrate_kernel_tile_edges_on_card(cuda_device, nd, c, tile_rows):
    prod, common, carry = _edge_case(nd + c, nd, c, cuda_device)
    got = tail_tm._launch_chanrate(prod, prod, *common, *carry, True, True,
                                   tile_rows)
    torch.cuda.synchronize()
    ref = tail_tm.fused_tail_tm_ref(prod, prod, *common, *carry, packed=True,
                                    fast=True)
    _assert_raw_audio(got[0].cpu().numpy(), ref[0].cpu().numpy(),
                      common[3].cpu().numpy())
    for g, r in zip(got[1:4], ref[1:4]):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(got[4].cpu().numpy(), ref[4].cpu().numpy(),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_chanrate_kernel_refuses_what_its_tiling_does_not_take(cuda_device):
    prod, common, carry = _edge_case(5, 256, 128, cuda_device)
    launch = lambda p, cm, cr, rows: tail_tm._launch_chanrate(
        p, p, *cm, *cr, True, True, rows)
    with pytest.raises(ValueError, match="tile_rows"):
        launch(prod, common, carry, 72)  # not whole chunks
    with pytest.raises(ValueError, match="tile_rows"):
        launch(prod, common, carry, 48)  # shorter than the halo
    with pytest.raises(ValueError, match="multiple of the decimation"):
        launch(prod[:248].contiguous(), common, carry, 640)
    # any channel count runs (the 128-channel tile is the Pallas kernel's);
    # the shaping FIR must have the 64 taps the kernel is built for
    short = fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000,
                                                              240_000, 32),
                                 1, 64)
    with pytest.raises(ValueError, match="64-tap"):
        launch(prod, (*common[:2], T(short).to(cuda_device), common[3]),
               carry, 640)
    before = tail_tm.fused_tail_tm.launches
    with pytest.raises(ValueError, match="contiguous"):
        launch(prod, common, (carry[0].T.contiguous().T, *carry[1:]), 640)
    assert tail_tm.fused_tail_tm.launches == before  # nothing was launched
    assert tail_tm.tile_rows_for(25_600, 1_024) == tail_tm.TILE_ROWS
    assert tail_tm.tile_rows_for(10_240, 16_384) == 4 * tail_tm.TILE_ROWS
