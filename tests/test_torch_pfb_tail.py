"""The port's fused-filterbank tail ``fused_pfb_tail_audio_tm`` against the
JAX package's Pallas kernel of that name.

On the CPU the port's wrapper runs its plain torch version (the filterbank
matmul in true float32, then the plain audio tail); the JAX side runs the
Pallas kernel in interpret mode at ``Precision.HIGHEST``. The frames are the
im2col frames of tone-source blocks with noise, through each package's own
``pfb_frames_tm`` with the filterbank history carried; two carried blocks,
all four demod laws, both LO laws. The CUDA kernel is compared with the
plain version by the ``cuda``-marked test, which skips where torch sees no
card (run there with ``--noconftest -m cuda``).

Bounds: audio 1e-5, the demod tail 1e-5 after removing FM branch-cut turns,
power rtol 1e-5. The mixed carries and the FM lag get 2e-6: they carry the
rounding of a 320-term float32 product sum, taken in another order by each
implementation, on top of the LO gap of ``tests/test_torch_tail_tm.py``.
"""

import numpy as np
import pytest
import torch

from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import channelizer, fir, firdesign, tail_tm

BLOCK, BINS, TAPS, C, K, D = 25_600, 10, 16, 128, 64, 5
ND, KP = BLOCK // BINS, BINS * TAPS
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-450_000.0, "FM", 700.0), (700_000.0, "AM", 1_300.0))
T = torch.from_numpy

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))


def _setup(seed):
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    proto = channelizer.design_prototype(2_400_000, BINS, TAPS)
    ifs = np.linspace(-900_000, 900_000, C).astype(np.int64)
    bin_idx, _ = channelizer.assign_bins(ifs, 2_400_000, BINS)
    weights = channelizer.bin_weights_for_channels(proto, BINS, bin_idx)
    src = ToneSource(carriers=CARRIERS, noise=0.5, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, BLOCK, False
    blocks = []
    for _ in range(2):
        z = src.read_block()
        blocks.append(np.stack([z.real, z.imag]).astype(np.float32))
    return dict(
        blocks=blocks, pfb_hist=u(2, KP - 1),
        weights=weights.reshape(2 * KP, 2 * C),
        w=fir.toeplitz_weights(firdesign.design_lowpass_fir(80_000, 240_000),
                               1, 128),
        wa=fir.toeplitz_weights(firdesign.design_lowpass_fir(8_000, 240_000),
                                D, 32),
        phase0=rng.integers(0, 2**31, C).astype(np.uint32),
        step=rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32),
        mode=(np.arange(C) % 4).astype(np.int32),
        carry=(u(K - 1, C), u(K - 1, C), u(2, C), u(K - 1, C)),
    )


def _advance(phase, step, n):
    return ((phase.astype(np.int64) + n * step.astype(np.int64))
            & 0x7FFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("fast", [True, False])
def test_plain_pfb_tail_matches_pallas_kernel(fast):
    import jax.numpy as jnp
    from jax import lax
    from webradio_tpu.ops.channelizer import pfb_frames_tm as j_frames
    from webradio_tpu.ops.pallas_tail_tm import (
        fused_pfb_tail_audio_tm as j_tail,
    )

    s = _setup(61 + fast)
    j_carry = tuple(jnp.asarray(a) for a in s["carry"])
    t_carry = tuple(T(a) for a in s["carry"])
    j_hist, t_hist = jnp.asarray(s["pfb_hist"]), T(s["pfb_hist"])
    phase = s["phase0"]
    fm = s["mode"] == 1
    launches = tail_tm.fused_pfb_tail_audio_tm.launches
    for iq in s["blocks"]:
        j_fr, j_hist = j_frames(jnp.asarray(iq), KP, BINS, j_hist)
        t_fr, t_hist = channelizer.pfb_frames_tm(T(iq), KP, BINS, t_hist)
        np.testing.assert_array_equal(t_fr.numpy(), np.asarray(j_fr))
        ref = j_tail(j_fr, jnp.asarray(s["weights"]), jnp.asarray(phase),
                     jnp.asarray(s["step"]), jnp.asarray(s["w"]),
                     jnp.asarray(s["wa"]), D, jnp.asarray(s["mode"]),
                     *j_carry, fast=fast,
                     pfb_precision=lax.Precision.HIGHEST)
        got = tail_tm.fused_pfb_tail_audio_tm(
            t_fr, T(s["weights"]), T(phase.astype(np.int64)),
            T(s["step"].astype(np.int64)), T(s["w"]), T(s["wa"]), D,
            T(s["mode"]), *t_carry, fast=fast)
        ref = [np.asarray(a) for a in ref]
        a48, hist_i, hist_q, prev, ahist, power = (g.numpy() for g in got)
        assert a48.shape == (ND // D, C)
        np.testing.assert_allclose(a48, ref[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(hist_i, ref[1], rtol=0, atol=2e-6)
        np.testing.assert_allclose(hist_q, ref[2], rtol=0, atol=2e-6)
        np.testing.assert_allclose(prev, ref[3], rtol=0, atol=2e-6)
        err = ahist - ref[4]
        err[:, fm] -= np.round(err[:, fm])
        assert np.abs(err).max() <= 1e-5
        np.testing.assert_allclose(power, ref[5], rtol=1e-5, atol=0)
        assert np.abs(ref[0]).max() > 1e-2  # not zeros against zeros
        j_carry = tuple(jnp.asarray(a) for a in ref[1:5])
        t_carry = got[1:5]
        phase = _advance(phase, s["step"], ND)
    np.testing.assert_array_equal(t_hist.numpy(), np.asarray(j_hist))
    assert tail_tm.fused_pfb_tail_audio_tm.launches == launches


def test_pfb_tail_is_the_matmul_then_the_audio_tail():
    s = _setup(67)
    frames, _ = channelizer.pfb_frames_tm(T(s["blocks"][0]), KP, BINS,
                                          T(s["pfb_hist"]))
    common = (T(s["phase0"].astype(np.int64)),
              T(s["step"].astype(np.int64)), T(s["w"]), T(s["wa"]), D,
              T(s["mode"]), *(T(a) for a in s["carry"]))
    got = tail_tm.fused_pfb_tail_audio_tm(frames, T(s["weights"]), *common,
                                          fast=True)
    y2, _, _ = channelizer.pfb_channelize_direct_tm(
        T(s["blocks"][0]), T(s["weights"]).reshape(2 * KP, 2, C), BINS,
        T(s["pfb_hist"]), split=False)
    want = tail_tm.fused_tail_audio_tm(y2, y2, *common, packed=True,
                                       fast=True)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_pfb_tail_rejects_what_it_does_not_take():
    s = _setup(3)
    frames = torch.zeros(ND, 2 * KP)
    args = [T(s["phase0"].astype(np.int64)), T(s["step"].astype(np.int64)),
            T(s["w"]), T(s["wa"]), D, T(s["mode"])] + [
                T(a) for a in s["carry"]]
    # the tiers that need the packed product (the JAX config's refusal)
    for tier in ("bf16", "u8exact"):
        with pytest.raises(ValueError, match="packed product"):
            tail_tm.fused_pfb_tail_audio_tm(frames, T(s["weights"]), *args,
                                            pfb_precision=tier)
    with pytest.raises(ValueError, match="contraction"):
        tail_tm.fused_pfb_tail_audio_tm(frames[:, :-4], T(s["weights"]),
                                        *args)
    with pytest.raises(ValueError, match="precision"):
        tail_tm.fused_pfb_tail_audio_tm(frames, T(s["weights"]), *args,
                                        precision="bf16x9")
    with pytest.raises(ValueError, match="no tail kernel"):
        tail_tm.fused_pfb_tail_audio_tm(frames.to("meta"), T(s["weights"]),
                                        *args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_rows", [128, 640, ND])
@pytest.mark.parametrize("fast", [True, False])
def test_pfb_kernel_matches_plain_version_on_card(cuda_device, fast,
                                                  tile_rows):
    s = _setup(71 + fast)
    dev = cuda_device
    carry = ref_carry = tuple(T(a).to(dev) for a in s["carry"])
    hist = T(s["pfb_hist"]).to(dev)
    weights = T(s["weights"]).to(dev)
    phase = s["phase0"]
    fm = s["mode"] == 1
    for iq in s["blocks"]:
        frames, hist = channelizer.pfb_frames_tm(T(iq).to(dev), KP, BINS,
                                                 hist)
        common = (frames, weights, T(phase.astype(np.int64)).to(dev),
                  T(s["step"].astype(np.int64)).to(dev), T(s["w"]).to(dev),
                  T(s["wa"]).to(dev), D, T(s["mode"]).to(dev))
        before = tail_tm.fused_pfb_tail_audio_tm.launches
        got = tail_tm._launch_pfb(*common, *carry, fast, tile_rows)
        torch.cuda.synchronize()
        assert tail_tm.fused_pfb_tail_audio_tm.launches == before + 1
        ref = tail_tm.fused_pfb_tail_audio_tm_ref(*common, *ref_carry,
                                                  fast=fast)
        g, r = ([a.cpu().numpy() for a in x] for x in (got, ref))
        np.testing.assert_allclose(g[0], r[0], rtol=0, atol=1e-5)
        for i in (1, 2, 3):
            np.testing.assert_allclose(g[i], r[i], rtol=0, atol=2e-6)
        err = g[4] - r[4]
        err[:, fm] -= np.round(err[:, fm])
        assert np.abs(err).max() <= 1e-5
        np.testing.assert_allclose(g[5], r[5], rtol=1e-5, atol=0)
        carry, ref_carry = got[1:5], ref[1:5]
        phase = _advance(phase, s["step"], ND)


def _edge_case(seed, nd, c, dev, d=D):
    """Frames, weights and carries of any height and width for the tiling's
    edge cases (``nd`` a multiple of 320: whole product groups of 64 rows
    and whole audio samples)."""
    rng = np.random.default_rng(seed)
    u = lambda *shape: T(rng.uniform(-0.5, 0.5, shape).astype(
        np.float32)).to(dev)
    proto = channelizer.design_prototype(2_400_000, BINS, TAPS)
    ifs = np.linspace(-900_000, 900_000, c).astype(np.int64)
    bin_idx, _ = channelizer.assign_bins(ifs, 2_400_000, BINS)
    weights = T(channelizer.bin_weights_for_channels(
        proto, BINS, bin_idx).reshape(2 * KP, 2 * c)).to(dev)
    src = ToneSource(carriers=CARRIERS, noise=0.5, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = (
        2_400_000, nd * BINS, False)
    z = src.read_block()
    iq = T(np.stack([z.real, z.imag]).astype(np.float32)).to(dev)
    frames, _ = channelizer.pfb_frames_tm(iq, KP, BINS, u(2, KP - 1))
    w = T(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(80_000, 240_000), 1, 64)).to(dev)
    wa = T(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(8_000, 240_000), d, 32)).to(dev)
    mode = T((np.arange(c) % 4).astype(np.int32)).to(dev)
    common = (frames, weights, T(rng.integers(0, 2**31, c)).to(dev),
              T(rng.integers(0, 2**32, c)).to(dev), w, wa, d, mode)
    return common, (u(K - 1, c), u(K - 1, c), u(2, c), u(K - 1, c))


@pytest.mark.cuda
@pytest.mark.parametrize("nd,c,tile_rows,d", [
    (320, 128, 640, D),       # one tile, five product groups
    (320, 128, 128, D),       # ragged last tile (128, 128, 64): one group
    (2_560, 128, 1_024, D),   # ragged last tile of 512 rows
    (320, 16_384, 128, D),    # the wide grid: 256 channel groups on grid.y
    (1_280, 128, 256, 10),    # a decimation whose audio FIR is the loop
])
def test_pfb_kernel_tile_edges_on_card(cuda_device, nd, c, tile_rows, d):
    common, carry = _edge_case(nd + c + d - D, nd, c, cuda_device, d)
    got = tail_tm._launch_pfb(*common, *carry, True, tile_rows)
    torch.cuda.synchronize()
    ref = tail_tm.fused_pfb_tail_audio_tm_ref(*common, *carry, fast=True)
    g, r = ([a.cpu().numpy() for a in x] for x in (got, ref))
    fm = common[7].cpu().numpy() == 1
    # behind the audio FIR an FM branch-cut flip (two float32 roundings on
    # opposite sides of the cut) moves an output by at most two audio taps,
    # on at most 1e-4 of the FM samples; every other slot holds the bound
    err = np.abs(g[0] - r[0])
    assert err[:, ~fm].max() <= 1e-5
    flipped = int((err[:, fm] > 1e-5).sum())
    assert flipped <= 1e-4 * err[:, fm].size, flipped
    assert err[:, fm].max() <= 2 * float(common[5][:K, 0].abs().max()) + 1e-5
    for i in (1, 2, 3):
        np.testing.assert_allclose(g[i], r[i], rtol=0, atol=2e-6)
    # raw demod rows: a flip is a whole turn and is removed; the FM angle is
    # ill-conditioned where consecutive shaped samples are near zero, so at
    # most 1e-4 of the FM samples may pass the bound, none 1e-3
    err = g[4] - r[4]
    err[:, fm] -= np.round(err[:, fm])
    err = np.abs(err)
    assert err[:, ~fm].max() <= 1e-5
    assert (err[:, fm] > 1e-5).sum() <= 1e-4 * err[:, fm].size
    assert err[:, fm].max() <= 1e-3
    np.testing.assert_allclose(g[5], r[5], rtol=1e-5, atol=0)
    assert np.abs(r[0]).max() > 1e-2


@pytest.mark.cuda
def test_pfb_kernel_refuses_what_its_tiling_does_not_take(cuda_device):
    common, carry = _edge_case(9, 320, 128, cuda_device)
    frames, weights = common[:2]
    before = tail_tm.fused_pfb_tail_audio_tm.launches
    with pytest.raises(ValueError, match="tile_rows"):
        tail_tm._launch_pfb(*common, *carry, True, 144)  # not whole groups
    with pytest.raises(ValueError, match="tile_rows"):
        tail_tm._launch_pfb(*common, *carry, True, 64)  # below the halo
    with pytest.raises(ValueError, match="multiple of the decimation"):
        tail_tm._launch_pfb(frames[:160].contiguous(), *common[1:], *carry,
                            True, 640)  # 160 rows: not whole groups of 64
    with pytest.raises(ValueError, match="multiple of 16"):
        tail_tm._launch_pfb(frames[:, :312].contiguous(),
                            weights[:312].contiguous(), *common[2:], *carry,
                            True, 640)
    shifted = torch.empty(frames.numel() + 1, device=frames.device)[1:]
    shifted = shifted.view_as(frames).copy_(frames)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tail_tm._launch_pfb(shifted, *common[1:], *carry, True, 640)
    # it stages whole 64-channel blocks of weights (the 128-channel tile
    # is the Pallas kernel's: 64 channels run)
    narrow, narrow_carry = _edge_case(10, 320, 96, cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        tail_tm._launch_pfb(*narrow, *narrow_carry, True, 640)
    assert tail_tm.fused_pfb_tail_audio_tm.launches == before
