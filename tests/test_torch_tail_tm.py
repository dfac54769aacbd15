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
    with pytest.raises(ValueError, match="multiple of 128"):
        tail_tm.fused_tail_audio_tm(ci[:, :64].contiguous(),
                                    cq[:, :64].contiguous(), *args, *carry)
    with pytest.raises(ValueError, match="tile_rows"):
        tail_tm._launch(ci, cq, *args, *carry, False, True, 120)
