"""The port's time-minor tail ``fused_receiver_tail`` against the JAX
package's Pallas kernel of that name (``ops/pallas_tail.py``).

On the CPU the port's wrapper runs its plain torch version (``nco_mix`` over
raw history plus block at negative sample indices, ``fir_decimate`` with
per-channel coefficients, ``demodulate``, mean power); the JAX side runs the
Pallas kernel in interpret mode, as ``tests/test_pallas_tail.py`` does. Two
carried blocks, per-channel coefficients of two designs, all four demod
laws. The CUDA kernel is compared with the plain version by the
``cuda``-marked test, which skips where torch sees no card (run there with
``--noconftest -m cuda``).

Bounds at inputs uniform in [-0.5, 0.5): audio 1e-5 (raw demod rows: on FM
slots a branch-cut flip is a whole turn and is removed, and up to 1e-4 of
the samples may exceed the bound, none by more than 1e-3, where small
consecutive shaped samples leave the angle ill-conditioned); the raw
history exactly; the FM lag 1e-6; power rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from webradio_tpu_torch.ops import firdesign, tail

ND, C, K = 2_048, 16, 64
T = torch.from_numpy

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))


def _setup(seed, C=C):
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    designs = [firdesign.design_lowpass_fir(bw, 240_000)
               for bw in (12_500, 80_000)]
    return dict(
        u=u, coeff=np.stack([designs[i % 2] for i in range(C)]),
        phase0=rng.integers(0, 2**31, C).astype(np.uint32),
        step=rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32),
        mode=(np.arange(C) % 4).astype(np.int32),
        carry=(u(2, C, K - 1), u(2, C)),
    )


def _advance(phase, step, n):
    return ((phase.astype(np.int64) + n * step.astype(np.int64))
            & 0x7FFFFFFF).astype(np.uint32)


def _assert_outputs(got, ref, mode):
    audio, hist, prev, power = got
    err = audio - ref[0]
    fm = mode == 1
    err[fm] -= np.round(err[fm])
    err = np.abs(err)
    assert err[~fm].max() <= 1e-5
    over = err[fm] > 1e-5
    assert over.sum() <= 1e-4 * over.size and err[fm].max() <= 1e-3
    np.testing.assert_array_equal(hist, ref[1])
    np.testing.assert_allclose(prev, ref[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(power, ref[3], rtol=1e-5, atol=0)


def test_plain_legacy_tail_matches_pallas_kernel():
    import jax.numpy as jnp
    from webradio_tpu.ops.pallas_tail import fused_receiver_tail as j_tail

    s = _setup(81)
    j_carry = tuple(jnp.asarray(a) for a in s["carry"])
    t_carry = tuple(T(a) for a in s["carry"])
    phase = s["phase0"]
    launches = tail.fused_receiver_tail.launches
    for _ in range(2):  # the raw history and the FM lag cross the boundary
        x = s["u"](2, C, ND)
        ref = j_tail(jnp.asarray(x), jnp.asarray(phase),
                     jnp.asarray(s["step"]), jnp.asarray(s["coeff"]),
                     jnp.asarray(s["mode"]), *j_carry, interpret=True)
        got = tail.fused_receiver_tail(
            T(x), T(phase.astype(np.int64)), T(s["step"].astype(np.int64)),
            T(s["coeff"]), T(s["mode"]), *t_carry)
        ref = [np.asarray(a) for a in ref]
        assert got[0].shape == (C, ND) and got[1].shape == (2, C, K - 1)
        assert got[1].is_contiguous()
        _assert_outputs([g.numpy() for g in got], ref, s["mode"])
        assert np.abs(ref[0]).max() > 1e-3  # not zeros against zeros
        j_carry = tuple(jnp.asarray(a) for a in ref[1:3])
        t_carry = got[1:3]
        phase = _advance(phase, s["step"], ND)
    assert tail.fused_receiver_tail.launches == launches  # CPU: no kernel


def test_legacy_tail_mirrors_the_selection_rule():
    s = _setup(3)
    args = [T(s["phase0"].astype(np.int64)), T(s["step"].astype(np.int64)),
            T(s["coeff"]), T(s["mode"])] + [T(a) for a in s["carry"]]
    with pytest.raises(ValueError, match="multiple of 1024"):
        tail.fused_receiver_tail(torch.zeros(2, C, 1_000), *args)
    with pytest.raises(ValueError, match="no tail kernel"):
        tail.fused_receiver_tail(torch.zeros(2, C, ND, device="meta"), *args)
    from webradio_tpu.ops import pallas_tail

    # the time chunk is the JAX kernel's; the 8-channel tile is a Pallas
    # tile that the CUDA kernel (one block a channel) does without: 12
    # channels run, each as its own 1-channel call computes it
    assert tail.TIME_CHUNK == pallas_tail.TIME_CHUNK
    assert tail.shape_refusal(ND, K) is None
    assert "64-tap" in tail.shape_refusal(ND, 32)
    w = _setup(4, C=12)  # 12 channels run, as three calls of 4 do
    x = T(w["u"](2, 12, ND))
    args12 = [T(w["phase0"].astype(np.int64)), T(w["step"].astype(np.int64)),
              T(w["coeff"]), T(w["mode"])] + [T(a) for a in w["carry"]]
    got = tail.fused_receiver_tail(x, *args12)
    assert got[0].shape == (12, ND)
    for j in range(0, 12, 4):
        cut = [a[j:j + 4] for a in args12[:4]] + [
            a[:, j:j + 4].contiguous() for a in args12[4:]]
        part = tail.fused_receiver_tail(x[:, j:j + 4].contiguous(), *cut)
        # the channel axis of audio, raw history, FM lag and power
        for g, p, axis in zip(got, part, (0, 1, 1, 0)):
            torch.testing.assert_close(g.narrow(axis, j, 4), p, rtol=0,
                                       atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_legacy_kernel_matches_plain_version_on_card(cuda_device):
    s = _setup(91)
    dev = cuda_device
    carry = ref_carry = tuple(T(a).to(dev) for a in s["carry"])
    phase = s["phase0"]
    for _ in range(2):
        x = T(s["u"](2, C, ND)).to(dev)
        common = (x, T(phase.astype(np.int64)).to(dev),
                  T(s["step"].astype(np.int64)).to(dev),
                  T(s["coeff"]).to(dev), T(s["mode"]).to(dev))
        before = tail.fused_receiver_tail.launches
        got = tail.fused_receiver_tail(*common, *carry)
        torch.cuda.synchronize()
        assert tail.fused_receiver_tail.launches == before + 1
        ref = tail.fused_receiver_tail_ref(*common, *ref_carry)
        _assert_outputs([g.cpu().numpy() for g in got],
                        [r.cpu().numpy() for r in ref], s["mode"])
        carry, ref_carry = got[1:3], ref[1:3]
        phase = _advance(phase, s["step"], ND)
    with pytest.raises(ValueError, match="contiguous"):
        tail.fused_receiver_tail(x.transpose(1, 2).contiguous().transpose(
            1, 2), *common[1:], *carry)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 1_024])
@pytest.mark.parametrize("nd", [1_024, 2_048, 10_240])
def test_legacy_kernel_shapes_and_chunk_edges_on_card(cuda_device, nd, c):
    """The wrapper's smallest and the path's widths, one to ten chunks: a
    thread's first output takes its FM lag from its neighbour, a chunk's
    first from the output before the chunk, a block's first from the
    carried state, and the last shaped sample is carried on."""
    s = _setup(101 + nd // 1_024 + c, c)
    dev = cuda_device
    carry = ref_carry = tuple(T(a).to(dev) for a in s["carry"])
    phase = s["phase0"]
    fm = s["mode"] == 1
    for _ in range(2):
        x = T(s["u"](2, c, nd)).to(dev)
        common = (x, T(phase.astype(np.int64)).to(dev),
                  T(s["step"].astype(np.int64)).to(dev),
                  T(s["coeff"]).to(dev), T(s["mode"]).to(dev))
        got = tail.fused_receiver_tail(*common, *carry)
        torch.cuda.synchronize()
        ref = tail.fused_receiver_tail_ref(*common, *ref_carry)
        got_np = [g.cpu().numpy() for g in got]
        ref_np = [r.cpu().numpy() for r in ref]
        _assert_outputs([a.copy() for a in got_np], ref_np, s["mode"])
        # FM samples whose lag crosses a thread, chunk or block edge (a
        # wrong lag is an error of a tenth of a turn and more)
        for stride in (8, 1_024):
            err = got_np[0][fm, 0::stride] - ref_np[0][fm, 0::stride]
            err -= np.round(err)
            assert np.abs(err).max() <= 1e-3
            assert np.median(np.abs(err)) <= 1e-6
        assert np.abs(ref_np[2]).max() > 1e-3  # the carried lag is not zero
        carry, ref_carry = got[1:3], ref[1:3]
        phase = _advance(phase, s["step"], nd)
