"""The CUDA kernels' tier variants against their plain versions on the
card: kernels #1 (``fused_tail_audio_tm``) and #2 (``fused_tail_tm``) on a
bfloat16 product (the "bf16" tier), and kernel #3
(``fused_pfb_tail_audio_tm``) at "default" and "high". Every test is
``cuda``-marked and skips where torch sees no card; the file imports no
JAX, so it runs on a machine without it (``--noconftest -m cuda``).

Bounds: #1 and #2 read the bfloat16 product and upcast it at load, which
is exact, so they keep the float32 product's bounds against the plain tail
on ``.float()`` of the same product (audio 1e-5 with the FM flip rule,
carries 1e-6, power rtol 1e-5). #3 at a lossy tier makes the tier's law on
the tensor cores and the plain version the same law with cuBLAS's (or
torch's) float32 sums, so both differ only in summation order: the tier
rule (PERF.md section 2) asks that the kernel's audio SNR against the
exactly-made product be within 0.5 dB of the plain version's, and the
AM/USB/LSB slots are held to the plain version within 1e-5 (a float32
summation difference of the 320-term product at unit level, ~1e-6, through
the tail's unit gains).
"""

import numpy as np
import pytest
import torch

from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import channelizer as tchan
from webradio_tpu_torch.ops import fir, firdesign, tail_tm
from webradio_tpu_torch.pipeline import channelized as tch

BINS = 10
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-450_000.0, "FM", 700.0), (700_000.0, "AM", 1_300.0))
T = torch.from_numpy


def _block(seed, block):
    src = ToneSource(carriers=CARRIERS, noise=0.5, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, block, False
    z = src.read_block()
    return np.stack([z.real, z.imag]).astype(np.float32)


def _fm_flips(got, ref, fm, bound, flip_step):
    """An FM output may exceed ``bound`` only by a branch-cut flip (at most
    two audio taps, on at most 1e-4 of the samples)."""
    err = np.abs(got - ref)
    assert err[:, ~fm].max() <= bound
    over = err[:, fm] > bound
    assert over.sum() <= 1e-4 * over.size
    assert err[:, fm].max() <= 2 * flip_step + bound


def _snr_db(ref, got, cols):
    err = got[:, cols] - ref[:, cols]
    return 10 * np.log10(np.sum(ref[:, cols] ** 2) / np.sum(err ** 2))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_tail_inputs(dev, nd, c, seed):
    rng = np.random.default_rng(seed)
    u = lambda *s: T(rng.uniform(-0.5, 0.5, s).astype(np.float32)).to(dev)
    wt = T(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(80_000, 240_000), 1, 128)).to(dev)
    wa = T(fir.toeplitz_weights(
        firdesign.design_lowpass_fir(8_000, 240_000), 5, 32)).to(dev)
    lo = (T(rng.integers(0, 2**31, c)).to(dev),
          T(rng.integers(0, 2**32, c)).to(dev))
    mode = T((np.arange(c) % 4).astype(np.int32)).to(dev)
    prod = u(nd, 2 * c).bfloat16()
    return prod, lo, wt, wa, mode, (u(63, c), u(63, c), u(2, c), u(63, c))


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
def test_audio_kernel_on_a_bf16_product_on_card(cuda_device, fast):
    prod, lo, wt, wa, mode, carry = _card_tail_inputs(cuda_device, 10_240,
                                                      1_024, 11)
    fm = (mode == 1).cpu().numpy()
    before = tail_tm.fused_tail_audio_tm.launches
    got = tail_tm.fused_tail_audio_tm(prod, prod, *lo, wt, wa, 5, mode,
                                      *carry, packed=True, fast=fast)
    torch.cuda.synchronize()
    assert tail_tm.fused_tail_audio_tm.launches == before + 1
    # the plain tail on .float() of the same product: the upcast is exact
    ref = tail_tm.fused_tail_audio_tm_ref(prod, prod, *lo, wt, wa, 5, mode,
                                          *carry, packed=True, fast=fast)
    g, r = ([a.cpu().numpy() for a in x] for x in (got, ref))
    assert np.abs(r[0]).max() > 1e-3
    _fm_flips(g[0], r[0], fm, 1e-5, float(wa.abs().max()))
    for i in (1, 2, 3):
        np.testing.assert_allclose(g[i], r[i], rtol=0, atol=1e-6)
    np.testing.assert_allclose(g[5], r[5], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_chanrate_kernel_on_a_bf16_product_on_card(cuda_device):
    prod, lo, wt, _, mode, carry = _card_tail_inputs(cuda_device, 25_600,
                                                     1_024, 12)
    got = tail_tm.fused_tail_tm(prod, prod, *lo, wt, mode, *carry[:3],
                                packed=True, fast=True)
    ref = tail_tm.fused_tail_tm_ref(prod, prod, *lo, wt, mode, *carry[:3],
                                    packed=True, fast=True)
    g, r = ([a.cpu().numpy() for a in x] for x in (got, ref))
    fm = (mode == 1).cpu().numpy()
    err = g[0] - r[0]
    err[:, fm] -= np.round(err[:, fm])  # raw demod rows: whole turns
    assert np.abs(err[:, ~fm]).max() <= 1e-5
    assert (np.abs(err[:, fm]) > 1e-5).mean() <= 1e-4
    for i in (1, 2, 3):
        np.testing.assert_allclose(g[i], r[i], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["default", "high"])
def test_fused_filterbank_kernel_at_tier_on_card(cuda_device, tier):
    """Kernel #3 at a lossy tier against its plain version (the same law).
    The yardstick is the product made exactly (float64) and rounded once
    to float32, through the same plain tail."""
    dev, c = cuda_device, 1_024
    cfg = tch.ChannelizedConfig(num_channels=c, block_frames=102_400,
                                tail_kernel="pallas_pfb", pfb_precision=tier)
    ifs = [int(f) for f in np.linspace(-1_150_000, 1_150_000, c)]
    modes = [("AM", "FM", "USB", "LSB")[i % 4] for i in range(c)]
    p = tch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                    device=dev)
    s = tch.init_channelized_state(cfg, dev)
    iq = T(_block(13, 102_400)).to(dev)
    frames, _ = tchan.pfb_frames_tm(iq, cfg.proto_taps, BINS, s.pfb_hist)
    w2 = p.pfb_weights.reshape(2 * cfg.proto_taps, 2 * c)
    common = (frames, w2, s.nco_phase, p.residual_step, p.chan_toep,
              p.audio_toep, 5, p.mode, s.chan_hist[0].T.contiguous(),
              s.chan_hist[1].T.contiguous(), s.demod_prev,
              s.audio_hist.T.contiguous())
    got = tail_tm.fused_pfb_tail_audio_tm(
        *common, fast=True, pfb_precision=tier,
        pfb_weights_split=p.pfb_weights_split)
    ref = tail_tm.fused_pfb_tail_audio_tm_ref(
        *common, fast=True, pfb_precision=tier,
        pfb_weights_split=p.pfb_weights_split)
    exact = tail_tm.fused_tail_audio_tm_ref(
        *((frames.double() @ w2.double()),) * 2, *common[2:], packed=True,
        fast=True)
    cols = np.array([m != "FM" for m in modes])
    g, r, x = (a[0].double().cpu().numpy() for a in (got, ref, exact))
    assert np.abs(x).max() > 1e-2
    assert _snr_db(x, g, cols) >= _snr_db(x, r, cols) - 0.5
    assert np.abs(g[:, cols] - r[:, cols]).max() <= 1e-5
