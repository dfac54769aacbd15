"""The benchmark's plain reference on the CPU: its frozen design law equals
the server's today, and its chain equals a separate float64 chain written
with complex numbers (``np.convolve``), block after block.

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import reference

TUNER = {"sample_rate": 2_400_000, "block_frames": 102_400}


def test_the_frozen_design_law_is_the_servers():
    from webradio_tpu_torch.ops import channelizer, firdesign, nco

    chain = reference.Chain(TUNER)
    for bw in (8_000, 12_500, 80_000):
        np.testing.assert_array_equal(
            chain.fir(bw), firdesign.design_lowpass_fir(bw, 240_000))
    proto = channelizer.design_prototype(2_400_000, 10, 16)
    np.testing.assert_array_equal(chain.proto, proto)
    ifs = [-1_080_000, -60_000, 0, 4_000, 100_000, 1_020_000]
    bins, res = channelizer.assign_bins(ifs, 2_400_000, 10)
    w = channelizer.bin_weights_for_channels(proto, 10, bins)
    np.testing.assert_array_equal(
        reference.bin_weights(chain.proto, 10, bins), w.reshape(320, -1))
    for f, b, r in zip(ifs, bins, res):
        assert chain.bin_and_step(f) == (
            b, nco.nco_phase_step(int(r) * 10, 2_400_000))


def _independent(x: np.ndarray, if_hz: int, mode: str, gain_db: float,
                 squelch) -> np.ndarray:
    """One receiver's audio over the whole of ``x`` ``[2, n]`` from zero
    state, in complex float64: the filterbank as a complex convolution
    decimated by D, the LO as ``exp(-j theta)``, the FIRs as
    ``np.convolve``."""
    chain = reference.Chain(TUNER)
    d = chain.bins
    b, step = chain.bin_and_step(if_hz)
    k = np.arange(chain.kp)
    ang = 2 * np.pi * (k * b % d) / d
    # the law's taps, each part rounded to float32 as the server's are
    h = ((chain.proto * np.cos(ang)).astype(np.float32)
         + 1j * (chain.proto * np.sin(ang)).astype(np.float32))
    z = x[0].astype(np.float64) + 1j * x[1].astype(np.float64)
    y = np.convolve(z, h)[: z.size][::d]
    m = np.arange(y.size, dtype=np.int64)
    phase = (m * step) & reference.PHASE_MASK
    mixed = y * np.exp(-1j * phase * (2 * np.pi / (1 << 31)))
    shaped = np.convolve(mixed, chain.fir(80_000).astype(np.float64))[
        : mixed.size]
    prev = np.concatenate([[0], shaped[:-1]])
    i, q, pi_, pq = shaped.real, shaped.imag, prev.real, prev.imag
    demod = {"AM": np.abs(shaped), "USB": i + q, "LSB": i - q,
             "FM": np.arctan2(i * pi_ + q * pq, q * pi_ - i * pq)
             / (2 * np.pi)}[mode]
    audio = np.convolve(demod, chain.fir(8_000).astype(np.float64))[
        : demod.size][:: chain.audio_decim]
    return audio, shaped


@pytest.mark.parametrize("blocks", [1, 3])
def test_the_chain_equals_a_complex_float64_chain(blocks):
    chain = reference.Chain(TUNER)
    rng = np.random.default_rng(7)
    n = TUNER["block_frames"]
    t = np.arange(blocks * n) / 2.4e6
    z = 0.05 * np.exp(1j * (2 * np.pi * 100_000 * t
                            + 0.6 * np.sin(2 * np.pi * 1_000 * t)))
    z += 0.05 * np.exp(1j * 2 * np.pi * -361_000 * t)
    z += 0.01 * (rng.standard_normal(z.size) + 1j * rng.standard_normal(
        z.size))
    x = np.round(np.stack([z.real, z.imag]) * 128).clip(-128, 127) / 128
    rx = [(100_000, "FM", 0.0, -40.0), (-361_000, "AM", 6.0, None),
          (99_000, "USB", -6.0, None), (100_000, "LSB", 0.0, None),
          (700_000, "FM", 0.0, -40.0)]
    settings = [[(f, 80_000, 8_000, mode, g, sq) for f, mode, g, sq in rx]
                ] * blocks
    nd = chain.nd
    phase0 = [[(j * nd * chain.bin_and_step(f)[1]) & reference.PHASE_MASK
               for f, *_ in rx] for j in range(blocks)]
    got, power = reference.audio_rows(
        chain, [x[:, j * n:(j + 1) * n] for j in range(blocks)], settings,
        phase0)
    af = chain.af
    for r, (f, mode, g, sq) in enumerate(rx):
        audio, shaped = _independent(x, f, mode, g, sq)
        want = audio[(blocks - 1) * af:]
        p = np.mean(np.abs(shaped[(blocks - 1) * nd:]) ** 2)
        assert power[r].item() == pytest.approx(p, rel=1e-9)
        gate = sq is None or 10 * math.log10(p) >= sq
        want = want * float(np.float32(10) ** (np.float32(g) / 20)) * gate
        scale = max(np.max(np.abs(want)), 1e-12)
        assert np.max(np.abs(got[r].numpy() - want)) <= 1e-9 * scale + 1e-15
    assert got[4].abs().max() == 0  # squelched: nothing at 700 kHz


def test_the_spectrum_row_is_the_windowed_dft():
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (2, 4096)) / 128
    row = reference.spectrum_row(x)
    z = (x[0, -512:] + 1j * x[1, -512:]) * reference.hamming(512)
    want = 10 * np.log10(np.abs(np.fft.fft(z)) ** 2) - float(
        np.float32(20) * np.log10(np.float32(512)))
    np.testing.assert_allclose(row, np.fft.fftshift(want), atol=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-12, 3.0 + 2.0**-10])
    assert reference.round_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0,
                                                 3.0 + 2.0**-9]
