"""The plain reference: the channelized receiver chain and the waterfall row
in float64 (or, as the control, float32 with TF32 products), from the
configuration alone.

It imports nothing of the program. The design law (the filterbank
prototype, its per-channel weights, the bin assignment, the residual NCO
step, the reference FIR design and the Hamming window) is a frozen copy of
the law the server designs its parameters by, value for value in float32,
so that the program and this file start from the same coefficients without
this file reading any of the program's. The arithmetic after the design is
exact (float64) here; the program computes it in float32 at its tiers.

The chain of one receiver, block after block (the stream semantics the
server's step carries):

1. filterbank: ``y[m] = sum_k x[m D - k] w[k]`` over the ``K_p``-tap
   prototype turned to the receiver's bin (``D`` bins, decimation ``D``),
   with the last ``K_p - 1`` input samples carried;
2. the residual NCO: the conjugate LO at the exact 31-bit phase
   ``(phase0 + m step) mod 2^31``, ``phase0`` carried;
3. the 64-tap shaping FIR on the mixed samples, 63 carried;
4. the squelch power: the mean of ``|y|^2`` over the block after the
   shaping FIR;
5. the demodulator (AM, FM ``atan2(ii, qq) / 2 pi`` against the previous
   sample, USB, LSB), the previous sample carried;
6. the decimating 64-tap audio FIR (output ``n`` at input ``D_a n``), 63
   carried;
7. the gain and the squelch gate.

Every carry spans fewer than one block's samples, so a block's audio is
exact after one earlier block run from zero history (the NCO phase, which
does not forget, is handed in): :func:`audio_rows` runs the blocks it is
given and returns the last one's audio.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PHASE_BITS = 31
PHASE_MASK = (1 << PHASE_BITS) - 1
FIR_LENGTH = 64
MODES = ("AM", "FM", "USB", "LSB")


# ---- the design law (frozen copy) -------------------------------------
def hamming(n: int) -> np.ndarray:
    """``0.54 - 0.46 cos(2 pi k / (n - 1))`` in float32."""
    k = np.arange(n, dtype=np.float32)
    return (0.54 - 0.46 * np.cos(2 * np.pi * k / np.float32(n - 1))).astype(
        np.float32)


def design_lowpass_fir(passband_hz: int, rate_hz: int,
                       n: int = FIR_LENGTH) -> np.ndarray:
    """The reference lowpass (mikestir/webradio ``src/dsp/lowpass.cxx``):
    a brick-wall spectrum below ``maxbin = n passband / rate / 2`` in
    integer division, its unnormalised inverse DFT in complex64, the
    fftshift reorder and a Hamming window carrying ``1/n``. Float32."""
    maxbin = (n * int(passband_hz)) // int(rate_hz) // 2
    spec = np.zeros(n, dtype=np.complex64)
    k = np.arange(n // 2 + 1)
    passed = (k < maxbin).astype(np.float32)
    spec[k] = passed
    spec[(n - k) & (n - 1)] = passed
    impulse = (np.fft.ifft(spec) * n).astype(np.complex64)
    shift = np.arange(n)
    taps = impulse[(shift + n // 2) & (n - 1)].real.astype(np.float32)
    return taps * (hamming(n) / np.float32(n))


def design_prototype(fs_hz: int, num_bins: int,
                     taps_per_phase: int) -> np.ndarray:
    """Hamming-windowed sinc, cutoff at the bin edge ``fs / (2 D)``, length
    ``D * taps_per_phase``, unit DC gain; float32."""
    kp = int(num_bins) * int(taps_per_phase)
    n = np.arange(kp, dtype=np.float64) - (kp - 1) / 2.0
    fc = 0.5 / num_bins
    h = 2 * fc * np.sinc(2 * fc * n)
    h = h * (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(kp) / (kp - 1)))
    return (h / h.sum()).astype(np.float32)


def assign_bins(if_hz, fs_hz: int, num_bins: int):
    """Nearest bin and the residual: ``if = bin fs / D + residual``."""
    ifs = np.atleast_1d(np.asarray(if_hz, dtype=np.int64))
    nearest = np.round(ifs / (fs_hz / num_bins)).astype(np.int64)
    residual = ifs - (nearest * fs_hz) // num_bins
    return (nearest % num_bins).astype(np.int64), residual


def nco_phase_step(if_hz: int, fs_hz: int) -> int:
    """31-bit phase step, truncated toward zero, as a uint32 pattern."""
    if if_hz >= 0:
        step = (int(if_hz) << PHASE_BITS) // int(fs_hz)
    else:
        step = -((-int(if_hz) << PHASE_BITS) // int(fs_hz))
    return step & 0xFFFFFFFF


def bin_weights(proto: np.ndarray, num_bins: int, bins) -> np.ndarray:
    """``[2 K_p, 2 k]``: for each channel its I-plane and Q-plane taps,
    columns ``[:k]`` the mixed I output and ``[k:]`` the mixed Q."""
    kp = proto.shape[0]
    kk = np.arange(kp)[:, None]
    c = np.asarray(bins, np.int64)[None, :]
    ang = 2.0 * np.pi * (kk * c % num_bins) / num_bins
    hcos = (proto[:, None] * np.cos(ang)).astype(np.float32)
    hsin = (proto[:, None] * np.sin(ang)).astype(np.float32)
    return np.concatenate([np.concatenate([hcos, -hsin], axis=0),
                           np.concatenate([hsin, hcos], axis=0)], axis=1)


class Chain:
    """A configuration's fixed sizes and the design of each receiver
    setting (``if_hz``, ``if_bw``, ``af_bw``), made once."""

    def __init__(self, tuner: dict):
        self.fs = int(tuner.get("sample_rate", 2_400_000))
        self.channel_rate = int(tuner.get("channel_rate", 240_000))
        self.audio_rate = int(tuner.get("audio_rate", 48_000))
        self.block_frames = int(tuner.get("block_frames", 102_400))
        self.fft_size = 512
        self.bins = self.fs // self.channel_rate
        self.audio_decim = self.channel_rate // self.audio_rate
        self.kp = self.bins * 16
        self.nd = self.block_frames // self.bins
        self.af = self.nd // self.audio_decim
        self.proto = design_prototype(self.fs, self.bins, 16)
        self._fir: dict = {}

    @property
    def block_seconds(self) -> float:
        return self.block_frames / self.fs

    def fir(self, bw: int) -> np.ndarray:
        if bw not in self._fir:
            self._fir[bw] = design_lowpass_fir(bw, self.channel_rate)
        return self._fir[bw]

    def bin_and_step(self, if_hz: int) -> tuple[int, int]:
        b, r = assign_bins([if_hz], self.fs, self.bins)
        return int(b[0]), nco_phase_step(int(r[0]) * self.bins, self.fs)


# ---- arithmetic ---------------------------------------------------------
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest: what
    a TF32 tensor-core product takes of its operands. The control rounds by
    hand on every device: cuBLAS takes a product of one row (the waterfall's
    DFT) off the tensor cores, where TF32 would not apply."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``a @ b``; with ``tf32`` the float32 operands are rounded to TF32
    first, so the product is TF32's (exact products, float32 sums)."""
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def _fir(x: torch.Tensor, hist: torch.Tensor, taps: torch.Tensor,
         decim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [n, k]`` through per-column ``taps [k, 64]`` with ``hist [63,
    k]`` before it: output ``j`` at input ``decim j``; the new history."""
    ntaps = taps.shape[1]
    ext = torch.cat([hist, x], dim=0)
    n_out = x.shape[0] // decim
    out = torch.zeros((n_out, x.shape[1]), dtype=x.dtype, device=x.device)
    for i in range(ntaps):
        # input decim * j - i sits at ext row decim * j - i + ntaps - 1
        start = ntaps - 1 - i
        out += taps[:, i][None, :] * ext[start:start + decim * n_out:decim]
    return out, ext[-(ntaps - 1):]


def _demod(i, q, pi_, pq, modes: torch.Tensor) -> torch.Tensor:
    ii = i * pi_ + q * pq
    qq = q * pi_ - i * pq
    fm = torch.atan2(ii, qq) / (2.0 * math.pi)
    am = torch.sqrt(i * i + q * q)
    m = modes[None, :]
    return torch.where(m == 0, am, torch.where(
        m == 1, fm, torch.where(m == 2, i + q, i - q)))


def audio_rows(chain: Chain, blocks, settings, phase0, *,
               dtype=torch.float64, tf32: bool = False,
               device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """The audio of the last of ``blocks`` for ``k`` receivers.

    ``blocks``: consecutive served blocks, each ``[2, N]`` (numpy, any
    float type), the earlier ones warm-up from zero history.
    ``settings[j]``: for block ``j``, a list of ``k`` tuples ``(if_hz,
    if_bw, af_bw, mode, gain_db, squelch_db or None)``. ``phase0[j]``:
    the ``k`` receivers' NCO phases at the first sample of block ``j``.
    Returns ``(audio [k, af], power [k])`` of the last block, float64 on
    the host's side of ``device``'s results."""
    dev = torch.device(device)
    k = len(settings[0])
    nd, kp, d = chain.nd, chain.kp, chain.bins
    raw_hist = torch.zeros((2, kp - 1), dtype=dtype, device=dev)
    mix_hist = torch.zeros((63, 2 * k), dtype=dtype, device=dev)
    prev = torch.zeros((2, k), dtype=dtype, device=dev)
    a_hist = torch.zeros((63, k), dtype=dtype, device=dev)
    scale_angle = 2.0 * math.pi / (1 << PHASE_BITS)
    m_idx = torch.arange(nd, dtype=torch.int64, device=dev)[:, None]
    for j, block in enumerate(blocks):
        x = torch.as_tensor(np.asarray(block), device=dev).to(dtype)
        rows = settings[j]
        design = [chain.bin_and_step(s[0]) for s in rows]
        w = torch.from_numpy(bin_weights(chain.proto, d,
                                         [b for b, _ in design])).to(dev)
        steps = torch.tensor([s for _, s in design], dtype=torch.int64,
                             device=dev)
        ext = torch.cat([raw_hist, x], dim=1)
        raw_hist = ext[:, -(kp - 1):]
        frames = ext.unfold(1, kp, d).flip(-1)  # [2, nd, kp]
        frames = torch.cat([frames[0], frames[1]], dim=1)  # [nd, 2 kp]
        y = _mm(frames, w.to(dtype), tf32)
        ci, cq = y[:, :k], y[:, k:]
        p0 = torch.tensor(phase0[j], dtype=torch.int64, device=dev)
        theta = ((p0[None, :] + m_idx * steps[None, :]) & PHASE_MASK)
        theta = theta.to(dtype) * scale_angle
        s, c = torch.sin(theta), torch.cos(theta)
        mixed = torch.cat([ci * c + cq * s, cq * c - ci * s], dim=1)
        chan_taps = torch.from_numpy(np.stack(
            [chain.fir(r[1]) for r in rows] * 2)).to(dev, dtype)
        shaped, mix_hist = _fir(mixed, mix_hist, chan_taps, 1)
        yi, yq = shaped[:, :k], shaped[:, k:]
        power = (yi * yi + yq * yq).mean(dim=0)
        pi_ = torch.cat([prev[0][None], yi[:-1]], dim=0)
        pq = torch.cat([prev[1][None], yq[:-1]], dim=0)
        prev = torch.stack([yi[-1], yq[-1]])
        modes = torch.tensor([MODES.index(r[3]) for r in rows], device=dev)
        demod = _demod(yi, yq, pi_, pq, modes)
        audio_taps = torch.from_numpy(np.stack(
            [chain.fir(r[2]) for r in rows])).to(dev, dtype)
        audio, a_hist = _fir(demod, a_hist, audio_taps, chain.audio_decim)
    gain = torch.tensor([float(np.float32(10.0) ** (np.float32(r[4])
                                                     / np.float32(20.0)))
                         for r in rows], dtype=dtype, device=dev)
    squelch = torch.tensor([math.nan if r[5] is None else float(r[5])
                            for r in rows], dtype=dtype, device=dev)
    power_db = 10.0 * torch.log10(torch.clamp(power, min=1e-30))
    gate = torch.isnan(squelch) | (power_db >= squelch)
    audio = audio * (gain * gate.to(dtype))[None, :]
    return (audio.T.to("cpu", torch.float64),
            power.to("cpu", torch.float64))


def spectrum_row(block, fft_size: int = 512, *, dtype=torch.float64,
                 tf32: bool = False, device="cpu") -> np.ndarray:
    """The waterfall row of a block: the Hamming-windowed DFT of its last
    ``fft_size`` frames, ``10 log10 |X|^2 - 20 log10(fft_size)`` dB,
    fftshifted (mikestir/webradio ``src/io/spectrumsink.cxx``)."""
    dev = torch.device(device)
    x = torch.as_tensor(np.asarray(block)[:, -fft_size:], device=dev).to(
        dtype)
    win = torch.from_numpy(hamming(fft_size)).to(dev, dtype)
    t = np.arange(fft_size)[:, None].astype(np.float64)
    theta = 2.0 * np.pi * t * t.T / fft_size
    cmat = torch.from_numpy(np.cos(theta)).to(dev, dtype)
    smat = torch.from_numpy(np.sin(theta)).to(dev, dtype)
    xr, xi = (x[0] * win)[None], (x[1] * win)[None]
    re = _mm(xr, cmat, tf32) + _mm(xi, smat, tf32)
    im = _mm(xi, cmat, tf32) - _mm(xr, smat, tf32)
    power = (re * re + im * im)[0]
    scaledb = float(np.float32(20.0) * np.log10(np.float32(fft_size)))
    db = 10.0 * torch.log10(power) - scaledb
    db = torch.cat([db[fft_size // 2:], db[:fft_size // 2]])
    return db.to("cpu", torch.float64).numpy()
