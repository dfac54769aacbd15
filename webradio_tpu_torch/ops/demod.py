"""Demodulation laws over time-major and time-minor planes (port of
``webradio_tpu.ops.demod``, reference src/dsp/demodulator.cxx:77-115).

* AM  — envelope ``sqrt(i^2 + q^2)``.
* FM  — multiply by the conjugate of the previous sample, then
  ``atan2(ii, qq) / 2pi`` — the reference's swapped argument order
  (demodulator.cxx:97), kept for audio parity.
* USB / LSB — the reference's naive ``i + q`` / ``i - q``.

The only cross-block state is FM's previous sample, ``[2, C]``.
"""

from __future__ import annotations

import numpy as np
import torch

from .trig import atan2

# Mode encoding matches the reference enum order (demodulator.cxx:37-41)
MODE_AM = 0
MODE_FM = 1
MODE_USB = 2
MODE_LSB = 3
MODES = ("AM", "FM", "USB", "LSB")

INV_2PI = float(np.float32(1.0 / (2.0 * np.pi)))


def _laws(i, q, pi_, pq, m):
    """The four laws on planes of any layout; ``pi_``/``pq`` are the planes
    delayed by one sample, ``m`` the mode broadcast against them."""
    am = torch.sqrt(i * i + q * q)
    ii = i * pi_ + q * pq
    qq = q * pi_ - i * pq
    fm = atan2(ii, qq) * INV_2PI  # reference arg order, demodulator.cxx:97
    usb = i + q
    lsb = i - q
    return torch.where(
        m == MODE_AM,
        am,
        torch.where(m == MODE_FM, fm, torch.where(m == MODE_USB, usb, lsb)),
    )


def demodulate_tm(
    i: torch.Tensor, q: torch.Tensor, mode: torch.Tensor, prev: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Demodulate planes ``i, q [N, C]`` with per-channel ``mode [C]``.

    ``prev [2, C]`` is the previous block's last (i, q) sample. Returns
    ``(audio [N, C], new_prev [2, C])``.
    """
    pi_ = torch.cat([prev[0][None, :], i[:-1, :]], dim=0)
    pq = torch.cat([prev[1][None, :], q[:-1, :]], dim=0)
    audio = _laws(i, q, pi_, pq, mode.to(torch.int32)[None, :])
    return audio, torch.stack([i[-1], q[-1]])


def demodulate(
    x: torch.Tensor, mode: torch.Tensor, prev: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-minor twin of :func:`demodulate_tm`: ``x [2, C, N]`` to
    ``(audio [C, N], new_prev [2, C])`` with ``new_prev = x[:, :, -1]``."""
    i, q = x[0], x[1]
    pi_ = torch.cat([prev[0][:, None], i[:, :-1]], dim=-1)
    pq = torch.cat([prev[1][:, None], q[:, :-1]], dim=-1)
    audio = _laws(i, q, pi_, pq, mode.to(torch.int32)[:, None])
    return audio, x[:, :, -1].contiguous()
