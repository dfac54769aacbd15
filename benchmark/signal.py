"""The input of a run, made from its seed: where the carriers and the
listened receivers sit, and the ring of distinct IQ blocks on the 8-bit
grid that the generator cycles through.

An RTL2832U delivers unsigned 8-bit I and Q, which the server reads as
``(u - 128) / 128``. The blocks here are FM carriers (a tone each, on a
grid that makes the ring's period a whole number of their cycles, so the
ring loops without a seam) plus Gaussian noise, rounded to that grid.

Carriers sit at fixed offsets from the filterbank's bin centres and never
near a bin edge; listened receivers sit a few kHz off a carrier (one
carrier in the channel, so the discriminator never meets the branch cut of
``atan2``), or, squelched, on a bin edge that no carrier reaches. Every
seed gives the same counts and the same schedule; the seed picks which
positions, tones, phases, gains and noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: distinct blocks in the ring the generator cycles through
POOL_BLOCKS = 16

#: the band every mix lays out: carriers at fixed offsets from each
#: filterbank bin's centre within ``span_hz`` of the tuner's centre,
#: listened receivers ``listen_offsets_hz`` off a carrier, FM tones,
#: noise, and the receivers' AF gains in turn
SIGNAL = {
    "span_hz": 1_100_000,
    "carrier_offsets_hz": [-60_000, 0, 60_000],
    "listen_offsets_hz": [-4_000, -3_000, -2_000, -1_000, 0, 1_000, 2_000,
                          3_000, 4_000],
    "carrier_amplitude": 0.05,
    "deviation_hz": 3_000,
    "tone_hz": [300, 3_000],
    "noise_rms": 0.01,
    "gains_db": [0, 6, -6],
}


@dataclasses.dataclass
class Receiver:
    """One listened receiver as the traffic sets it."""

    if_hz: int
    kind: str  # "carrier" or "empty"
    gain_db: float


@dataclasses.dataclass
class Plan:
    """What a seed fixes before the run."""

    carriers: list  # (if_hz, tone_hz, deviation_hz, phase, tone_phase)
    receivers: list  # Receiver, in attach order
    free: dict  # kind -> positions (if_hz) no receiver holds
    retunes: list  # (receiver index, new if_hz) in schedule order
    amplitude: float
    noise_rms: float


def positions(tuner: dict, signal: dict) -> tuple[list, list, list]:
    """``(carrier ifs, listening ifs by carrier, empty ifs)``: the carrier
    IFs at ``carrier_offsets_hz`` from each bin centre within
    ``span_hz``, the receiver IFs ``listen_offsets_hz`` off each, and the
    bin edges within the span, each with the same offsets."""
    fs = int(tuner.get("sample_rate", 2_400_000))
    spacing = int(tuner.get("channel_rate", 240_000))
    span = int(signal["span_hz"])
    offs = [int(o) for o in signal["carrier_offsets_hz"]]
    listen = [int(o) for o in signal["listen_offsets_hz"]]
    half = fs // 2
    carriers, by_carrier, empty = [], [], []
    for b in range(-(half // spacing), half // spacing + 1):
        centre = b * spacing
        for o in offs:
            f = centre + o
            if abs(f) + max(map(abs, listen)) <= span:
                carriers.append(f)
                by_carrier.append([f + d for d in listen])
        edge = centre + spacing // 2
        if abs(edge) + max(map(abs, listen)) <= span:
            empty.extend(edge + d for d in listen)
    return carriers, by_carrier, empty


def make_plan(tuner: dict, traffic: dict, seed: int,
              retune_count: int = 0) -> Plan:
    """The seed's receivers and carriers (and ``retune_count`` retunes):
    the mix's ``listeners`` (``squelched_listeners`` of them on empty bin
    edges) laid over :data:`SIGNAL`'s band."""
    sig = SIGNAL
    rng = np.random.default_rng(seed)
    carriers, by_carrier, empty = positions(tuner, sig)
    n = int(traffic["listeners"])
    n_empty = int(traffic["squelched_listeners"])
    listen = [f for fs_ in by_carrier for f in fs_]
    if n - n_empty > len(listen) or n_empty > len(empty):
        raise ValueError(f"{n} listeners ({n_empty} squelched) do not fit "
                         f"{len(listen)} carrier and {len(empty)} empty "
                         "positions")
    # at most one receiver a carrier until every carrier has one
    order = []
    for f_list in (rng.permutation(len(by_carrier)) for _ in
                   range(len(sig["listen_offsets_hz"]))):
        order.extend(f_list)
    used = set()
    picks = []
    for c in order:
        free = [f for f in by_carrier[c] if f not in used]
        if not free:
            continue
        f = free[rng.integers(len(free))]
        used.add(f)
        picks.append(f)
        if len(picks) == n - n_empty:
            break
    empties = [empty[i] for i in rng.permutation(len(empty))[:n_empty]]
    gains = list(sig["gains_db"])
    kinds = [("carrier", f) for f in picks] + [("empty", f)
                                               for f in empties]
    kinds = [kinds[i] for i in rng.permutation(len(kinds))]
    receivers = [Receiver(if_hz=int(f), kind=k,
                          gain_db=float(gains[i % len(gains)]))
                 for i, (k, f) in enumerate(kinds)]
    taken = {r.if_hz for r in receivers}
    free = {"carrier": [f for f in listen if f not in taken],
            "empty": [f for f in empty if f not in taken]}
    # a retune moves a receiver to a free position of its own kind, so
    # the work a run does is the same for every seed
    now = [r.if_hz for r in receivers]
    pool = {k: list(v) for k, v in free.items()}
    retunes = []
    for _ in range(retune_count):
        i = int(rng.integers(n))
        spare = pool[receivers[i].kind]
        j = int(rng.integers(len(spare)))
        spare[j], now[i] = now[i], spare[j]
        retunes.append((i, int(now[i])))
    lo, hi = sig["tone_hz"]
    tone = rng.uniform(lo, hi, len(carriers))
    carrier_rows = [(int(f), float(t), float(sig["deviation_hz"]),
                     float(p), float(tp))
                    for f, t, p, tp in zip(
                        carriers, tone, rng.uniform(0, 2 * np.pi,
                                                    len(carriers)),
                        rng.uniform(0, 2 * np.pi, len(carriers)))]
    return Plan(carriers=carrier_rows, receivers=receivers, free=free,
                retunes=retunes, amplitude=float(sig["carrier_amplitude"]),
                noise_rms=float(sig["noise_rms"]))


def make_pool(tuner: dict, plan: Plan, seed: int, device="cpu") -> list:
    """:data:`POOL_BLOCKS` consecutive ``[2, N]`` float32 blocks on the 8-bit grid,
    made on ``device`` in float64 and handed back as host arrays. Each
    frequency is moved onto the grid ``fs / (blocks N)`` (at most half a
    step, under 1 Hz at stock sizes) so that the ring loops seamlessly."""
    fs = int(tuner.get("sample_rate", 2_400_000))
    n = int(tuner.get("block_frames", 102_400))
    dev = torch.device(device)
    blocks = POOL_BLOCKS
    grid = fs / (blocks * n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    out = []
    two_pi = 2.0 * np.pi
    for j in range(blocks):
        t = torch.arange(j * n, (j + 1) * n, dtype=torch.float64,
                         device=dev) / fs
        re = torch.zeros(n, dtype=torch.float64, device=dev)
        im = torch.zeros(n, dtype=torch.float64, device=dev)
        for f, tone, dev_hz, phase, tone_phase in plan.carriers:
            fc = round(f / grid) * grid
            ft = max(1, round(tone / grid)) * grid
            ang = (two_pi * fc * t + phase
                   + (dev_hz / ft) * torch.sin(two_pi * ft * t + tone_phase))
            re += plan.amplitude * torch.cos(ang)
            im += plan.amplitude * torch.sin(ang)
        noise = torch.randn((2, n), generator=gen, dtype=torch.float64,
                            device=dev) * plan.noise_rms
        iq = torch.stack([re, im]) + noise
        iq = torch.clamp(torch.round(iq * 128.0), -128, 127) / 128.0
        out.append(iq.to(torch.float32).cpu().numpy())
    return out
