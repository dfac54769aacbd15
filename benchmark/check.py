"""How ``correct`` is decided: the answers a run produced, against the plain
reference (``reference.py``) on the same blocks.

The answers are the audio rows the fan-out delivered for a seeded sample of
the window's blocks and its latest ones (every listened receiver's row of
each), the bytes each listener read for those blocks, and every waterfall
row the spectrum polls read. For each compared block the reference runs
the receivers' chain over the served blocks before it (the carries) with
each receiver's settings as the pump applied them (retunes included) and
its NCO phase from every block served before.

The numbers, each with its limit in the configuration's file:

- ``audio_gap``: the widest gap between a delivered audio sample and the
  reference's, over the median peak of the compared rows whose squelch is
  open (a squelched row must read 0);
- ``spectrum_gap_db``: the widest gap, in dB, between a polled waterfall
  row and the reference's row of a block published around the poll;
- ``wav_mismatch``: listener chunks whose bytes are not the 16-bit PCM of
  the delivered row (exact: limit 0);
- ``missing``: compared answers lost without the server counting them
  (limit 0). A block that the ring, the fan-out's queue or a consumer's
  queue dropped, and counted as it dropped it (the harness notes which
  block each count was), is a failure the server owns (in the result's
  ``failed``), not a wrong answer; any other compared block that never
  reached a listener is.

The compared blocks are the latest :data:`COMPARED_LATEST` of the window's
offered blocks and a sample of :data:`COMPARED_SAMPLED` drawn from the
seed (:class:`Reservoir`); no mix changes either.

The control (:func:`outputs` with ``control=True``) puts the reference,
computed in float32 with TF32 products, in the program's place on the same
blocks.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from . import reference

#: the window's latest offered blocks, every one compared
COMPARED_LATEST = 4
#: the window's offered blocks compared besides, a seeded sample
COMPARED_SAMPLED = 12


class Reservoir:
    """A uniform sample of :data:`COMPARED_SAMPLED` of the blocks offered
    one by one, drawn from the seed (the harness offers them as the run
    makes them; the control as its stand-in would)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(int(seed) ^ 0x5EED)
        self.seen = 0
        self.sample: list = []

    def offer(self, seq: int) -> None:
        self.seen += 1
        if len(self.sample) < COMPARED_SAMPLED:
            self.sample.append(seq)
            return
        j = int(self.rng.integers(self.seen))
        if j < COMPARED_SAMPLED:
            self.sample[j] = seq


def compared(sample, offered) -> list:
    """The seqs whose answers are compared."""
    return sorted(set(sample) | set(offered[-COMPARED_LATEST:]))


@dataclasses.dataclass
class Record:
    """What the check needs of a run (or of the control's stand-in)."""

    chain: reference.Chain
    pool: list
    plan: object
    template: dict
    served: list  # seqs in dispatch order (increasing)
    applied: dict  # seq -> retune numbers applied just before it
    compared: list  # seqs whose answers are compared
    polls: list  # (candidate seqs, row)
    listeners: int
    kept: dict | None = None  # seq -> (slots, rows [k, af])
    rx_of_slot: dict | None = None
    crc: dict | None = None  # (seq, receiver) -> CRC-32 a listener read
    # the blocks each queue dropped as it counted a drop: the ring's
    # (seq), the fan-out's (seq), a consumer's ((seq, receiver))
    ring_dropped: set = dataclasses.field(default_factory=set)
    fanout_dropped: set = dataclasses.field(default_factory=set)
    consumer_dropped: set = dataclasses.field(default_factory=set)


def wav_crc(row: np.ndarray) -> int:
    """CRC-32 of a row as the WAV stream's 16-bit PCM: clipped to
    [-1, 1], times 32767, truncated toward zero."""
    import zlib

    x = np.clip(np.asarray(row, np.float32), -1.0, 1.0)
    return zlib.crc32((x * np.float32(32767.0)).astype("<i2").tobytes())


class Settings:
    """Each receiver's settings and NCO phase at any served block."""

    def __init__(self, rec: Record):
        self.rec = rec
        tpl = rec.template
        self.fixed = (int(tpl.get("if_bandwidth", 80_000)),
                      int(tpl.get("af_bandwidth", 8_000)),
                      tpl.get("demodulator", "AM"),
                      tpl.get("squelch_threshold"))
        self.runs = {i: [(-1, r.if_hz)]
                     for i, r in enumerate(rec.plan.receivers)}
        for seq in sorted(rec.applied):
            for k in rec.applied[seq]:
                rx, if_hz = rec.plan.retunes[k]
                self.runs[rx].append((seq, if_hz))

    def pos(self, seq: int) -> int:
        """Served blocks before ``seq``."""
        return bisect.bisect_left(self.rec.served, seq)

    def of(self, i: int, seq: int) -> tuple:
        run = self.runs[i]
        if_hz = run[bisect.bisect_right([s for s, _ in run], seq) - 1][1]
        ifbw, afbw, mode, sq = self.fixed
        return (if_hz, ifbw, afbw, mode, self.rec.plan.receivers[i].gain_db,
                sq)

    def phase(self, i: int, seq: int) -> int:
        """Each served block before ``seq`` advanced the phase by ``nd``
        steps of the step then in force."""
        chain, run, total = self.rec.chain, self.runs[i], 0
        for j, (start, if_hz) in enumerate(run):
            end = min(run[j + 1][0] if j + 1 < len(run) else seq, seq)
            a = 0 if start < 0 else self.pos(start)
            b = self.pos(end)
            if b > a:
                total += (b - a) * chain.nd * chain.bin_and_step(if_hz)[1]
        return total & reference.PHASE_MASK


def outputs(rec: Record, device="cpu", control: bool = False) -> dict:
    """The compared numbers of a run (``control``: of the reference in
    float32 with TF32 products put in the program's place)."""
    st = Settings(rec)
    served = rec.served
    n = rec.listeners
    gaps, peaks = [], []
    missing = wav_bad = 0
    low = dict(dtype=torch.float32, tf32=True, device=device)
    for seq in rec.compared:
        k = bisect.bisect_left(served, seq)
        if k >= len(served) or served[k] != seq:
            # never dispatched: counted where the ring dropped it
            missing += 0 if seq in rec.ring_dropped else n
            continue
        if not control and seq not in rec.kept:
            # published or not, never delivered: counted where the
            # fan-out's queue dropped it
            missing += 0 if seq in rec.fanout_dropped else n
            continue
        run = served[max(0, k - 2):k + 1]
        blocks = [rec.pool[s % len(rec.pool)] for s in run]
        settings = [[st.of(i, s) for i in range(n)] for s in run]
        phase0 = [[st.phase(i, s) for i in range(n)] for s in run]
        ref, _ = reference.audio_rows(rec.chain, blocks, settings, phase0,
                                      device=device)
        ref = ref.numpy()
        if control:
            got = reference.audio_rows(rec.chain, blocks, settings, phase0,
                                       **low)[0].numpy()
            pairs = [(i, got[i]) for i in range(n)]
        else:
            slots, rows = rec.kept[seq]
            pairs = [(rec.rx_of_slot[s], rows[j])
                     for j, s in enumerate(slots)]
            missing += n - len(pairs)
        for i, row in pairs:
            gaps.append(float(np.max(np.abs(row - ref[i]))))
            peak = float(np.max(np.abs(ref[i])))
            if peak > 0:
                peaks.append(peak)
            if rec.crc is not None:
                crc = rec.crc.get((seq, i))
                if crc is None:
                    # lost unless the consumer's queue dropped it, and
                    # counted it
                    missing += (seq, i) not in rec.consumer_dropped
                elif crc != wav_crc(row):
                    wav_bad += 1
    scale = float(np.median(peaks)) if peaks else 1.0
    spec_gap = 0.0
    cache: dict = {}

    def spec(key, **kw):
        if (key, bool(kw)) not in cache:
            cache[(key, bool(kw))] = reference.spectrum_row(
                rec.pool[key], rec.chain.fft_size,
                **(kw or {"device": device}))
        return cache[(key, bool(kw))]

    for cands, row in rec.polls:
        if control:
            row = spec(cands[-1] % len(rec.pool), **low)
        best = min(float(np.max(np.abs(row - spec(s % len(rec.pool)))))
                   for s in cands)
        spec_gap = max(spec_gap, best)
    return {"audio_gap": max(gaps) / scale if gaps else None,
            "spectrum_gap_db": spec_gap, "wav_mismatch": wav_bad,
            "missing": missing}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit; a number without a limit, or without a value (nothing was
    compared), fails."""
    checks = {name: {"value": numbers[name], "limit": limits.get(name)}
              for name in numbers}
    ok = all(c["limit"] is not None and c["value"] is not None
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
