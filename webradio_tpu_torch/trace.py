"""A per-block flight recorder: every block a front end serves, stamped
where the work happens, from the ingest ring to the listeners' queues.

Each front end has one :class:`Recorder` (:func:`recorder`, keyed by the
front end's uuid): a preallocated ``int64`` table of :data:`TRACE_BLOCKS`
rows, one per block id modulo that count, with a column per field of
:data:`FIELDS`. A block id is the ring's count of blocks put before it
(``io.ring.BlockRing.put``), and follows the block through the pump
(``radio.FrontEnd.run_once``) and the fan-out (``_fanout_worker``).

- Every time is ``time.perf_counter_ns()``: ``CLOCK_MONOTONIC``, the clock
  of the benchmark's spans and of its device timeline.
- Each field has one writer thread: the capture thread writes ``put`` and
  ``ring_depth``, the pump the fields from ``got`` to ``fanout_depth``, the
  fan-out the rest. :meth:`Recorder.begin` clears a row and writes its
  ``id`` last (the id plus one; 0 is an empty row), and every later stamp
  checks the row still holds its id, so a reader that finds the id it
  expects before and after reading a row has that block's fields (or
  zeros where a stamp has not come yet). Readers take no lock.
- It is always on: a stamp is a clock read and an item write, about half a
  microsecond.
- The recorders are process-wide, like ``radio.Radio.front_ends``, and
  outlive their front end: a reader may come after the front end closed.
  :func:`clear` drops them (tests).

Spans are pairs of fields ``<name>0`` (start) and ``<name>1`` (end). A
block's ``publish`` and ``handoff`` come one call of the pump after its own
``dispatch``: the pipeline hands back the previous block's outputs.

``fetch_ready`` is 1 where the block's step had ended on every card as
its fetch began (a query of the event recorded just after the step, no
wait), and 0 where the fetch still waited on a card; off the card 1.

On a sharded front end (``parallel``) ``step_ns`` is the slowest card's
step and ``step_min_ns`` the fastest card's, and ``launch0`` / ``launch1``
are the host's stamps of the first and the last card's graph launch of the
block's round (``parallel.graphs.BlockProgram.run``); a single-card front
end leaves the three 0.
"""

from __future__ import annotations

import threading
import time

import numpy as np

#: rows a recorder holds: 46 min of blocks at the tuner's rate (42.67 ms)
TRACE_BLOCKS = 65_536
#: the latest blocks /status summarises
STATUS_BLOCKS = 1024

#: the table's columns, in order
FIELDS = (
    "id",  # block id + 1, written last by begin(); 0: an empty row
    # capture thread (the ring's put)
    "put", "ring_depth",
    # pump
    "got", "got_depth", "drained",
    "control0", "control1", "dispatch0", "dispatch1", "step_ns",
    "step_min_ns", "launch0", "launch1",
    "publish0", "publish1", "rows", "handoff0", "handoff1", "fanout_depth",
    # fan-out
    "picked", "fetch0", "fetch1", "d2h_bytes", "deliver0", "deliver1",
    "encode_ns", "pushed", "consumer_drops", "deepest", "fetch_ready",
)
COLUMN = {name: i for i, name in enumerate(FIELDS)}

#: the spans /status and /profile show: (name, start field, end field)
SPANS = (
    ("ring", "put", "got"),
    ("control", "control0", "control1"),
    ("dispatch", "dispatch0", "dispatch1"),
    ("launch", "launch0", "launch1"),
    ("publish", "publish0", "publish1"),
    ("handoff", "handoff0", "handoff1"),
    ("hold", "dispatch1", "handoff1"),
    ("queue", "handoff0", "picked"),
    ("fetch", "fetch0", "fetch1"),
    ("deliver", "deliver0", "deliver1"),
)
#: the counters /status averages
COUNTERS = ("ring_depth", "got_depth", "drained", "rows", "fanout_depth",
            "d2h_bytes", "encode_ns", "pushed", "consumer_drops", "deepest",
            "fetch_ready")

now = time.perf_counter_ns


WIDTH = len(FIELDS)
# the first column each writer fills (its fields follow in FIELDS' order)
_PUT, _GOT, _CONTROL0, _STEP = (COLUMN[n] for n in ("put", "got", "control0",
                                                    "step_ns"))
_LAUNCH0, _PUBLISH0, _HANDOFF0, _PICKED = (
    COLUMN[n] for n in ("launch0", "publish0", "handoff0", "picked"))


class Recorder:
    """One front end's table of blocks (see the module's docstring). The
    writers name the stamps of one place in the program each and write
    them through a flat view of the table, a few hundred nanoseconds a
    block's call."""

    def __init__(self, key: str, blocks: int = TRACE_BLOCKS):
        self.key = key
        self.blocks = int(blocks)
        # zeros: the pages are mapped as rows are first written
        self.table = np.zeros((self.blocks, WIDTH), np.int64)
        self._flat = memoryview(self.table).cast("B").cast("q")
        self._zeros = memoryview(np.zeros(WIDTH, np.int64)).cast(
            "B").cast("q")
        #: one more than the highest block id begun
        self.next_id = 0
        #: blocks whose step device time has been read
        self.steps = 0

    # ---- writers ---------------------------------------------------------
    def begin(self, bid: int, put: int = 0, ring_depth: int = 0) -> None:
        """A block's first stamp (the ring's put): clear its row, write
        ``put`` and ``ring_depth``, then its id."""
        f, base = self._flat, (bid % self.blocks) * WIDTH
        f[base:base + WIDTH] = self._zeros
        f[base + _PUT] = put
        f[base + _PUT + 1] = ring_depth
        f[base] = bid + 1
        if bid >= self.next_id:
            self.next_id = bid + 1

    def _row(self, bid) -> int:
        """Where block ``bid``'s row starts in the flat table; -1 for None,
        or where the row was taken by a later block."""
        if bid is None:
            return -1
        base = (bid % self.blocks) * WIDTH
        return base if self._flat[base] == bid + 1 else -1

    def got(self, bid, t: int, depth: int, drained: int) -> None:
        """The pump popped the block: the ring's depth after, and the
        blocks served in the same call."""
        base = self._row(bid) + _GOT
        if base >= _GOT:
            f = self._flat
            f[base], f[base + 1], f[base + 2] = t, depth, drained

    def dispatched(self, bid, c0: int, c1: int, d0: int, d1: int) -> None:
        """The control writes applied before the block, and its
        ``process_host``."""
        base = self._row(bid) + _CONTROL0
        if base >= _CONTROL0:
            f = self._flat
            f[base], f[base + 1], f[base + 2], f[base + 3] = c0, c1, d0, d1

    def step(self, bid, ns: int, ns_min: int = 0) -> None:
        """Block ``bid``'s step device time (on several cards the slowest
        card's, and ``ns_min`` the fastest card's)."""
        base = self._row(bid)
        if base >= 0:
            self._flat[base + _STEP] = ns
            self._flat[base + _STEP + 1] = ns_min
            self.steps += 1

    def launched(self, bid, l0: int, l1: int) -> None:
        """The first and the last card's launch of the block's round."""
        base = self._row(bid) + _LAUNCH0
        if base >= _LAUNCH0:
            f = self._flat
            f[base], f[base + 1] = l0, l1

    def published(self, bid, p0: int, p1: int, rows: int) -> None:
        """The publish of the block's outputs, and the rows gathered."""
        base = self._row(bid) + _PUBLISH0
        if base >= _PUBLISH0:
            f = self._flat
            f[base], f[base + 1], f[base + 2] = p0, p1, rows

    def handed(self, bid, h0: int, h1: int, depth: int) -> None:
        """The hand-off of the block's rows to the fan-out, and the items
        queued ahead of it."""
        base = self._row(bid) + _HANDOFF0
        if base >= _HANDOFF0:
            f = self._flat
            f[base], f[base + 1], f[base + 2] = h0, h1, depth

    def delivered(self, bid, picked: int, f0: int, f1: int, nbytes: int,
                  d0: int, d1: int, encode_ns: int, pushed: int, drops: int,
                  deepest: int, fetch_ready: int = 0) -> None:
        """The fan-out's stamps of the block: its pick of the hand-off,
        the fetch (``f0`` to ``f1``, ``nbytes`` copied; ``fetch_ready`` 1
        where the block's step had ended as it began), the delivery
        (``d0`` to ``d1``) and its counters."""
        base = self._row(bid) + _PICKED
        if base >= _PICKED:
            f = self._flat
            f[base], f[base + 1], f[base + 2], f[base + 3] = (picked, f0, f1,
                                                              nbytes)
            f[base + 4], f[base + 5], f[base + 6] = d0, d1, encode_ns
            f[base + 7], f[base + 8], f[base + 9] = pushed, drops, deepest
            f[base + 10] = fetch_ready

    # ---- readers ---------------------------------------------------------
    def rows(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """The rows of the held blocks with ids in ``[lo, hi)``, by id: a
        copy, without the rows a writer took for another block while it
        was read."""
        hi = self.next_id if hi is None else min(hi, self.next_id)
        lo = max(lo, hi - self.blocks, 0)
        if hi <= lo:
            return self.table[:0].copy()
        idx = np.arange(lo, hi) % self.blocks
        before = self.table[idx, 0]  # copies, as every indexing by idx
        got = self.table[idx]
        keep = (before == np.arange(lo, hi) + 1) & (
            self.table[idx, 0] == before)
        return got[keep]

    def column(self, rows: np.ndarray, name: str) -> np.ndarray:
        return rows[:, COLUMN[name]]

    def latest(self, name: str, back: int = 64) -> int:
        """The newest non-zero ``name`` among the last ``back`` blocks (0
        where none has it)."""
        col = self.column(self.rows(self.next_id - back), name)
        col = col[col != 0]
        return int(col[-1]) if col.size else 0

    def window(self, field: str, t0_ns: int, t1_ns: int):
        """The held rows whose ``field`` lies in ``[t0_ns, t1_ns)``, by id;
        None where the table has wrapped past blocks that may have had
        ``field`` in the window (its oldest held ``field`` is not before
        ``t0_ns``)."""
        rows = self.rows()
        col = self.column(rows, field)
        stamped = col[col != 0]
        if self.next_id > self.blocks and (stamped.size == 0
                                           or stamped.min() >= t0_ns):
            return None
        return rows[(col >= t0_ns) & (col < t1_ns)]

    def summary(self, last: int = STATUS_BLOCKS) -> dict:
        """The last ``last`` blocks: each span's p50 and p95 in ms (over
        the blocks that have both its stamps), each counter's mean, and
        the step's device time (p50, p95 ms; on several cards the slowest
        card's, and ``step_min`` the fastest card's)."""
        rows = self.rows(self.next_id - last)
        out: dict = {"blocks": int(len(rows))}
        for name, a, b in SPANS + (("step", None, "step_ns"),
                                   ("step_min", None, "step_min_ns")):
            end = self.column(rows, b)
            if a is None:
                ms = end[end > 0] / 1e6
            else:
                start = self.column(rows, a)
                ok = (start > 0) & (end > 0)
                ms = (end[ok] - start[ok]) / 1e6
            out[name + "_ms"] = (
                {"p50": round(float(np.percentile(ms, 50)), 3),
                 "p95": round(float(np.percentile(ms, 95)), 3)}
                if ms.size else None)
        for name in COUNTERS:
            col = self.column(rows, name)
            seen = col[self.column(rows, _COUNTED_WITH[name]) > 0]
            out[name] = round(float(seen.mean()), 3) if seen.size else None
        return out


#: the stamp whose block a counter belongs to (a counter is averaged over
#: the blocks that reached that stamp)
_COUNTED_WITH = {"ring_depth": "put", "got_depth": "got", "drained": "got",
                 "rows": "publish1", "fanout_depth": "handoff0",
                 "d2h_bytes": "fetch1", "encode_ns": "deliver1",
                 "pushed": "deliver1", "consumer_drops": "deliver1",
                 "deepest": "deliver1", "fetch_ready": "fetch1"}

_lock = threading.Lock()
_recorders: dict[str, Recorder] = {}


def recorder(key: str) -> Recorder:
    """The recorder of front end ``key``, made at its first use."""
    with _lock:
        rec = _recorders.get(key)
        if rec is None:
            rec = _recorders[key] = Recorder(key, TRACE_BLOCKS)
        return rec


def recorders() -> dict[str, Recorder]:
    """Every recorder of this process, by front end."""
    with _lock:
        return dict(_recorders)


def clear() -> None:
    """Drop every recorder (tests)."""
    with _lock:
        _recorders.clear()


def window(field: str, t0_s: float, t1_s: float):
    """``(recorder, rows)`` of the recorder with the most blocks whose
    ``field`` lies in ``[t0_s, t1_s)`` (``perf_counter`` seconds), and
    those rows; None where no recorder has one, or where that recorder has
    wrapped past the window (:meth:`Recorder.window`)."""
    t0, t1 = int(t0_s * 1e9), int(t1_s * 1e9)
    best = None
    for rec in recorders().values():
        rows = rec.window(field, t0, t1)
        if rows is None:
            col = rec.column(rec.rows(), field)
            n, rows = int(((col >= t0) & (col < t1)).sum()), None
        else:
            n = len(rows)
        if n and (best is None or n > best[0]):
            best = (n, rec, rows)
    if best is None or best[2] is None:
        return None
    return best[1], best[2]


#: the host's tracks on a ``/profile`` trace: each recorder's pump,
#: fan-out and capture thread, and the spans (or instants) each shows
TRACKS = (
    ("pump", (("control", "control0", "control1"),
              ("dispatch", "dispatch0", "dispatch1"),
              ("launch", "launch0", "launch1"),
              ("publish", "publish0", "publish1"),
              ("handoff", "handoff0", "handoff1"))),
    ("fan-out", (("fetch", "fetch0", "fetch1"),
                 ("deliver", "deliver0", "deliver1"))),
    ("capture", (("put", "put", None),)),
)
#: the process id the host's tracks take in a trace
HOST_PID = 1 << 30


def chrome_events(t0_ns: int, t1_ns: int, to_us) -> list:
    """The recorders' spans that overlap ``[t0_ns, t1_ns]`` as Chrome trace
    events of a "webradio host" process, a track for each front end's pump,
    fan-out and capture thread; ``to_us`` maps a ``perf_counter_ns`` time
    to the trace's microseconds. Each event's ``args`` name the block (and
    a dispatch its step's device ms, where it was read, and on several
    cards the fastest card's)."""
    events = [{"ph": "M", "name": "process_name", "pid": HOST_PID,
               "args": {"name": "webradio host"}}]
    for k, rec in enumerate(sorted(recorders().values(),
                                   key=lambda r: r.key)):
        rows = rec.rows()
        for j, (track, spans) in enumerate(TRACKS):
            tid = len(TRACKS) * k + j + 1
            events.append({"ph": "M", "name": "thread_name", "pid": HOST_PID,
                           "tid": tid,
                           "args": {"name": f"{track} {rec.key}"}})
            for name, a, b in spans:
                start = rec.column(rows, a)
                end = start if b is None else rec.column(rows, b)
                ok = (start > 0) & (end >= start) & (start <= t1_ns) & (
                    end >= t0_ns)
                for row in rows[ok]:
                    s = int(row[COLUMN[a]])
                    ev = {"ph": "X" if b else "i", "name": name,
                          "cat": "webradio_host", "pid": HOST_PID,
                          "tid": tid, "ts": to_us(s),
                          "args": {"block": int(row[0]) - 1}}
                    if b:
                        ev["dur"] = (int(row[COLUMN[b]]) - s) / 1e3
                    else:
                        ev["s"] = "t"
                    if name == "dispatch" and row[COLUMN["step_ns"]]:
                        ev["args"]["step_ms"] = row[COLUMN["step_ns"]] / 1e6
                        if row[COLUMN["step_min_ns"]]:
                            ev["args"]["step_min_ms"] = (
                                row[COLUMN["step_min_ns"]] / 1e6)
                    events.append(ev)
    return events
