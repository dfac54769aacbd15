"""What a traced run hands its per-layer metrics' readers, and the
``breakdown`` of the result line: the device operations that took most
time and the longest idle gaps of the busiest card, each named by what the
pump thread was doing then (from the benchmark's own spans)."""

from __future__ import annotations

import bisect
import dataclasses

from . import roofline


@dataclasses.dataclass
class RunView:
    """A run as the readers see it. Times are host ``perf_counter``
    seconds; ``timeline`` is the traced device timeline (None untraced)."""

    window: tuple  # (start, end) of the measured window
    blocks: list  # harness.Block of every offered block of the window
    dispatched: list  # harness.Block dispatched inside the traced window
    pump_calls: list  # (start, end, ring wait s, blocks, dispatch s)
    listeners: int
    timeline: object
    channels_per_card: int
    pfb_precision: str

    def step_bound_ms(self) -> float:
        """The two-stage bound of one card's share of a block."""
        return roofline.roofline_ms(self.channels_per_card,
                                    self.pfb_precision)["ideal_ms"]

    def tail_bound_ms(self) -> float:
        """Kernel #1's bound for one card's share of a block."""
        product = 2 if self.pfb_precision == "bf16" else 4
        c = self.channels_per_card
        ops, nbytes = roofline._bound(roofline.tail_flops(10_240, c), 0.0,
                                      roofline.tail_bytes(10_240, c, product))
        return max(ops, nbytes)


def view(run, timeline) -> RunView:
    blocks = run.probe.blocks
    lo, hi = ((timeline.start_s, timeline.stop_s) if timeline is not None
              else (run.t_w0, run.t_w1))
    dispatched = [b for b in blocks.values()
                  if b.dispatch and lo <= b.dispatch[0] < hi]
    cap = int(run.cell.tuner["capacity"])
    return RunView(
        window=(run.t_w0, run.t_w1),
        blocks=[blocks[s] for s in run.offered],
        dispatched=dispatched, pump_calls=list(run.probe.pump_calls),
        listeners=len(run.listeners), timeline=timeline,
        channels_per_card=cap // max(1, len(run.devices)),
        pfb_precision=run.cell.tuner.get("pfb_precision", "highest"))


def busy_window(timeline) -> dict:
    """``busy_s`` averaged over the cards used, and ``window_s``."""
    devs = timeline.devices
    busy = (sum(timeline.busy_s(d) for d in devs) / len(devs)
            if devs else 0.0)
    return {"busy_s": busy, "window_s": timeline.window_s}


class PumpStates:
    """What the pump thread was doing at a moment: waiting on the ring,
    dispatching a block, or the rest of ``run_once`` (control writes,
    publish, hand-off), or between calls."""

    def __init__(self, run):
        spans = []
        for t0, t1, wait, _, _ in run.probe.pump_calls:
            spans.append((t0, t0 + wait, "ring wait"))
            spans.append((t0 + wait, t1, "run_once"))
        for b in run.probe.blocks.values():
            if b.dispatch:
                spans.append((b.dispatch[0], b.dispatch[1], "dispatch"))
        # dispatch spans lie inside run_once spans: look them up first
        self.dispatch = sorted(s for s in spans if s[2] == "dispatch")
        self.calls = sorted(s for s in spans if s[2] != "dispatch")
        self.fanout = sorted(b.delivered for b in run.probe.blocks.values()
                             if b.delivered)

    @staticmethod
    def _find(spans, t):
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return spans[i] if i >= 0 and spans[i][0] <= t < spans[i][1] else None

    def at(self, t: float) -> str:
        hit = self._find(self.dispatch, t) or self._find(self.calls, t)
        pump = hit[2] if hit else "between calls"
        fan = self._find([(a, b, "") for a, b in self.fanout], t)
        return f"pump {pump}; fan-out {'delivering' if fan else 'idle'}"


def breakdown(run, timeline) -> dict:
    ops = sorted(timeline.by_name().items(), key=lambda kv: -kv[1])[:10]
    dev, _ = timeline.busiest()
    states = PumpStates(run)
    gaps = []
    if dev is not None:
        for start, length in timeline.idle_gaps(dev):
            gaps.append([states.at(start + length / 2), length])
    return {"device_ops": [[name[:120], s] for name, s in ops],
            "idle_gaps": gaps}
