"""Each block of a sharded engine as CUDA graph replays: the port's
counterpart of the JAX package's jitted ``shard_map`` step (the state
donated: ``jax.jit(..., donate_argnums=(1,))``) and, block after block, of
its ``lax.scan`` capture runner.

A sharded body is a list of stages: :class:`Local` stages (each position's
own work, on its own device) and :class:`Move` stages (the collectives of
:class:`.comm.Comm`, which copy what a position receives into buffers that
stay). A :class:`BlockProgram` runs the stages over one block on one of two
slots, each slot with its own device inputs and outputs, so a block's
outputs stay as they are until the slot's next block, two blocks later
(the double-buffered contract of ``HostPipeline.process_host``). Three
ways to run it:

* eagerly (on the CPU, or ``graph=False``): the stages in order;
* **one graph a block** where every local position lies on one device and
  no process group carries the moves (a virtual mesh of one card, the CPU
  tests): every stage, the moves' copies included, captured into one graph
  per slot;
* **segments** where the positions lie on several devices, or ranks of a
  process group share the mesh: one graph per device for each run of
  :class:`Local` stages, and the :class:`Move` stages run between the
  replays, from fixed send buffers into fixed receive buffers (peer copies
  in one process, ``torch.distributed`` across ranks), so nothing that a
  replay reads is made per block.

What crosses a stage is kept where a replay finds it again: the state and
the parameters in the pipeline's persistent buffers (carried in place), a
move's sources and destinations in the program's fixed buffers, a slot's
outputs in buffers made before the first capture, outside the graphs'
memory pool (one pool a device, shared by both slots' graphs, which
replay in the order they were captured). Values between two
:class:`Local` stages of one segment stay inside its graph.

Before the captures one block runs eagerly on the capture streams (the
warm: it builds the kernels, the fixed buffers and cuBLAS's workspace,
none of which may be made under capture). A capture or a replay that
fails raises: nothing falls back to the eager stages.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..pipeline.graph import fields
from ..trace import now
from .comm import _into


class Local(NamedTuple):
    """``fn(ws, positions)``: the stage's work for ``positions`` (all on
    one device in a segment; every local position otherwise)."""
    fn: Callable


class Move(NamedTuple):
    """``fn(ws)``: collectives from ``ws.sent(..)`` into ``ws.recv(..)``."""
    fn: Callable


class Workspace:
    """One block's values on one slot, as the stages hand them on.

    ``params`` / ``state``: the pipeline's placed parameters and state per
    position; ``iq``: the slot's device input per position; ``send`` /
    ``sent``: a move's sources, copied into fixed buffers (a move between
    replays reads them); ``recv(name)``: a move's destination buffers;
    ``output``: the slot's outputs. Any other attribute is a dict per
    position (or per time row), made at its first use."""

    def __init__(self, fe, program: BlockProgram, slot: int):
        self.cfg, self.mesh, self.comm = fe.cfg, fe.mesh, fe.comm
        self.params, self.state = fe._placed, fe.state
        self.iq = program.inputs[slot]
        self._out = program.outputs[slot]
        self._bufs = program.bufs
        self._sends = program.sends

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        made = self.__dict__[name] = {}
        return made

    def send(self, name: str, p: int, xs: list) -> None:
        _into(self._sends.setdefault(name, {}), p, xs, self.mesh.devices[p])

    def sent(self, name: str) -> dict:
        return self._sends[name]

    def recv(self, name: str) -> dict:
        return self._bufs.setdefault(name, {})

    def output(self, name: str, key, x: torch.Tensor) -> None:
        """``x`` copied into the slot's output ``name`` (``key``: a
        position)."""
        outs = self._out.setdefault(name, {})
        buf = outs.get(key)
        if buf is None:  # at the warm, before any capture
            buf = outs[key] = torch.empty_like(x)
        buf.copy_(x)


@contextlib.contextmanager
def _on_streams(streams: dict):
    """Run the body on each device's side stream (``streams``: device ->
    stream or None), after what the current streams queued; the current
    streams go on after it."""
    cuda = [(dev, s) for dev, s in streams.items() if s is not None]
    for dev, s in cuda:
        s.wait_stream(torch.cuda.current_stream(dev))
    with contextlib.ExitStack() as stack:
        for _, s in cuda:
            stack.enter_context(torch.cuda.stream(s))
        yield
    for dev, s in cuda:
        torch.cuda.current_stream(dev).wait_stream(s)


class BlockProgram:
    """A sharded pipeline's blocks for one graph key: its stages, the two
    slots' inputs and outputs, the fixed buffers of its moves and, on
    graphs, each slot's round of replays (and moves between them)."""

    def __init__(self, fe, key, stages: list, graphed: bool,
                 segmented: bool):
        self.key, self.stages = key, stages
        self.graphed, self.segmented = graphed, segmented
        mesh = fe.mesh
        self.positions = mesh.local_positions
        #: local positions per device, in order
        self.by_device: dict = {}
        #: the first position of each (time row, device): its input is
        #: the row's on that device
        self._row_inputs: dict = {}
        for p in self.positions:
            self.by_device.setdefault(mesh.devices[p], []).append(p)
            self._row_inputs.setdefault((p // mesh.chan, mesh.devices[p]), p)
        self.inputs: list = [{}, {}]
        self.outputs: list = [{}, {}]
        self.bufs: dict = {}
        self.sends: dict = {}
        self.rounds = None
        #: for each item of a round (both slots' rounds have one plan):
        #: a graph's device, and whether it is that device's first and
        #: last replay of the round; ``(None, False, False)`` for a move
        self.marks: list = []
        self.kernels_per_block = 0
        #: the host's stamps (``trace.now``) of the last block's first and
        #: last card's launch: around its replays on graphs, around its
        #: stages otherwise
        self.launched = (0, 0)
        self._pinned = None
        self._copied = [[], []]
        self.next = 0

    # ---- inputs -----------------------------------------------------------
    def fill(self, fe, block) -> int:
        """Copy one block (this rank's ``[2, frames]``, numpy or tensor, or
        a block placed on the mesh: ``{position: [2, n_local]}``) into the
        next slot's device inputs (one per time row and device); the
        slot."""
        slot = self.next
        self.next ^= 1
        mesh, n = fe.mesh, fe.cfg.block_frames // fe.mesh.time
        rows = mesh.local_rows
        if not self.inputs[0]:
            for inputs in self.inputs:
                for p in self.positions:
                    first = self._row_inputs[(p // mesh.chan,
                                              mesh.devices[p])]
                    inputs[p] = inputs[first] if first != p else torch.empty(
                        (2, n), dtype=torch.float32, device=mesh.devices[p])
        if isinstance(block, dict):
            parts = block
        elif block.shape[-1] != n * len(rows):
            raise ValueError(f"{block.shape[-1]} frames for {len(rows)} "
                             f"time shards of {n}")
        elif isinstance(block, np.ndarray):
            staged = self._stage(slot, block, len(rows), n)
            parts = {p: staged[rows.index(p // mesh.chan)]
                     for p in self._row_inputs.values()}
        else:
            parts = {p: block[:, i * n:(i + 1) * n]
                     for p in self._row_inputs.values()
                     for i in [rows.index(p // mesh.chan)]}
        for p in self._row_inputs.values():
            self.inputs[slot][p].copy_(parts[p],
                                       non_blocking=parts[p].is_pinned())
        if self._pinned is not None and isinstance(block, np.ndarray):
            events = []
            for dev in self.by_device:
                if dev.type == "cuda":
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(dev))
                    events.append(event)
            self._copied[slot] = events
        return slot

    def _stage(self, slot: int, host: np.ndarray, rows: int, n: int):
        """The host block as ``[rows, 2, n]``, each time shard contiguous:
        in the slot's pinned buffer on the card, as it is on the CPU."""
        view = np.asarray(host, np.float32).reshape(2, rows, n).transpose(
            1, 0, 2)
        if not any(d.type == "cuda" for d in self.by_device):
            return torch.from_numpy(np.ascontiguousarray(view))
        if self._pinned is None:
            self._pinned = [torch.empty(view.shape, dtype=torch.float32,
                                        pin_memory=True) for _ in range(2)]
        for event in self._copied[slot]:
            # the slot's last copies have finished with its pinned buffer;
            # on each card's one stream they came after the replays of two
            # blocks back, so the host runs at most about three blocks ahead
            event.synchronize()
        self._pinned[slot].numpy()[...] = view
        return self._pinned[slot]

    # ---- blocks -------------------------------------------------------------
    def run(self, fe, slot: int) -> dict:
        """The block in the slot's inputs through the stages: the slot's
        outputs. Where the pipeline holds a timing-event pair for each of
        its cards (``fe.step_events``, taken here), each card's pair is
        recorded on its stream around its own share of the block: on
        graphs just before its first replay and just after its last, so
        its step leaves out the other cards' launches before its own;
        around every stage otherwise."""
        timed = dict(zip(fe.cards(), fe.step_events or ()))
        fe.step_events = None
        l0 = now()
        if self.rounds is None or not self.graphed:
            _record(timed, 1)
            if not self.graphed:
                self._eager(fe, slot)
            else:
                self._warm_and_capture(fe, slot)
            _record(timed, 2)
        else:
            ws = Workspace(fe, self, slot)  # the moves' buffers
            l0 = 0
            for item, (dev, first, last) in zip(self.rounds[slot],
                                                self.marks):
                if dev is None:
                    item.fn(ws)
                    continue
                l0 = l0 or now()
                pair = timed.get(dev)  # (stream, start, end)
                if pair and first:
                    pair[1].record(pair[0])
                item.replay()
                if pair and last:
                    pair[2].record(pair[0])
            fe.graph_replays += 1
            fe.graph_kernels += self.kernels_per_block
        self.launched = (l0, now())
        return self.outputs[slot]

    def _eager(self, fe, slot: int) -> None:
        self._all_stages(Workspace(fe, self, slot))

    def _all_stages(self, ws: Workspace) -> None:
        """Every stage in order, each :class:`Local` one over every local
        position."""
        for stage in self.stages:
            if isinstance(stage, Move):
                stage.fn(ws)
            else:
                stage.fn(ws, self.positions)

    def _warm_and_capture(self, fe, slot: int) -> None:
        streams = {dev: fe.capture_stream(dev) for dev in self.by_device}
        with _on_streams(streams):
            self._eager(fe, slot)
        other = self.outputs[slot ^ 1]
        for name, outs in self.outputs[slot].items():
            other[name] = {k: torch.empty_like(t) for k, t in outs.items()}
        # every buffer made on a side stream is read on the current one
        for t in self._fixed_tensors():
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))
        fe.graph_warms += 1
        pools: dict = {}
        self.rounds = [self._capture(fe, s, streams, pools) for s in (0, 1)]
        graphs = [g for g in self.rounds[0] if not isinstance(g, Move)]
        self.kernels_per_block = sum(g.kernel_nodes for g in graphs)
        fe.graph_captures += 1

    def _fixed_tensors(self) -> list:
        found = []

        def walk(x):
            if isinstance(x, torch.Tensor):
                found.append(x)
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)

        walk([self.outputs, self.bufs, self.sends])
        return found

    def _capture(self, fe, slot: int, streams: dict, pools: dict) -> list:
        """The slot's round: its graphs in order, with the moves that run
        between them in the segmented plan."""
        ws = Workspace(fe, self, slot)
        outs = self.outputs[slot]

        def carried(dev):
            # what a graph writes and a stand-in's capture must leave as
            # it was: the state and the slot's outputs on ``dev``
            on = [t for p in self.by_device[dev]
                  for t in fields(fe.state[p]) if t is not None]
            on += [t for o in outs.values() for t in o.values()
                   if t.device == dev]
            return on

        def graph(fn, dev):
            g = fe.graph_class(fn, carried(dev), streams[dev],
                               pools.get(dev))
            pools.setdefault(dev, g.pool())
            return g

        if not self.segmented:
            (dev,) = self.by_device
            self.marks = [(dev, True, True)]
            return [graph(lambda: self._all_stages(ws), dev)]

        def segment(run, pos):
            def fn():
                for stage in run:
                    stage.fn(ws, pos)
            return fn

        round_, devs, run = [], [], []
        for stage in self.stages + [None]:
            if isinstance(stage, Local):
                run.append(stage)
                continue
            if run:
                round_ += [graph(segment(run, pos), dev)
                           for dev, pos in self.by_device.items()]
                devs += list(self.by_device)
                run = []
            if stage is not None:
                round_.append(stage)
                devs.append(None)
        first = {d: i for i, d in reversed(list(enumerate(devs)))}
        last = {d: i for i, d in enumerate(devs)}
        self.marks = [(d, d is not None and first[d] == i,
                       d is not None and last[d] == i)
                      for i, d in enumerate(devs)]
        return round_


def _record(timed: dict, k: int) -> None:
    """Item ``k`` (1 the start, 2 the end) of each device's timing pair
    (``timed``: device -> (stream, start, end)) recorded on its stream."""
    for pair in timed.values():
        pair[k].record(pair[0])

