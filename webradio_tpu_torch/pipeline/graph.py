"""Each block as one captured CUDA graph: the port's counterpart of the JAX
package's jitted, state-donating step (``jax.jit(...,
donate_argnames=("state",))``) and of its ``lax.scan`` runners.

The JAX package compiles the step once and donates the state, so a block
costs one dispatch and its carries are updated in place. The eager step
costs the host ~25 torch ops and one or two kernel wrappers a block;
captured once into a ``torch.cuda.CUDAGraph`` and replayed, a block is one
``cudaGraphLaunch``. A captured step reads and writes fixed addresses: its
input buffer, the parameters, the state's persistent buffers (the carries
are written into them with ``copy_``: a kernel reads ``chan_hist`` while it
writes ``hist_i``, so the two are never aliased) and its outputs, which
every replay rewrites.

- :class:`StepGraph` / :class:`CudaStepGraph`: one captured block. What is
  captured is recorded, not run: the kernel wrappers' launches made while
  a thread captures go to the capture's tally, and every replay adds it
  (``ops.launches``).
- :class:`ServingGraphs`: a pipeline's two slots, each with its device
  input, its graph (the in-place step, then a copy of its outputs into the
  slot's own output buffers) and those buffers, so block *n*'s outputs stay
  as they are until the slot's next replay, two blocks later: the
  double-buffered contract of ``HostPipeline.process_host``. The two graphs
  share one memory pool for their intermediates; what outlives a replay
  (inputs, outputs, state, parameters) lies outside it. A served block's
  input comes from a pinned staging slot; the offline runners, the
  catch-up and ``process_host_many`` feed the same graphs from the device.

Before the first capture of a graph set one block runs eagerly on the
capture stream (it builds the kernels, cuBLAS's workspace and the cached
constants, none of which may be made under capture); it is a real block,
counted as a warm. A capture or a replay that fails raises: nothing falls
back to the eager step. Captures use ``capture_error_mode="thread_local"``
so that other threads (the pump, HTTP readers, the fan-out) go on using
the card while a growth build captures.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from ..ops.launches import add_launches, recording


#: held around every graph replay, and by a profiler's start and stop
#: (``web.handlers``), so that the two never overlap: a ``torch.profiler``
#: stop (CUPTI's flush and teardown) and a ``cudaGraphLaunch`` on another
#: thread were seen to deadlock on the H100
LAUNCH_LOCK = threading.Lock()


# ---- state and parameter layouts --------------------------------------
def fields(x) -> list:
    """The tensors of a (nested) NamedTuple in order, None entries kept."""
    if isinstance(x, tuple):
        return [t for v in x for t in fields(v)]
    return [x]


def layout(x) -> tuple:
    """Address, shape and type of every tensor of ``x``: what a captured
    graph has fixed about it."""
    return tuple(None if t is None else
                 (t.data_ptr(), tuple(t.shape), t.dtype, t.device)
                 for t in fields(x))


def shapes(x) -> tuple:
    """Shape, type and device of every tensor of ``x`` (its layout without
    the addresses)."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                 for t in fields(x))


def clone_tree(x):
    """A copy of a (nested) NamedTuple of tensors, each tensor its own."""
    if isinstance(x, tuple):
        return type(x)(*(clone_tree(v) for v in x))
    return None if x is None else x.clone()


class Kept:
    """A few pipelines kept between offline runs, by key (most recent
    last): the counterpart of the JAX package's ``lru_cache`` of its
    compiled scans. A pipeline is taken out while a run uses it (two runs
    of one key at once get two pipelines) and put back after; past
    ``size`` the oldest goes, and with it its graphs' memory."""

    def __init__(self, size: int):
        self.size = size
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def take(self, key):
        with self._lock:
            return self.entries.pop(key, None)

    def put(self, key, pipe) -> None:
        with self._lock:
            self.entries[key] = pipe
            while len(self.entries) > self.size:
                self.entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self.entries.clear()


def same_shapes(a, b) -> bool:
    """Whether ``b`` can be copied into ``a`` tensor by tensor (the same
    fields, None in the same places, each tensor of the same shape, type
    and device)."""
    if not (isinstance(a, tuple) and type(a) is type(b)):
        return False
    fa, fb = fields(a), fields(b)
    return len(fa) == len(fb) and all(
        (x is None and y is None)
        or (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
            and x.shape == y.shape and x.dtype == y.dtype
            and x.device == y.device) for x, y in zip(fa, fb))


def carry(buffers, new_state) -> None:
    """Write new values into persistent buffers (a step's new carries into
    the state's, or a parameter set into the parameters')."""
    for dst, src in zip(fields(buffers), fields(new_state)):
        if dst is not None:
            dst.copy_(src)


# ---- graphs -------------------------------------------------------------
class StepGraph:
    """``fn()`` captured once, replayed per block. ``launches`` is each
    counted wrapper's launches in one replay (``{wrapper: n}``, the
    capturing thread's alone); ``kernel_nodes`` the kernels the graph
    holds. ``carried`` names the tensors ``fn`` writes (a stand-in that runs
    ``fn`` at capture must leave them as they were). Subclasses make
    ``_capture`` and ``_replay``."""

    kernel_nodes = 0

    def __init__(self, fn, carried=(), stream=None, pool=None):
        with recording() as self.launches:  # recorded, not run
            self._capture(fn, carried, stream, pool)

    def _capture(self, fn, carried, stream, pool) -> None:
        raise NotImplementedError

    def _replay(self) -> None:
        raise NotImplementedError

    def pool(self):
        """A token for a later capture to share this graph's memory."""
        return None

    def replay(self) -> None:
        with LAUNCH_LOCK:
            self._replay()
        add_launches(self.launches)


class CudaStepGraph(StepGraph):
    """A ``torch.cuda.CUDAGraph`` of ``fn`` captured on ``stream``."""

    def _capture(self, fn, carried, stream, pool):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()  # the capture is invalid anyway
                raise
            graph.capture_end()
            self.kernel_nodes, self.copy_nodes = graph_node_counts(
                graph.raw_cuda_graph())
            graph.instantiate()  # on the stream's device
        self.graph = graph

    def _replay(self) -> None:
        self.graph.replay()

    def pool(self):
        return self.graph.pool()


#: CUgraphNodeType values (cuda.h)
_KERNEL_NODE, _MEMCPY_NODE, _MEMSET_NODE, _CHILD_GRAPH_NODE = 0, 1, 2, 4


@functools.lru_cache(maxsize=1)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    vp, size_p, int_p = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
                         ctypes.POINTER(ctypes.c_int))
    lib.cuGraphGetNodes.argtypes = [vp, vp, size_p]
    lib.cuGraphNodeGetType.argtypes = [vp, int_p]
    lib.cuGraphChildGraphNodeGetGraph.argtypes = [
        vp, ctypes.POINTER(ctypes.c_void_p)]
    return lib


def _cu(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUresult {code}")


def graph_node_counts(raw_graph: int) -> tuple[int, int]:
    """``(kernel nodes, copy and memset nodes)`` of a captured
    ``cudaGraph_t`` (child graphs included), read with libcuda's
    ``cuGraphGetNodes``: what one replay puts on a profiler's timeline."""
    lib = _libcuda()
    kinds: collections.Counter = collections.Counter()

    def walk(graph) -> None:
        n = ctypes.c_size_t(0)
        _cu(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)),
            "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        _cu(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
            "cuGraphGetNodes")
        kind = ctypes.c_int(0)
        for node in nodes[:n.value]:
            _cu(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
                "cuGraphNodeGetType")
            kinds[kind.value] += 1
            if kind.value == _CHILD_GRAPH_NODE:
                child = ctypes.c_void_p()
                _cu(lib.cuGraphChildGraphNodeGetGraph(node,
                                                      ctypes.byref(child)),
                    "cuGraphChildGraphNodeGetGraph")
                walk(child)

    walk(ctypes.c_void_p(raw_graph))
    return kinds[_KERNEL_NODE], kinds[_MEMCPY_NODE] + kinds[_MEMSET_NODE]


def _stream_for(device: torch.device):
    return torch.cuda.Stream(device) if device.type == "cuda" else None


@contextlib.contextmanager
def _on(stream, device: torch.device):
    """Run the body on ``stream`` after what the current stream queued,
    and let the current stream go on after it. Tensors the body puts into
    the list it is given were made on ``stream`` for the current stream to
    read: they are kept from reuse until it has."""
    made: list = []
    if stream is None:
        yield made
        return
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield made
    cur.wait_stream(stream)
    for t in made:
        t.record_stream(cur)


class ServingGraphs:
    """A pipeline's blocks on two graphs, one per slot.

    Slot *k* is a pinned host buffer, a device input, the graph of one
    block (the pipeline's in-place step on the input, then a copy of its
    outputs ``(audio, latest raw spectrum row, latest_db)`` into output set
    *k*) and output set *k*. Slots alternate, so the outputs handed back
    for a block stay as they are until the slot's next replay, two blocks
    later. The output sets are made before the capture, outside the
    graphs' shared memory pool, so that nothing a replay leaves in the pool
    is read after it. Captured for one ``key`` (the pipeline's
    configuration, its parameters' and state's addresses); the pipeline
    makes a new set when its key changes, and the new set keeps the old
    one's staging buffers and their events (a copy of the old set may still
    be reading one).
    """

    def __init__(self, pipe, key, shape, old: ServingGraphs | None = None):
        dev = pipe.device
        cuda = dev.type == "cuda"
        self.key, self.shape = key, tuple(shape)
        self.graphs = self.outputs = None
        if old is not None and old.shape == self.shape:
            self.pinned, self.inputs, self.copied = (old.pinned, old.inputs,
                                                     old.copied)
            self.stream, self.next = old.stream, old.next
            return
        self.pinned = [torch.empty(shape, dtype=torch.float32,
                                   pin_memory=cuda) for _ in range(2)]
        self.inputs = [torch.empty(shape, dtype=torch.float32, device=dev)
                       for _ in range(2)]
        self.copied = [None, None]
        self.stream = _stream_for(dev)
        self.next = 0

    def _slot(self) -> int:
        slot = self.next
        self.next ^= 1
        return slot

    def serve(self, pipe, host: np.ndarray):
        """One host block through the next slot (its pinned buffer, then
        the device input): the slot's outputs."""
        slot = self._slot()
        if self.copied[slot] is not None:
            # the slot's last copy has finished with its staging buffer; on
            # the one stream it came after the replay two blocks back, so
            # the wait also keeps the host at most about three blocks ahead
            self.copied[slot].synchronize()
        self.pinned[slot].numpy()[...] = host
        self.inputs[slot].copy_(self.pinned[slot], non_blocking=True)
        if pipe.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self.copied[slot] = event
        return self._run(pipe, slot)

    def serve_device(self, pipe, iq: torch.Tensor):
        """One block already on the device through the next slot (a copy
        into its input): the slot's outputs."""
        slot = self._slot()
        self.inputs[slot].copy_(iq)
        return self._run(pipe, slot)

    def _run(self, pipe, slot: int):
        if self.graphs is None:
            # the warm: the first block of the set runs eagerly, then both
            # slots are captured
            with _on(self.stream, pipe.device) as made:
                out = pipe._step_in_place(self.inputs[slot])
                made.extend(out)
            self.outputs = [tuple(torch.empty_like(t) for t in out)
                            for _ in range(2)]
            for dst, src in zip(self.outputs[slot], out):
                dst.copy_(src)
            pipe.graph_warms += 1
            self._capture(pipe)
        else:
            graph = self.graphs[slot]
            graph.replay()
            pipe.graph_replays += 1
            pipe.graph_kernels += graph.kernel_nodes
        return self.outputs[slot]

    def _capture(self, pipe) -> None:
        def body(slot):
            def fn():
                out = pipe._step_in_place(self.inputs[slot])
                for dst, src in zip(self.outputs[slot], out):
                    dst.copy_(src)
            return fn

        first = pipe.graph_class(body(0), fields(pipe.state)
                                 + list(self.outputs[0]), self.stream)
        second = pipe.graph_class(body(1), fields(pipe.state)
                                  + list(self.outputs[1]), self.stream,
                                  first.pool())
        self.graphs = (first, second)
        pipe.graph_captures += 1
