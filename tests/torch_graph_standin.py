"""A stand-in for a CUDA graph on the CPU (``RecordedGraph``), for the
port's tests and their subprocess workers (it imports no JAX)."""

from webradio_tpu_torch.ops.launches import recording
from webradio_tpu_torch.pipeline import graph as tgraph


class RecordedGraph(tgraph.StepGraph):
    """A stand-in for a CUDA graph on the CPU. Capturing runs ``fn`` once
    and puts back what it wrote (a capture runs nothing); a replay runs
    ``fn`` again, and what it writes lands in the same tensors, as a
    graph's does. The launches a run counts stay out of the wrappers'
    counts (a replay runs no Python: :class:`..graph.StepGraph` adds the
    capture's tally)."""

    kernel_nodes = 7

    def _capture(self, fn, carried, stream, pool):
        saved = [t.clone() for t in carried]
        fn()
        for t, s in zip(carried, saved):
            t.copy_(s)
        self.fn = fn

    def _replay(self):
        with recording():
            self.fn()
