"""The collectives of the sharded step bodies, over a mesh's positions.

The JAX package writes each shard body once under ``shard_map`` and moves
halos with ``lax.ppermute`` and carries with ``psum`` / ``pmean``
(``webradio_tpu.parallel.sharded._right_perm`` / ``_from_last``). Here one
process may drive several positions, so a body runs stage by stage over
all of this rank's positions, and between stages it calls one of three
operations, each taking and returning a list of tensors per position:

* :meth:`Comm.shift_right`: position ``(t, c)`` gets ``(t - 1, c)``'s
  tensors (None at ``t = 0``, which takes the carried block state);
* :meth:`Comm.from_last`: every position gets its column's last time
  shard's tensors (the next block's carries);
* :meth:`Comm.mean_time`: every position gets its column's mean over the
  time shards (the whole block's squelch power).

Two transports under one interface. In-process, a tensor moves to another
position's device with ``Tensor.to(device)``, which orders against both
devices' current streams (nothing else here assumes an order across
devices). Across ranks (``torch.distributed``, each rank driving whole
time rows) the halos between rank ``r``'s last row and rank ``r + 1``'s
first go by ``batch_isend_irecv``, the carries by ``broadcast`` from the
last row's rank, the power by ``all_reduce``; each operation packs what it
moves into one float32 message. NCCL moves CUDA tensors; under gloo, CUDA
tensors are staged through pinned host buffers, which the log says when
the transport is made. Without a process group only the in-process moves
run; a group of one process still runs its collectives.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from .mesh import Mesh

log = logging.getLogger(__name__)


def wire_device(local: torch.device) -> torch.device:
    """Where a collective's buffer lives: the rank's CUDA device under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        if local.type != "cuda":
            raise ValueError("the NCCL backend moves CUDA tensors only")
        return local
    return torch.device("cpu")


def to_wire(x: torch.Tensor, wire: torch.device) -> torch.Tensor:
    """``x`` on the wire device; CUDA tensors bound for the host go through
    a pinned buffer."""
    if x.device == wire:
        return x.contiguous()
    if wire.type == "cpu":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.to(wire)


class Comm:
    """The three collectives over ``mesh``'s local positions."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        local = mesh.local_positions
        self.wire = None
        #: CUDA halos through pinned host buffers (gloo on a card)
        self.staged = False
        #: whether a process group carries the collectives
        self.grouped = dist.is_available() and dist.is_initialized()
        if self.grouped:
            self.wire = wire_device(mesh.devices[local[0]])
            self.staged = self.wire.type == "cpu" and any(
                mesh.devices[p].type == "cuda" for p in local)
            log.info(
                "sharded transport: rank %d of %d, rows %s, %s%s", mesh.rank,
                mesh.world, mesh.local_rows, dist.get_backend(),
                " (CUDA halos staged through pinned host buffers)"
                if self.staged else "")

    # ---- packing: one float32 message per operation ----------------------
    def _pack(self, columns):
        """``columns[c]`` a list of tensors -> one flat wire tensor."""
        return torch.cat([to_wire(x.float().reshape(-1), self.wire)
                          for col in columns for x in col])

    @staticmethod
    def _unpack(flat, like):
        """Split ``flat`` back into tensors shaped as ``like`` (a list per
        column)."""
        out, at = [], 0
        for col in like:
            parts = []
            for x in col:
                parts.append(flat[at:at + x.numel()].reshape(x.shape))
                at += x.numel()
            out.append(parts)
        return out

    def _empty(self, like):
        n = sum(x.numel() for col in like for x in col)
        return torch.empty(n, dtype=torch.float32, device=self.wire,
                           pin_memory=self.staged)

    def _place(self, p, xs):
        dev = self.mesh.devices[p]
        return [x.to(dev, non_blocking=dev.type == "cuda") for x in xs]

    # ---- the operations ----------------------------------------------
    def shift_right(self, xs: dict) -> dict:
        m, c_n = self.mesh, self.mesh.chan
        out = {}
        for p in m.local_positions:
            if p < c_n:
                out[p] = None
            elif m.ranks[p - c_n] == m.rank:
                out[p] = self._place(p, xs[p - c_n])
        if not self.grouped:
            return out
        rows = m.local_rows
        first, last = rows[0], rows[-1]
        ops, recv, like = [], None, None
        if last < m.time - 1:
            send = self._pack([xs[last * c_n + c] for c in range(c_n)])
            ops.append(dist.P2POp(dist.isend, send, m.row_owner(last + 1)))
        if first > 0:
            like = [xs[first * c_n + c] for c in range(c_n)]
            recv = self._empty(like)
            ops.append(dist.P2POp(dist.irecv, recv, m.row_owner(first - 1)))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        if recv is not None:
            for c, parts in enumerate(self._unpack(recv, like)):
                out[first * c_n + c] = self._place(first * c_n + c, parts)
        return out

    def from_last(self, xs: dict) -> dict:
        m, c_n = self.mesh, self.mesh.chan
        last = m.time - 1
        if not self.grouped:
            cols = [xs[last * c_n + c] for c in range(c_n)]
        else:
            owner = m.row_owner(last)
            like = [xs[m.local_rows[0] * c_n + c] for c in range(c_n)]
            buf = (self._pack([xs[last * c_n + c] for c in range(c_n)])
                   if owner == m.rank else self._empty(like))
            dist.broadcast(buf, src=owner)
            cols = self._unpack(buf, like)
        return {p: self._place(p, cols[p % c_n]) for p in m.local_positions}

    def mean_time(self, xs: dict) -> dict:
        m, c_n = self.mesh, self.mesh.chan
        sums = []
        for c in range(c_n):
            acc = None
            for t in m.local_rows:
                here = xs[t * c_n + c]
                if acc is None:
                    acc = list(here)
                else:
                    acc = [a + b.to(a.device) for a, b in zip(acc, here)]
            sums.append(acc)
        if self.grouped:
            buf = self._pack(sums)
            dist.all_reduce(buf)
            sums = self._unpack(buf, sums)
        return {p: self._place(p, [s / m.time for s in sums[p % c_n]])
                for p in m.local_positions}
