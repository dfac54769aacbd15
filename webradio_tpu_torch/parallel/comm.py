"""The collectives of the sharded step bodies, over a mesh's positions.

The JAX package writes each shard body once under ``shard_map`` and moves
halos with ``lax.ppermute`` and carries with ``psum`` / ``pmean``
(``webradio_tpu.parallel.sharded._right_perm`` / ``_from_last``). Here one
process may drive several positions, so a body runs stage by stage over
all of this rank's positions, and between stages it calls one of three
operations. Each takes a list of tensors per position and copies what the
position receives into buffers that the caller keeps (``dst``, a dict:
the buffers are made at the first call and only written after it, so a
captured CUDA graph may read them):

* :meth:`Comm.shift_right_into`: position ``(t, c)`` gets ``(t - 1, c)``'s
  tensors (None at ``t = 0``, which takes the carried block state);
* :meth:`Comm.from_last_into`: every position gets its column's last time
  shard's tensors (the next block's carries);
* :meth:`Comm.mean_time_into`: every position gets its column's mean over
  the time shards (the whole block's squelch power).

Two transports under one interface. In-process, a tensor moves to another
position's device with ``Tensor.copy_``, which orders against both
devices' current streams (nothing else here assumes an order across
devices); on one device the operations are plain copies, which a graph
may capture. Across ranks (``torch.distributed``, each rank driving whole
time rows) the halos between rank ``r``'s last row and rank ``r + 1``'s
first go by ``batch_isend_irecv``, the carries by ``broadcast`` from the
last row's rank, the power by ``all_reduce``; each operation packs what it
moves into one float32 message, a wire buffer kept in ``dst`` too. NCCL
moves CUDA tensors; under gloo, CUDA tensors are staged through pinned
host buffers, which the log says when the transport is made. Without a
process group only the in-process moves run; a group of one process still
runs its collectives.
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


def _into(dst: dict, key, xs: list, device) -> list:
    """``xs`` copied into ``dst[key]`` (buffers shaped as ``xs`` on
    ``device``, made at the first call)."""
    bufs = dst.get(key)
    if bufs is None:
        bufs = dst[key] = [torch.empty(x.shape, dtype=x.dtype, device=device)
                           for x in xs]
    for b, x in zip(bufs, xs):
        b.copy_(x)  # from a wire buffer in host memory: before its reuse
    return bufs


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

    # ---- packing: one float32 message per operation, in fixed buffers --
    def _wire(self, dst: dict, key: str, like: list) -> torch.Tensor:
        """The wire buffer ``dst[key]`` for the tensors of ``like`` (a list
        per column), made at the first call."""
        buf = dst.get(key)
        if buf is None:
            n = sum(x.numel() for col in like for x in col)
            buf = dst[key] = torch.empty(n, dtype=torch.float32,
                                         device=self.wire,
                                         pin_memory=self.staged)
        return buf

    @staticmethod
    def _parts(flat, like):
        """Views of ``flat`` shaped as ``like`` (a list per column)."""
        out, at = [], 0
        for col in like:
            parts = []
            for x in col:
                parts.append(flat[at:at + x.numel()].view(x.shape))
                at += x.numel()
            out.append(parts)
        return out

    def _pack(self, dst: dict, key: str, columns) -> torch.Tensor:
        flat = self._wire(dst, key, columns)
        for parts, col in zip(self._parts(flat, columns), columns):
            for b, x in zip(parts, col):
                b.copy_(x)
        return flat

    # ---- the operations ----------------------------------------------
    def shift_right_into(self, xs: dict, dst: dict) -> dict:
        """Each position's left neighbour's ``xs`` in ``dst`` (None at
        ``t = 0``): ``{p: buffers or None}``."""
        m, c_n = self.mesh, self.mesh.chan
        out = {}
        for p in m.local_positions:
            if p < c_n:
                out[p] = None
            elif m.ranks[p - c_n] == m.rank:
                out[p] = _into(dst, p, xs[p - c_n], m.devices[p])
        if not self.grouped:
            return out
        rows = m.local_rows
        first, last = rows[0], rows[-1]
        ops, recv, like = [], None, None
        if last < m.time - 1:
            send = self._pack(dst, "send",
                              [xs[last * c_n + c] for c in range(c_n)])
            ops.append(dist.P2POp(dist.isend, send, m.row_owner(last + 1)))
        if first > 0:
            like = [xs[first * c_n + c] for c in range(c_n)]
            recv = self._wire(dst, "recv", like)
            ops.append(dist.P2POp(dist.irecv, recv, m.row_owner(first - 1)))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        if recv is not None:
            for c, parts in enumerate(self._parts(recv, like)):
                p = first * c_n + c
                out[p] = _into(dst, p, parts, m.devices[p])
        return out

    def from_last_into(self, xs: dict, dst: dict) -> dict:
        """Every position's column's last time shard's ``xs``, in
        ``dst``."""
        m, c_n = self.mesh, self.mesh.chan
        last = m.time - 1
        if not self.grouped:
            cols = [xs[last * c_n + c] for c in range(c_n)]
        else:
            owner = m.row_owner(last)
            like = [xs[m.local_rows[0] * c_n + c] for c in range(c_n)]
            if owner == m.rank:
                buf = self._pack(dst, "wire",
                                 [xs[last * c_n + c] for c in range(c_n)])
            else:
                buf = self._wire(dst, "wire", like)
            dist.broadcast(buf, src=owner)
            cols = self._parts(buf, like)
        return {p: _into(dst, p, cols[p % c_n], self.mesh.devices[p])
                for p in m.local_positions}

    def mean_time_into(self, xs: dict, dst: dict) -> dict:
        """Every position's column's mean of ``xs`` over the time shards,
        in ``dst``."""
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
            buf = self._pack(dst, "wire", sums)
            dist.all_reduce(buf)
            sums = self._parts(buf, sums)
        return {p: _into(dst, p, [s / m.time for s in sums[p % c_n]],
                         m.devices[p]) for p in m.local_positions}
