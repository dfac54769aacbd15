"""Several processes on ``torch.distributed``: bring-up, host-sliced
ingest, the control channel and the gathers of the multihost pump (port of
``webradio_tpu.parallel.multihost``).

A single host with several cards needs nothing here: one process drives
every position of the mesh. Across processes each rank drives whole time
rows of the mesh and ingests only its own frames of each block
(:func:`host_time_slice`, :func:`make_global_block`): no process holds the
whole block. The serving pump's collectives (:func:`broadcast_blob`,
:func:`agree_index`, :func:`gather_to_host` and the sharded step's own)
are issued by the pump thread alone, in the same order on every rank.
Without a process group every collective here is the identity, as the
JAX package's are in one process.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from .comm import to_wire, wire_device
from .mesh import Mesh
from .sharded import place_block

log = logging.getLogger(__name__)

#: how long a process group waits for its peers, at bring-up and in a
#: collective, before it fails (a hung peer fails the call, not the host)
TIMEOUT_S = 60.0

#: payload bytes of one control broadcast: the buffer's shape must be the
#: same on every rank, so a control blob rides a fixed-size uint8 tensor
#: (a longer blob goes in several broadcasts of the same round)
CONTROL_BLOB_BYTES = 65_536
_HEADER = 8  # uint32 length of this part, uint32 parts still to come


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device: torch.device | str | None = None) -> bool:
    """Bring up the default process group where a multi-process run is
    configured; returns False (and does nothing) where none is.

    ``coordinator`` is ``host:port`` (TCP) or an init URL (``tcp://``,
    ``file://``); without one, torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` are read (``env://``), and
    without those there is nothing to bring up. ``backend``: "nccl" or
    "gloo"; None picks NCCL for a CUDA ``device`` (None is the CUDA device)
    and gloo for the CPU. Under NCCL the rank's device becomes
    ``cuda:LOCAL_RANK`` (or ``rank % device_count``). The choice is logged;
    nothing falls back to another backend."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" not in env:
        return False
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already up")
    num = num_processes or env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if num is None or rank is None:
        raise ValueError("a process group needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK)")
    num, rank = int(num), int(rank)
    if coordinator is None:
        url = "env://"
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend is None:
        cuda = device is None or torch.device(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % max(
            torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=url, world_size=num,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    log.info("torch.distributed up: rank %d of %d, backend %s, %s", rank,
             num, backend, url)
    return True


def host_time_slice(block_frames: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's ``[start, stop)`` frame range of a block: its time rows,
    which are contiguous by construction (``mesh.make_mesh``)."""
    per_shard = block_frames // mesh.time
    rows = mesh.local_rows
    return rows[0] * per_shard, (rows[-1] + 1) * per_shard


def make_global_block(local_planes, block_frames: int, mesh: Mesh) -> dict:
    """This rank's ``[2, stop - start]`` float32 slice of a block
    (:func:`host_time_slice`), cut into its time shards and placed on its
    positions' devices: what the sharded front end's ``process_host``
    takes. No process holds the whole block."""
    return place_block(local_planes, mesh, block_frames)


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _wire() -> torch.device:
    return wire_device(torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))


def frame_blob(payload: bytes) -> list[np.ndarray]:
    """The broadcast buffers of one blob: ``_HEADER + CONTROL_BLOB_BYTES``
    uint8 each, headed by the part's length and the count of parts still
    to come (one buffer for an empty blob)."""
    parts = [payload[i:i + CONTROL_BLOB_BYTES]
             for i in range(0, len(payload), CONTROL_BLOB_BYTES)] or [b""]
    frames = []
    for i, part in enumerate(parts):
        buf = np.zeros(_HEADER + CONTROL_BLOB_BYTES, np.uint8)
        buf[:_HEADER] = np.frombuffer(np.array(
            [len(part), len(parts) - 1 - i], np.uint32).tobytes(), np.uint8)
        buf[_HEADER:_HEADER + len(part)] = np.frombuffer(part, np.uint8)
        frames.append(buf)
    return frames


def read_frame(buf: np.ndarray) -> tuple[bytes, int]:
    """``(part, parts still to come)`` of one broadcast buffer."""
    n, more = np.frombuffer(buf[:_HEADER].tobytes(), np.uint32)
    return buf[_HEADER:_HEADER + int(n)].tobytes(), int(more)


def broadcast_blob(payload: bytes | None) -> bytes:
    """Rank 0's byte blob on every rank: the multihost pump's control
    channel. Every rank calls it in the same round; the blob rides one
    fixed-size uint8 buffer per :data:`CONTROL_BLOB_BYTES`
    (:func:`frame_blob`), so a blob of any size arrives, in several
    broadcasts of the round, and none raises. Without a process group the
    payload comes back unchanged."""
    if not _grouped():
        return payload or b""
    frames = frame_blob(payload or b"") if dist.get_rank() == 0 else []
    wire = _wire()
    out, i = [], 0
    while True:
        buf = (frames[i] if frames else
               np.zeros(_HEADER + CONTROL_BLOB_BYTES, np.uint8))
        t = torch.from_numpy(buf).to(wire)
        dist.broadcast(t, src=0)
        part, more = read_frame(t.cpu().numpy())
        out.append(part)
        i += 1
        if more == 0:
            return b"".join(out)


def agree_index(index: int, ended: bool) -> tuple[int, int, bool]:
    """The multihost round's agreement on a source block: ``(the largest
    index, the smallest index, whether any rank's source ended)`` over the
    group, from one all-reduce (MAX) of three int64 on the wire device
    (gloo on the host, NCCL on the card). Every rank calls it in the same
    round. Without a process group: ``(index, index, ended)``."""
    if not _grouped():
        return index, index, ended
    t = torch.tensor([index, -index, int(ended)], dtype=torch.int64)
    t = t.to(_wire())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    top, neg_bottom, any_ended = t.tolist()
    return top, -neg_bottom, bool(any_ended)


def barrier() -> None:
    """Return once every rank of the group has called it (an all-reduce of
    one element on the wire device); nothing without a process group."""
    if _grouped():
        dist.all_reduce(torch.zeros(1, dtype=torch.int64).to(_wire()))


def gather_to_host(x, dim: int = 0) -> np.ndarray:
    """Every rank's ``x`` (tensor or numpy, one shape on every rank) joined
    along ``dim`` in rank order, on the host of EVERY rank. A collective:
    every rank calls it in the same order (the multihost pump's publish
    does). Without a process group ``x`` comes back on the host."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not _grouped():
        return x.cpu().numpy()
    wire = _wire()
    mine = to_wire(x, wire)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return torch.cat(parts, dim=dim).cpu().numpy()
