"""Device meshes: a ``(time, chan)`` grid of shard positions (port of
``webradio_tpu.parallel.mesh``).

A position is one shard of the block program: position ``p = t * chan +
c`` runs time slice ``t`` of the block for channel shard ``c``. The mesh
records each position's device and the rank of the process that drives it.
Positions may repeat a device (``["cpu"] * 8`` in the tests,
``["cuda:0"] * 4`` in the smoke's virtual meshes), as JAX's tests force a
count of virtual CPU devices.

Across processes (``torch.distributed``) each rank drives whole time rows,
in rank order, so that a rank's share of a block is one contiguous frame
range (``multihost.host_time_slice``); a layout that breaks this raises
when the mesh is built.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import require_cuda


def mesh_shape_for(
    n_devices: int, num_channels: int, block_frames: int, fft_size: int = 512
) -> tuple[int, int]:
    """Pick a ``(time, chan)`` factorization of ``n_devices`` (the JAX
    package's rule).

    Prefers channel sharding (no collectives) as long as each shard keeps at
    least one channel; remaining factors go to the time axis, constrained so
    each time shard holds a whole number of FFT groups.
    """
    chan = 1
    time = 1
    rem = n_devices
    # greedily assign powers of two to chan while channels divide evenly
    while rem % 2 == 0 and num_channels % (chan * 2) == 0:
        chan *= 2
        rem //= 2
    while rem > 1:
        nt = time * 2 if rem % 2 == 0 else time * rem
        step = nt // time
        if block_frames % (nt * fft_size) == 0:
            time = nt
            rem //= step
        else:
            break
    if time * chan != n_devices:
        # fall back: put everything on chan if divisible, else time
        if num_channels % n_devices == 0:
            return 1, n_devices
        if block_frames % (n_devices * fft_size) == 0:
            return n_devices, 1
        raise ValueError(
            f"cannot factor {n_devices} devices over C={num_channels}, "
            f"N={block_frames}"
        )
    return time, chan


def world() -> tuple[int, int]:
    """``(rank, world size)`` of this process: ``(0, 1)`` without a
    process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def visible_devices(device: torch.device | str | None = None
                    ) -> list[torch.device]:
    """The devices a sharded front end spreads over: every CUDA device of
    the process (one per rank, its current device, once a process group of
    several ranks is up: the torchrun convention), or the CPU once where
    ``device`` names the CPU. None is the CUDA device, and an error where
    there is none."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    current = require_cuda()
    if world()[1] > 1:
        return [current]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(time, chan)`` grid of positions: ``devices[p]`` is position
    ``p``'s device where this rank drives it (None where another rank
    does), ``ranks[p]`` its rank."""

    time: int
    chan: int
    devices: tuple
    ranks: tuple
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {"time": self.time, "chan": self.chan}

    @property
    def size(self) -> int:
        return self.time * self.chan

    @property
    def world(self) -> int:
        return max(self.ranks) + 1

    @property
    def local_positions(self) -> list[int]:
        return [p for p in range(self.size) if self.ranks[p] == self.rank]

    @property
    def local_rows(self) -> list[int]:
        return sorted({p // self.chan for p in self.local_positions})

    def row_owner(self, t: int) -> int:
        return self.ranks[t * self.chan]


def make_mesh(time: int, chan: int, devices=None) -> Mesh:
    """A ``(time, chan)`` mesh over ``devices`` (None:
    :func:`visible_devices`). Without a process group every position is
    this process's and takes ``devices[:time * chan]`` in row-major order;
    with one, ``devices`` are this rank's and each rank takes the next
    ``time * chan / world`` positions, which must be whole time rows."""
    rank, size = world()
    devices = list(devices if devices is not None else visible_devices())
    n = time * chan
    if n % size or (n // size) % chan:
        raise ValueError(
            f"a ({time}, {chan}) mesh does not split into whole time rows "
            f"over {size} processes")
    per_rank = n // size
    if len(devices) < per_rank:
        raise ValueError(f"need {per_rank} devices, have {len(devices)}")
    local = [torch.device(d) for d in devices[:per_rank]]
    ranks = tuple(p // per_rank for p in range(n))
    return Mesh(time=time, chan=chan, rank=rank, ranks=ranks,
                devices=tuple(local[p - rank * per_rank]
                              if ranks[p] == rank else None
                              for p in range(n)))
