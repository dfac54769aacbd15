"""The block program over several devices and processes (port of
``webradio_tpu.parallel``).

Two mesh axes (SURVEY §2.7):

* ``chan``: receivers are data-parallel (the reference's only scalable
  axis, there iterated sequentially: radio.cxx:151-156); the ``[C, ...]``
  batch splits with no communication.
* ``time``: the block's time axis splits with small halo exchanges: FIR
  histories (K-1 frames), the FM discriminator's previous sample and the
  filterbank's input tail move between neighbours; the NCO phase needs no
  exchange (closed-form from the block-start phase).

``mesh`` builds the grid, ``comm`` moves the halos and carries (within a
process, or across ranks of a ``torch.distributed`` group), ``sharded``
and ``sharded_channelized`` are the two engines' sharded steps and
``multihost`` the multi-process serving helpers.
"""

from .mesh import make_mesh, mesh_shape_for
from .sharded import ShardedFrontEnd, sharded_frontend_step

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "ShardedFrontEnd",
    "sharded_frontend_step",
]
