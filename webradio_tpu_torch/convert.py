"""Carry JAX-package parameters and state over to the port.

Both functions take the ``webradio_tpu.pipeline.channelized`` NamedTuple
with every field as a numpy array (``jax.tree.map(np.asarray, x)`` on the
JAX side) and return the port's NamedTuple on ``device``. Layouts are the
same; the uint32 NCO phase and step become int64 tensors holding the same
value. Nothing here imports JAX: the inputs are duck-typed.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline.channelized import ChannelizedParams, ChannelizedState

_INT64_FIELDS = ("residual_step", "nco_phase")


def _tensor(name, a, device):
    if a is None:
        return None
    a = np.asarray(a)
    if name in _INT64_FIELDS:
        a = a.astype(np.int64)
    elif name == "mode":
        a = a.astype(np.int32)
    elif a.dtype != np.float32:
        raise TypeError(f"{name} has dtype {a.dtype}, expected float32")
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(p, device: torch.device | str = "cpu"
                      ) -> ChannelizedParams:
    """The port's :class:`ChannelizedParams` from a JAX one of numpy
    arrays. The u8exact split weights are not ported (ROADMAP.md, the pfb
    tiers) and must be absent."""
    if getattr(p, "pfb_weights_split", None) is not None:
        raise NotImplementedError(
            "pfb_weights_split (the u8exact tier) is not ported to "
            "webradio_tpu_torch yet (ROADMAP.md, still to port: the pfb "
            "tiers)"
        )
    return ChannelizedParams(**{
        f: _tensor(f, getattr(p, f), device)
        for f in ChannelizedParams._fields
    })


def state_from_numpy(s, device: torch.device | str = "cpu"
                     ) -> ChannelizedState:
    """The port's :class:`ChannelizedState` from a JAX one of numpy
    arrays."""
    return ChannelizedState(**{
        f: _tensor(f, getattr(s, f), device)
        for f in ChannelizedState._fields
    })
