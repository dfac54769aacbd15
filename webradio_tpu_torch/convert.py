"""Carry JAX-package parameters and state over to the port.

Each function takes a JAX parameter or state NamedTuple (the channelized
engine's, or the direct engine's ``FrontEndParams`` / ``FrontEndState``)
with every field as a numpy array (``jax.tree.map(np.asarray, x)`` on the
JAX side) and return the port's NamedTuple on ``device`` (None: the CUDA
device, and an error where there is none). Layouts are the same; the
uint32 NCO phase and step become int64 tensors holding the same value.
``chan_hist`` holds the mixed-domain tail, except under
``cfg.use_pallas_tail``, where it holds the RAW pre-mix tail: as in the JAX
package, a state is not carried across that flag. Nothing here imports
JAX: the inputs are duck-typed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import require_cuda
from .pipeline.channelized import ChannelizedParams, ChannelizedState
from .pipeline.state import (
    FrontEndParams,
    FrontEndState,
    ReceiverParams,
    ReceiverState,
)

_INT64_FIELDS = ("residual_step", "phase_step", "nco_phase")


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


def params_from_numpy(p, device: torch.device | str | None = None
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
    return _carry(ChannelizedParams, p, device)


def _carry(cls, nt, device):
    if device is None:
        device = require_cuda()
    return cls(**{f: _tensor(f, getattr(nt, f), device) for f in cls._fields})


def state_from_numpy(s, device: torch.device | str | None = None
                     ) -> ChannelizedState:
    """The port's :class:`ChannelizedState` from a JAX one of numpy
    arrays."""
    return _carry(ChannelizedState, s, device)


def frontend_params_from_numpy(p, device: torch.device | str | None = None
                               ) -> FrontEndParams:
    """The direct engine's :class:`FrontEndParams` from a JAX one of numpy
    arrays."""
    return FrontEndParams(rx=_carry(ReceiverParams, p.rx, device))


def frontend_state_from_numpy(s, device: torch.device | str | None = None
                              ) -> FrontEndState:
    """The direct engine's :class:`FrontEndState` from a JAX one of numpy
    arrays."""
    return FrontEndState(rx=_carry(ReceiverState, s.rx, device))
