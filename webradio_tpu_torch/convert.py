"""Carry JAX-package parameters and state over to the port.

Each function takes a JAX parameter or state NamedTuple (the channelized
engine's, or the direct engine's ``FrontEndParams`` / ``FrontEndState``)
with every field as a numpy array (``jax.tree.map(np.asarray, x)`` on the
JAX side) and return the port's NamedTuple on ``device`` (None: the CUDA
device, and an error where there is none). Layouts are the same; the
uint32 NCO phase and step become int64 tensors holding the same value.
A JAX ``chan_hist`` holds the mixed-domain tail, except under
``cfg.use_pallas_tail``, where it holds the RAW pre-mix tail; the port's
holds the raw tail wherever its per-channel kernel runs, which on the card
is the per-channel fallback whatever that flag says
(``pipeline.channelized.carries_raw``). :func:`state_from_numpy` given the
configuration and the port's parameters carries the history into the
domain the port will run. Nothing here imports JAX: the inputs are
duck-typed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import require_cuda
from .pipeline.channelized import (
    ChannelizedParams,
    ChannelizedState,
    carries_raw,
    switch_hist_domain,
)
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
    if name == "pfb_weights_split":
        return _bfloat16(name, a, device)
    a = np.asarray(a)
    if name in _INT64_FIELDS:
        a = a.astype(np.int64)
    elif name == "mode":
        a = a.astype(np.int32)
    elif a.dtype != np.float32:
        raise TypeError(f"{name} has dtype {a.dtype}, expected float32")
    return torch.from_numpy(np.array(a)).to(device)


def _bfloat16(name, a, device):
    """A bfloat16 array (``ml_dtypes.bfloat16`` where it comes from JAX, or
    a bfloat16 tensor) as a bfloat16 tensor: through float32, which holds
    every bfloat16 value, so the carry is exact."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
    else:
        a = np.asarray(a)
        if a.dtype.name != "bfloat16":
            raise TypeError(f"{name} has dtype {a.dtype}, expected bfloat16")
        t = torch.from_numpy(a.astype(np.float32))
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} has dtype {t.dtype}, expected bfloat16")
    return t.to(torch.bfloat16).to(device)


def params_from_numpy(p, device: torch.device | str | None = None
                      ) -> ChannelizedParams:
    """The port's :class:`ChannelizedParams` from a JAX one of numpy
    arrays, the u8exact tier's bfloat16 split weights included. (JAX keeps
    the split for u8exact only; a port configuration at "default", "high"
    or "bf16" reads it too: build those parameters with
    ``make_channelized_params``.)"""
    return _carry(ChannelizedParams, p, device)


def _carry(cls, nt, device):
    if device is None:
        device = require_cuda()
    return cls(**{f: _tensor(f, getattr(nt, f), device) for f in cls._fields})


def state_from_numpy(s, device: torch.device | str | None = None,
                     cfg=None, params: ChannelizedParams | None = None
                     ) -> ChannelizedState:
    """The port's :class:`ChannelizedState` from a JAX one of numpy
    arrays. With ``cfg`` (the configuration both steps share) and
    ``params`` (the port's, on ``device``) the history goes into the
    domain the port's step of those parameters carries: a JAX state is raw
    exactly under ``cfg.use_pallas_tail``; without them it is carried as it
    is."""
    state = _carry(ChannelizedState, s, device)
    if cfg is None or params is None:
        return state
    raw = carries_raw(cfg, params)
    if raw == cfg.use_pallas_tail:
        return state
    return state._replace(chan_hist=switch_hist_domain(
        state.chan_hist, state.nco_phase, params.residual_step, raw))


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
