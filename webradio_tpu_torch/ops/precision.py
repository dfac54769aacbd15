"""Float32 matmul precision pinning.

The filterbank and spectrum matmuls are true float32 (the "highest" tier).
On a CUDA device a float32 matmul may silently run in TF32 when a caller
has flipped the global switches; every matmul of the serving path runs
inside :func:`full_fp32`, which pins both switches off for its duration and
restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Pin ``allow_tf32`` off for cuBLAS and cuDNN inside the block."""
    matmul = torch.backends.cuda.matmul
    old = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
