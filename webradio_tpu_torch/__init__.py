"""webradio_tpu_torch — the PyTorch + CUDA port of ``webradio_tpu``.

The JAX package (``webradio_tpu``) is the reference; this package mirrors
its module paths so each counterpart sits at the same relative path:

* ``ops``       — the DSP operators on torch tensors (FIR design, NCO mix,
                  Toeplitz FIR, demodulators, spectrum, filterbank) and the
                  hand-written Hopper kernel for the fused receiver tail
                  (``ops/tail_tm.py`` over ``csrc/tail_tm.cu``).
* ``pipeline``  — the channelized serving step and its double-buffered
                  host wrapper (``ChannelizedPipeline``).
* ``convert``   — carry a JAX parameter or state pytree (as numpy arrays)
                  over to the port's tensors.

The host I/O layer is shared: the port reads sample sources from
``webradio_tpu.io``, which imports no JAX. Nothing here imports ``jax``.

Kernels run only on a CUDA device. A function with a kernel takes its plain
torch version for tensors that lie on the CPU (the tests' path), and for a
CUDA tensor it launches the kernel or raises — it never falls back.
"""

import torch

__version__ = "0.1.0"


def require_cuda() -> torch.device:
    """The CUDA device to run on; raises when none is visible.

    There is no CPU fallback for device work: callers that need the card
    call this first and let the error stop them.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "webradio_tpu_torch needs a CUDA device, and torch sees none "
            f"(torch {torch.__version__}, CUDA {torch.version.cuda})"
        )
    return torch.device("cuda", torch.cuda.current_device())
