"""webradio_tpu_torch — the PyTorch + CUDA port of ``webradio_tpu``.

The JAX package (``webradio_tpu``) is the reference; this package mirrors
its module paths so each counterpart sits at the same relative path:

* ``ops``       — the DSP operators on torch tensors (FIR design, NCO mix,
                  direct, Toeplitz and overlap-save FIRs, demodulators,
                  spectrum, filterbank) and the hand-written Hopper kernels
                  for the four fused receiver tails (``ops/tail_tm.py``
                  over ``csrc/tail_tm.cu``, ``ops/tail.py`` over
                  ``csrc/tail.cu``).
* ``pipeline``  — both engines' serving steps: the direct engine
                  (``state``, ``frontend``) and every single-device branch
                  of the channelized step, their control plane (slot
                  scatter, capacity growth), the catch-up scan and the
                  double-buffered host wrappers (``FrontEndPipeline``,
                  ``ChannelizedPipeline``).
* ``io``        — the port's own sample sources, tuner drivers, ingest ring,
                  local audio I/O (``soundcard``) and native ingest library
                  (built from ``native/src`` into ``_build/`` at first
                  use).
* ``radio``     — the topology: front ends, receivers, the block pump, the
                  audio fan-out, control writes applied between blocks.
* ``web``, ``app`` — the HTTP server, the REST/streaming handlers and the
                  application (``python -m webradio_tpu_torch``).
* ``convert``   — carry a JAX parameter or state pytree (as numpy arrays)
                  over to the port's tensors.
* ``demod_cli``, ``entry`` — offline demodulation of a recorded capture
                  (``python -m webradio_tpu_torch.demod_cli``) and the
                  flagship single-card step as ``(fn, example_args)``.

Nothing here imports ``jax`` or the JAX package. Entry points that place
tensors take ``device=None`` for the CUDA device and raise where there is
none; the tests pass ``device="cpu"``.

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
