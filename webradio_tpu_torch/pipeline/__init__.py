"""The block program on torch tensors — port of ``webradio_tpu.pipeline``.

This slice ports the channelized serving step
(:mod:`webradio_tpu_torch.pipeline.channelized`) and the two helpers it
needs from ``frontend`` and ``state``. Import the submodules directly.
"""
