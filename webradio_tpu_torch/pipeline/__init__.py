"""The block program on torch tensors — port of ``webradio_tpu.pipeline``.

Both serving engines: the direct engine (``state``, ``frontend``: every
channel mixed and filtered from the wideband block) and the channelized
engine (``channelized``: a shared polyphase filterbank and the fused
receiver tails), with the offline capture runners and the catch-up scan
(``stream``). Import the submodules directly.
"""
