"""DSP operators on torch tensors — the port of ``webradio_tpu.ops``.

Same layouts as the JAX package: time-major planes ``[N, C]`` (time on the
leading axis, channels last), IQ as two float32 real planes, integer NCO
phases carried as int64 tensors holding the uint32 value. Host-side design
helpers (``window``, ``firdesign``, the numpy half of ``fir`` and
``channelizer``) are numpy and bit-identical to the JAX package's.

Import the submodules directly; this package module imports nothing so that
every submodule stays importable on its own.
"""
