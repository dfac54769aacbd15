"""tail_roofline.bulk: kernel #1's bound for one card's share of a block
(``roofline.tail_flops`` and ``tail_bytes``) over its device time a block
on the busiest card, in %. Kernel #1 is the launch of ``tail_tm_kernel``
and its ``power_reduce_kernel`` (``csrc/tail_tm.cu``, by
``ops.tail_tm.fused_tail_audio_tm``). Layer: kernels."""

#: the device symbols of kernel #1's launch, found in the demangled names
#: the profiler records (``void (anonymous namespace)::tail_tm_kernel<true,
#: 0, 0>(...)``)
KERNELS = ("tail_tm_kernel<", "power_reduce_kernel")


def read(run):
    tl = run.timeline
    if tl is None or not run.dispatched:
        return None
    dev, _ = tl.busiest()
    ms = sum(s for name, s in tl.by_name(dev).items()
             if any(k in name for k in KERNELS))
    if ms <= 0:
        return None
    per_block_ms = 1e3 * ms / len(run.dispatched)
    return 100.0 * run.tail_bound_ms() / per_block_ms
