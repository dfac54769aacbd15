"""Worker of ``tests/test_torch_multiprocess.py`` (run as a subprocess):
one rank of a two-process ``torch.distributed`` group on gloo.

Each rank drives two CPU positions of a global (time=2, chan=2) mesh and
ingests only ITS time slice of a capture made from a seed
(``multihost.host_time_slice`` / ``make_global_block``); two blocks go
through the sharded channelized step, each block's audio rows are gathered
across the ranks, and the gathered audio and the carried state are held to
the port's single-device step on the whole capture (3e-6 audio with the FM
flip rule of PERF.md §2, 1e-6 carries). Then rank 0 broadcasts a control
blob three times ``CONTROL_BLOB_BYTES`` long, which must arrive whole.
Prints MULTIPROC_OK on success. Imports neither JAX nor the JAX package.

Usage: python torch_multiproc_worker.py <init-url> <num_procs> <rank>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BOUND = 3e-6


def main() -> None:
    url, num, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import numpy as np
    import torch

    torch.sin(torch.zeros(1))  # see the test files' note on torch's CPU math
    torch.set_num_threads(2)  # beside the other test workers' CPU use
    from webradio_tpu_torch.io.source import ToneSource
    from webradio_tpu_torch.parallel import multihost
    from webradio_tpu_torch.parallel.mesh import make_mesh, world
    from webradio_tpu_torch.parallel.sharded_channelized import (
        ShardedChannelizedFrontEnd,
    )
    from webradio_tpu_torch.pipeline import channelized as ch

    assert multihost.init_distributed(url, num, rank, backend="gloo")
    assert world() == (rank, num)
    cfg = ch.ChannelizedConfig(sample_rate=1_024_000, channel_rate=128_000,
                               audio_rate=32_000, block_frames=10_240,
                               num_channels=4)
    modes = ["FM", "AM", "USB", "LSB"]
    params = ch.make_channelized_params(
        cfg, [100_000, 0, -150_000, 40_000], 80_000, 8_000, modes,
        device="cpu")
    mesh = make_mesh(2, 2, devices=["cpu"] * 2)
    assert mesh.local_rows == [rank]
    src = ToneSource(carriers=((0.0, "AM", 1_000.0),
                               (100_000.0, "FM", 440.0),
                               (-150_000.0, "FM", 700.0)),
                     noise=0.3, seed=7)
    src.sample_rate, src.block_frames, src.realtime = (
        cfg.sample_rate, cfg.block_frames, False)
    blocks = []
    for _ in range(2):
        z = src.read_block()
        blocks.append(np.stack([z.real, z.imag]).astype(np.float32))

    lo, hi = multihost.host_time_slice(cfg.block_frames, mesh)
    assert (lo, hi) == (rank * 5_120, (rank + 1) * 5_120)
    fe = ShardedChannelizedFrontEnd(cfg, params, mesh)
    state = ch.init_channelized_state(cfg, "cpu")
    fm = np.array([m == "FM" for m in modes])
    flip = float(params.audio_coeff.abs().max())
    for b in blocks:
        audio, _ = fe.process(multihost.make_global_block(
            b[:, lo:hi], cfg.block_frames, mesh))
        got = multihost.gather_to_host(audio.fetch_rows(range(4)), dim=-1)
        state, ref, _ = ch.channelized_step(cfg, params, state,
                                            torch.from_numpy(b))
        ref = ref.numpy()
        assert got.shape == ref.shape, (got.shape, ref.shape)
        assert np.abs(ref).max() > 1e-2
        err = np.abs(got.astype(np.float64) - ref)
        assert err[~fm].max() <= BOUND, err[~fm].max()
        assert (err[fm] > BOUND).sum() <= max(1, 1e-4 * err[fm].size)
        assert err[fm].max() <= 2 * flip + BOUND
    carried = fe.gathered_state()
    np.testing.assert_array_equal(carried.nco_phase.numpy(),
                                  state.nco_phase.numpy())
    for name in ("pfb_hist", "chan_hist", "demod_prev"):
        np.testing.assert_allclose(getattr(carried, name).numpy(),
                                   getattr(state, name).numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)

    blob = bytes(np.random.default_rng(3).integers(
        0, 256, 3 * multihost.CONTROL_BLOB_BYTES + 17, np.uint8))
    got = multihost.broadcast_blob(blob if rank == 0 else None)
    assert got == blob, len(got)
    print("MULTIPROC_OK", flush=True)


if __name__ == "__main__":
    main()
