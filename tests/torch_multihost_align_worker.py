"""Worker of ``tests/test_torch_multihost_align.py`` (run as a subprocess):
one rank of a two-process multihost front end on gloo whose sources
dropped unequal numbers of blocks at start.

Both ranks run ``radio.FrontEnd`` with ``engine="sharded"`` and
``multihost=True`` on two CPU positions each (``visible_devices`` replaced
in-process), driven round by round with ``run_once`` (no HTTP, no pump
thread). The tuner's source is a stand-in whose block k is a function of
k alone: the tone ensemble from sample ``k * block_frames`` on, its noise
seeded by k. Rank 1's source lost its first ``SKIP`` blocks (its first
read returns block ``SKIP``) and ends after block ``SKIP + ROUNDS - 1``;
rank 0's loses none and runs on. The ranks must agree on the source block
of every round: rank 0 passes over ``SKIP`` blocks (counted as drops) and
both serve blocks ``SKIP .. SKIP + ROUNDS - 1``, and where rank 1's source
ends, both stop at that round.

Rank 0 attaches four receivers (FM, AM, USB, LSB) with local sinks that
keep every row. Their audio, gathered from both ranks, is held to the
port's single-device step on the same source blocks (a round publishes
the block of the round before it: ``ROUNDS - 1`` carried blocks): 3e-6
with the FM flip rule (PERF.md §2's sharded bound), with a non-trivial
peak. Prints
``ALIGN {json}`` and ``ALIGN_OK`` on success. Imports neither JAX nor the
JAX package.

Usage: python torch_multihost_align_worker.py <init-url> <rank>
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SKIP = 4  # blocks rank 1's source lost at start
ROUNDS = 5  # rounds served before rank 1's source ends
BOUND = 3e-6
RATES = dict(sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
             block_frames=10_240)
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-150_000.0, "FM", 700.0))
RECEIVERS = ((100_000, "FM"), (0, "AM"), (-150_000, "USB"), (40_000, "LSB"))


def source_block(k: int):
    """Block ``k`` of the stand-in source: a function of ``k`` alone."""
    from webradio_tpu_torch.io.source import ToneSource

    src = ToneSource(carriers=CARRIERS, noise=0.3, seed=k)
    src.sample_rate = RATES["sample_rate"]
    src.block_frames = RATES["block_frames"]
    src.realtime = False
    src._n0 = k * src.block_frames
    return src.read_block()


def main() -> None:
    url, rank = sys.argv[1], int(sys.argv[2])

    import numpy as np
    import torch

    torch.sin(torch.zeros(1))  # see the test files' note on torch's CPU math
    torch.set_num_threads(2)  # beside the other test workers' CPU use
    from webradio_tpu_torch.io.source import SampleSource
    from webradio_tpu_torch.io.tuner import Tuner
    from webradio_tpu_torch.parallel import mesh as pmesh
    from webradio_tpu_torch.parallel import multihost
    from webradio_tpu_torch.pipeline import channelized as ch
    from webradio_tpu_torch.pipeline.state import ChainConfig
    from webradio_tpu_torch.radio import FrontEnd, Receiver, _to_planes

    class LossySource(SampleSource):
        """Blocks ``first, first + 1, .., last``, then the end."""

        def __init__(self, first: int, last: int):
            super().__init__()
            self.first, self.last, self._next = first, last, first

        def read_block(self):
            k = self._next
            if k > self.last:
                return None
            self._next += 1
            return self._counted(source_block(k), self.first)

    class Keep:
        """A receiver's local sink that keeps every row."""

        def __init__(self):
            self.rows = []

        def write(self, row):
            self.rows.append(np.array(row, np.float64))

        def close(self):
            pass

    pmesh.visible_devices = lambda device=None: [torch.device("cpu")] * 2
    assert multihost.init_distributed(url, 2, rank, backend="gloo")
    src = (LossySource(0, 10 * ROUNDS) if rank == 0
           else LossySource(SKIP, SKIP + ROUNDS - 1))
    fe = FrontEnd(Tuner(src), ChainConfig(**RATES), capacity=4,
                  engine="sharded", multihost=True, device="cpu")
    assert fe.start()
    sinks = []
    if rank == 0:
        for if_hz, mode in RECEIVERS:
            rx = Receiver()
            rx.update(if_frequency=if_hz, demodulator=mode)
            rx.set_front_end(fe)
            rx.audio_sink = Keep()
            sinks.append(rx.audio_sink)
    served = [fe.run_once() for _ in range(ROUNDS)]
    ended = fe.run_once()  # rank 1's source ends: both ranks stop here
    record = {"rank": rank, "served": list(fe.served), "rounds": served,
              "stopped": not ended and not fe.running,
              "skipped": fe.skipped_blocks, "dropped": fe.dropped_blocks,
              "mesh": fe.pipeline.mesh.shape}
    assert all(served) and record["stopped"], record
    assert [i for _, i in fe.served] == list(range(SKIP, SKIP + ROUNDS))
    assert fe.dropped_blocks == (SKIP if rank == 0 else 0), record
    if rank == 0:
        width = fe.pipeline.cfg.num_channels
        cfg = fe._channelized_cfg(width)
        params = fe._make_params(width)
        state = ch.init_channelized_state(cfg, "cpu")
        got = np.stack([np.stack(s.rows) for s in sinks])  # [rx, blocks, af]
        fm = np.array([mode == "FM" for _, mode in RECEIVERS])
        flip = float(params.audio_coeff.abs().max())
        worst = 0.0
        assert got.shape[1] == ROUNDS - 1, got.shape
        for b, k in enumerate(range(SKIP, SKIP + ROUNDS - 1)):
            state, ref, _ = ch.channelized_step(
                cfg, params, state, torch.from_numpy(
                    _to_planes(source_block(k))))
            ref = ref.numpy()[:len(RECEIVERS)]
            assert np.abs(ref).max() > 1e-2  # not the silent-FIR trap
            err = np.abs(got[:, b] - ref)
            assert err[~fm].max() <= BOUND, (b, err[~fm].max())
            assert (err[fm] > BOUND).sum() <= max(1, 1e-4 * err[fm].size)
            assert err[fm].max() <= 2 * flip + BOUND, (b, err[fm].max())
            worst = max(worst, float(err[~fm].max()))
        record.update(max_err=worst, peak=float(np.abs(got).max()))
    print("ALIGN " + json.dumps(record), flush=True)
    fe.close()
    print("ALIGN_OK", flush=True)


if __name__ == "__main__":
    main()
