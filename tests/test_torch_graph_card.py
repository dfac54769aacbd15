"""The CUDA graphs of ``pipeline/graph.py`` on the card (``cuda``-marked:
each test skips itself where torch sees no card). No JAX here, so the file
runs on the card's machine with ``--noconftest -m cuda`` (README).

A graphed ``ChannelizedPipeline`` against the same pipeline with
``graph=False``, each block's outputs read after the next block was
dispatched, as the server's pump reads them: bit-equal audio and state,
kernel #1 counted once a block (one warm block, then replays), and one
captured graph's kernel nodes counted on every replay.
"""

import numpy as np
import pytest
import torch

from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import tail_tm
from webradio_tpu_torch.pipeline import channelized as ch
from webradio_tpu_torch.pipeline import stream
from webradio_tpu_torch.pipeline.graph import fields


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _setup(card, c=512, n=5):
    cfg = ch.ChannelizedConfig(num_channels=c, block_frames=102_400)
    ifs = [int(f) for f in np.linspace(-900_000, 900_000, c)]
    modes = [("AM", "FM", "USB", "LSB")[i % 4] for i in range(c)]
    params = ch.make_channelized_params(cfg, ifs, 80_000, 8_000, modes,
                                        device=card)
    src = ToneSource(seed=3)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, 102_400, \
        False
    blocks = []
    for _ in range(n):
        z = src.read_block()
        blocks.append(np.stack([z.real, z.imag]).astype(np.float32))
    return cfg, params, blocks


def _keep(out):
    return None if out is None else tuple(t.clone() for t in out)


def _served(pipe, blocks):
    """Each block's outputs, copied as ``process_host`` hands them back
    (after the next block was dispatched): a slot's replay two blocks on
    rewrites them."""
    kept = [_keep(pipe.process_host(b)) for b in blocks][1:]
    kept.append(_keep(pipe.flush()))
    return kept


@pytest.mark.cuda
def test_graph_replays_equal_the_eager_step(card):
    cfg, params, blocks = _setup(card)
    tail_tm.fused_tail_audio_tm.launches = 0
    graphed = ch.ChannelizedPipeline(cfg, params)
    got = _served(graphed, blocks)
    torch.cuda.synchronize()
    assert tail_tm.fused_tail_audio_tm.launches == len(blocks)
    stats = graphed.graph_stats()
    assert (stats["captures"], stats["warms"], stats["replays"]) == (
        1, 1, len(blocks) - 1)
    assert graphed.graph_kernels_per_block() > 0
    assert stats["kernels"] == (len(blocks) - 1) * \
        graphed.graph_kernels_per_block()
    eager = ch.ChannelizedPipeline(cfg, params, graph=False)
    want = _served(eager, blocks)
    for (a, db), (b, eb) in zip(got, want):
        assert torch.equal(a, b) and torch.equal(db, eb)
    for x, y in zip(fields(graphed.state), fields(eager.state)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_the_offline_runner_on_graphs_equals_the_plain_loop(card):
    cfg, params, blocks = _setup(card, n=6)
    iq = torch.from_numpy(np.concatenate(blocks, axis=1)).to(card)
    tail_tm.fused_tail_audio_tm.launches = 0
    state, audio, latest = stream.run_capture_channelized(cfg, params, iq)
    assert tail_tm.fused_tail_audio_tm.launches == len(blocks)
    ref_state, ref_audio, ref_latest = stream.run_capture_channelized(
        cfg, params, iq, graph=False)
    assert torch.equal(audio, ref_audio) and torch.equal(latest, ref_latest)
    for x, y in zip(state, ref_state):
        assert torch.equal(x, y)
