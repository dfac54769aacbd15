"""The sharded engines on graphs (``webradio_tpu_torch/parallel/graphs.py``)
on the CPU: the counterpart of the JAX package's jitted ``shard_map`` step
and its ``lax.scan`` capture runner.

A CUDA graph cannot run here, so a stand-in
(``tests/torch_graph_standin.RecordedGraph``, put in as the engine's
``graph_class``) replays by running the captured stages again, which write
the same tensors, as a graph's replay does. Both plans are run: one graph a
block (every position on one device, as a mesh of one card) and segments
with the moves between replays (as several cards or ranks; forced here
through the engines' private ``_segmented`` argument, since every CPU
position is one device). Over three carried blocks of 16,384 frames on
(1, 4), (2, 2) and (4, 1) meshes each engine on graphs is held bit for bit
to its eager stages (``graph=False``), and to the JAX package's sharded
step on its 8 virtual CPU devices: audio 3e-6 under the FM flip rule of
PERF.md §2, carries 1e-6 (the raw FM demod tail under its rule), NCO phases
exactly. Then the fixed addresses and the recapture key, a backlog's pieces
across later replays, ``run_capture_sharded`` on graphs against its eager
loop and a kept front end, and the single-card runners' kept pipelines.
"""

import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_torch_radio as tr
from tests.test_torch_direct import assert_audio_close, assert_raw_fm_close
from tests.test_torch_radio import capture, registries  # noqa: F401
from tests.torch_graph_standin import RecordedGraph
from webradio_tpu import parallel as jpar
from webradio_tpu.parallel import sharded_channelized as jsc
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu.pipeline import state as jstate
from webradio_tpu_torch import radio as tradio
from webradio_tpu_torch.io import tuner as ttuner
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.parallel import mesh as tmesh
from webradio_tpu_torch.parallel import sharded as tsh
from webradio_tpu_torch.parallel import sharded_channelized as tsc
from webradio_tpu_torch.pipeline import channelized as tch
from webradio_tpu_torch.pipeline import graph as tgraph
from webradio_tpu_torch.pipeline import state as tstate
from webradio_tpu_torch.pipeline import stream as tstream

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
RATES = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR)
AUDIO_BOUND, CARRY_BOUND = 3e-6, 1e-6
N_BLOCKS = 3
MESHES = [(1, 4), (2, 2), (4, 1)]
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-150_000.0, "FM", 700.0), (230_000.0, "AM", 1_300.0))
LAWS = ["FM", "AM", "USB", "LSB"]


def _blocks(k, seed=0):
    src = ToneSource(carriers=CARRIERS, noise=0.3, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = FS, BF, False
    out = []
    for _ in range(k):
        z = src.read_block()
        out.append(np.stack([z.real, z.imag]).astype(np.float32))
    return out


def _cpu_mesh(t, c):
    return tmesh.make_mesh(t, c, devices=["cpu"] * (t * c))


# engine -> (its configuration and parameters, both packages')
def _direct():
    kw = dict(RATES, block_frames=BF, num_channels=4)
    args = ([100_000, 0, -150_000, 25_000], [80_000, 80_000, 40_000, 80_000],
            8_000, LAWS)
    cfg_j, cfg = jstate.ChainConfig(**kw), tstate.ChainConfig(**kw)
    return (cfg_j, cfg, jstate.make_receiver_params(cfg_j, *args),
            tstate.make_receiver_params(cfg, *args, device="cpu"))


def _channelized(ifbw=80_000, c=8):
    kw = dict(RATES, block_frames=BF, num_channels=c)
    args = ([i * 11_000 - 40_000 for i in range(c)], ifbw, 8_000,
            LAWS * (c // 4))
    sq = dict(squelch_db=[None, -200.0, 1000.0, -15.0] * (c // 4))
    cfg_j, cfg = jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)
    return (cfg_j, cfg, jch.make_channelized_params(cfg_j, *args, **sq),
            tch.make_channelized_params(cfg, *args, **sq, device="cpu"))


ENGINES = {
    "direct": _direct,
    # every slot shares one FIR kernel: the time-major body
    "channelized_tm": _channelized,
    # one 40 kHz slot: the stage body, a move between every stage
    "channelized_stage": functools.partial(
        _channelized, ifbw=[80_000, 80_000, 40_000, 80_000] * 2),
}


def _front_end(engine, cfg, params, mesh, **kw):
    cls = (tsh.ShardedFrontEnd if engine == "direct"
           else tsc.ShardedChannelizedFrontEnd)
    return cls(cfg, params, mesh, **kw)


def _rx(x):
    return x.rx if hasattr(x, "rx") else x


def _jax_run(engine, t, c):
    """The JAX package's sharded front end over the blocks: each block's
    audio ``[C, af]`` and the carried state."""
    cfg_j, _, pj, _ = ENGINES[engine]()
    cls = (jpar.ShardedFrontEnd if engine == "direct"
           else jsc.ShardedChannelizedFrontEnd)
    fe = cls(cfg_j, pj, jpar.make_mesh(t, c))
    audio = [np.asarray(fe.process(jnp.asarray(b))[0])
             for b in _blocks(N_BLOCKS)]
    return audio, jax.tree.map(np.asarray, fe.state)


def _run(fe, blocks):
    """Each block's audio ``[C, af]`` through ``process_host`` (a copy)."""
    out = []
    for b in blocks:
        fe.process_host(b)
        out.append(fe._pending[0].full().clone())
    return out


@pytest.mark.parametrize("tshape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("engine", list(ENGINES))
def test_graphs_match_eager_and_jax(engine, tshape):
    """Both plans on graphs, bit for bit the eager stages; the direct
    engine's and the time-major body's audio and carries against the JAX
    package's sharded step (the stage body's eager stages are held to it in
    ``tests/test_torch_sharded.py``)."""
    _, cfg, _, params = ENGINES[engine]()
    mesh = _cpu_mesh(*tshape)
    blocks = _blocks(N_BLOCKS)
    eager = _front_end(engine, cfg, params, mesh, graph=False)
    want = _run(eager, blocks)
    assert eager.graph_stats() == dict(captures=0, replays=0, warms=0,
                                       kernels=0)
    for segmented in (False, True):
        fe = _front_end(engine, cfg, params, mesh, _segmented=segmented)
        fe.graph_class = RecordedGraph
        assert fe.time_major == (engine == "channelized_tm")
        got = _run(fe, blocks)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        for x, y in zip(tgraph.fields(fe.gathered_state()),
                        tgraph.fields(eager.gathered_state())):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        graphs = len(fe._program.rounds[0])
        assert graphs == 1 if not segmented else graphs > 1
        assert (fe.graph_warms, fe.graph_captures, fe.graph_replays) == (
            1, 1, N_BLOCKS - 1)
    if engine == "channelized_stage":
        return

    ref, ref_state = _jax_run(engine, *tshape)
    prm = _rx(params)
    fm = prm.mode.numpy() == 1
    flip = float(prm.audio_coeff.abs().max())
    for g, r in zip(got, ref):
        assert np.abs(r).max() > 1e-2  # not zeros against zeros
        assert_audio_close(g.numpy(), r, fm, flip, AUDIO_BOUND)
    st, sj = _rx(fe.gathered_state()), _rx(ref_state)
    np.testing.assert_array_equal(st.nco_phase.numpy(),
                                  sj.nco_phase.astype(np.int64))
    for name in ("chan_hist", "demod_prev"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   getattr(sj, name), rtol=0,
                                   atol=CARRY_BOUND, err_msg=name)
    if engine != "direct":
        np.testing.assert_allclose(st.pfb_hist.numpy(), sj.pfb_hist,
                                   rtol=0, atol=CARRY_BOUND)
    assert_raw_fm_close(st.audio_hist.numpy(), sj.audio_hist, fm)


def test_a_sharded_tuners_rows_survive_the_replays_after_them(
        capture, registries, monkeypatch):  # noqa: F811
    """``engine="sharded"`` through the pump on a (1, 4) CPU mesh, on the
    stand-in graph: the rows the pump takes from a block at publish are
    that block's, though every replay since rewrote the pieces they came
    from (here the rows reach the sinks only after the last block); they
    equal an eager front end's bit for bit, and the graphs' counts (what
    ``/status`` shows under ``"graph"``) say one warm, one capture and a
    replay for every later block."""
    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda device=None: [torch.device("cpu")] * 4)
    fe, sinks = tr._front_end(tradio, ttuner, capture, 4, engine="sharded",
                              device="cpu")
    ref, ref_sinks = tr._front_end(tradio, ttuner, capture, 4,
                                   engine="sharded", device="cpu")
    fe.pipeline.graph_class = RecordedGraph
    assert fe.pipeline.mesh.shape == {"time": 1, "chan": 4}
    items = []
    for _ in range(6):
        block = fe.tuner.read_block()
        np.testing.assert_array_equal(block, ref.tuner.read_block())
        fe.ring.put(block)
        assert fe.run_once(timeout=1.0)
        items.append(fe._fanout.get(timeout=0))
        tr._pump(tradio, ref, block)
    for item in items:
        for gathered, rows in item or ():
            fe._deliver_rows(rows, gathered.to_host())
    for got, want in zip(sinks, ref_sinks):
        assert len(got.rows) == len(want.rows) == 5
        for g, w in zip(got.rows, want.rows):
            np.testing.assert_array_equal(g, w)
    assert np.abs(np.concatenate(sinks[0].rows)).max() > 1e-2
    per_block = fe.pipeline.graph_kernels_per_block()
    assert fe.graph_stats() == dict(captures=1, replays=5, warms=1,
                                    kernels=5 * per_block)
    assert ref.graph_stats()["replays"] == 0


def _ptrs(fe):
    pos = fe.mesh.local_positions
    return [t.data_ptr() for p in pos
            for t in tgraph.fields(fe._placed[p]) + tgraph.fields(fe.state[p])
            if t is not None]


def test_addresses_stay_and_only_a_new_key_captures():
    """Blocks, a slot write, a law change through a whole parameter set of
    the same layout and a reset keep every placed parameter and state
    tensor where it was, and so the graphs; a bandwidth that leaves the
    shared FIR kernels changes the body and the key, and the next block
    warms and captures again. Every block's audio stays bit-equal to the
    eager stages'."""
    _, cfg, _, params = _channelized()
    mesh = _cpu_mesh(2, 2)
    fe = tsc.ShardedChannelizedFrontEnd(cfg, params, mesh, _segmented=True)
    fe.graph_class = RecordedGraph
    eager = tsc.ShardedChannelizedFrontEnd(cfg, params, mesh, graph=False)
    blocks = _blocks(6, seed=1)

    def both(b):
        a, _ = fe.process_host_sync(b)
        e, _ = eager.process_host_sync(b)
        torch.testing.assert_close(a.full(), e.full(), rtol=0, atol=0)
        assert e.full().abs().max() > 1e-2

    both(blocks[0])
    both(blocks[1])
    ptrs, key = _ptrs(fe), fe.graph_key()
    sub = tch.make_channelized_params(
        dataclasses.replace(cfg, num_channels=2), [12_345, -54_321], 80_000,
        8_000, ["LSB", "FM"], device="cpu")
    for pipe in (fe, eager):
        pipe.update_params_slots([1, 6], sub)  # one slot in each column
    both(blocks[2])
    ifs = [i * 9_000 - 30_000 for i in range(8)]
    new = tch.make_channelized_params(cfg, ifs, 80_000, 8_000, ["USB"] * 8,
                                      device="cpu")
    for pipe in (fe, eager):
        pipe.update_params(new)
    both(blocks[3])
    for pipe in (fe, eager):
        pipe.reset()
    both(blocks[4])
    assert _ptrs(fe) == ptrs and fe.graph_key() == key
    assert (fe.graph_captures, fe.graph_warms, fe.graph_replays) == (1, 1, 4)
    mixed = tch.make_channelized_params(
        cfg, ifs, [40_000] + [80_000] * 7, 8_000, ["USB"] * 8, device="cpu")
    for pipe in (fe, eager):
        pipe.update_params(mixed)
    assert not fe.time_major and fe.graph_key() != key
    both(blocks[5])
    assert (fe.graph_captures, fe.graph_warms, fe.graph_replays) == (2, 2, 4)


def test_a_backlogs_pieces_survive_the_replays_after_it():
    """``process_host_many`` keeps a copy of each block's pieces: the
    replays of the same slots after it leave the backlog's audio as it
    was, and each block of it equals the eager stages' block."""
    _, cfg, _, params = _channelized()
    mesh = _cpu_mesh(2, 2)
    fe = tsc.ShardedChannelizedFrontEnd(cfg, params, mesh)
    fe.graph_class = RecordedGraph
    eager = tsc.ShardedChannelizedFrontEnd(cfg, params, mesh, graph=False)
    blocks = _blocks(6, seed=2)
    fe.process_host(blocks[0])
    fe.process_host_many(np.stack(blocks[1:4]))
    many, _ = fe.process_host(blocks[4])  # the backlog's, handed back now
    fe.process_host(blocks[5])
    fe.flush()
    assert len(many.blocks) == 3
    kept = many.full().clone()
    eager.process_host_sync(blocks[0])
    for i, b in enumerate(blocks[1:4]):
        a, _ = eager.process_host_sync(b)
        torch.testing.assert_close(kept[i], a.full(), rtol=0, atol=0)
    assert fe.graph_replays == 5  # every block after the warm


@pytest.mark.parametrize("tshape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_run_capture_sharded_on_graphs_and_kept(monkeypatch, tshape):
    """``run_capture_sharded`` on graphs equals its eager loop; a second
    call of the same configuration takes the kept front end (no warm, no
    capture: its graphs replay every block) with its own parameters and
    state copied in, and equals a fresh eager run."""
    monkeypatch.setattr(tsh.ShardedPipeline, "graph_class", RecordedGraph)
    tsc.KEPT.clear()
    _, cfg, _, params = _channelized()
    mesh = _cpu_mesh(*tshape)
    iq = torch.from_numpy(np.concatenate(_blocks(N_BLOCKS, seed=3), axis=1))
    got = tsc.run_capture_sharded(cfg, params, mesh, iq)
    want = tsc.run_capture_sharded(cfg, params, mesh, iq, graph=False)
    (fe,) = [f for k, f in tsc.KEPT.entries.items() if k[2]]
    assert (fe.graph_warms, fe.graph_captures, fe.graph_replays) == (
        1, 1, N_BLOCKS - 1)
    for g, w in zip(got[1:], want[1:]):
        assert g.abs().max() > 1e-2
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for x, y in zip(tgraph.fields(got[0]), tgraph.fields(want[0])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # the second call: other laws, from the first call's final state
    other = tch.make_channelized_params(
        cfg, [i * 7_000 - 20_000 for i in range(8)], 80_000, 8_000,
        ["AM"] * 8, device="cpu")
    again = tsc.run_capture_sharded(cfg, other, mesh, iq, got[0])
    assert (fe.graph_warms, fe.graph_captures, fe.graph_replays) == (
        1, 1, 2 * N_BLOCKS - 1)
    fresh = tsc.run_capture_sharded(cfg, other, mesh, iq, got[0],
                                    graph=False)
    for g, w in zip(tgraph.fields(again), tgraph.fields(fresh)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    tsc.KEPT.clear()


def test_the_offline_runners_keep_their_pipelines(monkeypatch):
    """``run_capture_channelized`` keeps its pipeline (a copy of the
    parameters of its own): a second call of the same configuration and
    layout replays its graphs without a warm or a capture, writes none of
    the caller's tensors, and equals a fresh eager run; past
    two kept the oldest is dropped and freed at once."""
    monkeypatch.setattr(tch.ChannelizedPipeline, "graph_class",
                        RecordedGraph)
    tstream.KEPT.clear()
    _, cfg, _, params = _channelized(c=16)
    iq = torch.from_numpy(np.concatenate(_blocks(N_BLOCKS, seed=4), axis=1))
    saved = tgraph.clone_tree(params)
    first = tstream.run_capture_channelized(cfg, params, iq)
    (pipe,) = tstream.KEPT.entries.values()
    other = tch.make_channelized_params(
        cfg, [i * 5_000 - 20_000 for i in range(16)], 80_000, 8_000,
        ["LSB"] * 16, device="cpu")
    again = tstream.run_capture_channelized(cfg, other, iq, first[0])
    assert next(iter(tstream.KEPT.entries.values())) is pipe
    assert (pipe.graph_warms, pipe.graph_captures, pipe.graph_replays) == (
        1, 1, 2 * N_BLOCKS - 1)
    fresh = tstream.run_capture_channelized(cfg, other, iq, first[0],
                                            graph=False)
    for g, w in zip(tgraph.fields(again), tgraph.fields(fresh)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for x, y in zip(tgraph.fields(params), tgraph.fields(saved)):
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    # with one pipeline kept, the next configuration drops the eager run's
    # (no graph: nothing but the collector could hold it) at once
    monkeypatch.setattr(tstream.KEPT, "size", 1)
    (key,) = [k for k in tstream.KEPT.entries if not k[1]]
    ref = weakref.ref(tstream.KEPT.entries[key])
    wider = dataclasses.replace(cfg, num_channels=32)
    gc.disable()
    try:
        tstream.run_capture_channelized(wider, tch.make_channelized_params(
            wider, [0] * 32, 80_000, 8_000, ["AM"] * 32, device="cpu"), iq)
        assert ref() is None and len(tstream.KEPT.entries) == 1
    finally:
        gc.enable()
    tstream.KEPT.clear()
