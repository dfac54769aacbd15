"""The port's in-place step and its CUDA-graph machinery on the CPU.

On the card every block of ``HostPipeline.process_host`` is a replay of a
captured graph over the state's persistent buffers (``pipeline/graph.py``).
Here, without a card, the same pipeline runs its eager in-place step, which
is held against the JAX package's functional step over three carried
blocks on each single-card branch (the time-major tail, with the JAX step
through kernel #1 in interpret mode; the per-channel fallback; 9.6 kHz
audio; the direct engine). Bounds as in ``tests/test_torch_channelized.py``
and PERF.md §2: audio 1e-5 (FM slots under the branch-cut flip rule),
carries 1e-6 (the FM slots' raw demod tail with whole-turn flips removed),
NCO phases and the filterbank history exactly.

A stand-in for the CUDA graph (:class:`RecordedGraph`, injected as the
pipeline's ``graph_class``) replays by running the recorded step again,
which writes the same output tensors, as a graph does. With it: the rows
the pump gathered from a block survive the replays after it, the kernel
launch counts add per replay (and a capture on one thread takes none of
another thread's launches), and a backlog, the offline runner and the
catch-up scan go through the graphs bit for bit as the eager step. Then
the pump's catch-up (``FrontEnd.run_once`` drains the whole ring) and the
strict check of a ``/profile`` trace's kernel events.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webradio_tpu.pipeline import channelized as jch
from webradio_tpu.pipeline import frontend as jfe
from webradio_tpu.pipeline import state as jstate
from webradio_tpu_torch import radio as tradio
from webradio_tpu_torch.io import tuner as ttuner
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import tail_tm
from webradio_tpu_torch.ops.launches import (
    add_launches,
    count_launch,
    recording,
)
from webradio_tpu_torch.pipeline import channelized as tch
from webradio_tpu_torch.pipeline import frontend as tfe
from webradio_tpu_torch.pipeline import graph as tgraph
from webradio_tpu_torch.pipeline import state as tstate
from webradio_tpu_torch.web import handlers

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

AUDIO_BOUND, CARRY_BOUND, RAW_FM_MAX = 1e-5, 1e-6, 1e-3
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-450_000.0, "FM", 700.0), (700_000.0, "AM", 1_300.0))
LAWS = ("AM", "FM", "USB", "LSB")


class RecordedGraph(tgraph.StepGraph):
    """A stand-in for a CUDA graph on the CPU. Capturing runs ``fn`` once
    and puts back what it wrote (a capture runs nothing); a replay runs
    ``fn`` again, and what it writes lands in the same tensors, as a
    graph's does. The launches a run counts stay out of the wrappers'
    counts (a replay runs no Python: :class:`..graph.StepGraph` adds the
    capture's tally)."""

    kernel_nodes = 7

    def _capture(self, fn, carried, stream, pool):
        saved = [t.clone() for t in carried]
        fn()
        for t, s in zip(carried, saved):
            t.copy_(s)
        self.fn = fn

    def _replay(self):
        with recording():
            self.fn()


def _blocks(n, block, rate=2_400_000, seed=0):
    src = ToneSource(carriers=CARRIERS, noise=0.5, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = rate, block, False
    out = []
    for _ in range(n):
        z = src.read_block()
        out.append(np.stack([z.real, z.imag]).astype(np.float32))
    return out


def _fm_close(got, ref, fm, flip_step, bound=AUDIO_BOUND, raw=False):
    """``got``/``ref`` ``[t, C]``: every non-FM column within ``bound``; an
    FM sample may exceed it only by a branch-cut flip (at most two audio
    taps, on at most 1e-4 of the samples; a whole turn on raw rows)."""
    err = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    if raw:
        err[:, fm] -= np.round(err[:, fm])
    err = np.abs(err)
    assert err[:, ~fm].max(initial=0.0) <= bound
    over = err[:, fm] > bound
    assert over.sum() <= max(1, 1e-4 * over.size)
    assert err[:, fm].max(initial=0.0) <= 2 * flip_step + bound


# name -> (ChannelizedConfig keywords, channels, IF and AF bandwidths)
BRANCHES = {
    # the time-major tail; the JAX step runs kernel #1 (interpret mode)
    "time_major": (dict(block_frames=51_200, tail_kernel="pallas"), 128,
                   80_000, 8_000),
    "fallback": (dict(block_frames=102_400), 16, [12_500, 80_000] * 8,
                 [9_000, 8_000] * 8),
    # no audio time tile: the JAX step runs kernel #2 (interpret mode)
    "audio_9600": (dict(block_frames=256_000, audio_rate=9_600,
                        tail_kernel="pallas"), 128, 80_000, 8_000),
}


def _ptrs(state):
    return [t.data_ptr() for t in tgraph.fields(state)]


@pytest.mark.parametrize("name", list(BRANCHES))
def test_in_place_step_matches_jax(name):
    kw, c, ifbw, afbw = BRANCHES[name]
    kw = dict(kw, num_channels=c)
    cfg_j, cfg_t = jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)
    ifs = [int(f) for f in np.linspace(-900_000, 900_000, c)]
    modes = [LAWS[i % 4] for i in range(c)]
    pj = jch.make_channelized_params(cfg_j, ifs, ifbw, afbw, modes)
    pt = tch.make_channelized_params(cfg_t, ifs, ifbw, afbw, modes,
                                     device="cpu")
    pipe = tch.ChannelizedPipeline(cfg_t, pt)
    assert not pipe.graphed()  # the CPU runs the eager in-place step
    ptrs = _ptrs(pipe.state)
    sj = jch.init_channelized_state(cfg_j)
    fm = pt.mode.numpy() == 1
    flip_step = float(pt.audio_coeff.abs().max())
    for iq in _blocks(3, cfg_t.block_frames, seed=5):
        sj, aj, _ = jch.channelized_step_serving(cfg_j, pj, sj,
                                                 jnp.asarray(iq))
        at, _ = pipe.process_host_sync(iq)
        aj = np.asarray(aj)
        assert at.shape == aj.shape
        assert np.abs(aj).max() > 1e-2  # not zeros against zeros
        _fm_close(at.numpy(), aj, fm, flip_step)
    assert _ptrs(pipe.state) == ptrs  # carried in place
    st, sj = pipe.state, jax.tree.map(np.asarray, sj)
    np.testing.assert_array_equal(st.nco_phase.numpy(),
                                  sj.nco_phase.astype(np.int64))
    np.testing.assert_array_equal(st.pfb_hist.numpy(), sj.pfb_hist)
    for f in ("chan_hist", "demod_prev"):
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(sj, f),
                                   rtol=0, atol=CARRY_BOUND)
    # the raw demod tail: FM flips are whole turns, and at most 1e-4 of the
    # FM samples may pass 1e-5, none 1e-3 (PERF.md §2)
    _fm_close(st.audio_hist.numpy().T, sj.audio_hist.T, fm,
              (RAW_FM_MAX - AUDIO_BOUND) / 2, raw=True)


def test_in_place_direct_step_matches_jax():
    kw = dict(sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
              block_frames=16_384, num_channels=4)
    ifs = [0, 100_000, -150_000, 230_000]
    modes = ["AM", "FM", "USB", "FM"]
    cfg_j, cfg_t = jstate.ChainConfig(**kw), tstate.ChainConfig(**kw)
    pj = jstate.make_receiver_params(cfg_j, ifs, 80_000, 8_000, modes)
    pt = tstate.make_receiver_params(cfg_t, ifs, 80_000, 8_000, modes,
                                     device="cpu")
    pipe = tfe.FrontEndPipeline(cfg_t, pt)
    ptrs = _ptrs(pipe.state)
    sj = jstate.init_state(cfg_j)
    fm = pt.rx.mode.numpy() == 1
    flip_step = float(pt.rx.audio_coeff.abs().max())
    for iq in _blocks(3, cfg_t.block_frames, rate=cfg_t.sample_rate):
        sj, aj, _ = jfe.frontend_step_serving(cfg_j, pj, sj, jnp.asarray(iq))
        at, _ = pipe.process_host_sync(iq)
        assert np.abs(np.asarray(aj)).max() > 1e-2
        _fm_close(at.numpy().T, np.asarray(aj).T, fm, flip_step)
    assert _ptrs(pipe.state) == ptrs
    st, sj = pipe.state.rx, jax.tree.map(np.asarray, sj).rx
    np.testing.assert_array_equal(st.nco_phase.numpy(),
                                  sj.nco_phase.astype(np.int64))
    for f in ("chan_hist", "demod_prev"):
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(sj, f),
                                   rtol=0, atol=CARRY_BOUND)


def _main(c=16, **kw):
    cfg = tch.ChannelizedConfig(num_channels=c, block_frames=51_200, **kw)
    ifs = [int(f) for f in np.linspace(-900_000, 900_000, c)]
    modes = [LAWS[i % 4] for i in range(c)]
    return cfg, ifs, modes, tch.make_channelized_params(
        cfg, ifs, 80_000, 8_000, modes, device="cpu")


def test_state_buffers_stay_across_blocks_writes_and_law_changes():
    cfg, ifs, modes, params = _main()
    pipe = tch.ChannelizedPipeline(cfg, params)
    ptrs = _ptrs(pipe.state)
    blocks = _blocks(4, cfg.block_frames)
    pipe.process_host(blocks[0])
    # a slot write: retune and change law
    sub = tch.make_channelized_params(
        dataclasses.replace(cfg, num_channels=2), [12_345, -54_321], 80_000,
        8_000, ["LSB", "FM"], device="cpu")
    pipe.update_params_slots([3, 9], sub)
    pipe.process_host(blocks[1])
    # a law change on every slot through a whole new parameter set
    pipe.update_params(tch.make_channelized_params(
        cfg, ifs, 80_000, 8_000, ["FM"] * cfg.num_channels, device="cpu"))
    pipe.process_host(blocks[2])
    pipe.reset()
    pipe.load_state(tch.init_channelized_state(cfg, "cpu"))
    pipe.process_host(blocks[3])
    assert _ptrs(pipe.state) == ptrs


def test_the_graph_key_changes_where_a_capture_must_be_made_again():
    cfg, ifs, modes, params = _main()
    pipe = tch.ChannelizedPipeline(cfg, params)
    key = pipe.graph_key()
    # a law change and a retune by slot scatter: the same addresses
    sub = tch.make_channelized_params(
        dataclasses.replace(cfg, num_channels=1), [77_000], 80_000, 8_000,
        ["USB"], device="cpu")
    pipe.update_params_slots([5], sub)
    assert pipe.graph_key() == key
    pipe.process_host(_blocks(1, cfg.block_frames)[0])
    assert pipe.graph_key() == key
    # a law change by a whole new parameter set of the same layout: copied
    # into the current tensors
    pipe.update_params(tch.make_channelized_params(
        cfg, ifs, 80_000, 8_000, ["LSB"] * cfg.num_channels, device="cpu"))
    assert pipe.graph_key() == key and int(pipe.params.mode[0]) == 3
    # a bandwidth that leaves the shared FIR kernels: new parameters (the
    # step takes the per-channel fallback)
    mixed = tch.make_channelized_params(
        cfg, ifs, [12_500] + [80_000] * (cfg.num_channels - 1), 8_000, modes,
        device="cpu")
    assert mixed.chan_toep is None
    pipe.update_params(mixed)
    assert pipe.graph_key() != key
    # a tier change and a wider pipeline
    other_tier = tch.ChannelizedPipeline(
        dataclasses.replace(cfg, pfb_precision="bf16"),
        tch.make_channelized_params(
            dataclasses.replace(cfg, pfb_precision="bf16"), ifs, 80_000, 8_000,
            modes, device="cpu"))
    assert other_tier.graph_key()[0] != key[0]
    fe = tradio.FrontEnd(ttuner.ToneTuner(), capacity=16,
                         engine="channelized", device="cpu")
    try:
        for _ in range(16):
            rx = tradio.Receiver()
            rx.set_front_end(fe)
        fe.apply_control()
        before = fe.pipeline.graph_key()
        extra = tradio.Receiver()
        extra.set_front_end(fe)  # past capacity: growth to 32
        assert fe.pipeline.cfg.num_channels == 32
        assert fe.pipeline.graph_key() != before
    finally:
        fe.close()
        tradio.Radio.reset()


class _Sink:
    def __init__(self):
        self.rows = []

    def write(self, row):
        self.rows.append(np.array(row, copy=True))


def _front_end(graph_class=None, capacity=16):
    """A channelized front end on the CPU with four receivers, each with a
    capturing sink, served by hand (no threads)."""
    tuner = ttuner.ToneTuner()
    cfg = tstate.ChainConfig(block_frames=51_200)
    fe = tradio.FrontEnd(tuner, cfg, capacity=capacity, engine="channelized",
                         device="cpu")
    sinks = []
    for i, (f, mode) in enumerate([(0, "AM"), (100_000, "FM"),
                                   (-450_000, "FM"), (700_000, "AM")]):
        rx = tradio.Receiver()
        rx.update(if_frequency=f, demodulator=mode)
        rx.set_front_end(fe)
        rx.audio_sink = _Sink()
        sinks.append(rx.audio_sink)
    fe.apply_control()
    if graph_class is not None:
        fe.pipeline.graph_class = graph_class
    return fe, sinks


def _deliver(fe, item):
    for gathered, rows in item or ():
        fe._deliver_rows(rows, tradio._rows_to_host(gathered))


def test_a_published_blocks_rows_survive_the_replays_after_it():
    blocks = _blocks(6, 51_200, seed=2)
    fe, sinks = _front_end(RecordedGraph)
    ref, ref_sinks = _front_end()
    try:
        items, outs = [], []
        for b in blocks:
            fe.ring.put(b)
            assert fe.run_once(timeout=0)
            items.append(fe._fanout.get(timeout=0))
            outs.append(fe.pipeline._pending[0])
            ref.ring.put(b)
            assert ref.run_once(timeout=0)
            _deliver(ref, ref._fanout.get(timeout=0))
        pipe = fe.pipeline
        assert (pipe.graph_warms, pipe.graph_captures,
                pipe.graph_replays) == (1, 1, 5)
        # the graphs' outputs are fixed: a slot's replay two blocks on
        # rewrites the tensor handed out for a block
        assert outs[2] is outs[4] and outs[3] is outs[5]
        # rows gathered as each block was published are that block's,
        # though every replay since rewrote the outputs they came from
        assert items[0] is None  # the first block only primes
        for item in items[1:]:
            _deliver(fe, item)
        for got, want in zip(sinks, ref_sinks):
            assert len(got.rows) == len(want.rows) == 5
            for g, w in zip(got.rows, want.rows):
                np.testing.assert_array_equal(g, w)
        assert not all(np.array_equal(a, b) for a, b in
                       zip(ref_sinks[0].rows[:-1], ref_sinks[0].rows[1:]))
    finally:
        fe.close()
        ref.close()
        tradio.Radio.reset()


def test_launch_counts_add_per_replay(monkeypatch):
    """Each replay adds the launches its graph holds (a kernel wrapper's
    count rises in Python, which a replay never runs); the capture's own
    count is taken back, since a captured launch never ran."""
    real = tch.fused_tail_audio_tm

    def counting(*args, **kw):
        count_launch(tail_tm.fused_tail_audio_tm)  # as the card's route
        return real(*args, **kw)

    monkeypatch.setattr(tch, "fused_tail_audio_tm", counting)
    monkeypatch.setattr(tail_tm.fused_tail_audio_tm, "launches", 0)
    cfg, ifs, modes, params = _main(c=128, tail_kernel="pallas")
    pipe = tch.ChannelizedPipeline(cfg, params)
    pipe.graph_class = RecordedGraph
    eager = tch.ChannelizedPipeline(cfg, params, graph=False)
    blocks = _blocks(5, cfg.block_frames, seed=3)
    for b in blocks:
        a, _ = pipe.process_host_sync(b)
        e, _ = eager.process_host_sync(b)
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    assert pipe.graph_replays == 4 and pipe.graph_warms == 1
    assert tail_tm.fused_tail_audio_tm.launches == 2 * len(blocks)
    assert pipe.graph_kernels == 4 * RecordedGraph.kernel_nodes
    # a backlog: replays of the same graphs, fed from the device; bit for
    # bit the blocks one by one, launches one a block
    more = _blocks(3, cfg.block_frames, seed=4)
    pipe.process_host_many(np.stack(more))
    many, _ = pipe.flush()
    for i, b in enumerate(more):
        e, _ = eager.process_host_sync(b)
        torch.testing.assert_close(many[i], e.T, rtol=0, atol=0)
    for x, y in zip(tgraph.fields(pipe.state), tgraph.fields(eager.state)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert tail_tm.fused_tail_audio_tm.launches == 2 * (len(blocks) + 3)
    assert pipe.graph_replays == 4 + 3 and pipe.graph_captures == 1


def test_a_capture_counts_only_its_own_threads_launches(monkeypatch):
    """A growth build captures on its own thread while the pump goes on
    launching: the pump's launches made during the capture stay counted,
    and none of them is credited to the new graph."""
    import threading

    wrapper = tail_tm.fused_tail_audio_tm
    monkeypatch.setattr(wrapper, "launches", 0)
    inside, pumped = threading.Event(), threading.Event()

    def fn():  # the captured step: one launch of kernel #1
        count_launch(wrapper)
        inside.set()
        assert pumped.wait(5)

    def pump():  # another pipeline's eager block and replay meanwhile
        assert inside.wait(5)
        count_launch(wrapper)
        add_launches({wrapper: 2})
        pumped.set()

    other = threading.Thread(target=pump)
    other.start()
    graph = RecordedGraph(fn)
    other.join()
    assert graph.launches == {wrapper: 1}
    assert wrapper.launches == 3  # the pump's, none of the capture's
    graph.replay()
    assert wrapper.launches == 4


def test_the_runners_on_graphs_match_the_plain_loop(monkeypatch):
    """The offline runner and the catch-up scan feed the serving graphs
    from the device, a replay a block after the warm: bit for bit the
    eager step's audio, spectra and state."""
    from webradio_tpu_torch.pipeline import stream as tstream

    monkeypatch.setattr(tfe.HostPipeline, "graph_class", RecordedGraph)
    cfg, ifs, modes, params = _main()
    iq = torch.from_numpy(np.concatenate(_blocks(5, cfg.block_frames,
                                                 seed=6), axis=1))
    got = tstream.run_capture_channelized(cfg, params, iq)
    want = tstream.run_capture_channelized(cfg, params, iq, graph=False)
    for g, w in zip(got[1:], want[1:]):
        assert g.abs().max() > 1e-2
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for x, y in zip(tgraph.fields(got[0]), tgraph.fields(want[0])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    blocks = iq.reshape(2, 5, -1).transpose(0, 1)
    state = tch.init_channelized_state(cfg, "cpu")
    got = tstream.scan_serving(cfg, params, state, blocks)
    want = tstream.scan_serving(cfg, params, state, blocks, graph=False)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert not state.nco_phase.any()  # the caller's state is not written


def test_run_once_drains_the_whole_backlog():
    blocks = _blocks(5, 51_200, seed=7)
    fe, sinks = _front_end()
    ref, ref_sinks = _front_end()
    try:
        fe.ring.put(blocks[0])
        assert fe.run_once(timeout=0)  # primes the double buffer
        for b in blocks[1:]:
            fe.ring.put(b)
        assert fe.ring.backlog == fe.ring_blocks == 4
        assert fe.run_once(timeout=0)
        assert fe.block_count == 5 and fe.ring.backlog == 0
        item = fe._fanout.get(timeout=0)
        assert len(item) == 4  # one hand-off, a block each
        _deliver(fe, item)
        for b in blocks:
            ref.ring.put(b)
            assert ref.run_once(timeout=0)
            got = ref._fanout.get(timeout=0)
            if got is not None:
                _deliver(ref, got)
        for got, want in zip(sinks, ref_sinks):
            assert len(got.rows) == len(want.rows) == 4
            for g, w in zip(got.rows, want.rows):
                np.testing.assert_array_equal(g, w)
    finally:
        fe.close()
        ref.close()
        tradio.Radio.reset()


def _trace(path, kernels, copies=3):
    events = ([{"cat": "kernel", "name": f"k{i}"} for i in range(kernels)]
              + [{"cat": "gpu_memcpy", "name": "Memcpy HtoD"}] * copies
              + [{"cat": "cuda_runtime", "name": "cudaGraphLaunch"}] * 5)
    path.write_text(json.dumps({"traceEvents": events}))
    return path


class _FrontEndStub:
    def __init__(self, per_block):
        self.per_block = per_block

    def graph_kernels_per_block(self):
        return self.per_block


def test_a_trace_holds_the_kernel_events_the_replays_launched(tmp_path):
    a, b = _FrontEndStub(30), _FrontEndStub(12)
    # 10 replays of a's graph and 4 of b's between the readings, less one
    # block each for a replay under way as the trace began
    expected = handlers.expected_kernel_events({a: 60, b: 0},
                                               {a: 360, b: 48})
    assert expected == (300 - 30) + (48 - 12)
    (tmp_path / "whole").mkdir()
    whole = _trace(tmp_path / "whole" / "trace.json", expected + 5)
    assert handlers.check_trace_has_kernels(whole, 14, expected) == \
        expected + 5
    (tmp_path / "part").mkdir()
    part = _trace(tmp_path / "part" / "trace.json", 24)
    with pytest.raises(RuntimeError, match=f"24 kernel events of the "
                                           f"{expected}"):
        handlers.check_trace_has_kernels(part, 14, expected)
    assert (tmp_path / "part" / "trace_missing_kernels.json").exists()
    assert not part.exists()
    (tmp_path / "none").mkdir()
    none = _trace(tmp_path / "none" / "trace.json", 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        handlers.check_trace_has_kernels(none, 14, expected)
    assert (tmp_path / "none" / "trace_without_kernels.json").exists()
    # eager blocks only (no replay counted): none still fails, one passes
    (tmp_path / "eager").mkdir()
    one = _trace(tmp_path / "eager" / "trace.json", 1)
    assert handlers.check_trace_has_kernels(one, 3, 0) == 1
