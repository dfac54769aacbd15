"""The port's topology layer (``webradio_tpu_torch.radio``) against the JAX
package's, block by block, with no pump threads.

Both packages' ``FrontEnd`` read the same file through their own
``FileTuner`` (a ``.cu8`` capture quantized from the tone source's AM and
FM carriers plus noise, made from a seed); the test pushes each block into
both front ends' rings, calls ``run_once``, and hands what each queued for
its fan-out to its own fetch (the port's ``SelectedRows.to_host``, the
JAX package's ``_fetch_audio_rows``) and ``_deliver_rows``. Every
receiver carries a capturing audio sink, so the rows compared are the rows
a consumer gets. Bounds as in ``tests/test_torch_direct.py``: audio 1e-5
(FM slots under the branch-cut flip rule), waterfall 1e-3 dB on bins within
60 dB of the peak.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_direct import assert_audio_close
from webradio_tpu import radio as jradio
from webradio_tpu.io import tuner as jtuner
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu.pipeline import state as jstate
from webradio_tpu_torch import convert
from webradio_tpu_torch import radio as tradio
from webradio_tpu_torch.io import tuner as ttuner
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.pipeline import channelized as tch
from webradio_tpu_torch.pipeline import frontend as tfe

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
CHAIN = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR, block_frames=BF)
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-150_000.0, "AM", 700.0))
RECEIVERS = [dict(if_frequency=0, demodulator="AM"),
             dict(if_frequency=100_000, demodulator="FM"),
             dict(if_frequency=-150_000, demodulator="USB", af_gain=4)]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A ``.cu8`` capture of 10 blocks, quantized from the tone source."""
    src = ToneSource(carriers=CARRIERS, noise=0.05, seed=11)
    src.sample_rate, src.block_frames, src.realtime = FS, 10 * BF, False
    z = src.read_block()
    iq = np.stack([z.real, z.imag], axis=-1).reshape(-1)
    path = tmp_path_factory.mktemp("radio") / "tones.cu8"
    np.clip(np.round(iq * 120 + 128), 0, 255).astype(np.uint8).tofile(path)
    return path


class Sink:
    def __init__(self):
        self.rows = []

    def write(self, row):
        self.rows.append(np.array(row, np.float32))

    def close(self):
        pass


@pytest.fixture
def registries():
    yield
    for mod in (jradio, tradio):
        mod.Radio.reset()


def _front_end(mod, tuner_mod, path, capacity, engine="auto", **kw):
    tuner = tuner_mod.FileTuner(str(path))
    tuner.source.realtime = False
    chain = (jstate.ChainConfig if mod is jradio
             else tradio.ChainConfig)(**CHAIN)
    tuner.set_sample_rate(chain.sample_rate)
    tuner.set_block_frames(chain.block_frames)
    fe = mod.FrontEnd(tuner, chain, capacity=capacity, engine=engine, **kw)
    sinks = []
    for spec in RECEIVERS:
        rx = mod.Receiver()
        rx.update(**spec)
        rx.set_front_end(fe)
        rx.audio_sink = Sink()
        sinks.append(rx.audio_sink)
    if mod is tradio:
        fe.apply_control()  # what run_once does before its first block
    return fe, sinks


def _pump(mod, fe, block):
    """One block through ``run_once`` and the fan-out, on this thread."""
    fe.ring.put(block)
    assert fe.run_once(timeout=1.0)
    item = fe._fanout.get(timeout=0)
    if item is not None and mod is tradio:
        # the port's pump hands on the rows it gathered, block by block
        for gathered, rows in item:
            fe._deliver_rows(rows, gathered.to_host())
    elif item is not None:
        audio, rows, tm = item
        fe._deliver_rows(rows, mod._fetch_audio_rows(audio, rows, tm))
    return fe.get_spectrum_db()


def _flip_step(params):
    """The largest audio tap: what a branch-cut flip moves an output by."""
    rx = getattr(params, "rx", params)
    return float(rx.audio_coeff.abs().max())


def _assert_db_close(dbt, dbj):
    live = dbj > dbj.max() - 60.0
    assert live.sum() > 10
    np.testing.assert_allclose(dbt[live], dbj[live], rtol=0, atol=1e-3)


@pytest.mark.parametrize("capacity,engine_name", [
    (4, "direct"), (16, "channelized")])
def test_run_once_matches_jax(capture, registries, capacity, engine_name):
    fj, sinks_j = _front_end(jradio, jtuner, capture, capacity)
    ft, sinks_t = _front_end(tradio, ttuner, capture, capacity,
                             device="cpu")
    want = {"direct": tfe.FrontEndPipeline,
            "channelized": tch.ChannelizedPipeline}[engine_name]
    assert isinstance(ft.pipeline, want)
    assert ft._use_channelized() == fj._use_channelized()
    rx_j = list(fj.receivers.values())
    rx_t = list(ft.receivers.values())
    for k in range(6):
        if k == 2:  # a PUT between blocks: retune and change law
            for rxs in (rx_j, rx_t):
                assert rxs[2].update(if_frequency=-100_000,
                                     demodulator="LSB")
        if k == 4:  # a PUT that changes a bandwidth (a full rebuild)
            for rxs in (rx_j, rx_t):
                assert rxs[0].update(af_bandwidth=12_000)
        block = fj.tuner.read_block()
        np.testing.assert_array_equal(block, ft.tuner.read_block())
        dbj = _pump(jradio, fj, block)
        dbt = _pump(tradio, ft, block)
        _assert_db_close(dbt, dbj)
    # after the second PUT the channelized engine runs the per-channel
    # fallback (the bandwidths differ), in both packages
    if engine_name == "channelized":
        assert ft.pipeline.params.chan_toep is not None
        assert ft.pipeline.params.audio_toep is None
    for i, (sj, st) in enumerate(zip(sinks_j, sinks_t)):
        assert len(sj.rows) == len(st.rows) == 5  # double-buffered: 6 - 1
        got, ref = np.stack(st.rows), np.stack(sj.rows)
        assert np.abs(ref).max() > 1e-2, i  # not zeros against zeros
        fm = np.full(got.shape[0], RECEIVERS[i]["demodulator"] == "FM")
        flip_step = _flip_step(ft.pipeline.params)
        assert_audio_close(got, ref, fm, flip_step)


def test_growth_across_the_auto_threshold(capture, registries):
    """Attaching past capacity while serving: the wider pipeline is built
    off the pump thread and swapped in between blocks; 4 -> 8 -> 16 -> 32
    channels flips the engine from direct to channelized. After the swap
    the front end's audio equals the JAX channelized step's from a fresh
    state on the same blocks (an engine flip carries no state)."""
    ft, sinks = _front_end(tradio, ttuner, capture, 4, device="cpu")
    ft.running = True  # serving as far as growth can tell; no threads
    try:
        blocks = [ft.tuner.read_block() for _ in range(6)]
        _pump(tradio, ft, blocks[0])
        extra = []
        for i in range(26):  # 3 + 26 = 29 receivers: capacity 32
            rx = tradio.Receiver()
            rx.update(if_frequency=-400_000 + 30_000 * i)
            rx.set_front_end(ft)
            extra.append(rx)
        assert len(ft._slots) == 32
        assert isinstance(ft.pipeline, tfe.FrontEndPipeline)  # still old
        deadline = time.monotonic() + 120
        while ft._pending_swap is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ft._pending_swap is not None, "growth build never finished"
        _pump(tradio, ft, blocks[1])  # swaps, then the first new block
        assert isinstance(ft.pipeline, tch.ChannelizedPipeline)
        assert ft.pipeline.cfg.num_channels == 32
        assert ft.receivers == {r.uuid: r for r in ft._slots if r}
        for b in blocks[2:]:
            _pump(tradio, ft, b)
        ft.pipeline.flush()
    finally:
        ft.running = False
    # the JAX channelized step at the grown width from a fresh state
    cfg = jch.ChannelizedConfig(num_channels=32, **CHAIN)
    settings = ft._slot_settings(32)
    pj = jch.make_channelized_params(cfg, *settings)
    sj = jch.init_channelized_state(cfg)
    ref = []
    for b in blocks[1:]:
        planes = tradio._to_planes(b)
        sj, aj, _ = jch.channelized_step_serving(cfg, pj, sj,
                                                 jnp.asarray(planes))
        ref.append(np.asarray(aj))
    ref = np.stack(ref[:-1])  # the last block is still in flight
    # row 0 of each sink is the direct engine's block 0, published at the
    # swap; rows 1.. are the channelized pipeline's blocks 1..4
    for slot, sink in zip(range(3), sinks):
        got = np.stack(sink.rows[1:])
        assert got.shape == (4, cfg.audio_frames)
        fm = np.full(4, RECEIVERS[slot]["demodulator"] == "FM")
        flip_step = _flip_step(ft.pipeline.params)
        assert np.abs(ref[:, :, slot]).max() > 1e-2
        assert_audio_close(got, ref[:, :, slot], fm, flip_step)
    for rx in extra:
        assert ft.slots_of(rx) is not None


def test_growth_is_not_live_before_start(capture, registries):
    ft, _ = _front_end(tradio, ttuner, capture, 2, device="cpu")
    assert len(ft._slots) == 4 and ft._grow_thread is None
    assert isinstance(ft.pipeline, tfe.FrontEndPipeline)
    assert ft.pipeline.cfg.num_channels == 4


def test_control_writes_never_mix_parameter_sets(capture, registries):
    """A writer thread flips slot 0 between (IF 0, AM) and (IF +100 kHz,
    FM) every few ms while this thread pumps blocks; the channelized slot
    scatter writes in place, so a write landing inside a step would give a
    block half of each. Every block's audio must equal the step on the
    block's input state with ONE of the two full parameter sets."""
    ft, _ = _front_end(tradio, ttuner, capture, 16, device="cpu")
    rx0 = ft._slots[0]
    settings_a = ft._slot_settings(16)
    rx0.update(if_frequency=100_000, demodulator="FM")
    settings_b = ft._slot_settings(16)
    ft.apply_control()
    cfg = ft.pipeline.cfg
    params = [tch.make_channelized_params(cfg, *s, device="cpu")
              for s in (settings_a, settings_b)]
    stop = threading.Event()
    writes = [0]

    def writer():
        flip = False
        while not stop.is_set():
            spec = (dict(if_frequency=100_000, demodulator="FM") if flip
                    else dict(if_frequency=0, demodulator="AM"))
            assert rx0.update(**spec)
            writes[0] += 1
            flip = not flip
            time.sleep(0.003)

    thread = threading.Thread(target=writer)
    thread.start()
    seen = set()
    try:
        for k in range(24):
            block = ft.tuner.read_block()
            # the pipeline writes its state in place: keep the input state
            state = ft.pipeline.state
            state0 = type(state)(*(t.clone() for t in state))
            _pump(tradio, ft, block)
            # the receivers' columns (empty slots take the first occupied
            # slot's law in a full build, which a slot write leaves alone:
            # their audio is never consumed)
            audio = ft.pipeline._pending[0][:, :3]
            iq = torch.from_numpy(tradio._to_planes(block))
            refs = [tch.channelized_step_serving(cfg, p, state0, iq)[1][:, :3]
                    for p in params]
            err = [float((audio - r).abs().max()) for r in refs]
            assert float((refs[0] - refs[1]).abs().max()) > 1e-2
            assert min(err) <= 1e-6, f"block {k} mixes parameters: {err}"
            seen.add(int(np.argmin(err)))
    finally:
        stop.set()
        thread.join()
    assert writes[0] > 24
    assert seen == {0, 1}


def test_queued_writes_apply_in_order_and_only_between_blocks(
        capture, registries):
    ft, _ = _front_end(tradio, ttuner, capture, 16, device="cpu")
    ft.apply_control()
    rx = ft._slots[1]
    before = ft.pipeline.params.mode.clone()
    rx.update(demodulator="USB")
    rx.update(demodulator="LSB")
    # queued, not applied: the resident parameters are untouched
    torch.testing.assert_close(ft.pipeline.params.mode, before)
    assert len(ft._ctrl) == 2
    _pump(tradio, ft, ft.tuner.read_block())
    assert int(ft.pipeline.params.mode[1]) == 3  # LSB, the last write
    assert ft._ctrl == []


def test_front_end_refuses_what_is_not_ported(capture, registries):
    """Everything is ported: the sharded engine and multihost serving build
    (on the CPU a mesh of one position), and what the JAX front end refuses
    is refused."""
    tuner = ttuner.FileTuner(str(capture))
    fe = tradio.FrontEnd(tuner, engine="sharded", device="cpu")
    assert fe.engine == "sharded" and fe._use_channelized()
    mh = tradio.FrontEnd(tuner, engine="sharded", multihost=True,
                         device="cpu")
    assert mh.multihost
    with pytest.raises(ValueError, match="requires engine='sharded'"):
        tradio.FrontEnd(tuner, multihost=True, device="cpu")
    # the pfb tiers are ported: a front end takes every tier
    assert tradio.FrontEnd(tuner, pfb_precision="u8exact",
                           device="cpu").pfb_precision == "u8exact"
    with pytest.raises(ValueError):
        tradio.FrontEnd(tuner, engine="bogus", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tradio.FrontEnd(tuner)  # no device named: the card, or raise


def test_fetch_audio_rows_matches_jax():
    rng = np.random.default_rng(3)
    tm = rng.standard_normal((64, 10)).astype(np.float32)
    cm = rng.standard_normal((3, 10, 64)).astype(np.float32)
    rows = (7, 0, 3)
    for audio, time_major in ((tm, True), (cm, False), (cm[0], False)):
        want = jradio._fetch_audio_rows(jnp.asarray(audio), rows, time_major)
        got = tfe.Outputs(torch.from_numpy(audio), None,
                          time_major=time_major).select_rows(rows).to_host()
        np.testing.assert_array_equal(got, np.asarray(want))


def test_drop_oldest_queue_and_planes_match_jax():
    for mod in (jradio, tradio):
        q = mod.DropOldestQueue(2)
        for i in range(4):
            q.put(i)
        assert q.dropped == 2 and q.get(timeout=0) == 2
        q.close()
        assert q.get() == 3 and q.get() is None and q.closed
    z = (np.random.default_rng(0).standard_normal(256)
         + 1j).astype(np.complex64)
    np.testing.assert_array_equal(tradio._to_planes(z),
                                  jradio._to_planes(z))
    planes = np.ones((2, 8), np.float64)
    assert tradio._to_planes(planes).dtype == np.float32


def test_convert_starts_both_packages_from_one_state(capture, registries):
    """A JAX front end's direct-engine state, carried over with
    ``convert``, continues in the port's pipeline as it continues in the
    JAX one."""
    fj, _ = _front_end(jradio, jtuner, capture, 4)
    ft, _ = _front_end(tradio, ttuner, capture, 4, device="cpu")
    block = fj.tuner.read_block()
    fj.pipeline.process_host_sync(jradio._to_planes(block))
    ft.pipeline.state = convert.frontend_state_from_numpy(
        jax.tree.map(np.asarray, fj.pipeline.state), device="cpu")
    nxt = jradio._to_planes(fj.tuner.read_block())
    aj, _ = fj.pipeline.process_host_sync(nxt)
    at, _ = ft.pipeline.process_host_sync(nxt)
    fm = np.array([r["demodulator"] == "FM" for r in RECEIVERS] + [False])
    assert_audio_close(at.numpy(), np.asarray(aj), fm,
                       _flip_step(ft.pipeline.params))


def test_sink_writer_matches_jax():
    """A blocking local sink behind the writer thread: rows arrive in
    order, overflow drops the oldest, a failing sink unbinds itself, and
    close() frees the sink on the writer's thread."""
    for mod in (jradio, tradio):
        gate = threading.Event()

        class Slow(Sink):
            closed = False

            def write(self, row):
                gate.wait()
                super().write(row)

            def close(self):
                self.closed = True

        sink = Slow()
        w = mod.SinkWriter(sink, "test")
        for i in range(12):
            w.write(np.full(4, i, np.float32))
        gate.set()
        w.close()
        w._thread.join(timeout=10)
        got = [int(r[0]) for r in sink.rows]
        assert got == sorted(got) and got[-1] == 11
        assert w.dropped == 12 - len(got) > 0 and sink.closed

        class Broken(Sink):
            def write(self, row):
                raise OSError("gone")

        w = mod.SinkWriter(Broken(), "broken")
        w.write(np.zeros(4, np.float32))
        w._thread.join(timeout=10)
        assert w.failed
