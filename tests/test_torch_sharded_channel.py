"""The sharded channelized engine's per-channel body on kernel #4
(``parallel.sharded_channelized.CHANNEL_STAGES``), with the card's choice
run on the CPU.

Slots whose bandwidths differ send a sharded front end to a per-channel
body. On the card it runs kernel #4 (``ops.tail.fused_receiver_tail``) on
each shard, the halos remade from the shard's last ``2K - 1`` raw rows;
on the CPU the JAX package's stage body runs, plain. Here
``channelized.on_card``, the rule's device test, is replaced, so that CPU
tensors take the card's body and #4's wrapper computes its plain version
(``fused_receiver_tail_ref``), as ``tests/test_torch_tail_select.py`` does
for the single card. The JAX side is the JAX package's sharded stage body
on its 8 virtual CPU devices (``tests/conftest.py``), and its single-card
step with its plain fallback.

Blocks come from the port's tone source (AM and FM carriers plus noise);
slot 1, FM on a carrier, has a 40 kHz channel filter, so the slots no
longer share the FIR kernels, and the audio's peak is asserted (the
silent-FIR trap of ROADMAP.md). Bounds: sharded audio within 3e-6 of the
single card's #4 fallback and of the JAX package's stage body, under the
FM flip rule of PERF.md §2; the carried raw history within 1e-6 of the
single card's, the FM lag 1e-6, the demod tail by the raw-FM rule; a live
switch against the JAX fallback 1e-5 (the two LO laws of the time-major
and the per-channel tail meet there); graph replays bit-equal to the
eager stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_direct import assert_audio_close, assert_raw_fm_close
from tests.torch_graph_standin import RecordedGraph
from webradio_tpu import parallel as jpar
from webradio_tpu.parallel import sharded_channelized as jsc
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import tail
from webradio_tpu_torch.ops.channelizer import pfb_channelize_direct
from webradio_tpu_torch.parallel import mesh as tmesh
from webradio_tpu_torch.parallel import sharded_channelized as tsc
from webradio_tpu_torch.pipeline import channelized as tch

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
KW = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR, block_frames=BF)
C = 16
AUDIO_BOUND, CARRY_BOUND, SWITCH_BOUND = 3e-6, 1e-6, 1e-5
N_BLOCKS = 3
MESHES = [(2, 1), (2, 2), (4, 1)]
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-150_000.0, "FM", 700.0), (230_000.0, "AM", 1_300.0))
LAWS = ("AM", "FM", "USB", "LSB")


def _blocks(k, seed=0):
    src = ToneSource(carriers=CARRIERS, noise=0.3, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = FS, BF, False
    return [np.stack([z.real, z.imag]).astype(np.float32)
            for z in (src.read_block() for _ in range(k))]


def _controls(mixed=True):
    """Slots on the carriers first (AM at 0, FM at +100 kHz and -150 kHz,
    AM at 230 kHz), the rest spread over the band with the laws in turn;
    ``mixed`` gives slot 1 a 40 kHz channel filter."""
    ifs = [0, 100_000, -150_000, 230_000] + [
        int(f) for f in np.linspace(-400_000, 400_000, C - 4)]
    modes = ["AM", "FM", "FM", "AM"] + [LAWS[i % 4] for i in range(C - 4)]
    ifbw = [80_000, 40_000 if mixed else 80_000] + [80_000] * (C - 2)
    return ifs, ifbw, 8_000, modes


def _params(cfg, mixed=True, jax_cfg=None):
    ctl = _controls(mixed)
    pt = tch.make_channelized_params(cfg, *ctl, device="cpu")
    return pt, (None if jax_cfg is None
                else jch.make_channelized_params(jax_cfg, *ctl))


def _cpu_mesh(t, c):
    return tmesh.make_mesh(t, c, devices=["cpu"] * (t * c))


@pytest.fixture
def card(monkeypatch):
    """The card's choice on CPU tensors, and a tally of the kernel wrappers
    the sharded bodies and the single-card step call (each computes its
    plain version here)."""
    monkeypatch.setattr(tch, "on_card", lambda x: True)
    calls = {}
    for mod, name in ((tsc, "fused_receiver_tail"),
                      (tsc, "fused_tail_audio_tm"),
                      (tch, "fused_receiver_tail"),
                      (tch, "fused_tail_audio_tm")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=f"{mod.__name__.split('.')[-1]}."
                    f"{name}", **kw):
            calls[_key] = calls.get(_key, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _fm(params):
    return params.mode.numpy() == 1


@pytest.mark.parametrize("t,c", MESHES)
def test_channel_body_matches_single_card_and_jax_stage_body(card, t, c):
    """Three carried blocks through the per-channel body on #4 against the
    single card's #4 fallback and the JAX package's sharded stage body;
    #4 once a shard a block; the carried state against the single card's
    (raw history, FM lag, demod tail)."""
    cfg = tch.ChannelizedConfig(**KW, num_channels=C)
    cfg_j = jch.ChannelizedConfig(**KW, num_channels=C)
    pt, pj = _params(cfg, jax_cfg=cfg_j)
    fm, flip = _fm(pt), float(pt.audio_coeff.abs().max())
    fe = tsc.ShardedChannelizedFrontEnd(cfg, pt, _cpu_mesh(t, c))
    assert not fe.time_major and fe.carries_raw()
    assert fe._stages() is tsc.CHANNEL_STAGES and fe.plain_tail is None
    jfe = jsc.ShardedChannelizedFrontEnd(cfg_j, pj, jpar.make_mesh(t, c))
    state = tch.init_channelized_state(cfg, "cpu")
    peak = 0.0
    for b in _blocks(N_BLOCKS, seed=t + c):
        got = fe.process(b)[0].full().numpy()
        state, single, _ = tch.channelized_step(cfg, pt, state,
                                                torch.from_numpy(b))
        assert got.shape == (C, cfg.audio_frames)
        assert_audio_close(got, single.numpy(), fm, flip, AUDIO_BOUND)
        ja = np.asarray(jfe.process(jnp.asarray(b))[0])
        assert_audio_close(got, ja, fm, flip, AUDIO_BOUND)
        peak = max(peak, float(np.abs(single.numpy()[1]).max()))
    assert peak > 1e-2  # the 40 kHz FM slot is heard, not zeros
    assert card == {"sharded_channelized.fused_receiver_tail":
                    t * c * N_BLOCKS, "channelized.fused_receiver_tail":
                    N_BLOCKS}
    carried = fe.gathered_state()
    assert tch.carries_raw(cfg, pt)  # the single card's domain: raw
    np.testing.assert_array_equal(carried.nco_phase.numpy(),
                                  state.nco_phase.numpy())
    np.testing.assert_allclose(carried.chan_hist.numpy(),
                               state.chan_hist.numpy(), rtol=0,
                               atol=CARRY_BOUND)
    np.testing.assert_allclose(carried.demod_prev.numpy(),
                               state.demod_prev.numpy(), rtol=0,
                               atol=CARRY_BOUND)
    assert_raw_fm_close(carried.audio_hist.numpy(), state.audio_hist.numpy(),
                        fm)


def test_channel_halos_are_the_left_shards_own_outputs():
    """The halos a shard sends (:func:`_channel_rows`, from its last 127
    raw rows) against what #4's plain version computes on the whole
    left shard: the raw history exactly, the FM lag 1e-6, the last 63
    demodulated samples by the raw-FM rule."""
    cfg = tch.ChannelizedConfig(**KW, num_channels=C)
    pt, _ = _params(cfg)
    rng = np.random.default_rng(3)
    iq = torch.from_numpy(_blocks(1, seed=3)[0])
    chan_in, _ = pfb_channelize_direct(
        iq, pt.pfb_weights, cfg.num_bins,
        torch.zeros(2, cfg.proto_taps - 1))
    k = cfg.fir_length
    for rows in (2 * k - 1, 512, chan_in.shape[-1]):
        left = chan_in[..., :rows].contiguous()
        phase = torch.from_numpy(rng.integers(0, 2**31, C))
        raw_hist = torch.from_numpy(
            rng.uniform(-0.5, 0.5, (2, C, k - 1)).astype(np.float32))
        prev = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, C))
                                .astype(np.float32))
        audio_if, raw_tail, prev_tail, _ = tail.fused_receiver_tail_ref(
            left, phase, pt.residual_step, pt.chan_coeff, pt.mode, raw_hist,
            prev)
        h_raw, h_prev, h_audio = tsc._channel_rows(cfg, pt, left, phase)
        assert torch.equal(h_raw, raw_tail)
        np.testing.assert_allclose(h_prev.numpy(), prev_tail.numpy(), rtol=0,
                                   atol=CARRY_BOUND)
        assert float(prev_tail.abs().max()) > 1e-3
        assert_raw_fm_close(h_audio.numpy(),
                            audio_if[:, rows - (k - 1):].numpy(), _fm(pt))


def test_live_switch_uniform_mixed_uniform_matches_jax_fallback(card):
    """One sharded front end on (2, 2) with the card's choice goes uniform
    (the time-major body, #1) -> mixed (the per-channel body, #4) ->
    uniform, two blocks each, its history converted at each switch; the
    JAX single-card step runs the same blocks through its plain tails with
    the same parameter switches and carries its mixed history straight
    across."""
    cfg = tch.ChannelizedConfig(**KW, num_channels=C)
    cfg_j = jch.ChannelizedConfig(**KW, num_channels=C, tail_kernel="xla")
    uni_t, uni_j = _params(cfg, False, cfg_j)
    mix_t, mix_j = _params(cfg, True, cfg_j)
    fm, flip = _fm(uni_t), float(uni_t.audio_coeff.abs().max())
    fe = tsc.ShardedChannelizedFrontEnd(cfg, uni_t, _cpu_mesh(2, 2))
    sj = jch.init_channelized_state(cfg_j)
    raw_seen = []
    for k, b in enumerate(_blocks(6, seed=9)):
        if k in (2, 4):
            fe.update_params(mix_t if k == 2 else uni_t)
        pj = mix_j if k in (2, 3) else uni_j
        sj, aj, _ = jch.channelized_step(cfg_j, pj, sj, jnp.asarray(b))
        got = fe.process(b)[0].full().numpy()
        assert_audio_close(got, np.asarray(aj), fm, flip, SWITCH_BOUND)
        assert np.abs(got).max() > 1e-2
        raw_seen.append(fe.carries_raw())
        assert fe.plain_tail is None
        # the carried history is the JAX fallback's, in its domain
        st = fe.gathered_state()
        hist = st.chan_hist
        if tch.carries_raw(cfg, fe.params):
            hist = tch.switch_hist_domain(hist, st.nco_phase,
                                          fe.params.residual_step,
                                          to_raw=False)
        np.testing.assert_allclose(hist.numpy(), np.asarray(sj.chan_hist),
                                   rtol=0, atol=SWITCH_BOUND)
    assert raw_seen == [False, False, True, True, False, False]
    assert card == {"sharded_channelized.fused_tail_audio_tm": 16,
                    "sharded_channelized.fused_receiver_tail": 8}


@pytest.mark.parametrize("segmented", [False, True])
def test_channel_body_graph_replay_equals_eager(card, segmented):
    """The per-channel body on graphs (the stand-in graph; one graph a
    block, or segments with the moves between replays) against its eager
    stages over three carried blocks, bit for bit, audio and state."""
    cfg = tch.ChannelizedConfig(**KW, num_channels=C)
    pt, _ = _params(cfg)
    mesh = _cpu_mesh(2, 2)
    fe_g = tsc.ShardedChannelizedFrontEnd(cfg, pt, mesh,
                                          _segmented=segmented)
    fe_g.graph_class = RecordedGraph
    fe_e = tsc.ShardedChannelizedFrontEnd(cfg, pt, mesh, graph=False)
    for b in _blocks(N_BLOCKS, seed=4):
        fe_g.process_host(b)
        fe_e.process_host(b)
        a_g = fe_g._pending[0].full()
        a_e = fe_e._pending[0].full()
        assert torch.equal(a_g, a_e) and float(a_e.abs().max()) > 1e-2
    assert fe_g.graph_stats()["replays"] == N_BLOCKS - 1
    for f_g, f_e in zip(fe_g.gathered_state(), fe_e.gathered_state()):
        assert torch.equal(f_g, f_e)


def test_the_body_and_its_refusals(card, monkeypatch):
    """The card's choice of body on the shards' sizes: #4 wherever it
    takes the shard's rows (any multiple of 16 that holds the 127 rows the
    halos are remade from) and the taps; else the stage body, which
    ``plain_tail`` names; ``tail_kernel="xla"`` is the plain stage body
    and names nothing. The JAX rule on the CPU keeps the stage body."""
    cfg = tch.ChannelizedConfig(**KW, num_channels=C)
    pt, _ = _params(cfg)
    assert tsc._channel_uses_kernel(cfg, 2_560, pt)
    assert tsc._channel_uses_kernel(cfg, 128, pt)
    assert "shorter than the 127" in tsc._channel_refusal(cfg, 112)
    assert "multiple of 16" in tsc._channel_refusal(cfg, 1_000)
    assert not tsc._channel_uses_kernel(cfg, 112, pt)
    short = tch.ChannelizedConfig(**KW, num_channels=C, fir_length=32)
    fe = tsc.ShardedChannelizedFrontEnd(short, _params(short)[0],
                                        _cpu_mesh(2, 2))
    assert fe._stages() is tsc.STAGE_STAGES and not fe.carries_raw()
    assert "64-tap" in fe.plain_tail
    xla = tch.ChannelizedConfig(**KW, num_channels=C, tail_kernel="xla")
    fe = tsc.ShardedChannelizedFrontEnd(xla, pt, _cpu_mesh(2, 2))
    assert fe._stages() is tsc.STAGE_STAGES and fe.plain_tail is None
    monkeypatch.setattr(tch, "on_card", lambda x: False)
    fe = tsc.ShardedChannelizedFrontEnd(cfg, pt, _cpu_mesh(2, 2))
    assert fe._stages() is tsc.STAGE_STAGES and fe.plain_tail is None
    assert not tsc._channel_uses_kernel(cfg, 2_560, pt)
