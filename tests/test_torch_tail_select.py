"""Which receiver tail the port's channelized step runs, on the card and on
the CPU, and the carried history across a switch between the per-channel
kernel and the time-major tail.

On a CUDA device every tail that a ported kernel computes runs that kernel
(``pipeline.channelized.tail_branch``); on the CPU the JAX package's rule
picks the branch. The card's choice is run here through the kernels' plain
versions: ``channelized.on_card``, the rule's device test, is replaced so
that CPU tensors take the card's branch, and the wrappers, given CPU
tensors, compute their plain versions. The JAX side is the JAX package's
step with its plain tails (``tail_kernel="xla"``, ``use_pallas_tail``
False), whose arithmetic the kernels' plain versions match.

The per-channel kernel carries the RAW selected-bin history and every
other tail the mixed one; ``switch_hist_domain`` converts between them at
the table law, which the JAX package's fallback under ``use_pallas_tail``
True and False shows on the same blocks.

Bounds: audio 1e-5 under the FM flip rule (PERF.md, section 2), histories
1e-6 across the conversion, 1e-5 where two tails' carries meet.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from webradio_tpu.pipeline import channelized as jch
from webradio_tpu_torch import convert
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.ops import firdesign
from webradio_tpu_torch.parallel import sharded_channelized as tsc
from webradio_tpu_torch.pipeline import channelized as tch

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

BLOCK = 51_200  # nd = 5,120: whole time chunks of the per-channel kernel
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-450_000.0, "FM", 700.0), (700_000.0, "AM", 1_300.0))
BOUND = 1e-5
#: a flip of the FM law moves an audio output by at most the largest tap
FLIP_STEP = float(np.abs(firdesign.design_lowpass_fir(8_000, 240_000)).max())


def _blocks(n, seed=0):
    src = ToneSource(carriers=CARRIERS, noise=0.5, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, BLOCK, False
    return [np.stack([z.real, z.imag]).astype(np.float32)
            for z in (src.read_block() for _ in range(n))]


def _controls(c, mixed):
    """IFs on and between the carriers, the four laws in turn; ``mixed``
    gives slot 0 a 12.5 kHz channel filter, so the slots no longer share
    the FIR kernels (the server's one odd receiver)."""
    ifs = [int(f) for f in np.linspace(-900_000, 900_000, c)]
    ifs[:2] = [0, 100_000]
    modes = [("AM", "FM", "USB", "LSB")[i % 4] for i in range(c)]
    ifbw = [12_500 if mixed else 80_000] + [80_000] * (c - 1)
    return ifs, ifbw, 8_000, modes


def _params(cfg_t, c, mixed, jax_cfg=None):
    ctl = _controls(c, mixed)
    pt = tch.make_channelized_params(cfg_t, *ctl, device="cpu")
    return pt, (None if jax_cfg is None
                else jch.make_channelized_params(jax_cfg, *ctl))


@pytest.fixture
def card(monkeypatch):
    """The card's selection on CPU tensors, and a tally of the kernel
    wrappers the step calls (each computes its plain version here)."""
    monkeypatch.setattr(tch, "on_card", lambda x: True)
    calls = {}
    for name in ("fused_tail_audio_tm", "fused_tail_tm",
                 "fused_receiver_tail"):
        fn = getattr(tch, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tch, name, counted)
    return calls


def _assert_audio(got, ref, modes):
    """``[t, C]`` audio within BOUND, FM slots under the flip rule."""
    err = np.abs(np.asarray(got) - np.asarray(ref))
    fm = np.array([m == "FM" for m in modes])
    assert err[:, ~fm].max() <= BOUND
    assert (err[:, fm] > BOUND).sum() <= 1e-4 * err[:, fm].size
    assert err[:, fm].max() <= 2 * FLIP_STEP + BOUND
    assert np.abs(np.asarray(ref)).max() > 1e-2  # not zeros against zeros


# (channels, block, bandwidths mixed, tail_kernel, use_pallas_tail,
#  fir_length, audio_rate): the card's (time-major, kernel), and the
# refusal it names
RULES = [
    (16, BLOCK, False, "auto", False, 64, 48_000, (True, True), None),
    (100, BLOCK, False, "auto", False, 64, 48_000, (True, True), None),
    (100, BLOCK, False, "pallas", False, 64, 48_000, (True, True), None),
    (256, BLOCK, False, "pallas", False, 64, 48_000, (True, True), None),
    (512, BLOCK, False, "auto", False, 64, 48_000, (True, True), None),
    (512, 25_600, False, "auto", False, 64, 48_000, (True, True), None),
    (512, BLOCK, False, "xla", False, 64, 48_000, (True, False), None),
    (16, 256_000, False, "auto", False, 64, 9_600, (True, True), None),
    (64, BLOCK, False, "pallas_pfb", False, 64, 48_000, (True, True),
     None),
    (96, BLOCK, False, "pallas_pfb", False, 64, 48_000, (True, False),
     "multiple of 64"),
    (16, BLOCK, False, "auto", False, 32, 48_000, (True, False), "64-tap"),
    (16, BLOCK, True, "auto", False, 64, 48_000, (False, True), None),
    (100, BLOCK, True, "auto", False, 64, 48_000, (False, True), None),
    (16, BLOCK, True, "xla", False, 64, 48_000, (False, False), None),
    (16, BLOCK, True, "auto", True, 64, 48_000, (False, True), None),
    (16, BLOCK, False, "auto", True, 64, 48_000, (False, True), None),
    (16, BLOCK, True, "auto", False, 32, 48_000, (False, False), "64-tap"),
]


@pytest.mark.parametrize("c,block,mixed,tail_kernel,pallas_tail,taps,"
                         "audio_rate,on_card_branch,refusal", RULES)
def test_selection_rule_on_each_device(monkeypatch, c, block, mixed,
                                       tail_kernel, pallas_tail, taps,
                                       audio_rate, on_card_branch, refusal):
    kw = dict(block_frames=block, num_channels=c, tail_kernel=tail_kernel,
              use_pallas_tail=pallas_tail, fir_length=taps,
              audio_rate=audio_rate)
    cfg_j, cfg_t = jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)
    pt, pj = _params(cfg_t, c, mixed, cfg_j)
    nd = cfg_t.chan_frames
    # the CPU: the JAX package's rule exactly
    jax_tm = (not pallas_tail and pj.chan_toep is not None
              and pj.audio_toep is not None
              and nd % pj.chan_toep.shape[1] == 0
              and (nd // cfg_j.audio_decim) % pj.audio_toep.shape[1] == 0)
    jax_kernel = (jch._use_pallas_tm(cfg_j, nd, pj) if jax_tm
                  else pallas_tail)
    assert tch.tail_branch(cfg_t, pt) == (jax_tm, jax_kernel)
    assert tch.carries_raw(cfg_t, pt) == (not jax_tm and jax_kernel)
    assert tch.tail_refusal(cfg_t, pt) is None
    # the card: a kernel wherever one computes the tail
    monkeypatch.setattr(tch, "on_card", lambda x: True)
    assert tch.tail_branch(cfg_t, pt) == on_card_branch
    time_major, kernel = on_card_branch
    assert tch.carries_raw(cfg_t, pt) == (not time_major and kernel)
    why = tch.tail_refusal(cfg_t, pt)
    assert (why is None) == (refusal is None)
    if refusal:
        assert refusal in why


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("c", [16, 100])
def test_card_choice_matches_jax_plain_step(card, c, mixed):
    """Two carried blocks through the branch the card takes (kernel #1, or
    kernel #4 on mixed bandwidths), here through the kernels' plain
    versions, against the JAX step's plain tails."""
    kw = dict(block_frames=BLOCK, num_channels=c)
    cfg_j = jch.ChannelizedConfig(**kw, tail_kernel="xla")
    cfg_t = tch.ChannelizedConfig(**kw)
    pt, pj = _params(cfg_t, c, mixed, cfg_j)
    modes = _controls(c, mixed)[3]
    sj = jch.init_channelized_state(cfg_j)
    st = tch.init_channelized_state(cfg_t, "cpu")
    for iq in _blocks(2, seed=c):
        sj, aj, _ = jch.channelized_step_serving(cfg_j, pj, sj,
                                                 jnp.asarray(iq))
        st, at, _ = tch.channelized_step_serving(cfg_t, pt, st,
                                                 torch.from_numpy(iq))
        _assert_audio(at.numpy(), aj, modes)
    assert card == ({"fused_receiver_tail": 2} if mixed
                    else {"fused_tail_audio_tm": 2})
    sj = jax.tree.map(np.asarray, sj)
    hist = st.chan_hist
    if mixed:  # the kernel's raw history, in the JAX fallback's domain
        hist = tch.switch_hist_domain(hist, st.nco_phase, pt.residual_step,
                                      to_raw=False)
    np.testing.assert_allclose(hist.numpy(), sj.chan_hist, rtol=0,
                               atol=BOUND)
    np.testing.assert_allclose(st.demod_prev.numpy(), sj.demod_prev,
                               rtol=0, atol=BOUND)


def test_history_conversion_matches_jax_fallback_domains(monkeypatch):
    """The JAX fallback with ``use_pallas_tail`` True (raw history, its
    Pallas kernel in interpret mode) and False (mixed) over the same
    blocks: each history converts into the other within 1e-6, through the
    port's own conversion and through ``convert.state_from_numpy``."""
    c = 16
    ctl = _controls(c, mixed=True)
    states = {}
    for pallas_tail in (True, False):
        cfg = jch.ChannelizedConfig(block_frames=BLOCK, num_channels=c,
                                    use_pallas_tail=pallas_tail)
        p = jch.make_channelized_params(cfg, *ctl)
        s = jch.init_channelized_state(cfg)
        for iq in _blocks(2, seed=5):
            s, _, _ = jch.channelized_step_serving(cfg, p, s,
                                                   jnp.asarray(iq))
        states[pallas_tail] = jax.tree.map(np.asarray, s)
    raw, mixed = states[True], states[False]
    np.testing.assert_array_equal(raw.nco_phase, mixed.nco_phase)
    cfg_t = tch.ChannelizedConfig(block_frames=BLOCK, num_channels=c)
    pt = tch.make_channelized_params(cfg_t, *ctl, device="cpu")
    phase = torch.from_numpy(raw.nco_phase.astype(np.int64))
    hist = lambda s: torch.from_numpy(np.array(s.chan_hist))
    to_mixed = tch.switch_hist_domain(hist(raw), phase, pt.residual_step,
                                      to_raw=False)
    to_raw = tch.switch_hist_domain(hist(mixed), phase, pt.residual_step,
                                    to_raw=True)
    np.testing.assert_allclose(to_mixed.numpy(), mixed.chan_hist, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(to_raw.numpy(), raw.chan_hist, rtol=0,
                               atol=1e-6)
    assert np.abs(raw.chan_hist - mixed.chan_hist).max() > 1e-2  # domains
    # a JAX state goes into the domain the port's step carries: on the
    # CPU the JAX rule's (mixed, as it is), on the card the kernel's (raw)
    kept = convert.state_from_numpy(mixed, "cpu", cfg_t, pt)
    np.testing.assert_array_equal(kept.chan_hist.numpy(), mixed.chan_hist)
    monkeypatch.setattr(tch, "on_card", lambda x: True)
    carried = convert.state_from_numpy(mixed, "cpu", cfg_t, pt)
    np.testing.assert_allclose(carried.chan_hist.numpy(), raw.chan_hist,
                               rtol=0, atol=1e-6)


def test_live_switch_uniform_mixed_uniform_matches_jax_fallback(card):
    """One live pipeline with the card's choice goes uniform (kernel #1)
    -> mixed (kernel #4) -> uniform, two blocks each, its history converted
    at each switch; the JAX step runs the same blocks through its plain
    tails (the time-major chain, then the plain fallback) with the same
    parameter switches and carries its state straight across."""
    c = 16
    cfg_j = jch.ChannelizedConfig(block_frames=BLOCK, num_channels=c)
    cfg_t = tch.ChannelizedConfig(block_frames=BLOCK, num_channels=c)
    uni_t, uni_j = _params(cfg_t, c, False, cfg_j)
    mix_t, mix_j = _params(cfg_t, c, True, cfg_j)
    modes = _controls(c, False)[3]
    pipe = tch.ChannelizedPipeline(cfg_t, uni_t)
    sj = jch.init_channelized_state(cfg_j)
    blocks = _blocks(6, seed=9)
    raw_seen = []
    for k, iq in enumerate(blocks):
        if k in (2, 4):
            new_t, new_j = (mix_t, mix_j) if k == 2 else (uni_t, uni_j)
            pipe.update_params(new_t)
        pj = (uni_j, mix_j)[k in (2, 3)]
        sj, aj, _ = jch.channelized_step_serving(cfg_j, pj, sj,
                                                 jnp.asarray(iq))
        at, _ = pipe.process_host_sync(iq)
        _assert_audio(at.numpy(), aj, modes)
        raw_seen.append(pipe.carries_raw())
        # the carried history is the JAX fallback's, in its domain
        hist = pipe.state.chan_hist
        if pipe.carries_raw():
            hist = tch.switch_hist_domain(hist, pipe.state.nco_phase,
                                          pipe.params.residual_step,
                                          to_raw=False)
        np.testing.assert_allclose(hist.numpy(), np.asarray(sj.chan_hist),
                                   rtol=0, atol=BOUND)
    assert raw_seen == [False, False, True, True, False, False]
    assert card == {"fused_tail_audio_tm": 4, "fused_receiver_tail": 2}
    assert pipe.plain_tail is None


def test_shard_rule_is_the_step_rule_on_local_sizes(monkeypatch):
    """A (4, 1) mesh's shard of a stock block holds 2,560 rows, off the
    JAX kernel's 1,024-row tile: plain on the CPU, as the JAX package's
    per-shard rule says, and kernel #1 on the card; a (1, 4) mesh's shard
    of 64 channels holds 16, below the JAX threshold."""
    cfg = tch.ChannelizedConfig(num_channels=64)
    pt, _ = _params(cfg, 64, False)
    for nd_local, c_local in ((2_560, 64), (10_240, 16)):
        assert not tsc._tm_uses_kernel(cfg, nd_local, c_local, pt)
        xla = tch.ChannelizedConfig(num_channels=64, tail_kernel="xla")
        with monkeypatch.context() as m:
            m.setattr(tch, "on_card", lambda x: True)
            assert tsc._tm_uses_kernel(cfg, nd_local, c_local, pt)
            assert not tsc._tm_uses_kernel(xla, nd_local, c_local, pt)


def test_a_plain_tail_on_the_card_is_said_once(monkeypatch, caplog):
    """Where the card's kernel refuses the configuration (a 32-tap FIR) the
    pipeline says so when it is built, in the log and in ``plain_tail``
    (``/status``'s ``"graph"`` block reads it); so does a sharded front end
    whose slots differ in bandwidth, where kernel #4 refuses its shards,
    and with 64 taps it runs #4 and says nothing. On the CPU neither says
    anything."""
    from webradio_tpu_torch.parallel import mesh as tmesh

    short = tch.ChannelizedConfig(block_frames=BLOCK, num_channels=16,
                                  fir_length=32)
    pt, _ = _params(short, 16, False)
    assert tch.ChannelizedPipeline(short, pt).plain_tail is None
    cfg = tch.ChannelizedConfig(block_frames=BLOCK, num_channels=16)
    mixed, _ = _params(cfg, 16, True)
    mixed_short, _ = _params(short, 16, True)
    mesh = tmesh.make_mesh(2, 2, devices=["cpu"] * 4)
    assert tsc.ShardedChannelizedFrontEnd(cfg, mixed, mesh).plain_tail is None
    monkeypatch.setattr(tch, "on_card", lambda x: True)
    with caplog.at_level("WARNING"):
        pipe = tch.ChannelizedPipeline(short, pt)
        fe = tsc.ShardedChannelizedFrontEnd(cfg, mixed, mesh)
        fe_short = tsc.ShardedChannelizedFrontEnd(short, mixed_short, mesh)
    assert "64-tap" in pipe.plain_tail
    assert fe.plain_tail is None
    assert "per-channel tail kernel on each shard" in fe_short.plain_tail
    assert "64-tap" in fe_short.plain_tail
    said = [r.getMessage() for r in caplog.records]
    assert sum("channelized pipeline" in m and "64-tap" in m
               for m in said) == 1
    assert sum("sharded channelized front end" in m and "64-tap" in m
               for m in said) == 1
    # a parameter set of the same branch is not said again; one that moves
    # the step to the per-channel kernel, which refuses it too, is
    with caplog.at_level("WARNING"):
        pipe.update_params(_params(short, 16, False)[0])
        pipe.update_params(_params(short, 16, True)[0])
    said = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("channelized pipeline")]
    assert sum("time-major tail kernel" in m for m in said) == 1
    assert sum("per-channel tail kernel" in m for m in said) == 1
    assert pipe.plain_tail.startswith("per-channel tail kernel")
