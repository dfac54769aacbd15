"""The port's catch-up scan (``pipeline.stream.scan_serving`` and
``ChannelizedPipeline.process_host_many``) against the JAX package's
``scan_serving``, on a configuration that takes the per-channel fallback
(slots of differing bandwidths), and against the port's own per-block step.
The time-major kernel branch is covered in ``tests/test_torch_channelized.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from webradio_tpu.pipeline import channelized as jch
from webradio_tpu.pipeline import stream as jstream
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.pipeline import channelized as tch
from webradio_tpu_torch.pipeline import stream as tstream

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

FS, CR, AR, BF, K_BLOCKS = 1_024_000, 128_000, 32_000, 16_384, 3
KW = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR, block_frames=BF,
          num_channels=4)
IFS = [100_000, 0, -50_000, 25_000]
MODES = ["FM", "AM", "USB", "LSB"]
IFBW = [80_000, 80_000, 40_000, 80_000]


def _blocks(k=K_BLOCKS, block_frames=BF):
    src = ToneSource(carriers=((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
                               (-50_000.0, "AM", 700.0)), noise=0.3, seed=4)
    src.sample_rate, src.block_frames, src.realtime = FS, block_frames, False
    out = []
    for _ in range(k):
        z = src.read_block()
        out.append(np.stack([z.real, z.imag]).astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("use_pallas_tail", [False, True])
def test_scan_serving_matches_jax_and_per_block(use_pallas_tail):
    kw = dict(KW, use_pallas_tail=use_pallas_tail)
    if use_pallas_tail:
        # the time-minor kernel's rule: C % 8 == 0 and nd % 1024 == 0
        kw.update(num_channels=8, block_frames=4 * BF)
    n = kw["num_channels"] // 4
    cfg_j, cfg_t = jch.ChannelizedConfig(**kw), tch.ChannelizedConfig(**kw)
    args = (IFS * n, IFBW * n, [8_000] * 4 * n, MODES * n)
    pj = jch.make_channelized_params(cfg_j, *args)
    pt = tch.make_channelized_params(cfg_t, *args, device="cpu")
    assert pt.chan_toep is None  # the per-channel fallback
    blocks = _blocks(2 if use_pallas_tail else K_BLOCKS, kw["block_frames"])
    sj, aj, dbj = jstream.scan_serving(
        cfg_j, pj, jch.init_channelized_state(cfg_j), jnp.asarray(blocks))
    st, at, dbt = tstream.scan_serving(
        cfg_t, pt, tch.init_channelized_state(cfg_t, "cpu"),
        torch.from_numpy(blocks))
    aj, dbj = np.asarray(aj), np.asarray(dbj)
    assert at.shape == aj.shape == (len(blocks), kw["num_channels"],
                                    cfg_t.audio_frames)
    assert np.abs(aj).max() > 1e-2  # not zeros against zeros
    np.testing.assert_allclose(at.numpy(), aj, rtol=0, atol=1e-5)
    live = dbj > dbj.max() - 40.0  # see tests/test_torch_channelized.py
    np.testing.assert_allclose(dbt.numpy()[live], dbj[live], rtol=0,
                               atol=1e-3)
    sj = jax.tree.map(np.asarray, sj)
    np.testing.assert_array_equal(st.nco_phase.numpy(),
                                  sj.nco_phase.astype(np.int64))
    for f in ("pfb_hist", "chan_hist", "demod_prev", "audio_hist"):
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(sj, f),
                                   rtol=0, atol=1e-6)
    # the port's own per-block steps: the same audio and state, exactly
    s1 = tch.init_channelized_state(cfg_t, "cpu")
    for i, iq in enumerate(blocks):
        s1, a1, spectra = tch.channelized_step(cfg_t, pt, s1,
                                               torch.from_numpy(iq))
        torch.testing.assert_close(a1, at[i], rtol=0, atol=0)
    for f in tch.ChannelizedState._fields:
        torch.testing.assert_close(getattr(s1, f), getattr(st, f), rtol=0,
                                   atol=0)


def test_process_host_many_is_scan_serving_with_the_host_contract():
    cfg = tch.ChannelizedConfig(**KW)
    pt = tch.make_channelized_params(cfg, IFS, IFBW, [8_000] * 4, MODES,
                                     device="cpu")
    blocks = _blocks()
    pipe = tch.ChannelizedPipeline(cfg, pt)
    assert pipe.process_host_many(blocks[:2]) is None
    first = pipe.process_host(blocks[2])  # hands back the backlog's result
    last = pipe.flush()
    s, audio, db = tstream.scan_serving(
        cfg, pt, tch.init_channelized_state(cfg, "cpu"),
        torch.from_numpy(blocks[:2]))
    torch.testing.assert_close(first[0], audio, rtol=0, atol=0)
    torch.testing.assert_close(first[1], db, rtol=0, atol=0)
    _, a2, _ = tch.channelized_step_serving(cfg, pt, s,
                                            torch.from_numpy(blocks[2]))
    torch.testing.assert_close(last[0], a2, rtol=0, atol=0)
    assert last[0].shape == (cfg.audio_frames, 4)  # time-major per block
    assert pipe.flush() is None


def test_scan_serving_runs_the_direct_engine():
    """A direct engine's ``ChainConfig`` scans its own step, block by
    block, exactly."""
    from webradio_tpu_torch.pipeline import frontend as tfe
    from webradio_tpu_torch.pipeline import state as tstate

    cfg = tstate.ChainConfig(sample_rate=FS, channel_rate=CR, audio_rate=AR,
                             block_frames=BF, num_channels=4)
    pt = tstate.make_receiver_params(cfg, IFS, IFBW, 8_000, MODES,
                                     device="cpu")
    blocks = _blocks()
    st, audio, db = tstream.scan_serving(cfg, pt, tstate.init_state(cfg, "cpu"),
                                         torch.from_numpy(blocks))
    s1 = tstate.init_state(cfg, "cpu")
    for i, iq in enumerate(blocks):
        s1, a1, spectra = tfe.frontend_step(cfg, pt, s1, torch.from_numpy(iq))
        torch.testing.assert_close(a1, audio[i], rtol=0, atol=0)
    torch.testing.assert_close(db, tfe.spectrum_db(spectra[:, -1, :]),
                               rtol=0, atol=0)
    assert float(audio.abs().max()) > 1e-2
    with pytest.raises(AttributeError):
        tstream.scan_serving(object(), None, None, torch.zeros(1, 2, 8))
