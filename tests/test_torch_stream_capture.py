"""The port's offline capture runners (``pipeline.stream.run_capture`` and
``run_capture_channelized``) against the JAX package's, and against the
port's own per-block serving step.

Captures come from the port's tone source (AM and FM carriers plus noise,
made from a seed) with a part-block tail that the runners drop. Bounds as
in ``tests/test_torch_direct.py``: audio 1e-5 (FM slots under the
branch-cut flip rule of PERF.md §2), carries 1e-6 (the raw FM demod tail
under its rule), the latest raw DFT planes 1e-5 of the strongest bin; a
non-trivial audio peak is asserted, so zeros never pass against zeros
(the ``design_lowpass_fir`` trap, ROADMAP.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_direct import (
    CARRY_BOUND,
    _assert_state_close,
    assert_audio_close,
    assert_raw_fm_close,
)
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu.pipeline import state as jstate
from webradio_tpu.pipeline import stream as jstream
from webradio_tpu_torch.io.source import ToneSource
from webradio_tpu_torch.pipeline import channelized as tch
from webradio_tpu_torch.pipeline import frontend as tfe
from webradio_tpu_torch.pipeline import state as tstate
from webradio_tpu_torch.pipeline import stream as tstream

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
CHAIN = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR, block_frames=BF)
N_BLOCKS, TAIL = 3, 5_000  # whole blocks, then a part-block the runners drop
IFS = [0, 100_000, -150_000, 230_000]
CARRIERS = ((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
            (-150_000.0, "FM", 700.0), (230_000.0, "AM", 1_300.0))


def _capture(frames=N_BLOCKS * BF + TAIL, seed=3):
    src = ToneSource(carriers=CARRIERS, noise=0.3, seed=seed)
    src.sample_rate, src.block_frames, src.realtime = FS, frames, False
    z = src.read_block()
    return np.stack([z.real, z.imag]).astype(np.float32)


def _assert_latest_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("law", ["AM", "FM", "USB", "LSB"])
def test_run_capture_matches_jax(law):
    cfg_j = jstate.ChainConfig(num_channels=4, **CHAIN)
    cfg_t = tstate.ChainConfig(num_channels=4, **CHAIN)
    args = (IFS, 80_000, 8_000, [law] * 4, [0, 3, -2, 6])
    pj = jstate.make_receiver_params(cfg_j, *args)
    pt = tstate.make_receiver_params(cfg_t, *args, device="cpu")
    iq = _capture()
    sj, aj, lj = jstream.run_capture(cfg_j, pj, jnp.asarray(iq))
    st, at, lt = tstream.run_capture(cfg_t, pt, torch.from_numpy(iq))
    aj = np.asarray(aj)
    assert at.shape == aj.shape == (4, N_BLOCKS * cfg_t.audio_frames)
    assert np.abs(aj).max() > 1e-2  # not zeros against zeros
    fm = np.array([law == "FM"] * 4)
    flip_step = float(pt.rx.audio_coeff.abs().max())
    assert_audio_close(at.numpy(), aj, fm, flip_step)
    assert lt.shape == (N_BLOCKS, 2, cfg_t.fft_size)
    _assert_latest_close(lt, lj)
    _assert_state_close(st, sj, fm)


def test_run_capture_is_the_step_block_by_block_and_carries_state():
    cfg = tstate.ChainConfig(num_channels=4, **CHAIN)
    pt = tstate.make_receiver_params(cfg, IFS, 80_000, 8_000,
                                     ["AM", "FM", "USB", "LSB"], device="cpu")
    iq = torch.from_numpy(_capture())
    st, audio, latest = tstream.run_capture(cfg, pt, iq)
    s = tstate.init_state(cfg, "cpu")
    af = cfg.audio_frames
    for b in range(N_BLOCKS):
        s, a, spectra = tfe.frontend_step(cfg, pt, s, iq[:, b * BF:(b + 1) * BF])
        torch.testing.assert_close(audio[:, b * af:(b + 1) * af], a, rtol=0,
                                   atol=0)
        torch.testing.assert_close(latest[b], spectra[:, -1, :], rtol=0,
                                   atol=0)
    for got, want in zip(st.rx, s.rx):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a capture split in two, the state carried across: the same audio
    s1, a1, _ = tstream.run_capture(cfg, pt, iq[:, :BF])
    _, a2, _ = tstream.run_capture(cfg, pt, iq[:, BF:], state=s1)
    torch.testing.assert_close(torch.cat([a1, a2], 1), audio, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shorter than one block"):
        tstream.run_capture(cfg, pt, iq[:, :BF - 1])


def test_block_size_invariance():
    """The same capture in blocks of 8,192 and of 2,048 frames gives the
    same audio (every carry at once: FIR histories, NCO phase, FM lag),
    within the JAX package's bound for it (tests/test_pipeline.py)."""
    big = tstate.ChainConfig(sample_rate=FS, channel_rate=CR, audio_rate=AR,
                             block_frames=8_192, num_channels=1)
    small = tstate.ChainConfig(sample_rate=FS, channel_rate=CR,
                               audio_rate=AR, block_frames=2_048,
                               num_channels=1)
    params = tstate.make_receiver_params(big, 100_000, 80_000, 8_000, "FM",
                                         device="cpu")
    iq = torch.from_numpy(_capture(4 * 8_192))
    _, audio_big, _ = tstream.run_capture(big, params, iq)
    _, audio_small, _ = tstream.run_capture(small, params, iq)
    assert float(audio_big.abs().max()) > 1e-2
    np.testing.assert_allclose(audio_big.numpy(), audio_small.numpy(),
                               rtol=0, atol=3e-6)


#: the channelized runner on the per-channel fallback (slots whose
#: bandwidths differ: tests/test_stream_scan.py's configuration) and on the
#: time-major chain (every slot at 80 / 8 kHz; below the kernel's "auto"
#: threshold, so the plain tail)
CHANNELIZED = {
    "fallback": (4, [80_000, 80_000, 40_000, 80_000]),
    "time_major": (8, 80_000),
}


@pytest.mark.parametrize("name", sorted(CHANNELIZED))
def test_run_capture_channelized_matches_jax(name):
    c, ifbw = CHANNELIZED[name]
    cfg_j = jch.ChannelizedConfig(num_channels=c, **CHAIN)
    cfg_t = tch.ChannelizedConfig(num_channels=c, **CHAIN)
    modes = ["FM", "AM", "USB", "LSB"] * (c // 4)
    ifs = [100_000, 0, -50_000, 25_000] * (c // 4)
    if c > 4:
        ifs = [f + 200_000 * (i // 4) - 200_000 for i, f in enumerate(ifs)]
    args = (ifs, ifbw, 8_000, modes)
    pj = jch.make_channelized_params(cfg_j, *args)
    pt = tch.make_channelized_params(cfg_t, *args, device="cpu")
    assert (pt.chan_toep is None) == (name == "fallback")
    iq = _capture()
    sj, aj, lj = jstream.run_capture_channelized(cfg_j, pj, jnp.asarray(iq))
    st, at, lt = tstream.run_capture_channelized(cfg_t, pt,
                                                 torch.from_numpy(iq))
    aj = np.asarray(aj)
    assert at.shape == aj.shape == (c, N_BLOCKS * cfg_t.audio_frames)
    assert np.abs(aj).max() > 1e-2
    fm = np.array([m == "FM" for m in modes])
    flip_step = float(pt.audio_coeff.abs().max())
    assert_audio_close(at.numpy(), aj, fm, flip_step)
    _assert_latest_close(lt, lj)
    sj = jax.tree.map(np.asarray, sj)
    np.testing.assert_array_equal(st.nco_phase.numpy(),
                                  sj.nco_phase.astype(np.int64))
    for f in ("pfb_hist", "chan_hist", "demod_prev"):
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(sj, f),
                                   rtol=0, atol=CARRY_BOUND)
    # the audio FIR's tail holds raw demod output
    assert_raw_fm_close(st.audio_hist.numpy(), sj.audio_hist, fm)


def test_run_capture_channelized_is_the_serving_step_transposed():
    """What the smoke checks on the card, here on the plain tail: the
    runner's audio is ``process_host``'s per-block serving audio,
    transposed, exactly; a part-block tail is dropped."""
    c = 8
    cfg = tch.ChannelizedConfig(num_channels=c, **CHAIN)
    pt = tch.make_channelized_params(
        cfg, [-300_000 + 100_000 * i for i in range(c)], 80_000, 8_000,
        ["AM", "FM", "USB", "LSB"] * 2, device="cpu")
    iq = _capture()
    st, audio, latest = tstream.run_capture_channelized(cfg, pt,
                                                        torch.from_numpy(iq))
    pipe = tch.ChannelizedPipeline(cfg, pt)
    af = cfg.audio_frames
    for b in range(N_BLOCKS):
        a, _ = pipe.process_host_sync(iq[:, b * BF:(b + 1) * BF])
        torch.testing.assert_close(audio[:, b * af:(b + 1) * af], a.T,
                                   rtol=0, atol=0)
    for f in tch.ChannelizedState._fields:
        torch.testing.assert_close(getattr(st, f), getattr(pipe.state, f),
                                   rtol=0, atol=0)
    assert latest.shape == (N_BLOCKS, 2, cfg.fft_size)
    with pytest.raises(ValueError, match="shorter than one block"):
        tstream.run_capture_channelized(cfg, pt, torch.zeros(2, BF - 1))
