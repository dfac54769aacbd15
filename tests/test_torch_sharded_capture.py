"""The port's ``run_capture_sharded`` against the JAX package's (the cases
of ``tests/test_stream_scan.py``'s sharded capture test), and against the
port's single-device runner ``run_capture_channelized`` on the same
capture.

The capture comes from the port's tone source (AM and FM carriers plus
noise, made from a seed), three whole blocks and a part-block that the
runners drop. Bounds: sharded against single-device audio 3e-6 with the
FM flip rule of PERF.md §2, carries 1e-6 (the raw FM demod tail under its
rule), the latest raw DFT planes 1e-5 of the strongest bin; the port
against the JAX package at the port's step bound, 1e-5 (FM flip rule).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_direct import (
    assert_audio_close,
    assert_raw_fm_close,
)
from tests.test_torch_stream_capture import _assert_latest_close, _capture
from webradio_tpu import parallel as jpar
from webradio_tpu.parallel import sharded_channelized as jsc
from webradio_tpu.pipeline import channelized as jch
from webradio_tpu_torch.parallel import mesh as tmesh
from webradio_tpu_torch.parallel import sharded_channelized as tsc
from webradio_tpu_torch.pipeline import channelized as tch
from webradio_tpu_torch.pipeline import stream as tstream

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
KW = dict(sample_rate=FS, channel_rate=CR, audio_rate=AR, block_frames=BF,
          num_channels=4)
N_BLOCKS = 3
IFS = [100_000, 0, -150_000, 25_000]
MODES = ["FM", "AM", "USB", "LSB"]
ARGS = (IFS, [80_000, 80_000, 40_000, 80_000], [8_000] * 4, MODES)


@pytest.mark.parametrize("tshape", [(2, 2), (4, 1), (2, 4)])
def test_sharded_capture_matches_jax_and_single_device(tshape):
    t, c = tshape
    cfg_j, cfg = jch.ChannelizedConfig(**KW), tch.ChannelizedConfig(**KW)
    pj = jch.make_channelized_params(cfg_j, *ARGS)
    pt = tch.make_channelized_params(cfg, *ARGS, device="cpu")
    iq = _capture()
    mesh = tmesh.make_mesh(t, c, devices=["cpu"] * (t * c))
    state, audio, latest = tsc.run_capture_sharded(cfg, pt, mesh,
                                                   torch.from_numpy(iq))
    s1, a1, l1 = tstream.run_capture_channelized(cfg, pt,
                                                 torch.from_numpy(iq))
    assert audio.shape == a1.shape == (4, N_BLOCKS * cfg.audio_frames)
    assert latest.shape == (N_BLOCKS, 2, cfg.fft_size)
    assert np.abs(a1.numpy()).max() > 1e-2  # not zeros against zeros
    fm = np.array([m == "FM" for m in MODES])
    flip = float(pt.audio_coeff.abs().max())
    assert_audio_close(audio.numpy(), a1.numpy(), fm, flip, 3e-6)
    _assert_latest_close(latest, l1)
    np.testing.assert_array_equal(state.nco_phase.numpy(),
                                  s1.nco_phase.numpy())
    for name in ("pfb_hist", "chan_hist", "demod_prev"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   getattr(s1, name).numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert_raw_fm_close(state.audio_hist.numpy(), s1.audio_hist.numpy(), fm)

    _, aj, lj = jsc.run_capture_sharded(cfg_j, pj, jpar.make_mesh(t, c),
                                        jnp.asarray(iq))
    assert_audio_close(audio.numpy(), np.asarray(aj), fm, flip)
    _assert_latest_close(latest, lj)


def test_sharded_capture_carries_a_given_state_and_needs_a_block():
    cfg = tch.ChannelizedConfig(**KW)
    pt = tch.make_channelized_params(cfg, *ARGS, device="cpu")
    iq = torch.from_numpy(_capture())
    mesh = tmesh.make_mesh(2, 2, devices=["cpu"] * 4)
    head = iq[:, :BF]
    s0, _, _ = tsc.run_capture_sharded(cfg, pt, mesh, head)
    _, audio, _ = tsc.run_capture_sharded(cfg, pt, mesh, iq[:, BF:], s0)
    _, whole, _ = tsc.run_capture_sharded(cfg, pt, mesh, iq)
    torch.testing.assert_close(audio, whole[:, cfg.audio_frames:], rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="shorter than one block"):
        tsc.run_capture_sharded(cfg, pt, mesh, iq[:, :BF - 1])
