"""The port's single-card entry (``webradio_tpu_torch.entry``) against
``__graft_entry__.entry``: the flagship direct-engine step at C=16, stock
rates, on a seeded tone-and-noise block (not zeros), with the JAX
parameters and state carried over by ``webradio_tpu_torch.convert``.

Bounds as in ``tests/test_torch_direct.py``: audio 1e-5 (FM slots under
the branch-cut flip rule of PERF.md §2), the latest raw DFT planes 1e-5 of
the strongest bin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__
from tests.test_torch_direct import assert_audio_close
from webradio_tpu_torch import convert
from webradio_tpu_torch.entry import dryrun_multichip, entry
from webradio_tpu_torch.io.source import ToneSource

# The first multi-threaded call into torch's CPU vector math in a process
# can return reduced-accuracy values (~1.5e-4) on some threads' chunks; a
# single-element call first initializes it.
torch.sin(torch.zeros(1))


def test_entry_matches_the_jax_entry():
    jfn, (pj, sj, iq_j) = __graft_entry__.entry()
    fn, (pt, st, iq_t) = entry(device="cpu")
    # the example arguments: the JAX entry's, on the named device
    assert iq_t.shape == iq_j.shape == (2, 102_400)
    assert iq_t.device.type == "cpu" and not iq_t.any()
    host = jax.tree.map(np.asarray, pj)
    for name, t in zip(pt.rx._fields, pt.rx):
        a = getattr(host.rx, name)
        np.testing.assert_array_equal(
            t.numpy(), a.astype(np.int64) if t.dtype == torch.int64 else a)

    src = ToneSource(carriers=((0.0, "AM", 1_000.0), (100_000.0, "FM", 440.0),
                               (-300_000.0, "AM", 700.0),
                               (500_000.0, "FM", 1_300.0)),
                     noise=0.3, seed=5)
    src.sample_rate, src.block_frames, src.realtime = 2_400_000, 102_400, False
    z = src.read_block()
    iq = np.stack([z.real, z.imag]).astype(np.float32)

    pc = convert.frontend_params_from_numpy(host, device="cpu")
    sc = convert.frontend_state_from_numpy(jax.tree.map(np.asarray, sj),
                                           device="cpu")
    audio, latest = fn(pc, sc, torch.from_numpy(iq))
    aj, lj = jfn(pj, sj, jnp.asarray(iq))
    aj, lj = np.asarray(aj), np.asarray(lj)
    assert audio.shape == aj.shape == (16, 2_048)
    assert latest.shape == lj.shape == (2, 512)
    assert np.abs(aj).max() > 1e-2  # not zeros against zeros
    fm = np.array([m == 1 for m in host.rx.mode])
    assert fm.sum() == 4
    assert_audio_close(audio.numpy(), aj, fm,
                       float(pc.rx.audio_coeff.abs().max()))
    np.testing.assert_allclose(latest.numpy(), lj, rtol=0,
                               atol=1e-5 * np.abs(lj).max())
    # the port's own example arguments give the same step
    a0, _ = fn(pt, st, torch.from_numpy(iq))
    torch.testing.assert_close(a0, audio, rtol=0, atol=0)


def test_dryrun_multichip_on_the_cpu(capsys):
    """The twin of ``__graft_entry__.dryrun_multichip(8)`` on eight CPU
    positions: a (time=2, chan=4) mesh; the direct and channelized engines
    sharded against single, and the fused tail (its plain version here)
    sharded against single and against the plain tail, under 3e-6; the
    u8exact law against float32 under 1e-5 relative."""
    errors = dryrun_multichip(8, devices=["cpu"] * 8)
    names = ("direct", "channelized", "fused_vs_plain",
             "sharded_fused_vs_single")
    assert set(errors) == {*names, *(n + "_fm" for n in names),
                           "u8exact_rel"}
    assert max(errors[n] for n in names) < 3e-6
    assert errors["u8exact_rel"] < 1e-5
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip ok") == 3
    assert "mesh(time=2, chan=4)" in out
