"""The port's offline CLI (``python -m webradio_tpu_torch.demod_cli``): the
twin of ``tests/test_demod_cli.py``, with each WAV compared to the JAX
package's CLI on the same capture.

The WAVs hold PCM16, so audio within 1e-5 of the JAX package's differs by
at most one step of 1/32767 where a sample sits on a rounding boundary; on
FM rows a branch-cut flip of the FM law (PERF.md §2) may move at most 1e-4
of the samples by at most two audio taps.
"""

import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_web import REPO, _env
from webradio_tpu.demod_cli import main as jmain
from webradio_tpu_torch.demod_cli import main as tmain

FS = 256_000


def _pcm(path):
    raw = path.read_bytes()
    return raw[:44], np.frombuffer(raw[44:], "<i2").astype(np.int32)


def _dominant_hz(pcm, rate=8_000):
    x = pcm[2000:].astype(np.float32) / 32767
    x = x - x.mean()
    f = np.fft.rfftfreq(len(x), 1 / rate)
    mag = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    lo = np.searchsorted(f, 100)
    return f[lo + mag[lo:].argmax()]


def _assert_wav_close(got, ref, fm, flip_step):
    (hg, g), (hr, r) = _pcm(got), _pcm(ref)
    assert hg == hr and g.shape == r.shape
    assert np.abs(r).max() > 300  # not silence against silence
    d = np.abs(g - r)
    if not fm:
        assert d.max() <= 1
        return
    assert (d > 1).sum() <= max(1, 1e-4 * d.size)
    assert d.max() <= (2 * flip_step + 1e-5) * 32767 + 1


def _run_both(tmp_path, capsys, name, args):
    """Both CLIs on the same arguments; their stderr lines, with the output
    paths made alike."""
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    out_j.mkdir()
    out_t.mkdir()
    capsys.readouterr()
    assert jmain(args + ["-o", str(out_j / name)]) == 0
    err_j = capsys.readouterr().err.replace(str(out_j), "OUT")
    assert tmain(args + ["-o", str(out_t / name), "--platform", "cpu"]) == 0
    err_t = capsys.readouterr().err.replace(str(out_t), "OUT")
    assert err_t == err_j
    return out_j, out_t


def test_cli_two_receivers(tmp_path, capsys):
    t = np.arange(FS // 2) / FS
    fm = np.exp(1j * (2 * np.pi * 50_000 * t
                      - 5_000 / 440 * np.cos(2 * np.pi * 440 * t)))
    am = (1 + 0.5 * np.sin(2 * np.pi * 1_000 * t)) * np.exp(
        -1j * 2 * np.pi * 60_000 * t)
    z = ((fm + am) / 2).astype(np.complex64)
    cap = tmp_path / "cap.npy"
    np.save(cap, z)
    out_j, out_t = _run_both(tmp_path, capsys, "rx", [
        str(cap), "--rate", str(FS),
        "--if-freq", "50000", "--if-freq", "-60000",
        "--mode", "FM", "--mode", "AM",
        "--channel-rate", "32000", "--audio-rate", "8000",
        "--block", "10240",
    ])
    from webradio_tpu_torch.ops.firdesign import design_lowpass_fir

    flip_step = float(np.abs(design_lowpass_fir(8_000, 32_000)).max())
    for i, (expect, is_fm) in enumerate(((440, True), (1000, False))):
        got = out_t / f"rx_{i:02d}.wav"
        assert abs(_dominant_hz(_pcm(got)[1]) - expect) < 20
        _assert_wav_close(got, out_j / f"rx_{i:02d}.wav", is_fm, flip_step)


def test_cli_single_receiver_channelized(tmp_path, capsys):
    t = np.arange(FS // 2) / FS
    z = ((1 + 0.5 * np.sin(2 * np.pi * 800 * t))
         * np.exp(1j * 2 * np.pi * 32_000 * t)).astype(np.complex64)
    cap = tmp_path / "cap.npy"
    np.save(cap, z)
    out_j, out_t = _run_both(tmp_path, capsys, "single.wav", [
        str(cap), "--rate", str(FS), "--if-freq", "32000", "--mode", "AM",
        "--channel-rate", "32000", "--audio-rate", "8000",
        "--block", "10240", "--engine", "channelized",
    ])
    got = out_t / "single.wav"
    assert abs(_dominant_hz(_pcm(got)[1]) - 800) < 20
    _assert_wav_close(got, out_j / "single.wav", False, 0.0)


def test_cli_refuses_bad_arguments(tmp_path):
    cap = tmp_path / "cap.cf32"
    np.zeros(2 * 1_000, np.float32).tofile(cap)
    with pytest.raises(SystemExit):  # shorter than one block
        tmain([str(cap), "--rate", str(FS), "--block", "10240",
               "--platform", "cpu", "-o", str(tmp_path / "x")])
    with pytest.raises(SystemExit):  # two modes for one receiver
        tmain([str(cap), "--rate", str(FS), "--mode", "AM", "--mode", "FM",
               "--platform", "cpu"])


def test_python_m_without_a_card_exits_with_the_error(tmp_path):
    cap = tmp_path / "cap.cf32"
    np.zeros(2 * 20_480, np.float32).tofile(cap)
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "webradio_tpu_torch.demod_cli", str(cap),
         "--rate", str(FS), "-o", str(tmp_path / "a")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "needs a CUDA device" in out.stderr
    assert not (tmp_path / "a.wav").exists()
