"""Audio encoder round trips on the port's own copy of the encoders
(``webradio_tpu_torch/web/encoders.py``): the counterparts of
``tests/test_encoders.py``, each also held to the JAX package's encoder on
the same input (the same bytes out).

The encoder binds ``lame_encode_buffer_ieee_float``, whose convention is
+/-1.0 full scale (the reference pre-scales by 32768 for
``lame_encode_buffer_float``, src/web/mp3encoder.cxx:64-72). A sine
round-tripped through the encoder and LAME's own hip decoder must come
back at its input amplitude, unclipped: a 32768 pre-scale turns a 0.25
sine into a full-scale square wave.
"""

import ctypes

import numpy as np
import pytest

from webradio_tpu.web import encoders as jax_encoders
from webradio_tpu_torch.web import encoders

pytestmark = pytest.mark.skipif(
    not encoders.lame_available(), reason="libmp3lame not available"
)


def _hip_decode(mp3_bytes: bytes) -> np.ndarray:
    """Decode an MP3 byte stream to float mono (+/-1.0) with LAME's hip
    API, fed in sub-frame chunks (``hip_decode1`` emits at most one
    1152-sample frame per call)."""
    lame = encoders._LAME
    lame.hip_decode_init.restype = ctypes.c_void_p
    lame.hip_decode1.restype = ctypes.c_int
    lame.hip_decode1.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_short), ctypes.POINTER(ctypes.c_short),
    ]
    hip = ctypes.c_void_p(lame.hip_decode_init())
    try:
        out = []
        cap = 1 << 16
        pcm_l = (ctypes.c_short * cap)()
        pcm_r = (ctypes.c_short * cap)()
        for i in range(0, len(mp3_bytes), 32):
            chunk = mp3_bytes[i:i + 32]
            n = lame.hip_decode1(hip, chunk, len(chunk), pcm_l, pcm_r)
            if n > 0:
                out.append(np.ctypeslib.as_array(pcm_l)[:n].copy())
        if not out:
            return np.zeros(0, np.float32)
        return np.concatenate(out).astype(np.float32) / 32768.0
    finally:
        lame.hip_decode_exit(hip)


def _flush(enc) -> bytes:
    """What LAME still buffers for ``enc`` (either package's encoder: both
    bind the same library)."""
    out = ctypes.create_string_buffer(65536)
    n = encoders._LAME.lame_encode_flush(enc._gf, out, 65536)
    return out.raw[:n] if n > 0 else b""


def _mp3(module, x, sr, chunk=None):
    """``x`` through ``module``'s MP3 encoder, flushed."""
    enc = module.Mp3Encoder(sr)
    step = chunk or len(x)
    data = b"".join(enc.encode(x[i:i + step])
                    for i in range(0, len(x), step))
    data += _flush(enc)
    enc.close()
    return data


def test_mp3_roundtrip_amplitude():
    """A 0.25-amplitude sine comes back at ~0.25, not hard-clipped."""
    sr, amp = 48_000, 0.25
    t = np.arange(sr, dtype=np.float64)  # 1 second
    x = (amp * np.sin(2 * np.pi * 1000.0 * t / sr)).astype(np.float32)
    data = _mp3(encoders, x, sr, chunk=4096)
    assert data == _mp3(jax_encoders, x, sr, chunk=4096)
    assert len(data) > 1000
    y = _hip_decode(data)
    assert len(y) > sr // 2
    core = y[2000:-2000]  # past the codec's warm-up and padding
    peak = np.abs(core).max()
    assert amp * 0.85 < peak < amp * 1.15, f"decoded peak {peak} vs {amp}"
    clipped = np.mean(np.abs(core) > 0.9)
    assert clipped == 0.0, f"{clipped:.1%} of samples near full scale"
    # a sine, not a square: crest factor ~ sqrt(2)
    crest = peak / np.sqrt(np.mean(core ** 2))
    assert 1.25 < crest < 1.65, f"crest factor {crest} (square wave ~1.0)"


def test_mp3_roundtrip_full_scale_not_distorted():
    """A 0.9-amplitude sine survives without flattening into a square."""
    sr, amp = 48_000, 0.9
    t = np.arange(sr // 2, dtype=np.float64)
    x = (amp * np.sin(2 * np.pi * 440.0 * t / sr)).astype(np.float32)
    data = _mp3(encoders, x, sr)
    assert data == _mp3(jax_encoders, x, sr)
    core = _hip_decode(data)[2000:-2000]
    rms = np.sqrt(np.mean(core ** 2))
    expect_rms = amp / np.sqrt(2)
    assert abs(rms - expect_rms) < 0.12 * expect_rms


def test_wav_roundtrip_amplitude():
    sr = 8000
    x = (0.5 * np.sin(2 * np.pi * 100 * np.arange(sr) / sr)).astype(
        np.float32)
    raw = encoders.WavEncoder(sr).encode(x)
    assert raw == jax_encoders.WavEncoder(sr).encode(x)
    pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0
    assert abs(np.abs(pcm).max() - 0.5) < 1e-3


def test_mp3_close_flushes_final_frame():
    """``close()`` drains LAME's final partial frame (the reference never
    flushes: fine for endless live streams, wrong for finite recordings),
    and a second close returns nothing."""
    t = np.arange(480, dtype=np.float32) / 48_000
    sine = (0.25 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    streams = []
    for module in (encoders, jax_encoders):
        enc = module.Mp3Encoder(48_000)
        body = enc.encode(sine)  # far less than one frame: stays buffered
        tail = enc.close()
        assert tail, "flush produced no bytes for a buffered partial frame"
        assert enc.close() == b""  # idempotent
        streams.append(body + tail)
    assert streams[0] == streams[1]
    assert _hip_decode(streams[0]).size > 0, "flushed stream did not decode"
