"""Audio encoders for HTTP streaming (the port's own copy of
``webradio_tpu.web.encoders``).

The reference encodes each receiver's 48 kHz mono audio with LAME
(joint-stereo VBR quality 2, float input scaled to +/-32768 —
src/web/mp3encoder.cxx:35-46,64-72). Here :class:`Mp3Encoder` binds
``libmp3lame`` directly with ctypes; :class:`WavEncoder` provides a
dependency-free streaming fallback (an "infinite" RIFF header followed by
raw PCM — browsers accept it for live streams).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct

import numpy as np


class AudioEncoder:
    """Interface per src/web/audioencoder.h:45-48."""

    content_type = "application/octet-stream"
    extension = ""

    def header(self) -> bytes:
        return b""

    def encode(self, samples: np.ndarray) -> bytes:
        raise NotImplementedError

    def close(self) -> bytes:
        """Finish the stream; returns any final buffered bytes."""
        return b""


def _load_lame():
    for name in ("mp3lame", "mp3lame.0"):
        path = ctypes.util.find_library(name)
        if path:
            return ctypes.CDLL(path)
    for path in ("libmp3lame.so.0", "libmp3lame.so"):
        try:
            return ctypes.CDLL(path)
        except OSError:
            continue
    return None


_LAME = _load_lame()


def lame_available() -> bool:
    return _LAME is not None


class Mp3Encoder(AudioEncoder):
    """LAME MP3: joint stereo, VBR default quality 2 (mp3encoder.cxx:35-46).

    Mono input is duplicated onto both channels, as in mp3encoder.cxx:64-72.
    The reference scales to +/-32768 because it calls
    ``lame_encode_buffer_float`` (whose convention is +/-32768 full scale);
    here we call ``lame_encode_buffer_ieee_float``, whose input convention is
    +/-1.0 full scale, so the samples go in unscaled.
    """

    content_type = "audio/mpeg"
    extension = "mp3"

    def __init__(self, sample_rate: int, channels: int = 1, vbr_quality: int = 2):
        if _LAME is None:
            raise RuntimeError("libmp3lame not available")
        lame = _LAME
        lame.lame_init.restype = ctypes.c_void_p
        self._gf = ctypes.c_void_p(lame.lame_init())
        lame.lame_set_in_samplerate(self._gf, sample_rate)
        lame.lame_set_num_channels(self._gf, 2)
        lame.lame_set_mode(self._gf, 1)  # JOINT_STEREO (mp3encoder.cxx:40)
        lame.lame_set_VBR(self._gf, 4)  # vbr_default   (mp3encoder.cxx:41)
        lame.lame_set_VBR_q(self._gf, vbr_quality)  # (mp3encoder.cxx:42)
        if lame.lame_init_params(self._gf) < 0:
            raise RuntimeError("lame_init_params failed")
        self._channels = channels
        self._closed = False

    def encode(self, samples: np.ndarray) -> bytes:
        if self._closed:
            return b""
        # lame_encode_buffer_ieee_float takes +/-1.0 full scale — no pre-scale.
        mono = np.ascontiguousarray(np.asarray(samples, dtype=np.float32).reshape(-1))
        n = len(mono)
        # worst-case output size per LAME docs (mp3encoder.cxx:57)
        out_size = int(1.25 * n) + 7200
        out = ctypes.create_string_buffer(out_size)
        written = _LAME.lame_encode_buffer_ieee_float(
            self._gf,
            mono.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mono.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            out,
            out_size,
        )
        if written < 0:
            return b""
        return out.raw[:written]

    def close(self) -> bytes:
        """Flush LAME's final partial frame, then free the encoder.

        The reference never flushes (its streams are infinite); for
        finite recordings the last frame would otherwise be lost.
        """
        if self._closed:
            return b""
        self._closed = True
        out = ctypes.create_string_buffer(7200)
        written = _LAME.lame_encode_flush(self._gf, out, len(out))
        _LAME.lame_close(self._gf)
        return out.raw[:written] if written > 0 else b""


class WavEncoder(AudioEncoder):
    """Streaming WAV: RIFF header with a maximal length field, then raw
    16-bit PCM. No native dependency; useful for tests and as a fallback."""

    content_type = "audio/wav"
    extension = "wav"

    def __init__(self, sample_rate: int, channels: int = 1):
        self.sample_rate = sample_rate
        self.channels = channels

    def header(self) -> bytes:
        sr, ch = self.sample_rate, self.channels
        byte_rate = sr * ch * 2
        return b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE" + (
            b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sr, byte_rate, ch * 2, 16)
        ) + b"data" + struct.pack("<I", 0xFFFFFFFF)

    def encode(self, samples: np.ndarray) -> bytes:
        x = np.clip(np.asarray(samples, np.float32).reshape(-1), -1.0, 1.0)
        return (x * 32767.0).astype("<i2").tobytes()


def make_encoder(ext: str, sample_rate: int, channels: int = 1) -> AudioEncoder:
    """Encoder factory by file extension (audiostream.cxx:146-158 supports
    only '.mp3'; we add '.wav')."""
    if ext == "mp3":
        return Mp3Encoder(sample_rate, channels)
    if ext == "wav":
        return WavEncoder(sample_rate, channels)
    raise KeyError(ext)
