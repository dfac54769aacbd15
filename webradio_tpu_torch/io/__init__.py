"""Host-side I/O of the port: sample sources, tuner drivers, the ingest
ring and the native ingest runtime.

Numpy, the standard library and ctypes only. A capture thread fills a
bounded ring of fixed-size blocks (drop-with-log on overrun, the reference's
backpressure policy, rtlsdrtuner.cxx:99-102) and the pump thread pops blocks
and feeds the step.
"""

from .ring import BlockRing, CaptureThread
from .source import FileSource, RandSource, SampleSource, ToneSource
from .tuner import (
    TUNER_DRIVERS,
    FileTuner,
    RandTuner,
    RtlTcpTuner,
    SoundcardTuner,
    ToneTuner,
    Tuner,
)

__all__ = [
    "SampleSource",
    "RandSource",
    "FileSource",
    "ToneSource",
    "Tuner",
    "FileTuner",
    "RandTuner",
    "ToneTuner",
    "RtlTcpTuner",
    "SoundcardTuner",
    "TUNER_DRIVERS",
    "BlockRing",
    "CaptureThread",
]
