"""Host-side I/O of the port: sample sources and the ingest ring.

Numpy and the standard library only. A capture thread fills a bounded ring
of fixed-size blocks (drop-with-log on overrun, the reference's
backpressure policy, rtlsdrtuner.cxx:99-102) and the pipeline thread pops
blocks and feeds the step. The tuners come with the server.
"""

from .ring import BlockRing, CaptureThread
from .source import FileSource, RandSource, SampleSource, ToneSource

__all__ = [
    "SampleSource",
    "RandSource",
    "FileSource",
    "ToneSource",
    "BlockRing",
    "CaptureThread",
]
