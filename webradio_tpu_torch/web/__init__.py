"""Web server and REST/streaming API of the port (the port's own copy of
``webradio_tpu.web``).

Behaviour-compatible with the reference surface (SURVEY §2.5): the same
routes, JSON schemas, wildcard semantics and streaming model, on Python's
threading HTTP server (the reference uses libmicrohttpd in
thread-per-connection mode, httpserver.cxx:254-276).
"""

from .audiostream import AudioStreamManager
from .routes import UrlTree
from .server import RadioHttpServer

__all__ = ["UrlTree", "RadioHttpServer", "AudioStreamManager"]
