"""Threaded HTTP server with the reference's routing and response model
(the port's own copy of ``webradio_tpu.web.server``).

The reference runs libmicrohttpd in thread-per-connection mode with a
wildcard URL trie, per-request handler instances, autogenerated HTML error
pages, CORS, and callback-driven persistent streams
(src/web/httpserver.cxx:89-343). Python's ``ThreadingHTTPServer`` gives the
same concurrency model; routing and handler dispatch reproduce the same
semantics:

* ``*`` matches one path component, ``**`` the remainder; matches are passed
  to the handler as a wildcard list (httpserver.h:169-174).
* GET/PUT/POST/DELETE dispatch to handler virtuals; anything else (and any
  handler returning 405) answers with an ``Allow:`` header
  (httpserver.cxx:156-168,225-226).
* Status >= 300 gets a minimal HTML error page (doError,
  httpserver.cxx:57-85); redirects add an absolute ``Location`` built from
  the Host header (httpserver.cxx:192-203).
* Persistent handlers stream chunks from ``content_stream()`` until the
  client disconnects, then are closed (httpserver.cxx:177-190).
"""

from __future__ import annotations

import logging
import socketserver
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .routes import UrlTree

log = logging.getLogger(__name__)

SERVER_NAME = "webradio-tpu/1.0"

STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 302: "Found",
    400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 500: "Internal Server Error",
}


def _error_page(status: int) -> bytes:
    """Minimal HTML error page (the shape of doError,
    httpserver.cxx:57-85)."""
    text = STATUS_TEXT.get(status, "Error")
    return (
        f"<html><head><title>{status} {text}</title></head>"
        f"<body><h1>{status} {text}</h1><hr>{SERVER_NAME}</body></html>"
    ).encode()


class _RequestHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Idle-connection timeout, matching the reference's 10 s MHD setting
    # (httpserver.h:43): reaps keep-alive connections with no next request.
    # Python socket timeouts cap a sendall's TOTAL duration (not
    # inactivity), so response WRITES switch to _WRITE_TIMEOUT per bounded
    # chunk (_write_chunked below) — a slow-but-draining client is never
    # cut off mid-body the way a blanket 10 s send deadline would.
    timeout = 10
    #: max seconds with no progress on one bounded write chunk
    _WRITE_TIMEOUT = 30
    _WRITE_CHUNK = 16384

    def _write_chunked(self, data: bytes) -> None:
        """sendall in bounded chunks so the socket timeout approximates an
        inactivity timeout: an active client at >= _WRITE_CHUNK /
        _WRITE_TIMEOUT bytes/s always progresses; a stalled one is reaped
        within _WRITE_TIMEOUT."""
        for off in range(0, len(data), self._WRITE_CHUNK):
            self.wfile.write(data[off : off + self._WRITE_CHUNK])
    server_version = SERVER_NAME

    # ---- verb entry points --------------------------------------------
    def do_GET(self):
        self._dispatch("GET")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def do_HEAD(self):
        self._dispatch("GET", head_only=True)

    def do_OPTIONS(self):
        # CORS preflight — the reference adds Allow-Origin:* to every
        # response (httpserver.cxx:213-222); preflight needs the verbs too.
        self.send_response(204)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods",
                         "GET, PUT, POST, DELETE")
        self.send_header("Access-Control-Allow-Headers", "Content-Type")
        self.send_header("Content-Length", "0")
        self.end_headers()

    # ---- core ----------------------------------------------------------
    def _dispatch(self, verb: str, head_only: bool = False):
        radio_server: "RadioHttpServer" = self.server.radio_server
        parsed = urllib.parse.urlsplit(self.path)
        query = {
            k: v[-1]
            for k, v in urllib.parse.parse_qs(parsed.query).items()
        }

        # the reference requires a Host header (httpserver.cxx:127-135)
        if self.headers.get("Host") is None:
            return self._respond(None, 400, verb)

        match = radio_server.routes.find(parsed.path)
        if match is None:
            return self._respond(None, 404, verb)
        factory, arg, wildcards = match

        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""

        handler = factory(arg=arg, query=query, headers=dict(self.headers))
        try:
            method = {
                "GET": handler.do_get,
                "PUT": handler.do_put,
                "POST": handler.do_post,
                "DELETE": handler.do_delete,
            }[verb]
            status = method(wildcards, body)
        except Exception:
            log.exception("handler error for %s %s", verb, self.path)
            handler.close()
            return self._respond(None, 500, verb)
        self._respond(handler, status, verb, wildcards, head_only)

    def _respond(self, handler, status: int, verb: str,
                 wildcards=None, head_only: bool = False):
        persistent = bool(handler and handler.persistent and status == 200)
        data = handler.data if handler else b""
        content_type = handler.content_type if handler else "text/html"

        if status >= 300 and not data:
            data = _error_page(status)
            content_type = "text/html"

        self.send_response(status)
        self.send_header("Access-Control-Allow-Origin", "*")
        if handler and handler.location:
            # absolute Location from the Host header
            # (httpserver.cxx:192-203)
            host = self.headers.get("Host", "")
            self.send_header("Location", f"http://{host}{handler.location}")
        if status == 405 and handler is not None:
            self.send_header("Allow", handler.allows(wildcards or []))
        self.send_header("Content-Type", content_type)

        if persistent and not head_only:
            # unbounded stream: no Content-Length, connection closes when
            # the stream ends (the MHD callback-response analog,
            # httpserver.cxx:177-190). Per-chunk write timeout: an active
            # client never hits it (audio chunks are small); a client
            # stalled >_WRITE_TIMEOUT is reaped rather than pinning the
            # thread forever.
            self.send_header("Connection", "close")
            self.send_header("Cache-Control", "no-cache, no-store")
            self.end_headers()
            self.connection.settimeout(self._WRITE_TIMEOUT)
            try:
                for chunk in handler.content_stream():
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except (TimeoutError, BrokenPipeError, ConnectionResetError,
                    OSError):
                pass  # client went away — the normal stream ending
            finally:
                handler.close()
                self.close_connection = True
            return

        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        if data and not head_only and verb != "HEAD" and status != 204:
            self.connection.settimeout(self._WRITE_TIMEOUT)
            try:
                self._write_chunked(data)
            except (TimeoutError, BrokenPipeError, ConnectionResetError,
                    OSError):
                self.close_connection = True  # cannot resync mid-body
            finally:
                self.connection.settimeout(self.timeout)
        if handler:
            handler.close()

    def log_message(self, fmt, *args):
        log.debug("%s - %s", self.address_string(), fmt % args)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 100
    #: concurrent-connection cap, matching the reference's
    #: MHD_OPTION_CONNECTION_LIMIT of 100 (httpserver.h:42) — above it new
    #: connections are refused instead of spawning unbounded threads
    max_connections = 100

    def __init__(self, *args, max_connections: int | None = None, **kwargs):
        if max_connections is not None:
            self.max_connections = max_connections
        self._conn_slots = threading.BoundedSemaphore(self.max_connections)
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        if not self._conn_slots.acquire(blocking=False):
            log.warning("connection limit (%d) reached; refusing %s",
                        self.max_connections, client_address)
            self.shutdown_request(request)
            return
        try:
            super().process_request(request, client_address)
        except BaseException:
            self._conn_slots.release()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._conn_slots.release()


class RadioHttpServer:
    """Routes + server lifecycle (the reference's HttpServer,
    httpserver.cxx:245-276)."""

    def __init__(self, port: int = 8080, host: str = "0.0.0.0",
                 max_connections: int | None = None):
        self.routes = UrlTree()
        self.port = port
        self.host = host
        self.max_connections = max_connections
        self._httpd: _Server | None = None
        self._thread: threading.Thread | None = None

    def register_handler(self, pattern: str, factory, arg=None) -> None:
        self.routes.register(pattern, factory, arg)

    def start(self) -> bool:
        if self._httpd is not None:
            return True
        try:
            self._httpd = _Server((self.host, self.port), _RequestHandler,
                                  max_connections=self.max_connections)
        except OSError as e:
            log.error("HTTP bind failed on %s:%d: %s", self.host, self.port, e)
            return False
        self._httpd.radio_server = self
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http"
        )
        self._thread.start()
        log.info("HTTP server listening on %s:%d", self.host, self.port)
        return True

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
