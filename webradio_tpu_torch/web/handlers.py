"""REST / streaming request handlers (the reference surface, SURVEY §2.5;
the port of ``webradio_tpu.web.handlers``).

Each handler is instantiated per request by the route's factory and
dispatched to ``do_get/do_put/do_post/do_delete`` with the matched wildcard
components and the request body — the contract of the reference's
``HttpRequestHandler`` (src/web/httpserver.h:114-174). Handlers fill
``data``/``content_type`` for one-shot responses or set ``persistent`` and
provide ``content_stream()`` for unbounded streams (the audio path).

JSON schemas match the reference field-for-field:

* ``/config``                     confighandler.cxx:41-55
* ``/tuners[/<id>]``              tunerhandler.cxx:42-84
* ``/tuners/<id>/control``        tunercontrolhandler.cxx:83-110
* ``/tuners/<id>/waterfall``      waterfallhandler.cxx:44-76
* ``/receivers[/<id>]``           receiverhandler.cxx:108-140
* ``/audio/<id>.<ext>``           audiostream.cxx:140-183
* ``/static/**``                  filehandler.cxx:37-88
* redirects with $n substitution  redirecthandler.cxx:40-57

One deliberate extension: receiver POST (create) and DELETE, which the
reference API declares but answers with 405 (receiverhandler.cxx:96-106).
"""

from __future__ import annotations

import json
import math
import pathlib
import tempfile
import threading
import time

from .. import trace as flight
from ..pipeline.graph import LAUNCH_LOCK
from ..radio import Radio, Receiver

HTTP_OK = 200
HTTP_CREATED = 201
HTTP_NO_CONTENT = 204
HTTP_BAD_REQUEST = 400
HTTP_NOT_FOUND = 404
HTTP_METHOD_NOT_ALLOWED = 405
HTTP_CONFLICT = 409
HTTP_INTERNAL = 500


class HttpRequestHandler:
    """Base request handler; unimplemented methods return 405 with an
    ``Allow`` header from :meth:`allows` (httpserver.cxx:156-168,225-226)."""

    def __init__(self, arg=None, query: dict | None = None,
                 headers: dict | None = None):
        self.arg = arg
        self.query = query or {}
        self.headers = headers or {}
        self.data: bytes = b""
        self.content_type = "text/html"
        self.location: str | None = None
        self.persistent = False

    # ---- verb dispatch -------------------------------------------------
    def do_get(self, wildcards, body) -> int:
        return HTTP_METHOD_NOT_ALLOWED

    def do_put(self, wildcards, body) -> int:
        return HTTP_METHOD_NOT_ALLOWED

    def do_post(self, wildcards, body) -> int:
        return HTTP_METHOD_NOT_ALLOWED

    def do_delete(self, wildcards, body) -> int:
        return HTTP_METHOD_NOT_ALLOWED

    def allows(self, wildcards) -> str:
        return "GET"

    # ---- streaming -----------------------------------------------------
    def content_stream(self):
        """Yield byte chunks until the stream ends (persistent only)."""
        return iter(())

    def close(self) -> None:
        """Called when the client disconnects (httpserver.h:120-123)."""

    # ---- helpers -------------------------------------------------------
    def send_json(self, obj) -> int:
        self.content_type = "application/json"
        self.data = json.dumps(obj, indent=3).encode()
        return HTTP_OK


class StatusHandler(HttpRequestHandler):
    """GET /status — structured runtime metrics.

    A superset of the reference's stderr profile log (Radio::profile,
    radio.cxx:51-54; ns-per-frame definition dspblock.cxx:93-104): per
    front-end block counters and real-time factor, ingest-ring drops, and
    per-mountpoint stream fan-out. No reference analog (SURVEY §5 lists
    observability as a gap to close)."""

    def do_get(self, wildcards, body) -> int:
        import time as _time

        from .audiostream import AudioStreamManager

        fes = {}
        for uuid, fe in Radio.front_ends.items():
            nspf = fe.profile_ns_per_frame()
            budget = 1e9 / fe.cfg.sample_rate
            fes[uuid] = {
                "running": fe.running,
                "blocks": fe.block_count,
                "dropped_blocks": fe.dropped_blocks,
                # the step's device time a frame over the last blocks
                # (trace.STATUS_BLOCKS), from the flight recorder; on the
                # CPU its host time. throughput_factor is the served
                # signal time over wall time since start
                "ns_per_frame": round(nspf, 1),
                "realtime_factor": round(budget / nspf, 2) if nspf else None,
                "throughput_factor": (
                    round(tput, 3)
                    if (tput := fe.throughput_factor()) is not None
                    else None),
                "last_step_ms": round(fe.trace.latest("step_ns") / 1e6, 2),
                "step_samples": fe.step_samples,
                # the host time of the last block's process_host
                "last_dispatch_ms": round(
                    (fe.trace.latest("dispatch1")
                     - fe.trace.latest("dispatch0")) / 1e6, 2),
                # fan-out worker overflow: device audio arrays dropped
                # before their consumer rows could be fetched (slow
                # host link; the compute loop is unaffected by design)
                "fanout_dropped": fe.fanout_dropped,
                # driver-level USB overrun accounting (RtlSdrTuner async
                # capture; the reference's "Lost N bytes" health metric,
                # rtlsdrtuner.cxx:99-102) — absent for synthetic tuners
                **({"capture_lost_bytes": fe.tuner.lost_bytes}
                   if hasattr(fe.tuner, "lost_bytes") else {}),
                "sample_rate": fe.cfg.sample_rate,
                "channel_capacity": fe.cfg.num_channels,
                "engine": ("channelized" if fe._use_channelized()
                           else "direct"),
                # arithmetic quality tiers
                "fir_precision": fe.fir_precision,
                "pfb_precision": fe.pfb_precision,
                # CUDA graphs (pipeline.graph): capture events, replays,
                # eager warm blocks, replayed kernel nodes; and on the card
                # why a tail runs plain where no option asks for it (None:
                # the kernels serve, or the CPU)
                "graph": dict(fe.graph_stats(), plain_tail=fe.plain_tail()),
                # the flight recorder over the last 1,024 blocks: each
                # span's p50 and p95 ms, each counter's mean
                # (webradio_tpu_torch.trace)
                "trace": fe.trace.summary(),
                "receivers": sorted(fe.receivers),
            }
        return self.send_json(
            {
                "server_time": _time.time(),
                "front_ends": fes,
                "receivers": {
                    uuid: {
                        "front_end": rx.front_end.uuid if rx.front_end else None,
                        "demodulator": rx.demodulator,
                        "if_frequency": rx.if_frequency,
                        # bounded local-sink queue overflow (SinkWriter
                        # drop-oldest), present only for bound receivers
                        **({"sink_dropped": rx.audio_sink.dropped}
                           if getattr(rx.audio_sink, "dropped", None)
                           is not None else {}),
                    }
                    for uuid, rx in Radio.receivers.items()
                },
                "streams": AudioStreamManager.stats(),
            }
        )


def _blocks_served() -> int:
    return sum(fe.block_count for fe in Radio.front_ends.values())


def _graph_kernels() -> dict:
    """Each front end's replayed kernel nodes so far (``graph_stats()``'s
    ``kernels``): what a trace of the card must hold of them."""
    return {fe: fe.graph_stats()["kernels"]
            for fe in list(Radio.front_ends.values())}


def expected_kernel_events(before: dict, after: dict) -> int:
    """The kernel events a trace must hold for the graph replays between
    two :func:`_graph_kernels` readings: each front end's replayed kernels
    less one block's (a replay under way as the trace started may fall
    before it)."""
    total = 0
    for fe, k1 in after.items():
        per_block = fe.graph_kernels_per_block()
        total += max(0, k1 - before.get(fe, k1) - per_block)
    return total


#: the longest the trace thread waits for the pump after a stretch of the
#: trace that held it (about 23 blocks at stock rates)
PUMP_CATCH_UP_S = 1.0


def _pump_mark() -> tuple[float, list]:
    """Now, and each running front end with the blocks it has served and
    the blocks its ring holds: the start of a stretch that may hold the
    pump."""
    return time.monotonic(), [(fe, fe.block_count, fe.ring.backlog)
                              for fe in Radio.front_ends.values()
                              if fe.running]


def wait_for_pump(mark, timeout: float = PUMP_CATCH_UP_S) -> bool:
    """Wait until every front end of ``mark`` (:func:`_pump_mark`) has
    served what its ring held then and every block its source delivered
    since (one per ``block_seconds``), and its ring is empty: the pump has
    caught up with the stretch. False where ``timeout`` s passed first (a
    front end that stopped no longer counts)."""
    t0, front_ends = mark
    now = time.monotonic()
    deadline = now + timeout
    targets = [(fe, served + held + int((now - t0) / fe.cfg.block_seconds))
               for fe, served, held in front_ends]
    while not all(not fe.running or (fe.block_count >= n
                                     and not fe.ring.backlog)
                  for fe, n in targets):
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.002)
    return True


def trace_event_counts(path) -> tuple[int, int]:
    """``(kernel events, copy and memset events)`` of a Chrome trace."""
    with open(path) as f:
        cats = [e.get("cat", "") for e in json.load(f).get("traceEvents", [])]
    return (sum(c == "kernel" for c in cats),
            sum(c in ("gpu_memcpy", "gpu_memset") for c in cats))


def check_trace_has_kernels(trace: pathlib.Path, served: int,
                            expected: int = 0) -> int:
    """The kernel events of a card's trace ``trace``. Where it holds none
    although the pump served ``served`` blocks while it ran, or fewer than
    the ``expected`` kernels the pump's graph replays launched in it
    (:func:`expected_kernel_events`), the trace is a profiler fault, not a
    reading: it is renamed ``trace_without_kernels.json`` (none) or
    ``trace_missing_kernels.json`` (some) and RuntimeError says so."""
    kernels, copies = trace_event_counts(trace)
    if served and not kernels:
        kept = trace.replace(trace.with_name("trace_without_kernels.json"))
        raise RuntimeError(
            f"the profiler recorded {copies} copy events but no kernel while "
            f"the pump served {served} blocks (a profiler fault; the trace "
            f"is kept as {kept})")
    if kernels < expected:
        kept = trace.replace(trace.with_name("trace_missing_kernels.json"))
        raise RuntimeError(
            f"the profiler recorded {kernels} kernel events of the "
            f"{expected} the pump's graph replays launched while it ran (a "
            f"profiler fault; the trace is kept as {kept})")
    return kernels


def add_host_tracks(path: pathlib.Path, t0_ns: int, t1_ns: int) -> int:
    """Write the flight recorders' spans of ``[t0_ns, t1_ns]``
    (``perf_counter_ns``) into the Chrome trace at ``path`` as a "webradio
    host" process (``trace.chrome_events``), in the trace's own time base:
    the profiler's wall-clock nanoseconds less the trace's
    ``baseTimeNanoseconds``. Returns the events added."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    offset = time.time_ns() - time.perf_counter_ns()
    events = flight.chrome_events(
        t0_ns, t1_ns, lambda ns: (ns + offset - base) / 1e3)
    if len(events) > 1:
        doc.setdefault("traceEvents", []).extend(events)
        with open(path, "w") as f:
            json.dump(doc, f)
    return len(events) - 1


def warm_profiler() -> float:
    """Start and stop one ``torch.profiler`` session of the card's
    activity and return the ms it took. The first start in a process sets
    up the profiler's CUDA side (CUPTI): 6.4-9.6 s on the H100, holding the
    interpreter lock in stretches long enough to stall a pump past its ring
    (``tools/torch_profiler_probe.py``); every later start takes ~2 ms. The
    app runs this once before its pump starts, so a user's ``/profile``
    costs the pump nothing of that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    prof = profile(activities=[ProfilerActivity.CUDA])
    with LAUNCH_LOCK:
        prof.start()
    torch.cuda.synchronize()
    with LAUNCH_LOCK:
        prof.stop()
    return 1e3 * (time.perf_counter() - t0)


class _TraceSession:
    """One ``torch.profiler`` trace, started and stopped on a thread of its
    own (the profiler must be stopped on the thread that started it; HTTP
    requests come on any thread). Where there is a card it records the
    device's activity, every stream and thread; host operations would be
    the profiler thread's own only, so they are recorded only where there
    is no card (the trace then holds that thread's few events).

    The export adds the host's spans of the session from the front ends'
    flight recorders (:func:`add_host_tracks`): each block's pump, fan-out
    and capture stamps beside the card's kernels.

    The profiler's stop (on the card it holds up the pump's CUDA calls
    while the capture threads run on, and at times the interpreter too),
    its export and the trace's check (the interpreter) each stall or slow
    the pump, for about 100 ms each under three tuners, while a front
    end's ring holds 4 blocks (170.7 ms at stock rates) and a native
    session's 16 (``io.native.SESSION_RING_BLOCKS``). So they are never
    run back to back: after the stop and after the export the trace thread
    waits until the pump has served what the rings took in meanwhile
    (:func:`wait_for_pump`, at most :data:`PUMP_CATCH_UP_S` each).

    ``timings_ms`` holds what ``start()``, ``stop()``, the export, the
    waits for the pump (``wait_after_stop``, ``wait_after_export``) and,
    on the card, the trace's check took. On the card the kernel nodes the
    pump's graphs replayed are read after the start and before the stop,
    the card is synchronized before the stop (every counted replay has
    then run), and :meth:`stop` raises for a trace that holds no kernel
    event, or fewer than those replays launched
    (:func:`check_trace_has_kernels`).
    """

    def __init__(self, trace_dir: str):
        self.trace_dir = trace_dir
        self.error: BaseException | None = None
        self.timings_ms: dict[str, float] = {}
        self.kernel_events: int | None = None
        self.expected_kernel_events: int | None = None
        self._blocks0 = _blocks_served()
        self._started = threading.Event()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="profile-trace")
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            raise self.error

    def _run(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        card = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA if card else ProfilerActivity.CPU]
        try:
            prof = profile(activities=acts)
            with LAUNCH_LOCK:  # no graph launch meanwhile (graph.py)
                self._timed("start", prof.start)
            t0_ns = time.perf_counter_ns()
            kernels0 = _graph_kernels()
        except BaseException as e:
            self.error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            mark = _pump_mark()
            expected = expected_kernel_events(kernels0, _graph_kernels())
            if card:
                self._timed("sync", torch.cuda.synchronize)
            t1_ns = time.perf_counter_ns()
            with LAUNCH_LOCK:
                self._timed("stop", prof.stop)
            served = _blocks_served() - self._blocks0
            self._timed("wait_after_stop", lambda: wait_for_pump(mark))
            path = pathlib.Path(self.trace_dir)
            path.mkdir(parents=True, exist_ok=True)
            trace = path / "trace.json"
            mark = _pump_mark()

            def export():
                prof.export_chrome_trace(str(trace))
                add_host_tracks(trace, t0_ns, t1_ns)

            self._timed("export", export)
            self._timed("wait_after_export", lambda: wait_for_pump(mark))
            if card:
                self.expected_kernel_events = expected
                self.kernel_events = self._timed(
                    "check",
                    lambda: check_trace_has_kernels(trace, served, expected))
        except BaseException as e:
            self.error = e
        self._done.set()

    def _timed(self, name: str, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.timings_ms[name] = 1e3 * (time.perf_counter() - t0)

    def stop(self) -> None:
        self._stop.set()
        self._done.wait()
        if self.error is not None:
            raise self.error


class ProfileHandler(HttpRequestHandler):
    """GET/POST /profile — capture a ``torch.profiler`` trace of the live
    pipeline (the JAX package's ``jax.profiler`` endpoint, same JSON).

    POST ``{"action": "start", "dir": "..."}`` begins a trace (default dir
    ``webradio_trace`` in the temporary directory), ``{"action": "stop"}``
    ends it, writes ``<dir>/trace.json`` (Chrome trace format: Perfetto,
    chrome://tracing) and returns the directory, what each stretch of the
    trace took (``timings_ms``: the profiler's start, the card's
    synchronize, the stop and export and the waits for the pump between
    them), the trace's kernel events and the kernel events the pump's
    graph replays launched in it (``expected_kernel_events``). A trace of
    the card without a kernel event while blocks were served, or with
    fewer than the replays launched, answers 500 with the reason (see
    ``_TraceSession``). GET reports the state.
    """

    # class-level: one trace at a time; the lock serializes the
    # check-then-act sequences (thread-per-request server)
    _active_dir: str | None = None
    _session: _TraceSession | None = None
    _lock = threading.Lock()

    def allows(self, wildcards) -> str:
        return "GET, POST"

    def do_get(self, wildcards, body) -> int:
        return self.send_json(
            {"tracing": ProfileHandler._active_dir is not None,
             "trace_dir": ProfileHandler._active_dir}
        )

    def do_post(self, wildcards, body) -> int:
        try:
            root = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return HTTP_BAD_REQUEST
        action = root.get("action", "")
        with ProfileHandler._lock:
            if action == "start":
                if ProfileHandler._active_dir is not None:
                    return HTTP_BAD_REQUEST  # already tracing
                trace_dir = str(root.get("dir", pathlib.Path(
                    tempfile.gettempdir()) / "webradio_trace"))
                try:
                    ProfileHandler._session = _TraceSession(trace_dir)
                except Exception as exc:
                    self.send_json({"error": str(exc)})
                    return HTTP_INTERNAL
                ProfileHandler._active_dir = trace_dir
                return self.send_json(
                    {"tracing": True, "trace_dir": trace_dir})
            if action == "stop":
                if ProfileHandler._active_dir is None:
                    return HTTP_BAD_REQUEST
                session = ProfileHandler._session
                trace_dir = ProfileHandler._active_dir
                ProfileHandler._active_dir = ProfileHandler._session = None
                try:
                    session.stop()
                except Exception as exc:
                    self.send_json({
                        "error": str(exc), "timings_ms": session.timings_ms,
                        "expected_kernel_events":
                            session.expected_kernel_events})
                    return HTTP_INTERNAL
                return self.send_json(
                    {"tracing": False, "trace_dir": trace_dir,
                     "timings_ms": session.timings_ms,
                     "kernel_events": session.kernel_events,
                     "expected_kernel_events":
                         session.expected_kernel_events})
        return HTTP_BAD_REQUEST


class ConfigHandler(HttpRequestHandler):
    """GET /config — static stub, field-compatible with
    confighandler.cxx:41-55."""

    def do_get(self, wildcards, body) -> int:
        return self.send_json(
            {
                "htmlpath": "html",
                "version": "1.0",
                "blah": {"test": "foo", "test2": "bar"},
            }
        )


def _tuner_info(fe) -> dict:
    """tunerhandler.cxx:66-84, field for field (incl. the string-typed
    ``iq`` flag)."""
    t = fe.tuner
    return {
        "uri": f"/tuners/{fe.uuid}",
        "name": t.name,
        "driver": t.type,
        "port": "",
        "serial_nr": t.serial,
        "manufacturer": t.manufacturer,
        "product": t.product,
        # the device's ACTUAL rate (readback parity, rtlsdrtuner.cxx:226-228)
        "sample_rate": t.effective_sample_rate,
        "iq": "true",
        "control": f"/tuners/{fe.uuid}/control",
        "peaks": f"/tuners/{fe.uuid}/peaks",
        "receivers": f"/tuners/{fe.uuid}/receivers",
        "waterfall": f"/tuners/{fe.uuid}/waterfall",
    }


class TunerHandler(HttpRequestHandler):
    """GET /tuners (list) and /tuners/<uuid> (tunerhandler.cxx:42-64)."""

    def do_get(self, wildcards, body) -> int:
        if not wildcards:
            return self.send_json([_tuner_info(fe)
                                   for fe in Radio.front_ends.values()])
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        return self.send_json(_tuner_info(fe))


class TunerControlHandler(HttpRequestHandler):
    """GET/PUT /tuners/<uuid>/control (tunercontrolhandler.cxx:83-110).

    PUT writes become parameters of the next block instead of racing the
    pipeline thread (the FIXME at tunercontrolhandler.cxx:99, resolved)."""

    def allows(self, wildcards) -> str:
        return "GET, PUT"

    def do_get(self, wildcards, body) -> int:
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        t = fe.tuner
        return self.send_json(
            {
                "centre_frequency": t.centre_frequency,
                "agc": t.agc,
                "rf_gain": t.gain_db,
                "if_gain": 0,
                "offset": t.offset_ppm,
            }
        )

    def do_put(self, wildcards, body) -> int:
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        try:
            root = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return HTTP_BAD_REQUEST
        t = fe.tuner
        if "centre_frequency" in root:
            t.set_centre_frequency(int(root["centre_frequency"]))
        if "agc" in root:
            t.set_agc(bool(root["agc"]))
        if "rf_gain" in root:
            t.set_gain_db(int(root["rf_gain"]))
        if "offset" in root:
            t.set_offset_ppm(int(root["offset"]))
        self.content_type = "application/json"
        return HTTP_NO_CONTENT


def _receiver_info(rx) -> dict:
    """receiverhandler.cxx:108-123 — including its quirk of labelling the
    tuner URI ``/receivers/<frontend-uuid>``."""
    fe_uuid = rx.front_end.uuid if rx.front_end else ""
    return {
        "uri": f"/receivers/{rx.uuid}",
        "tuner": f"/receivers/{fe_uuid}",
        "if_frequency": rx.if_frequency,
        "if_bandwidth": rx.if_bandwidth,
        "af_bandwidth": rx.af_bandwidth,
        "af_gain": rx.af_gain,
        "squelch_threshold": rx.squelch_threshold,
        "demodulator": rx.demodulator,
    }


class ReceiverHandler(HttpRequestHandler):
    """GET/POST /receivers, GET/PUT/DELETE /receivers/<uuid>."""

    def allows(self, wildcards) -> str:
        # receiverhandler.cxx:42-48, plus the implemented POST/DELETE
        return "GET, POST" if not wildcards else "GET, PUT, DELETE"

    def do_get(self, wildcards, body) -> int:
        if not wildcards:
            rxs = Radio.receivers.values()
            tuner_id = self.query.get("tuner_id")
            if tuner_id is not None:
                rxs = [r for r in rxs
                       if r.front_end and r.front_end.uuid == tuner_id]
            return self.send_json([_receiver_info(r) for r in rxs])
        rx = Radio.receivers.get(wildcards[0])
        if rx is None:
            return HTTP_NOT_FOUND
        return self.send_json(_receiver_info(rx))

    def do_put(self, wildcards, body) -> int:
        if not wildcards:
            return HTTP_METHOD_NOT_ALLOWED
        rx = Radio.receivers.get(wildcards[0])
        if rx is None:
            return HTTP_NOT_FOUND
        try:
            root = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return HTTP_BAD_REQUEST
        ok = rx.update(
            if_frequency=root.get("if_frequency"),
            if_bandwidth=root.get("if_bandwidth"),
            af_bandwidth=root.get("af_bandwidth"),
            demodulator=root.get("demodulator"),
            af_gain=root.get("af_gain"),
            # presence matters: absent = unchanged, JSON null = gate off
            **({"squelch_threshold": root["squelch_threshold"]}
               if "squelch_threshold" in root else {}),
        )
        self.content_type = "application/json"
        return HTTP_NO_CONTENT if ok else HTTP_BAD_REQUEST

    def do_post(self, wildcards, body) -> int:
        """Create a receiver (the reference's declared-but-405 lifecycle,
        receiverhandler.cxx:96-100, completed)."""
        if wildcards:
            return HTTP_METHOD_NOT_ALLOWED
        try:
            root = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return HTTP_BAD_REQUEST
        tuner = root.get("tuner", "")
        fe_uuid = str(tuner).rstrip("/").rpartition("/")[2]
        fe = Radio.front_ends.get(fe_uuid)
        if fe is None and len(Radio.front_ends) == 1:
            fe = next(iter(Radio.front_ends.values()))
        if fe is None:
            return HTTP_BAD_REQUEST
        rx = Receiver()
        ok = rx.update(
            if_frequency=root.get("if_frequency"),
            if_bandwidth=root.get("if_bandwidth"),
            af_bandwidth=root.get("af_bandwidth"),
            demodulator=root.get("demodulator"),
            af_gain=root.get("af_gain"),
            **({"squelch_threshold": root["squelch_threshold"]}
               if "squelch_threshold" in root else {}),
        )
        if not ok:
            rx.close()
            return HTTP_BAD_REQUEST
        from ..radio import CapacityError

        try:
            rx.set_front_end(fe)
        except CapacityError as e:
            # multihost serving cannot grow capacity live (the growth
            # compile's warm would run collectives off the lockstep SPMD
            # schedule); reject cleanly instead of stalling the slice
            rx.close()
            self.send_json({
                "error": str(e),
                "capacity": fe.cfg.num_channels,
                "attached": len(fe.receivers),
            })
            return HTTP_CONFLICT
        self.location = f"/receivers/{rx.uuid}"
        self.send_json(_receiver_info(rx))
        return HTTP_CREATED

    def do_delete(self, wildcards, body) -> int:
        if not wildcards:
            return HTTP_METHOD_NOT_ALLOWED
        rx = Radio.receivers.get(wildcards[0])
        if rx is None:
            return HTTP_NOT_FOUND
        from .audiostream import AudioStreamManager

        AudioStreamManager.drop_mountpoint(rx.uuid)
        rx.close()
        return HTTP_NO_CONTENT


class WaterfallHandler(HttpRequestHandler):
    """GET /tuners/<uuid>/waterfall (waterfallhandler.cxx:44-76)."""

    def do_get(self, wildcards, body) -> int:
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        spectrum = fe.get_spectrum_db()
        # JSON has no NaN/Inf: the reference maps them to -10000
        # (waterfallhandler.cxx:64-68).
        data = [float(v) if math.isfinite(v) else -10000.0
                for v in spectrum.tolist()]
        return self.send_json(
            {
                "centre_frequency": fe.tuner.centre_frequency,
                # actual device rate, so the UI's frequency labels stay
                # correct when the dongle quantizes the requested rate
                "sample_rate": fe.tuner.effective_sample_rate,
                "data": data,
            }
        )


class PeaksHandler(HttpRequestHandler):
    """GET /tuners/<uuid>/peaks — strongest spectral peaks.

    The reference *advertises* this URL in its tuner JSON
    (tunerhandler.cxx:80) but ships no PeaksHandler (the route is
    commented out, main.cxx:100). Implemented here: local maxima of the
    latest spectrum, strongest first, as absolute frequencies.
    ``?count=N`` limits the list (default 10), ``?min_db=X`` filters.
    """

    def do_get(self, wildcards, body) -> int:
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        import numpy as np

        spectrum = fe.get_spectrum_db()
        n = len(spectrum)
        fs = fe.tuner.effective_sample_rate
        centre = fe.tuner.centre_frequency
        try:
            count = int(self.query.get("count", 10))
            min_db = float(self.query.get("min_db", "-1e9"))
        except ValueError:
            return HTTP_BAD_REQUEST
        inner = spectrum[1:-1]
        is_peak = (inner > spectrum[:-2]) & (inner >= spectrum[2:]) & (
            inner >= min_db) & np.isfinite(inner)
        idx = np.nonzero(is_peak)[0] + 1
        idx = idx[np.argsort(spectrum[idx])[::-1]][:count]
        peaks = [
            {
                "frequency": int(centre + (int(i) - n // 2) * fs / n),
                "level_db": round(float(spectrum[i]), 2),
                "bin": int(i),
            }
            for i in idx
        ]
        return self.send_json(
            {"centre_frequency": centre, "sample_rate": fs, "peaks": peaks}
        )


class AudioStreamHandler(HttpRequestHandler):
    """GET /audio/<mountpoint>.<ext> — persistent chunked stream
    (audiostream.cxx:140-183). The reference supports only mp3; wav is a
    documented extension."""

    def __init__(self, arg=None, query=None, headers=None):
        super().__init__(arg, query, headers)
        self._consumer = None

    def do_get(self, wildcards, body) -> int:
        from .audiostream import AudioStreamManager
        from .encoders import Mp3Encoder, WavEncoder, lame_available

        name = wildcards[0] if wildcards else ""
        mountpoint, _, ext = name.rpartition(".")
        if not mountpoint:
            return HTTP_NOT_FOUND
        if ext == "mp3" and lame_available():
            self.content_type = Mp3Encoder.content_type
        elif ext == "wav":
            self.content_type = WavEncoder.content_type
        else:
            return HTTP_NOT_FOUND  # audiostream.cxx:151-158
        rx = Radio.receivers.get(mountpoint)
        if rx is None or rx.front_end is None:
            return HTTP_NOT_FOUND
        try:
            self._consumer = AudioStreamManager.subscribe(
                mountpoint, ext, rx.front_end.cfg.audio_rate
            )
        except Exception:
            return HTTP_INTERNAL
        self.persistent = True
        return HTTP_OK

    def content_stream(self):
        while True:
            chunk = self._consumer.read(timeout=5.0)
            if chunk is None:
                if self._consumer.mountpoint in Radio.receivers:
                    continue  # idle pipeline, keep the connection
                return
            yield chunk

    def close(self) -> None:
        if self._consumer is not None:
            from .audiostream import AudioStreamManager

            AudioStreamManager.unsubscribe(self._consumer)
            self._consumer = None


class FileHandler(HttpRequestHandler):
    """GET /static/** from the html directory (filehandler.cxx:33-88)."""

    MIME = {
        ".html": "text/html",
        ".htm": "text/html",
        ".js": "text/javascript",
        ".css": "text/css",
        ".png": "image/png",
        ".jpg": "image/jpeg",
        ".jpeg": "image/jpeg",
        ".gif": "image/gif",
        ".ico": "image/x-icon",
        ".svg": "image/svg+xml",
        ".json": "application/json",
        ".txt": "text/plain",
    }

    def do_get(self, wildcards, body) -> int:
        root = pathlib.Path(self.arg or "html")
        rel = (wildcards[0] if wildcards else "").replace("..", "")
        path = root / rel.lstrip("/")
        if not path.is_file():
            return HTTP_NOT_FOUND
        self.content_type = self.MIME.get(path.suffix.lower(),
                                          "application/octet-stream")
        self.data = path.read_bytes()
        return HTTP_OK


class RedirectHandler(HttpRequestHandler):
    """302 to a target with $1..$n wildcard substitution
    (redirecthandler.cxx:40-57)."""

    def do_get(self, wildcards, body) -> int:
        target = str(self.arg or "/")
        for i, w in enumerate(wildcards, start=1):
            target = target.replace(f"${i}", w)
        self.location = target
        return 302
