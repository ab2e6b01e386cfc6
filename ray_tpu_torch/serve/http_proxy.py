"""HTTP ingress (counterpart of ``ray_tpu/serve/http_proxy.py``).

Ref analogue: serve/_private/proxy.py ProxyActor (:1097) — the reference
runs uvicorn/ASGI per node; here a threaded stdlib HTTP server in the
driver process routes ``POST /<deployment>`` with a JSON body to the
deployment handle and returns the JSON result, and ``POST
/<deployment>/<method>`` (or an ``Accept: text/event-stream`` request)
streams the method's items as server-sent events. The admission gate
sheds with 503 and ``Retry-After``; a spent deadline answers 504.

Not ported yet: raw-HTTP (ASGI) deployments, the TLS server, per-node
proxy actors and the flight recorder's request records.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import urlparse

from .. import core as rt
from ..core.config import get_config
from ..core.exceptions import DeadlineExceededError, OverloadedError
from ..util import overload
from ..util.timeline import (
    enter_span,
    exit_span,
    format_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
    record_span,
)
from . import _telemetry
from .handle import DeploymentHandle

_routes: Dict[str, DeploymentHandle] = {}
_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None


def _make_gate(name: str) -> overload.AdmissionGate:
    """Per-deployment admission gate; sheds map to 503 + Retry-After
    (ref analogue: the proxy's queue-length admission)."""
    return overload.gate_from_config(get_config())


_gates = overload.GateRegistry(_make_gate)


def _request_deadline(headers) -> float:
    """Absolute deadline for one ingress request: an explicit
    ``X-Request-Timeout-S`` budget when the client sent one, else the
    ``serve_default_request_timeout_s`` knob — the single source of
    truth that seeds deadline propagation through handle and replica."""
    default = get_config().serve_default_request_timeout_s
    budget = default
    raw = headers.get("X-Request-Timeout-S")
    if raw:
        try:
            # Clients may only SHORTEN the budget: an unclamped header
            # would let one client pin proxy threads and admission slots
            # for arbitrarily long.
            budget = min(default, max(0.001, float(raw)))
        except ValueError:
            pass
    return time.time() + budget


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # silence request logging
        pass

    def send_response(self, code, message=None):
        # Remember the status for the request metrics recorded in
        # do_POST's finally — covers the JSON, SSE and shed paths.
        self._obs_status = code
        super().send_response(code, message)
        # Every response names its trace (W3C traceparent), so a
        # user-visible 504/503 correlates to its recorded spans.
        trace = getattr(self, "_obs_trace", None)
        if trace is not None:
            self.send_header("traceparent",
                             format_traceparent(trace[0], trace[1]))

    def _reply(self, code: int, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        # HEAD responses (incl. errors) must never carry a body — a
        # keep-alive client would parse it as the next response.
        if self.command != "HEAD":
            self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — stdlib API
        if self.path in ("/-/routes", "/-/healthz"):
            # Not a traced request: clear any trace left by an earlier
            # request on this keep-alive connection.
            self._obs_trace = None
        if self.path == "/-/routes":
            self._reply(200, sorted(_routes))
        elif self.path == "/-/healthz":
            self._reply(200, "ok")
        else:
            self.do_POST()

    def do_PUT(self):  # noqa: N802
        self.do_POST()

    def do_DELETE(self):  # noqa: N802
        self.do_POST()

    def do_PATCH(self):  # noqa: N802
        self.do_POST()

    def do_OPTIONS(self):  # noqa: N802
        self.do_POST()

    def do_HEAD(self):  # noqa: N802
        self.do_POST()

    def _stream_reply(self, handle, arg):
        """Server-sent events: one `data:` frame per item the replica's
        generator yields, flushed as produced (ref analogue: proxy.py
        RESPONSE_STREAMING over ASGI; `curl -N` shows tokens live)."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            for item in handle.stream(arg):
                self.wfile.write(
                    f"data: {json.dumps(item)}\n\n".encode()
                )
                self.wfile.flush()
            self.wfile.write(b"event: end\ndata: null\n\n")
            self.wfile.flush()
        except BrokenPipeError:
            pass  # client went away mid-stream
        except Exception as e:  # noqa: BLE001 — reported in the stream
            try:
                self.wfile.write(
                    f"event: error\ndata: {json.dumps(str(e))}\n\n".encode()
                )
                self.wfile.flush()
            except OSError:
                pass

    def do_POST(self):  # noqa: N802
        """Instrumented ingress entry (ref analogue: the proxy's request
        span + ray_serve_num_http_requests in serve/_private/proxy.py):
        opens the request's ROOT span — honoring an incoming W3C
        ``traceparent`` so an upstream gateway owns the trace — installs
        it as this thread's context, and records the e2e latency
        histogram + status-code counter on the way out."""
        name = urlparse(self.path).path.strip("/").split("/")[0]
        parent = parse_traceparent(self.headers.get("traceparent"))
        trace_id = parent[0] if parent else new_trace_id()
        span_id = new_span_id()
        prev = enter_span(trace_id, span_id)
        # Per-request reset: the handler instance is reused across a
        # keep-alive connection, so a request that dies before
        # send_response must not inherit the previous request's status.
        self._obs_status = 500
        self._obs_trace = (trace_id, span_id)
        started = time.time()
        try:
            self._route_request(name)
        finally:
            exit_span(prev)
            ended = time.time()
            code = getattr(self, "_obs_status", 500)
            # Unknown routes record under ONE fixed label: client-chosen
            # paths must not mint unbounded metric series.
            dep_label = (name or "/") if code != 404 else "__unknown__"
            _telemetry.observe_ingress(
                dep_label, "http", code, started, ended,
                trace_id=trace_id,
            )
            record_span(f"http:{name or '/'}", started, ended,
                        parent=(trace_id, parent[1] if parent else ""),
                        span_id=span_id)

    def _route_request(self, name: str):
        parts = urlparse(self.path).path.strip("/").split("/")
        streaming = (
            (len(parts) > 1 and parts[1] == "stream")
            or "text/event-stream" in (self.headers.get("Accept") or "")
        )
        handle = _routes.get(name)
        if handle is None:
            # Dynamic discovery: any live deployment is routable without
            # explicit registration (resolved lazily through the
            # controller and cached, after which the handle long-polls on
            # its own). A stray request must never SPAWN a controller,
            # and a transient controller failure is 503, not 404.
            from . import api as serve_api
            from .controller import CONTROLLER_NAME

            try:
                rt.get_actor(CONTROLLER_NAME)
            except ValueError:
                self._reply(404, {"error": "serve is not running"})
                return
            try:
                handle = serve_api.get_deployment_handle(name)
                _routes[name] = handle
            except KeyError:
                self._reply(404, {"error": f"no deployment {name!r}"})
                return
            except Exception as e:  # noqa: BLE001
                self._reply(503, {"error": f"controller error: {e}"})
                return
        if self.command in ("HEAD", "OPTIONS"):
            # Deployments speak the JSON envelope only; do NOT execute
            # them on preflight/health probes, and never write a body to
            # a HEAD response (keep-alive desync).
            self.send_response(405)
            self.send_header("Allow", "GET, POST")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        # ---- overload control: deadline + admission ------------------
        # Shed BEFORE dispatch: past the adaptive concurrency limit and
        # the bounded queue, the request never reaches a handle thread.
        deadline_ts = _request_deadline(self.headers)
        gate = _gates.get(name)
        try:
            gate.acquire(deadline_ts=deadline_ts)
        except OverloadedError as e:
            _telemetry.observe_shed(name, "proxy")
            self._reply_overloaded(e)
            return
        t0 = time.monotonic()
        prev_dl = overload.set_ambient_deadline(deadline_ts)
        try:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b"null"
            try:
                arg = json.loads(raw) if raw else None
            except json.JSONDecodeError:
                self._reply(400, {"error": "invalid JSON body"})
                return
            if streaming:
                # /<name>/<method> routes to that method (e.g.
                # /llm/stream → the deployment's generator endpoint);
                # bare /<name> with an SSE Accept header streams
                # __call__'s result as one event.
                if len(parts) > 1:
                    handle = handle.options(method=parts[1])
                self._stream_reply(handle, arg)
                return
            try:
                result = handle.remote(arg).result(
                    timeout=overload.remaining(60.0)
                )
                self._reply(200, {"result": result})
            except OverloadedError as e:
                # Shed downstream (replica limiter / all breakers open).
                self._reply_overloaded(e)
            except (DeadlineExceededError, TimeoutError) as e:
                _telemetry.observe_deadline_exceeded(name, "ingress")
                self._reply(504, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": str(e)})
        finally:
            overload.set_ambient_deadline(prev_dl)
            code = getattr(self, "_obs_status", 500)
            # Only downstream pushback (503: replica shed / breakers
            # open) shrinks the gate. A 504 means the CLIENT's budget
            # was too small — one client sending tiny X-Request-
            # Timeout-S values must not collapse the shared limit.
            gate.release(time.monotonic() - t0,
                         overloaded=code == 503)

    def _reply_overloaded(self, e: OverloadedError):
        """503 + Retry-After (integer seconds, RFC 9110). The request
        body may be unread at this point: close the connection so a
        keep-alive client cannot desync on the stray bytes."""
        body = json.dumps({"error": str(e)}).encode()
        self.send_response(503)
        retry_after = getattr(e, "retry_after_s", 1.0)
        self.send_header("Retry-After",
                         str(max(1, int(math.ceil(retry_after)))))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.close_connection = True
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)


def start_proxy(port: int = 8000) -> int:
    """Start the proxy in this process on 127.0.0.1 (once; a later call
    returns the port it already has). ``port=0`` picks a free port."""
    global _server, _thread
    if _server is not None:
        return _server.server_address[1]
    _server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    _server.daemon_threads = True
    _thread = threading.Thread(target=_server.serve_forever, daemon=True,
                               name="ray_tpu_torch-serve-proxy")
    _thread.start()
    return _server.server_address[1]


def register_route(name: str, handle: DeploymentHandle):
    _routes[name] = handle


def stop_proxy():
    """Stop the server and close its listening port."""
    global _server, _thread
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _thread.join(timeout=10)
        _server = None
        _thread = None
    _routes.clear()
    _gates.clear()
