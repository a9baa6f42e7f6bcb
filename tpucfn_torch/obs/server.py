"""Per-host observability HTTP endpoint.

Every role in the fan-out — trainer rank, serving frontend, restart
supervisor — binds a tiny stdlib HTTP server so the whole fleet is
scrapeable (ISSUE 2: the reference's answer was ssh + tail over
``/var/log``; per-host JSONL fixed durability but not visibility):

* ``GET /metrics`` — Prometheus text exposition of the host's registry.
* ``GET /healthz`` — liveness: 200 ``{"status":"ok",...}`` while the
  role's health callback agrees, 503 otherwise (the shape load
  balancers and the restart supervisor probe).
* ``GET /varz``    — the registry's full JSON snapshot (counters plus
  summary/histogram decompositions), for humans and ``tpucfn obs``.
* ``GET /flightrecorder`` — the attached
  :class:`~tpucfn.obs.flight.FlightRecorder`'s ring as JSON (ISSUE 6):
  the last-N-seconds snapshot the gang coordinator pulls from surviving
  hosts at detect time, and operators pull ad hoc.  404 when no
  recorder is attached.
* ``POST /profile?seconds=S`` — on-demand ``jax.profiler`` capture via
  the attached :class:`~tpucfn.obs.profiler.ProfileCapture`: blocks for
  S seconds, returns the artifact directory as JSON (409 while another
  capture runs, 404 when none is attached).
* ``GET /clock`` — this host's wall + monotonic clocks in one reply
  (ISSUE 20): the sample the coordinator's NTP-style probe brackets
  between two of ITS monotonic reads to estimate this host's wall
  offset with an RTT/2 uncertainty bound (``obs.timeline.probe_clock``).
* ``GET /tracetail?lines=N`` — the last N complete lines of the
  attached tracer's span JSONL as JSON (ISSUE 20): what the gang
  coordinator pulls from survivors at incident detect time, span
  siblings to the flight ring.  404 when no tracer (or an unwritten
  one) is attached.

Port convention: ``TPUCFN_OBS_PORT`` carries each process's assigned
port (the launcher assigns ``base + 1 + host_id`` per host, keeping
``base`` for its own supervisor endpoint — see launch/launcher.py).
Port 0 binds an ephemeral port (tests; single-host ad hoc runs) — the
bound port is on :attr:`ObsServer.port`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from tpucfn_torch.obs.profiler import ProfilerBusy
from tpucfn_torch.obs.registry import MetricRegistry, default_registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# health_fn() -> (healthy, detail_dict); detail is merged into the body.
HealthFn = Callable[[], tuple[bool, dict]]


class ObsServer:
    """One registry behind /metrics, /healthz, /varz on a daemon thread."""

    def __init__(self, registry: MetricRegistry | None = None, *,
                 port: int = 0, host: str = "0.0.0.0", role: str = "",
                 host_id: int | None = None, health_fn: HealthFn | None = None,
                 flight=None, profiler=None, tracer=None):
        """``flight`` is a :class:`~tpucfn.obs.flight.FlightRecorder`
        (or anything with ``snapshot() -> dict``) behind
        ``/flightrecorder``; ``profiler`` is a callable
        ``(seconds) -> dict`` (normally
        :class:`~tpucfn.obs.profiler.ProfileCapture`) behind
        ``POST /profile``; ``tracer`` is this process's
        :class:`~tpucfn.obs.trace.Tracer` behind ``/tracetail``.
        Any None leaves its route 404."""
        self.registry = registry if registry is not None else default_registry()
        self.role = role
        self.host_id = host_id
        self.health_fn = health_fn
        self.flight = flight
        self.profiler = profiler
        self.tracer = tracer
        self._t0 = time.monotonic()
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no per-scrape stderr spam
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    body = obs.registry.to_prometheus().encode()
                    self._send(200, body, PROMETHEUS_CONTENT_TYPE)
                elif path == "/healthz":
                    code, payload = obs._health()
                    self._send(code, json.dumps(payload).encode(),
                               "application/json")
                elif path == "/varz":
                    self._send(200, json.dumps(obs.registry.varz()).encode(),
                               "application/json")
                elif path == "/flightrecorder":
                    if obs.flight is None:
                        self._send(404, b"no flight recorder attached\n",
                                   "text/plain")
                    else:
                        self._send(200,
                                   json.dumps(obs.flight.snapshot()).encode(),
                                   "application/json")
                elif path == "/clock":
                    # Both clocks read back to back: the probe's
                    # offset math needs this host's wall time; mono is
                    # returned for symmetry/debugging.  Kept tiny so
                    # serve time stays well inside the RTT bound.
                    self._send(200, json.dumps({
                        "wall": time.time(),
                        "mono": time.monotonic(),
                        "host_id": obs.host_id,
                        "role": obs.role,
                    }).encode(), "application/json")
                elif path == "/tracetail":
                    body, code = obs._tracetail(self.path)
                    self._send(code, body, "application/json"
                               if code == 200 else "text/plain")
                elif path == "/":
                    self._send(200,
                               b"/metrics /healthz /varz /flightrecorder "
                               b"/clock /tracetail POST /profile\n",
                               "text/plain")
                else:
                    self._send(404, b"not found\n", "text/plain")

            def do_POST(self):
                path, _, query = self.path.partition("?")
                path = path.rstrip("/") or "/"
                if path != "/profile":
                    self._send(404, b"not found\n", "text/plain")
                    return
                if obs.profiler is None:
                    self._send(404, b"no profiler attached\n", "text/plain")
                    return
                from urllib.parse import parse_qs

                raw = parse_qs(query).get("seconds", ["1.0"])[0]
                try:
                    seconds = float(raw)
                except ValueError:
                    self._send(400, f"seconds={raw!r} is not a number\n"
                               .encode(), "text/plain")
                    return
                try:
                    result = obs.profiler(seconds)
                except ValueError as e:  # bad duration (<=0, non-finite...)
                    self._send(400, (str(e) + "\n").encode(), "text/plain")
                except ProfilerBusy as e:
                    self._send(409, (str(e) + "\n").encode(), "text/plain")
                except Exception as e:  # noqa: BLE001 — capture failed
                    self._send(500, (repr(e) + "\n").encode(), "text/plain")
                else:
                    self._send(200, json.dumps(result).encode(),
                               "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"tpucfn-obs:{self._httpd.server_address[1]}")
        self._thread.start()

    def _tracetail(self, raw_path: str) -> tuple[bytes, int]:
        """Last-N span lines of the attached tracer's file (ISSUE 20).
        Reads the file rather than any in-memory state so it sees
        exactly what a postmortem would; torn final lines are skipped
        the same way ``read_trace_file`` skips them."""
        tr = self.tracer
        path = getattr(tr, "path", None)
        if tr is None or path is None:
            return b"no tracer attached\n", 404
        from urllib.parse import parse_qs, urlparse

        raw = parse_qs(urlparse(raw_path).query).get("lines", ["500"])[0]
        try:
            n = max(1, int(raw))
        except ValueError:
            return f"lines={raw!r} is not an int\n".encode(), 400
        try:
            from tpucfn_torch.obs.trace import read_trace_file

            events = read_trace_file(path)
        except OSError as e:
            return f"trace file unreadable: {e}\n".encode(), 404
        return json.dumps({
            "path": str(path),
            "host_id": self.host_id,
            "role": self.role,
            "events": events[-n:],
        }).encode(), 200

    def _health(self) -> tuple[int, dict]:
        healthy, detail = True, {}
        if self.health_fn is not None:
            try:
                healthy, detail = self.health_fn()
            except Exception as e:  # a crashing probe IS unhealthy
                healthy, detail = False, {"probe_error": repr(e)}
        detail = dict(detail)
        if self.flight is not None:
            # HBM watermark (ISSUE 12 satellite): when this role carries
            # a flight ring with device-memory samples, /healthz detail
            # predicts OOMs (sustained used/limit over the threshold)
            # instead of leaving them to the postmortem.  Detail only —
            # a prediction must not flap a load balancer.
            try:
                from tpucfn_torch.obs.flight import hbm_watermark

                wm = hbm_watermark(
                    self.flight.snapshot().get("samples") or [])
                if wm["level"] != "no_data":
                    detail.setdefault("hbm_watermark", wm)
            except Exception:  # noqa: BLE001 — best-effort enrichment
                pass
        payload = {
            "status": "ok" if healthy else "unhealthy",
            "role": self.role,
            "host_id": self.host_id,
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            **detail,
        }
        return (200 if healthy else 503), payload

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def url(self, path: str = "/metrics") -> str:
        host = self._httpd.server_address[0]
        if host in ("0.0.0.0", ""):
            host = "127.0.0.1"
        return f"http://{host}:{self.port}{path}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def obs_port_from_env(env: dict | None = None) -> int | None:
    """The launcher-assigned port for this process, or None when the run
    opted out of the obs plane (unset / empty / unparseable)."""
    raw = (env or os.environ).get("TPUCFN_OBS_PORT", "").strip()
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


def start_obs_server(registry: MetricRegistry | None = None, *,
                     port: int | None = None, role: str = "",
                     host: str = "0.0.0.0",
                     host_id: int | None = None,
                     health_fn: HealthFn | None = None,
                     flight=None, profiler=None,
                     tracer=None) -> ObsServer | None:
    """Start the endpoint for this process; ``port=None`` consults
    ``TPUCFN_OBS_PORT`` and returns None when the env opted out — the
    one-liner every role calls unconditionally."""
    if port is None:
        port = obs_port_from_env()
        if port is None:
            return None
    return ObsServer(registry, port=port, host=host, role=role,
                     host_id=host_id, health_fn=health_fn,
                     flight=flight, profiler=profiler, tracer=tracer)
