"""Minimal asyncio HTTP/1.1 exposition endpoint (GET-only, no deps).

One :class:`ObsServer` per node serves:

- ``GET /metrics`` — Prometheus text format 0.0.4 from the node's registry;
- ``GET /status``  — the runtime's JSON status document;
- ``GET /spans``   — finished epoch-phase spans as JSONL
  (``application/x-ndjson``), newest-bounded (see ``SpanTracer.max_spans``);
- ``GET /flight``  — the flight recorder's in-memory record tail as JSONL
  (payloads summarized as digest+size; the on-disk journal has the bytes);
- ``GET /trace``   — the tail filtered to per-tx causal trace records
  (``obs.trace``), tids in hex — grep a tid across nodes live;
- ``GET /health``  — the runtime's machine-readable health/headroom
  document (status + per-lever headroom fractions; what the watchtower
  polls and the future adaptive controller will consume);
- ``GET /perf``    — the performance plane's flame-style profile +
  headroom document (``obs.perf.PerfPlane.perf_doc``): per-layer
  utilization, per-segment busy time over the retained window, and the
  raw sampling-window series.

Deliberately tiny: request line + headers are read with a hard cap and a
timeout, responses are ``Connection: close``, and anything but a known GET
path is a 404/405.  This is a diagnostics port with the same trust model as
the transport hello (identification, not authentication) — bind it to
localhost or a private fabric, like the consensus port.

The port's copy of the JAX package's module; :meth:`ObsServer.stop` ends
its request handlers before it waits for the server, and bounds the wait
(see ``net/transport.py``).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
from typing import Callable, Dict, Optional, Tuple

Addr = Tuple[str, int]

logger = logging.getLogger("hbbft_tpu_torch.obs")

_MAX_HEADER_BYTES = 8192
_REQUEST_TIMEOUT_S = 5.0
#: seconds :meth:`ObsServer.stop` waits for its handlers, then its server
STOP_WAIT_S = 2.0


class ObsServer:
    """Serve one registry (+ optional status/spans providers) over HTTP."""

    def __init__(self, registry, status_fn: Optional[Callable[[], dict]] = None,
                 spans_fn: Optional[Callable[[], str]] = None,
                 flight_fn: Optional[Callable[[], str]] = None,
                 trace_fn: Optional[Callable[[], str]] = None,
                 health_fn: Optional[Callable[[], dict]] = None,
                 perf_fn: Optional[Callable[[], dict]] = None):
        self.registry = registry
        self.status_fn = status_fn
        self.spans_fn = spans_fn
        self.flight_fn = flight_fn
        self.trace_fn = trace_fn
        self.health_fn = health_fn
        self.perf_fn = perf_fn
        self._c_dropped = registry.counter(
            "hbbft_obs_http_dropped_requests_total",
            "obs-endpoint requests dropped (malformed, timed out, or "
            "the client vanished mid-response)")
        self._server: Optional[asyncio.base_events.Server] = None
        self.addr: Optional[Addr] = None
        self._handlers: set = set()
        self._stopping = False

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        self._server = await asyncio.start_server(
            self._handle, host=host, port=port
        )
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self.addr

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()  # accept nothing more
        # Since Python 3.12.1 wait_closed() returns only once every
        # accepted connection has dropped: end the request handlers still
        # running first (each aborts its socket on the way out), then
        # wait, bounded.
        self._stopping = True
        pending = {t for t in self._handlers if not t.done()}
        for task in pending:
            task.cancel()
        if pending:
            await asyncio.wait(pending, timeout=STOP_WAIT_S)
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(self._server.wait_closed(), STOP_WAIT_S)
        self._server = None

    # -- request handling ----------------------------------------------------

    def _route(self, path: str) -> Tuple[int, str, str]:
        """(status code, content type, body)."""
        if path == "/metrics":
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    self.registry.render_prometheus())
        if path == "/status":
            doc = self.status_fn() if self.status_fn is not None else {}
            return (200, "application/json", json.dumps(doc))
        if path == "/spans":
            body = self.spans_fn() if self.spans_fn is not None else ""
            return (200, "application/x-ndjson", body)
        if path == "/flight":
            body = self.flight_fn() if self.flight_fn is not None else ""
            return (200, "application/x-ndjson", body)
        if path == "/trace":
            body = self.trace_fn() if self.trace_fn is not None else ""
            return (200, "application/x-ndjson", body)
        if path == "/health":
            doc = self.health_fn() if self.health_fn is not None else {}
            return (200, "application/json", json.dumps(doc))
        if path == "/perf":
            doc = self.perf_fn() if self.perf_fn is not None else {}
            return (200, "application/json", json.dumps(doc))
        return (404, "text/plain; charset=utf-8",
                "not found; try /metrics /status /spans /flight /trace "
                "/health /perf\n")

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._handlers.add(task)
        try:
            request = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), _REQUEST_TIMEOUT_S
            )
            if len(request) > _MAX_HEADER_BYTES:
                raise ValueError("oversized request header")
            line = request.split(b"\r\n", 1)[0].decode("latin-1")
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(f"bad request line {line!r}")
            method, target = parts[0], parts[1]
            if method != "GET":
                code, ctype, body = (405, "text/plain; charset=utf-8",
                                     "GET only\n")
            else:
                code, ctype, body = self._route(target.split("?", 1)[0])
            payload = body.encode()
            reason = {200: "OK", 404: "Not Found",
                      405: "Method Not Allowed"}.get(code, "Error")
            head = (
                f"HTTP/1.1 {code} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n"
            ).encode("latin-1")
            writer.write(head + payload)
            await writer.drain()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ValueError, OSError) as exc:
            self._c_dropped.inc()
            logger.debug("obs request dropped: %r", exc)
        finally:
            # suppress: best-effort close of a possibly-dead diagnostics
            # socket; the request itself was already served or logged
            self._handlers.discard(task)
            with contextlib.suppress(Exception):
                if self._stopping:
                    writer.transport.abort()
                else:
                    writer.close()


def http_get(host: str, port: int, path: str,
             timeout_s: float = 3.0) -> str:
    """Blocking one-shot GET helper (stdlib only) for pollers like
    ``obs.top`` and ``bench.py --net`` — returns the body, raises
    ``OSError``/``ValueError`` on failure or non-200."""
    import urllib.request

    url = f"http://{host}:{port}{path}"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        if resp.status != 200:
            raise ValueError(f"{url}: HTTP {resp.status}")
        return resp.read().decode()
