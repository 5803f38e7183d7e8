"""Prometheus text exposition and a ``/metrics`` endpoint (the port's
copy of the reference's ``obs/expo.py``, over the port's registry; what
``python -m aiocluster_torch sim --metrics-port`` serves).

``render_prometheus`` emits text format 0.0.4 (the format every scraper
accepts): ``# HELP``/``# TYPE`` headers, one line per sample, histograms
as cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``.

``MetricsHTTPServer`` is a stdlib-only asyncio HTTP/1.0 responder for the
two paths a scraper needs (``/metrics``, ``/healthz``). It runs either on
the caller's event loop (``start``) or on a daemon thread with its own
loop (``start_in_thread``) so the synchronous sim/bench entry points can be
scraped mid-run.
"""

from __future__ import annotations

import asyncio
import threading
from asyncio import StreamReader, StreamWriter

from .registry import Histogram, MetricsRegistry, default_registry


def _fmt_value(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if float(value).is_integer() and abs(value) < 2**53:
        return str(int(value))
    return repr(float(value))


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _labels_text(names: tuple[str, ...], values: tuple[str, ...],
                 extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    ] + [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """The registry as Prometheus text format 0.0.4 (trailing newline
    included — scrapers require it)."""
    registry = registry if registry is not None else default_registry()
    lines: list[str] = []
    for family in registry.families():
        lines.append(f"# HELP {family.name} {family.help}")
        lines.append(f"# TYPE {family.name} {family.kind}")
        for values, child in family.samples():
            if isinstance(family, Histogram):
                buckets, total_sum, total_count = child.stats()
                for bound, cum in buckets:
                    le = _labels_text(
                        family.label_names, values,
                        extra=(("le", _fmt_value(bound)),),
                    )
                    lines.append(f"{family.name}_bucket{le} {cum}")
                base = _labels_text(family.label_names, values)
                lines.append(
                    f"{family.name}_sum{base} {_fmt_value(total_sum)}"
                )
                lines.append(f"{family.name}_count{base} {total_count}")
            else:
                base = _labels_text(family.label_names, values)
                lines.append(
                    f"{family.name}{base} {_fmt_value(child.value)}"
                )
    return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """Tiny asyncio HTTP endpoint serving ``/metrics`` (and ``/healthz``)."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self._registry = registry
        self._host = host
        self._requested_port = port
        self._server: asyncio.Server | None = None
        self._thread: threading.Thread | None = None
        self._thread_loop: asyncio.AbstractEventLoop | None = None
        self.port: int | None = None  # bound port once started

    async def _handle(self, reader: StreamReader, writer: StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = request.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else ""
            # Drain (and ignore) the header block.
            while True:
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            if path.split("?")[0] == "/metrics":
                body = render_prometheus(self._registry).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                status = "200 OK"
            elif path.split("?")[0] == "/healthz":
                body, ctype, status = b"ok\n", "text/plain", "200 OK"
            else:
                body, ctype, status = b"not found\n", "text/plain", "404 Not Found"
            writer.write(
                f"HTTP/1.0 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
                + body
            )
            await writer.drain()
        except (TimeoutError, asyncio.TimeoutError, OSError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def start(self) -> int:
        """Bind on the caller's loop; returns the bound port."""
        self._server = await asyncio.start_server(
            self._handle, self._host, self._requested_port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        # Swap-to-local before wait_closed suspends so a concurrent
        # stop() sees None at the guard instead of double-closing.
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    # -- thread mode (synchronous callers: sim CLI, bench.py) ---------------

    def start_in_thread(self) -> int:
        """Serve from a daemon thread running its own event loop; returns
        the bound port. For callers that aren't themselves async. A bind
        failure (port in use, privileged port) re-raises HERE, in the
        caller's thread, with the original OSError."""
        started = threading.Event()
        failure: list[BaseException] = []

        def run() -> None:
            loop = asyncio.new_event_loop()
            self._thread_loop = loop
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(self.start())
            except BaseException as exc:  # surface bind errors to caller
                failure.append(exc)
                started.set()
                loop.close()
                return
            started.set()
            loop.run_forever()
            # stop_thread() stops the loop; close the server here, on its
            # own loop, then tear the loop down.
            loop.run_until_complete(self.stop())
            loop.close()

        self._thread = threading.Thread(
            target=run, name="metrics-http", daemon=True
        )
        self._thread.start()
        if not started.wait(timeout=10.0):
            raise RuntimeError("metrics HTTP server failed to start")
        if failure:
            self._thread = None
            self._thread_loop = None
            raise failure[0]
        assert self.port is not None
        return self.port

    def stop_thread(self) -> None:
        if self._thread_loop is not None:
            self._thread_loop.call_soon_threadsafe(self._thread_loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
            self._thread_loop = None
