"""The remote-write HTTP listener.

A copy of `krr_tpu/ingest/listener.py` over the port's modules.

A minimal asyncio HTTP/1.1 server for exactly one verb: ``POST
/api/v1/write`` with a snappy-framed protobuf body (the server app's
``HttpApp`` is GET/HEAD-only by design, so the write path gets its own
socket and port — also the deployment shape Prometheus expects).

Protocol posture: bodies require a ``Content-Length`` (chunked uploads get
411 — remote-write senders always set it), oversized declarations are
refused with 413 BEFORE reading the body, malformed frames are 400, and
every accepted body answers 204 on a kept-alive connection. A failing
request never takes the listener down: the catch-all 500 arm keeps serving.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from krr_tpu_torch.ingest.plane import IngestPlane
from krr_tpu_torch.integrations.native import RemoteWriteError, RemoteWriteTooLarge

_MAX_HEADER_BYTES = 16384

_REASONS = {
    204: "No Content",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    411: "Length Required",
    413: "Payload Too Large",
    500: "Internal Server Error",
}


class RemoteWriteListener:
    def __init__(
        self,
        plane: IngestPlane,
        *,
        host: str = "0.0.0.0",
        port: int = 0,
        max_body_bytes: int = 16 << 20,
        metrics=None,
        logger=None,
    ) -> None:
        self.plane = plane
        self.host = host
        self.port = port  # 0 until started; then the bound port
        self.max_body_bytes = int(max_body_bytes)
        self.metrics = metrics
        self.logger = logger
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._serve_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _count(self, code: int) -> None:
        if self.metrics is not None:
            self.metrics.inc("krr_tpu_ingest_requests_total", code=str(code))

    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    return  # clean close between requests
                except asyncio.LimitOverrunError:
                    return
                if len(head) > _MAX_HEADER_BYTES:
                    return
                keep_alive = await self._serve_request(head, reader, writer)
                if not keep_alive:
                    return
        except (ConnectionError, asyncio.CancelledError):
            return
        except Exception:  # a torn connection must never kill the listener
            if self.logger is not None:
                self.logger.exception("ingest listener connection error")
            return
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _serve_request(self, head: bytes, reader, writer) -> bool:
        lines = head.split(b"\r\n")
        parts = lines[0].split()
        if len(parts) != 3:
            await self._respond(writer, 400, close=True)
            return False
        method, path = parts[0].decode("latin-1"), parts[1].decode("latin-1")
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if b":" in line:
                name, _, value = line.partition(b":")
                headers[name.decode("latin-1").strip().lower()] = value.decode("latin-1").strip()
        close_requested = headers.get("connection", "").lower() == "close"

        if method != "POST":
            await self._respond(writer, 405, close=close_requested)
            return not close_requested
        if path.split("?", 1)[0] != "/api/v1/write":
            await self._drain(reader, headers)
            await self._respond(writer, 404, close=close_requested)
            return not close_requested
        length_header = headers.get("content-length")
        if length_header is None or not length_header.isdigit():
            # Chunked/absent lengths: refuse rather than stream-parse —
            # remote-write senders always declare the body size.
            await self._respond(writer, 411, close=True)
            return False
        length = int(length_header)
        if length > self.max_body_bytes:
            self._count(413)
            await self._respond(writer, 413, close=True)
            return False
        try:
            body = await reader.readexactly(length)
        except asyncio.IncompleteReadError:
            return False

        try:
            accepted = self.plane.ingest_body(body)
        except RemoteWriteTooLarge:
            self._count(413)
            await self._respond(writer, 413, close=close_requested)
            return not close_requested
        except RemoteWriteError:
            self._count(400)
            await self._respond(writer, 400, close=close_requested)
            return not close_requested
        except Exception:
            if self.logger is not None:
                self.logger.exception("ingest body failed")
            self._count(500)
            await self._respond(writer, 500, close=close_requested)
            return not close_requested
        self._count(204)
        if self.metrics is not None:
            self.metrics.inc("krr_tpu_ingest_bytes_total", float(len(body)))
            if accepted:
                self.metrics.inc("krr_tpu_ingest_samples_total", float(accepted))
        await self._respond(writer, 204, close=close_requested)
        return not close_requested

    async def _drain(self, reader, headers: dict) -> None:
        length_header = headers.get("content-length", "")
        if length_header.isdigit():
            length = int(length_header)
            if 0 < length <= self.max_body_bytes:
                try:
                    await reader.readexactly(length)
                except asyncio.IncompleteReadError:
                    pass

    async def _respond(self, writer, code: int, close: bool = False) -> None:
        connection = "close" if close else "keep-alive"
        writer.write(
            (
                f"HTTP/1.1 {code} {_REASONS[code]}\r\n"
                f"Content-Length: 0\r\nConnection: {connection}\r\n\r\n"
            ).encode("latin-1")
        )
        await writer.drain()
