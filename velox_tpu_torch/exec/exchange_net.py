"""Streaming exchange: bounded buffers, ack windows and a socket transport
(the port of the JAX package's ``exec/exchange_net.py``).

* ``StreamingBufferManager`` (velox/exec/OutputBufferManager.h:41):
  ``enqueue`` blocks while a destination's unacked bytes would pass the
  buffer limit (producer backpressure); ``get_data(seq)`` returns the
  pages from ``seq`` on, which stay buffered until acked (the retry
  contract); ``ack(seq)`` releases them; ``no_more_data`` finishes a
  destination once every producer task of its fragment has called it.
* ``ExchangeServer`` and ``RemoteExchangeSource``: the ExchangeSource
  contract (velox/exec/ExchangeSource.h:23-42) over TCP, each message a
  little-endian u32 length, a JSON header, then the pages' bytes; pages
  are ``serial/page.py`` pages, so either package reads the other's.

Every wait has a deadline and raises when it passes: a producer that
never publishes, a consumer that never acks, a dead peer or a socket
that goes quiet fail the caller instead of hanging it. ``abort`` makes
every wait on the manager raise at once (a failed task stops its
peers).
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from velox_tpu_torch.utils.metrics import reporter
from velox_tpu_torch.utils.testvalue import TestValue

#: fetches a consumer made, and the bytes and seconds they took
METRIC_EXCHANGE_FETCHES = "velox_tpu.exchange_fetches"
METRIC_EXCHANGE_FETCH_BYTES = "velox_tpu.exchange_fetch_bytes"
METRIC_EXCHANGE_FETCH_S = "velox_tpu.exchange_fetch_s"
#: pages deserialized on the consumer side, and the seconds they took
METRIC_EXCHANGE_DESERIALIZE_S = "velox_tpu.exchange_deserialize_s"

#: seconds any exchange wait lasts before it raises
DEFAULT_TIMEOUT_S = 60.0


class _PartitionBuffer:
    """Pages of one destination, retained until acked."""

    __slots__ = ("pages", "base_seq", "next_seq", "done", "bytes")

    def __init__(self):
        self.pages: List[bytes] = []
        self.base_seq = 0          # seq of pages[0]
        self.next_seq = 0          # seq the next enqueue gets
        self.done = 0              # producer tasks that finished
        self.bytes = 0


class StreamingBufferManager:
    """Bounded, acked, blocking output buffers."""

    def __init__(self, max_buffered_bytes: int = 8 << 20,
                 timeout: float = DEFAULT_TIMEOUT_S):
        self.max_bytes = max_buffered_bytes
        self.timeout = timeout
        self._parts: Dict[tuple, _PartitionBuffer] = defaultdict(
            _PartitionBuffer)
        self._producers: Dict[str, int] = {}
        self._cv = threading.Condition()
        self._error: Optional[BaseException] = None
        #: times a producer had to wait for room
        self.blocked_count = 0

    def expect_producers(self, frag: str, n: int) -> None:
        """``n`` producer tasks write ``frag``: its destinations finish
        when all ``n`` have called ``no_more_data`` (default 1)."""
        with self._cv:
            self._producers[frag] = n

    def abort(self, error: BaseException) -> None:
        """Make every wait on this manager raise (a task failed)."""
        with self._cv:
            if self._error is None:
                self._error = error
            self._cv.notify_all()

    def _check(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                f"exchange aborted: {self._error!r}") from self._error

    def _wait(self, ready, deadline: float, what: str) -> None:
        """Wait under the lock until ``ready()``; raise past ``deadline``
        or once aborted."""
        while not ready():
            self._check()
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"exchange {what} timed out")
            self._cv.wait(timeout=left)
        self._check()

    def _finished(self, frag: str, buf: _PartitionBuffer) -> bool:
        return buf.done >= self._producers.get(frag, 1)

    def enqueue(self, frag: str, part: int, page: bytes) -> None:
        TestValue.adjust("velox_tpu.exchange.enqueue", (frag, part, page))
        with self._cv:
            buf = self._parts[(frag, part)]
            if buf.bytes + len(page) > self.max_bytes and buf.pages:
                self.blocked_count += 1
            self._wait(lambda: not (buf.bytes + len(page) > self.max_bytes
                                    and buf.pages),
                       time.monotonic() + self.timeout,
                       f"{frag}:{part} enqueue")
            buf.pages.append(page)
            buf.bytes += len(page)
            buf.next_seq += 1
            self._cv.notify_all()

    def no_more_data(self, frag: str, parts: Optional[List[int]] = None
                     ) -> None:
        """One producer task of ``frag`` is done with ``parts`` (default:
        every destination it has)."""
        with self._cv:
            if parts is None:
                parts = [p for (f, p) in self._parts if f == frag]
            for p in parts:
                self._parts[(frag, p)].done += 1
            self._cv.notify_all()

    def get_data(self, frag: str, part: int, seq: int,
                 max_bytes: int = 1 << 20, timeout: Optional[float] = None
                 ) -> Tuple[List[bytes], int, bool]:
        """Pages from ``seq`` on, waiting for data or the end:
        (pages, next_seq, at_end). Pages stay buffered until acked, so a
        consumer may fetch again from any unacked sequence."""
        TestValue.adjust("velox_tpu.exchange.get_data", (frag, part, seq))
        with self._cv:
            buf = self._parts[(frag, part)]
            self._wait(lambda: seq < buf.next_seq or self._finished(
                frag, buf), time.monotonic() + (timeout or self.timeout),
                f"{frag}:{part} seq {seq}")
            if seq < buf.base_seq:
                raise ValueError(f"sequence {seq} already acked (base "
                                 f"{buf.base_seq})")
            out: List[bytes] = []
            total = 0
            s = seq
            while s < buf.next_seq:
                page = buf.pages[s - buf.base_seq]
                if out and total + len(page) > max_bytes:
                    break
                out.append(page)
                total += len(page)
                s += 1
            at_end = self._finished(frag, buf) and s >= buf.next_seq
            return out, s, at_end

    def ack(self, frag: str, part: int, seq: int) -> None:
        """Release the pages with sequence < ``seq``."""
        with self._cv:
            buf = self._parts[(frag, part)]
            while buf.base_seq < seq and buf.pages:
                buf.bytes -= len(buf.pages[0])
                buf.pages.pop(0)
                buf.base_seq += 1
            self._cv.notify_all()

    def buffered_bytes(self, frag: str, part: int) -> int:
        with self._cv:
            return self._parts[(frag, part)].bytes


# ------------------------------------------------------------- transport

def _no_delay(sock: socket.socket) -> None:
    """Send each small header at once (no Nagle wait for the reply)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("exchange peer closed")
        got += k
    return bytes(out)


def _send_msg(sock: socket.socket, header: dict,
              payloads: List[bytes] = ()) -> None:
    h = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(h)) + h)
    for p in payloads:
        sock.sendall(p)


def _recv_msg(sock: socket.socket) -> dict:
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n))


class ExchangeServer:
    """Serves a ``StreamingBufferManager``'s pages over TCP on
    127.0.0.1. A request is ``{op: get|ack, frag, part, seq,
    max_bytes}``; a get answers ``{sizes, next_seq, at_end}`` and the
    pages, a failed get ``{error}``. ``close`` stops the server."""

    def __init__(self, manager: StreamingBufferManager, port: int = 0):
        mgr = manager

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                self.request.settimeout(mgr.timeout)
                _no_delay(self.request)
                try:
                    while True:
                        req = _recv_msg(self.request)
                        if req["op"] == "get":
                            try:
                                pages, nxt, end = mgr.get_data(
                                    req["frag"], req["part"], req["seq"],
                                    req.get("max_bytes", 1 << 20))
                            except Exception as e:   # to the client
                                _send_msg(self.request, {"error": repr(e)})
                                return
                            _send_msg(self.request, {
                                "sizes": [len(p) for p in pages],
                                "next_seq": nxt, "at_end": end}, pages)
                        elif req["op"] == "ack":
                            mgr.ack(req["frag"], req["part"], req["seq"])
                            _send_msg(self.request, {"ok": True})
                        else:
                            return
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        # a short poll: ``close`` waits for the serving loop's next look
        self._thread = threading.Thread(
            target=self._server.serve_forever, args=(0.02,), daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=DEFAULT_TIMEOUT_S)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ExchangeSourceBase:
    """velox/exec/ExchangeSource.h contract: fetch, ack, close."""

    def fetch(self, seq: int, max_bytes: int = 1 << 20
              ) -> Tuple[List[bytes], int, bool]:
        raise NotImplementedError

    def ack(self, seq: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalExchangeSource(ExchangeSourceBase):
    """A destination of a manager in this process."""

    def __init__(self, manager: StreamingBufferManager, frag: str,
                 part: int):
        self.m, self.frag, self.part = manager, frag, part

    def fetch(self, seq, max_bytes=1 << 20):
        return self.m.get_data(self.frag, self.part, seq, max_bytes)

    def ack(self, seq):
        self.m.ack(self.frag, self.part, seq)


class RemoteExchangeSource(ExchangeSourceBase):
    """A socket client pulling pages with an ack window; every socket
    wait times out after ``timeout`` seconds."""

    def __init__(self, host: str, port: int, frag: str, part: int,
                 timeout: float = DEFAULT_TIMEOUT_S):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        _no_delay(self.sock)
        self.frag, self.part = frag, part
        self.roundtrips = 0

    def fetch(self, seq, max_bytes=1 << 20):
        _send_msg(self.sock, {"op": "get", "frag": self.frag,
                              "part": self.part, "seq": seq,
                              "max_bytes": max_bytes})
        resp = _recv_msg(self.sock)
        if "error" in resp:
            raise RuntimeError(f"exchange server: {resp['error']}")
        pages = [_recv_exact(self.sock, n) for n in resp["sizes"]]
        self.roundtrips += 1
        return pages, resp["next_seq"], resp["at_end"]

    def ack(self, seq):
        _send_msg(self.sock, {"op": "ack", "frag": self.frag,
                              "part": self.part, "seq": seq})
        _recv_msg(self.sock)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def consume_source(source: ExchangeSourceBase, max_bytes: int = 1 << 20,
                   device=None):
    """The batches of an exchange source, deserialized onto ``device``
    (``None``: the card), with fetch -> process -> ack windowing (velox
    Exchange.cpp's request loop)."""
    from velox_tpu_torch.serial import deserialize_page

    seq = 0
    while True:
        t0 = time.perf_counter()
        pages, nxt, at_end = source.fetch(seq, max_bytes)
        reporter.add_counter(METRIC_EXCHANGE_FETCH_S,
                             time.perf_counter() - t0)
        reporter.add_counter(METRIC_EXCHANGE_FETCHES)
        reporter.add_counter(METRIC_EXCHANGE_FETCH_BYTES,
                             sum(len(p) for p in pages))
        for p in pages:
            t0 = time.perf_counter()
            b = deserialize_page(p, device)
            reporter.add_counter(METRIC_EXCHANGE_DESERIALIZE_S,
                                 time.perf_counter() - t0)
            yield b
        if nxt > seq:
            source.ack(nxt)
            seq = nxt
        if at_end and not pages:
            break
