"""Exchange fuzzer (velox/exec/fuzzer/ExchangeFuzzer.cpp analog; the
port of ``velox_tpu/fuzzer/exchange_fuzzer.py``).

Random batches serialize into pages (``serial/page.py``) and stream
through the exchange (``exec/exchange_net.py``) under randomized
conditions: page sizes, fetch windows, ack cadences, duplicate fetches
(a lost response retried), buffer limits that make the producer wait,
codecs, and local or TCP transport. The reassembled stream must be the
input exactly. The draws are the JAX package's for a seed; where it
draws zstd and the ``zstandard`` package is missing, the page is
zlib-compressed instead. A retried fetch may return more pages than the
first where more arrived in between (``same_retry``); the reference
fuzzer requires the same pages, which fails at random (ROADMAP, C13).
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np

from velox_tpu_torch import resolve_device
from velox_tpu_torch.exec.exchange_net import (
    ExchangeServer, LocalExchangeSource, RemoteExchangeSource,
    StreamingBufferManager,
)
from velox_tpu_torch.serial import deserialize_page, serialize_page
from velox_tpu_torch.types import BIGINT, DOUBLE, VARCHAR
from velox_tpu_torch.vector.batch import Batch

_WORDS = ["ash", "birch", "cedar", "dune", "elm"]


def _batch(rng, rows, device):
    return Batch.from_pydict(
        {"k": [None if rng.random() < 0.1 else int(x)
               for x in rng.integers(0, 50, rows)],
         "v": [float(np.round(x, 6)) for x in rng.normal(size=rows)],
         "s": [str(rng.choice(_WORDS)) for _ in range(rows)]},
        {"k": BIGINT, "v": DOUBLE, "s": VARCHAR}, device=device)


def _codec(drawn: str):
    if drawn == "False":
        return False
    if drawn == "True":
        return True
    try:
        import zstandard  # noqa: F401
    except ImportError:
        return "zlib"
    return "zstd"


def same_retry(first, retry) -> bool:
    """Whether a retried fetch of one sequence agrees with the first
    ``(pages, next_seq)``: the same pages first, and more only where the
    producer, which runs on, enqueued more between the two."""
    (ps, nxt), (ps2, nxt2) = first, retry
    return ps2[:len(ps)] == ps and nxt2 - nxt == len(ps2) - len(ps)


def run_exchange_fuzz(iterations: int = 30, seed: int = 0,
                      verbose: bool = False, device=None) -> None:
    """``iterations`` random page streams through the exchange, their
    batches made and read back on ``device`` (default: the card)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    for i in range(iterations):
        n_pages = int(rng.integers(1, 25))
        rows = int(rng.integers(1, 200))
        compress = _codec(str(rng.choice([False, True, "zstd"])))
        batches = [_batch(rng, rows, device) for _ in range(n_pages)]
        pages = [serialize_page(b, compress=compress) for b in batches]
        biggest = max(len(p) for p in pages)
        max_buf = int(rng.integers(biggest + 1,
                                   sum(len(p) for p in pages) + 2))
        mgr = StreamingBufferManager(max_buffered_bytes=max_buf)
        remote = bool(rng.random() < 0.4)
        frag = f"fz{i}"

        def produce():
            for p in pages:
                mgr.enqueue(frag, 0, p)
            mgr.no_more_data(frag, [0])

        t = threading.Thread(target=produce)
        t.start()
        server = None
        if remote:
            server = ExchangeServer(mgr, port=0)
            src = RemoteExchangeSource("127.0.0.1", server.port, frag, 0)
        else:
            src = LocalExchangeSource(mgr, frag, 0)
        try:
            got: List[bytes] = []
            seq = 0
            while True:
                window = int(rng.integers(64, 4 * biggest))
                ps, nxt, at_end = src.fetch(seq, window)
                if rng.random() < 0.2 and ps:
                    # lost response: fetch the same sequence again
                    ps2, nxt2, _ = src.fetch(seq, window)
                    assert same_retry((ps, nxt), (ps2, nxt2)), (
                        f"iter {i}: a retry returned other pages")
                got.extend(ps)
                if nxt > seq:
                    if rng.random() < 0.8:
                        src.ack(nxt)
                        seq = nxt
                    else:   # a delayed ack: the pages come again
                        got = got[: len(got) - len(ps)]
                if at_end and not ps:
                    break
            t.join(timeout=20)
            assert not t.is_alive(), f"iter {i}: the producer is stuck"
        finally:
            src.close()
            if server is not None:
                server.close()
        assert len(got) == n_pages, (i, len(got), n_pages)
        for page, b in zip(got, batches):
            rb = deserialize_page(page, device)
            assert rb.to_pydict() == b.to_pydict(), f"iter {i}: payload"
        if verbose:
            print(f"iter {i}: pages={n_pages} rows={rows} remote={remote} "
                  f"buf={max_buf} ok")
