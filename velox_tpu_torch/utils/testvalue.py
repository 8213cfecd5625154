"""Deterministic fault and behaviour injection for tests (the port of the
JAX package's ``utils/testvalue.py``).

The TestValue mechanism (velox/common/testutil/TestValue.h:33): code
under test calls ``TestValue.adjust(point, payload)`` at named points;
tests register callbacks that observe state, change payloads or raise,
which makes the spill, exchange, abandon and scan failure paths
testable. It is off by default: a point costs one flag check until
``enable()`` or ``set()`` turns it on.

The points keep the JAX package's names, so one test body can drive
both packages:
  velox_tpu.spill.spill_all    a buffer's or store's batches move to host
  velox_tpu.spill.partitions   a partitioned or range restore begins
  velox_tpu.agg.abandon_check  the PARTIAL step's abandon decision
  velox_tpu.exchange.enqueue   the producer side of the exchange
  velox_tpu.exchange.get_data  a consumer's fetch
  velox_tpu.scan.read_split    a table's splits are read
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict


class TestValue:
    __test__ = False   # not a pytest class

    _enabled = False
    _callbacks: Dict[str, Callable] = {}
    _lock = threading.Lock()

    @classmethod
    def enable(cls) -> None:
        cls._enabled = True

    @classmethod
    def disable(cls) -> None:
        cls._enabled = False
        with cls._lock:
            cls._callbacks.clear()

    @classmethod
    def set(cls, point: str, fn: Callable) -> None:
        with cls._lock:
            cls._callbacks[point] = fn
        cls._enabled = True

    @classmethod
    def clear(cls, point: str) -> None:
        with cls._lock:
            cls._callbacks.pop(point, None)

    @classmethod
    def adjust(cls, point: str, payload=None):
        """Called at an injection point: the callback's result (a test
        may substitute a payload), or None."""
        if not cls._enabled:
            return None
        fn = cls._callbacks.get(point)
        if fn is None:
            return None
        return fn(payload)

    @classmethod
    @contextmanager
    def scoped(cls, point: str, fn: Callable):
        cls.set(point, fn)
        try:
            yield
        finally:
            cls.clear(point)
