"""Process-wide metrics (the port of the JAX package's ``utils/metrics.py``,
its counters).

Analog of velox's StatsReporter macros (velox/common/base/
StatsReporter.h): named counters recorded through one in-process
reporter, which tests and ``chip_smoke.py`` read. Spill writes
``velox_tpu.spilled_bytes``, ``velox_tpu.spill_events`` and
``velox_tpu.spill_file_bytes`` (``exec/spill.py``); the task
``METRIC_TASK_EXECUTIONS``, grouped execution ``METRIC_TASK_BARRIERS``,
the exchange its pages, bytes and seconds (``exec/fragments.py``,
``exec/exchange_net.py``).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict


class StatsReporter:
    """In-process counters (BaseStatsReporter analog)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)

    def add_counter(self, name: str, value: float = 1) -> None:
        with self._lock:
            self.counters[name] += value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

    def clear(self) -> None:
        with self._lock:
            self.counters.clear()


reporter = StatsReporter()

#: named metrics the engine records (velox/common/base/Counters.h analog)
METRIC_TASK_EXECUTIONS = "velox_tpu.task_executions"
METRIC_TASK_BARRIERS = "velox_tpu.task_barriers"
