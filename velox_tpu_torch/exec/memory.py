"""Hierarchical memory pools and cross-query arbitration (the port of the
JAX package's ``exec/memory.py``).

Analog of velox/common/memory/Memory.h (MemoryPool tree),
MemoryArbitrator.h and SharedArbitrator.cpp: torch's caching allocator
owns device memory, so a pool does not allocate, it *accounts*. The
tree is root -> query -> operator; leaf
pools hold the spill buffers of blocking operators (``SpillableBuffer``,
and a generic aggregation's ``PartitionedEntryStore``; a buffer made
outside any query hangs off the root), and a pool's
usage is computed LIVE from its buffers (plus any manual reservations),
which makes the accounting drift-proof by construction — there is no
reserve/free pairing to get wrong. The tree is the one arbiter of the
device budget (``config.spill_memory_budget_bytes``, the root's
capacity unless it has its own).

Arbitration (SharedArbitrator::growCapacity analog): when a query's
usage would exceed the root capacity, the arbitrator reclaims from the
query with the most reclaimable bytes — OTHER queries first (global
arbitration), the requester last — by spilling its buffers device ->
host (-> page files under the host budget, exec/spill.py). A per-query
cap (config.query_memory_cap_bytes) reclaims from the query itself.

One re-entrant lock (``MemoryPool._lock``) guards the tree and every
spill buffer's lists (``exec/spill.py`` takes the same lock), so a buffer
that one query's thread spills is never read half-moved by its owner's
thread.

``MemoryPool.tree_usage()`` renders the velox
``MemoryPool::treeMemoryUsage`` style breakdown for debugging.
"""

from __future__ import annotations

import threading
from contextvars import ContextVar
from typing import Dict, List, Optional

from velox_tpu_torch.utils.config import config


class MemoryPool:
    """One node of the accounting tree. Thread-safe via a tree lock."""

    _lock = threading.RLock()

    def __init__(self, name: str, parent: Optional["MemoryPool"] = None,
                 kind: str = "operator",
                 capacity: Optional[int] = None):
        self.name = name
        self.parent = parent
        self.kind = kind  # "root" | "query" | "operator"
        self.capacity = capacity
        self.children: Dict[str, "MemoryPool"] = {}
        self._buffers: List[object] = []   # SpillableBuffers (leaf)
        self._reserved = 0                 # manual reservations
        self.peak = 0
        if parent is not None:
            with MemoryPool._lock:
                # name collisions get a suffix (two OrderBy ops in
                # one query)
                base, i = name, 1
                while name in parent.children:
                    i += 1
                    name = f"{base}#{i}"
                self.name = name
                parent.children[name] = self

    # ------------------------------------------------------ accounting

    def attach_buffer(self, buf) -> None:
        with MemoryPool._lock:
            self._buffers.append(buf)

    def detach_buffer(self, buf) -> None:
        with MemoryPool._lock:
            if buf in self._buffers:
                self._buffers.remove(buf)

    def used(self) -> int:
        """Live device bytes under this subtree."""
        with MemoryPool._lock:
            n = self._reserved + sum(
                b.device_bytes() for b in self._buffers)
            n += sum(c.used() for c in self.children.values())
            if n > self.peak:
                self.peak = n
            return n

    def reclaimable(self) -> int:
        """Bytes a reclaim pass could move off-device right now."""
        with MemoryPool._lock:
            n = sum(b.device_bytes() for b in self._buffers)
            return n + sum(
                c.reclaimable() for c in self.children.values())

    def reserve(self, nbytes: int) -> None:
        """Manual reservation (non-buffer usage: exchange queues,
        serialized pages). Triggers arbitration like buffer growth."""
        with MemoryPool._lock:
            self._reserved += nbytes
        self.maybe_arbitrate()

    def release(self, nbytes: int) -> None:
        with MemoryPool._lock:
            self._reserved = max(0, self._reserved - nbytes)

    # ----------------------------------------------------- arbitration

    def root(self) -> "MemoryPool":
        p = self
        while p.parent is not None:
            p = p.parent
        return p

    def query_pool(self) -> Optional["MemoryPool"]:
        p = self
        while p is not None and p.kind != "query":
            p = p.parent
        return p

    def _spill_victims(self) -> List[object]:
        """Buffers of this subtree, largest first."""
        with MemoryPool._lock:
            out = list(self._buffers)
            for c in self.children.values():
                out.extend(c._spill_victims())
        return sorted(out, key=lambda b: -b.device_bytes())

    def maybe_arbitrate(self) -> None:
        """Enforce the per-query cap, then the root capacity.

        Per-query: reclaim from the query itself. Root: reclaim from
        the query with the most reclaimable bytes, requester LAST
        (SharedArbitrator victim policy)."""
        with MemoryPool._lock:
            self._arbitrate()

    def _arbitrate(self) -> None:
        qp = self.query_pool()
        qcap = (qp.capacity if qp is not None and qp.capacity
                else config.query_memory_cap_bytes)
        if qp is not None and qcap is not None:
            while qp.used() > qcap:
                if not _reclaim_one(qp):
                    break
        root = self.root()
        rcap = (root.capacity
                if root.capacity is not None
                else config.spill_memory_budget_bytes)
        if rcap is None:
            return
        while root.used() > rcap:
            # the queries, and the buffers made outside any query
            queries = sorted(root.children.values(),
                             key=lambda q: (q is qp, -q.reclaimable()))
            done = False
            for q in queries:
                if q.reclaimable() > 0 and _reclaim_one(q):
                    done = True
                    break
            if not done:
                break

    # -------------------------------------------------------- reporting

    def stats(self) -> Dict[str, int]:
        return {"used": self.used(), "peak": self.peak,
                "reclaimable": self.reclaimable(),
                "reserved": self._reserved}

    def tree_usage(self, indent: int = 0) -> str:
        """velox MemoryPool::treeMemoryUsage-style breakdown."""
        s = self.stats()
        line = (" " * indent + f"{self.name} [{self.kind}] "
                f"used={s['used']} peak={s['peak']} "
                f"reclaimable={s['reclaimable']}")
        subs = [c.tree_usage(indent + 2)
                for c in self.children.values()]
        return "\n".join([line] + subs)

    def close(self) -> None:
        with MemoryPool._lock:
            if self.parent is not None:
                self.parent.children.pop(self.name, None)


def _reclaim_one(pool: MemoryPool) -> bool:
    """Spill the largest on-device buffer under ``pool``. Returns
    whether anything moved."""
    for buf in pool._spill_victims():
        if buf.device_bytes() > 0:
            buf.spill_all()
            return True
    return False


#: process root (velox MemoryManager::getInstance()->rootPool analog)
root_pool = MemoryPool("root", None, kind="root")

#: ambient pool for SpillableBuffer creation — the Task sets its query
#: pool here for the duration of operator setup/execution
_current: ContextVar[Optional[MemoryPool]] = ContextVar(
    "velox_tpu_torch_current_pool", default=None)


def current_pool() -> Optional[MemoryPool]:
    return _current.get()


class scoped_pool:
    """Context manager: make ``pool`` ambient for buffer creation."""

    def __init__(self, pool: Optional[MemoryPool]):
        self.pool = pool
        self._token = None

    def __enter__(self):
        self._token = _current.set(self.pool)
        return self.pool

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


def query_pool(name: str, capacity: Optional[int] = None
               ) -> MemoryPool:
    """Create (or reuse) a query-level pool under the root."""
    with MemoryPool._lock:
        existing = root_pool.children.get(name)
        if existing is not None:
            return existing
    return MemoryPool(name, root_pool, kind="query",
                      capacity=capacity)
