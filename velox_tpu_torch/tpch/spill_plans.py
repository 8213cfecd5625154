"""Plans that hold a lot of state between batches, for spill over TPC-H
at full width: the plans of ``chip_smoke.py``'s phase 16, and the
device-side reading and comparison of their results.

**Q18** with ``optimize_plans`` off (hash joins, generic aggregation);
**G** a generic aggregation by ``l_orderkey`` (15M groups at SF10) with
``sum``/``count``/``avg``; **O** an OrderBy of orders by
(``o_totalprice``, ``o_orderkey``); **J** a full outer join of orders
before 1995 to lineitem shipped after 1992-06-30 (a hash join: its
lineitem build spills partitioned, and both probe-only and build-only
rows come out). W1 (``tpcds/window_plans.py``) runs over TPC-DS's
store_sales. Every plan runs with ``optimize_plans`` off.

A result is read on the device (``device_rows``): each column's live
rows, concatenated; or on the host batch by batch (``host_rows``, W1's
reading, so that its peak measures the window, not the result).
``same_rows`` compares two results row for row, or as multisets after
one lexicographic sort of every column (``canonical``); DOUBLE columns
to a relative tolerance, the rest exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def plan_agg(pb):
    return (pb().table_scan("lineitem", ["l_orderkey", "l_quantity",
                                         "l_extendedprice"])
            .aggregate(["l_orderkey"], [
                "sum(l_quantity) AS q", "count(*) AS n",
                "avg(l_extendedprice) AS p"]))


def plan_order(pb):
    return pb().table_scan("orders").order_by(["o_totalprice", "o_orderkey"])


def plan_join(pb):
    build = (pb().table_scan("lineitem", [
        "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
        "l_quantity", "l_extendedprice", "l_shipdate"])
        .filter("l_shipdate > DATE '1992-06-30'"))
    return (pb().table_scan("orders", ["o_orderkey", "o_totalprice",
                                       "o_orderdate"])
            .filter("o_orderdate < DATE '1995-01-01'")
            .hash_join(build, ["o_orderkey"], ["l_orderkey"], "full",
                       output=["o_orderkey", "o_totalprice", "l_orderkey",
                               "l_linenumber", "l_partkey", "l_suppkey",
                               "l_quantity", "l_extendedprice"]))


#: label -> (plan, whether its order is part of the result)
PLANS = {"G agg by l_orderkey": (plan_agg, False),
         "O orderby orders": (plan_order, True),
         "J full join": (plan_join, False)}

Rows = Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]


def device_rows(task) -> Rows:
    """Each column's live rows of a task's result, on its device."""
    return batch_rows(task.run())


def host_rows(task) -> Rows:
    """``device_rows`` on the host: each batch's live rows copied there
    as the batch comes, so no result is held on the card."""
    return batch_rows(task.run(), host=True)


def batch_rows(batches, host: bool = False) -> Rows:
    """Each column's live rows of ``batches``, concatenated (on the host
    with ``host``)."""
    from velox_tpu_torch.utils.syncs import nonzero

    def take(t, idx):
        t = t.index_select(0, idx)
        return t.cpu() if host else t

    parts: Dict[str, List[tuple]] = {}
    for b in batches:
        idx = nonzero(b.sel)
        for n, c in b.columns.items():
            parts.setdefault(n, []).append((
                take(c.values, idx),
                None if c.valid is None else take(c.valid, idx)))
    out: Rows = {}
    for n, ps in parts.items():
        vals = torch.cat([v for v, _ in ps])
        valid = (None if all(m is None for _, m in ps) else torch.cat([
            torch.ones_like(v, dtype=torch.bool) if m is None else m
            for v, m in ps]))
        out[n] = (vals, valid)
    return out


def canonical(rows: Rows) -> Rows:
    """The rows sorted by every column (NULLs last within a column)."""
    from velox_tpu_torch.ops.sort import lex_sort

    ops = []
    for v, m in rows.values():
        if m is not None:
            ops.append((~m).to(torch.int8))
            v = torch.where(m, v, torch.zeros_like(v))
        ops.append(v)
    perm = lex_sort(ops)
    return {n: (v.index_select(0, perm),
                None if m is None else m.index_select(0, perm))
            for n, (v, m) in rows.items()}


def same_rows(got: Rows, want: Rows, ordered: bool,
              rtol: float = 1e-9) -> List[str]:
    """The columns where ``got`` differs from ``want`` (empty if none);
    multisets unless ``ordered``."""
    if list(got) != list(want):
        return [f"columns {list(got)} against {list(want)}"]
    if not ordered:
        got, want = canonical(got), canonical(want)
    bad = []
    for n, (wv, wm) in want.items():
        gv, gm = got[n]
        if gv.shape != wv.shape:
            bad.append(f"{n}: {gv.shape[0]} rows, want {wv.shape[0]}")
            continue
        live = (torch.ones_like(wv, dtype=torch.bool) if wm is None else wm)
        gl = (torch.ones_like(gv, dtype=torch.bool) if gm is None else gm)
        if not torch.equal(live, gl):
            bad.append(f"{n}: NULLs differ")
            continue
        if wv.dtype.is_floating_point:
            ok = torch.isclose(gv[live], wv[live], rtol=rtol, atol=0.0,
                               equal_nan=True).all()
        else:
            ok = torch.equal(gv[live], wv[live])
        if not bool(ok):
            bad.append(n)
    return bad
