"""Distributed execution over TPC-H: the strategy each query takes, the
plan shapes of ``tests/test_parallel.py`` over TPC-H tables (phase 18 of
``chip_smoke.py``, D3), and the comparison of a distributed result with
its serial run.

``STRATEGY`` is the JAX package's record of its distributed runner over
the 22 queries on an 8-device mesh (``DISTRIBUTED_REHEARSAL.json``): 18
run distributed, Q1, Q15, Q21 and Q22 fall back to the serial engine.

``same_result`` holds a distributed result against the serial one: row
for row (DOUBLE to ``RTOL``, the rest exactly) where it can. A query's
rows that tie on every ORDER BY key may come in another order when the
two runs feed the sort in another order (the serial run's merge joins
against the mesh's hash joins), so there the keys are held row for row
and each run of equal keys as a multiset; at a LIMIT's cut, only the
keys (ties at the cut may pick other rows).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

RTOL = 1e-9

#: query -> the strategy of the JAX package's ``run_plan_distributed``
STRATEGY: Dict[int, str] = {
    q: "distributed_pipeline" for q in range(1, 23)}
STRATEGY.update({1: "serial_fallback", 4: "broadcast_semi_join",
                 6: "fused_scan_agg", 15: "serial_fallback",
                 21: "serial_fallback", 22: "serial_fallback"})


def _eq(a, b) -> bool:
    if isinstance(b, float) and isinstance(a, float):
        if a != a or b != b:
            return a != a and b != b
        return abs(a - b) <= RTOL * abs(b)
    return a == b


def _canon(v):
    return float(f"{v:.10g}") if isinstance(v, float) else v


def _sort_key(row) -> tuple:
    return tuple((v is None, str(_canon(v))) for v in row)


def _same_multiset(a: List[tuple], b: List[tuple]) -> bool:
    a, b = sorted(a, key=_sort_key), sorted(b, key=_sort_key)
    return len(a) == len(b) and all(
        all(_eq(x, y) for x, y in zip(ra, rb)) for ra, rb in zip(a, b))


def order_keys(plan) -> Optional[Tuple[List[str], bool]]:
    """The ORDER BY keys at the top of ``plan`` and whether a LIMIT cuts
    the result, or None."""
    from velox_tpu_torch.plan.nodes import LimitNode, OrderByNode, TopNNode

    node, limit = plan, False
    while isinstance(node, LimitNode):
        limit = True
        node = node.source
    if isinstance(node, (OrderByNode, TopNNode)):
        return [k.name for k in node.keys], limit or isinstance(node,
                                                                 TopNNode)
    return None


def same_result(got: dict, want: dict, plan) -> Tuple[str, List[str]]:
    """How ``got`` equals ``want`` ("row for row", "ties reordered" or
    "as a multiset"), and what differs (empty if nothing)."""
    if list(got) != list(want):
        return "", [f"columns {list(got)} against {list(want)}"]
    names = list(want)
    g = list(zip(*[got[n] for n in names])) if names else []
    w = list(zip(*[want[n] for n in names])) if names else []
    if len(g) != len(w):
        return "", [f"{len(g)} rows, want {len(w)}"]
    if all(all(_eq(x, y) for x, y in zip(rg, rw)) for rg, rw in zip(g, w)):
        return "row for row", []
    ok = order_keys(plan)
    if ok is None or not all(k in names for k in ok[0]):
        if _same_multiset(g, w):
            return "as a multiset", []
        return "", ["rows differ as multisets"]
    keys, limit = ok
    ki = [names.index(k) for k in keys]
    for i, (rg, rw) in enumerate(zip(g, w)):
        if not all(_eq(rg[j], rw[j]) for j in ki):
            return "", [f"sort keys differ at row {i}: {rg} against {rw}"]
    lo = 0
    while lo < len(w):
        hi = lo + 1
        while hi < len(w) and all(_eq(w[hi][j], w[lo][j]) for j in ki):
            hi += 1
        cut = limit and hi == len(w)
        if not cut and not _same_multiset(g[lo:hi], w[lo:hi]):
            return "", [f"rows {lo}-{hi - 1} (equal keys) differ"]
        lo = hi
    return "ties reordered", []


# ------------------------------------------------------------ D3 plans

def _orders_customers(pb):
    """Orders with their customer's nation (15M rows at SF10): an inner
    join on a replicated build."""
    return (pb().table_scan("orders", ["o_orderkey", "o_custkey",
                                       "o_totalprice", "o_orderdate"])
            .hash_join(pb().table_scan("customer", ["c_custkey",
                                                    "c_nationkey"]),
                       ["o_custkey"], ["c_custkey"], "inner",
                       output=["o_orderkey", "o_custkey", "o_totalprice",
                               "o_orderdate", "c_nationkey"]))


def _one_day_to_suppliers(pb, jt):
    """One day's lineitems to every supplier: most suppliers ship nothing
    that day, so the right and full joins emit unmatched build rows."""
    return (pb().table_scan("lineitem", ["l_suppkey", "l_extendedprice"],
                            subfilter="l_shipdate = DATE '1995-06-17'")
            .hash_join(pb().table_scan("supplier", ["s_suppkey",
                                                    "s_acctbal"]),
                       ["l_suppkey"], ["s_suppkey"], jt,
                       output=["l_suppkey", "l_extendedprice", "s_suppkey",
                               "s_acctbal"]))


def plan_right(pb):
    return _one_day_to_suppliers(pb, "right")


def plan_full(pb):
    return _one_day_to_suppliers(pb, "full")


def plan_order(pb):
    return _orders_customers(pb).order_by(["o_totalprice", "o_orderkey"])


def plan_order_limit(pb):
    return (_orders_customers(pb).order_by(["o_totalprice DESC",
                                            "o_orderkey"]).limit(100))


def plan_partial_final(pb):
    return (pb().table_scan("lineitem", ["l_partkey", "l_quantity",
                                         "l_extendedprice"])
            .hash_join(pb().table_scan("part", ["p_partkey", "p_size"])
                       .filter("p_size <= 5"),
                       ["l_partkey"], ["p_partkey"], "inner",
                       output=["p_size", "l_quantity", "l_extendedprice"])
            .partial_aggregation(["p_size"], [
                "sum(l_quantity) AS q", "count(*) AS n",
                "max(l_extendedprice) AS hi"])
            .final_aggregation()
            .order_by(["p_size"]))


def plan_window(pb):
    return (_orders_customers(pb)
            .window(["o_custkey"], ["o_orderdate", "o_orderkey"],
                    ["row_number() AS rn", "sum(o_totalprice) AS st"])
            .order_by(["o_orderkey"]))


#: label -> plan maker; each must run distributed
PLANS = {"right join": plan_right, "full join": plan_full,
         "orderby orders": plan_order, "orderby + limit": plan_order_limit,
         "partial/final": plan_partial_final,
         "window by o_custkey": plan_window}
