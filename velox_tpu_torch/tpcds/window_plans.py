"""Window-family plans over TPC-DS ``store_sales``, their numpy oracles,
and the comparison of a plan's result arrays with an oracle's.

* **W1**, the blocking window: partition by ``ss_store_sk``, order by
  ``ss_sold_date_sk, ss_item_sk, ss_customer_sk``; every function the
  window operator evaluates, running aggregates under the default frame,
  a ROWS frame and a RANGE frame over the date key.
* **W2**, the streaming window: partition by ``ss_sold_date_sk`` (the
  table ascends on it, so the optimizer picks ``StreamingWindowNode``),
  ordered by ``ss_ext_sales_price DESC``.
* **W3**, the other operators: TopNRowNumber, RowNumber with a limit,
  MarkDistinct followed by a count, GroupId followed by an aggregation,
  and UnionAll of two filtered scans followed by an aggregation.

Each plan function takes a PlanBuilder class, so the same plan text runs
through either package. Each oracle computes, on the host from the
generated ``store_sales`` arrays, the plan's result columns in the order
the plan emits its rows (arrival order for the windows, RowNumber and
TopNRowNumber, the ORDER BY for the aggregations); ties in a sort resolve
by arrival order, as the engine's stable sort resolves them. Results are
compared as numpy arrays taken from the result batches, never through
Python lists.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

Arrays = Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]

W1_ORDER = ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk"]
W1_FUNCTIONS = [
    "row_number() AS rn", "rank() AS rk", "dense_rank() AS drk",
    "percent_rank() AS prk", "cume_dist() AS cd", "ntile(4) AS nt",
    "lag(ss_quantity) AS lag_q", "lead(ss_quantity) AS lead_q",
    "first_value(ss_ext_sales_price) AS fv",
    "last_value(ss_ext_sales_price) AS lv",
    "nth_value(ss_ext_sales_price, 3) AS nv",
    "sum(ss_ext_sales_price) AS run_sum",
    "avg(ss_ext_sales_price) AS run_avg",
    "min(ss_ext_sales_price) AS run_min",
    "max(ss_ext_sales_price) AS run_max",
    "count(ss_ext_sales_price) AS run_cnt",
    "sum(ss_ext_sales_price) ROWS BETWEEN 6 PRECEDING AND CURRENT ROW"
    " AS sum7",
    "min(ss_ext_sales_price) ROWS BETWEEN 6 PRECEDING AND CURRENT ROW"
    " AS min7",
    "sum(ss_ext_sales_price) RANGE BETWEEN 30 PRECEDING AND CURRENT ROW"
    " AS sum30d",
]


def w1(pb):
    return (pb().table_scan("store_sales", columns=[
        "ss_store_sk", *W1_ORDER, "ss_quantity", "ss_ext_sales_price"])
        .window(["ss_store_sk"], W1_ORDER, W1_FUNCTIONS))


def w2(pb):
    return (pb().table_scan("store_sales", columns=[
        "ss_sold_date_sk", "ss_ext_sales_price"])
        .window(["ss_sold_date_sk"], ["ss_ext_sales_price DESC"],
                ["rank() AS rk", "sum(ss_ext_sales_price) AS run_sum"]))


def w3_top_n(pb):
    return (pb().table_scan("store_sales", columns=[
        "ss_store_sk", "ss_ext_sales_price"])
        .top_n_row_number(["ss_store_sk"], ["ss_ext_sales_price DESC"], 10,
                          "rn"))


def w3_row_number(pb):
    return (pb().table_scan("store_sales", columns=[
        "ss_item_sk", "ss_customer_sk"])
        .row_number(["ss_item_sk"], "rn", limit=3))


def w3_mark_distinct(pb):
    return (pb().table_scan("store_sales", columns=[
        "ss_customer_sk", "ss_store_sk"])
        .mark_distinct("first", ["ss_customer_sk", "ss_store_sk"])
        .filter("first")
        .aggregate([], ["count(*) AS marked"]))


def w3_group_id(pb):
    return (pb().table_scan("store_sales", columns=[
        "ss_store_sk", "ss_promo_sk", "ss_ext_sales_price"])
        .group_id([["ss_store_sk", "ss_promo_sk"], ["ss_store_sk"], []])
        .aggregate(["ss_store_sk", "ss_promo_sk", "group_id"],
                   ["sum(ss_ext_sales_price) AS s", "count(*) AS c"])
        .order_by(["group_id", "ss_store_sk", "ss_promo_sk"]))


def w3_union_all(pb):
    def branch(cond):
        return pb().table_scan("store_sales", columns=[
            "ss_store_sk", "ss_ext_sales_price"], subfilter=cond)

    return (branch("ss_quantity <= 10")
            .union_all([branch("ss_quantity > 90")])
            .aggregate(["ss_store_sk"], ["sum(ss_ext_sales_price) AS s",
                                         "count(*) AS c"])
            .order_by(["ss_store_sk"]))


#: name -> (plan function, the result columns its oracle gives)
PLANS: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {
    "W1": (w1, tuple(f.rsplit(" AS ", 1)[1] for f in W1_FUNCTIONS)),
    "W2": (w2, ("ss_sold_date_sk", "ss_ext_sales_price", "rk",
                "run_sum")),
    "W3 top_n_row_number": (w3_top_n, ("ss_store_sk", "ss_ext_sales_price",
                                       "rn")),
    "W3 row_number": (w3_row_number, ("ss_item_sk", "ss_customer_sk",
                                      "rn")),
    "W3 mark_distinct": (w3_mark_distinct, ("marked",)),
    "W3 group_id": (w3_group_id, ("ss_store_sk", "ss_promo_sk", "group_id",
                                  "s", "c")),
    "W3 union_all": (w3_union_all, ("ss_store_sk", "s", "c")),
}


# ------------------------------------------------------------- oracles

def _segments(head: np.ndarray):
    """(start, end) of each row's segment, given segment heads."""
    n = len(head)
    idx = np.arange(n)
    starts = np.flatnonzero(head)
    seg = np.cumsum(head) - 1
    ends = np.append(starts[1:], n)
    return starts[seg], ends[seg], idx


def _changes(*cols) -> np.ndarray:
    out = np.zeros(len(cols[0]), dtype=bool)
    out[0] = True
    for c in cols:
        out[1:] |= c[1:] != c[:-1]
    return out


def _per_segment(values, head, fn):
    """``fn`` (a running numpy op) applied to each segment on its own."""
    out = np.empty_like(values)
    starts = np.flatnonzero(head)
    for a, b in zip(starts, np.append(starts[1:], len(values))):
        out[a:b] = fn(values[a:b])
    return out


def _ranks(part_head, peer_head):
    ps, pe, idx = _segments(part_head)
    qs, qe, _ = _segments(peer_head)
    heads = np.cumsum(peer_head)
    return ps, pe, qs, qe, idx, heads - heads[ps] + 1


def oracle_w1(ss) -> Arrays:
    store = ss["ss_store_sk"]
    # the four sort keys packed into one int64 (their spans multiply to
    # under 2^63 at every scale the generator makes), sorted stably
    packed = np.zeros(len(store), dtype=np.int64)
    for c in ("ss_store_sk", *W1_ORDER):
        packed = packed * (int(ss[c].max()) + 1) + ss[c]
    perm = np.argsort(packed, kind="stable")
    st = store[perm]
    date = ss["ss_sold_date_sk"][perm]
    qty = ss["ss_quantity"][perm]
    price = ss["ss_ext_sales_price"][perm]
    part = _changes(st)
    peer = part | _changes(date, ss["ss_item_sk"][perm],
                           ss["ss_customer_sk"][perm])
    ps, pe, qs, qe, idx, dense = _ranks(part, peer)
    n = len(idx)
    npart = pe - ps
    rn = idx - ps + 1
    rank = qs - ps + 1
    size, rem = npart // 4, npart % 4
    cut = rem * (size + 1)
    rn0 = rn - 1
    ntile = np.where(rn0 < cut, rn0 // np.maximum(size + 1, 1),
                     rem + (rn0 - cut) // np.maximum(size, 1)) + 1
    last = qe - 1
    run_sum = _per_segment(price, part, np.cumsum)[last]
    cnt = qe - ps
    prev_ok, next_ok = idx - 1 >= ps, idx + 1 < pe
    nth = ps + 2
    sum7 = np.zeros(n)
    min7 = np.full(n, np.inf)
    for k in range(7):
        ok = idx - k >= ps
        v = price[np.maximum(idx - k, 0)]
        sum7 += np.where(ok, v, 0.0)
        min7 = np.where(ok, np.minimum(min7, v), min7)
    sum30 = np.empty(n)
    for a, b in zip(np.flatnonzero(part), np.append(
            np.flatnonzero(part)[1:], n)):
        d = date[a:b]
        pref = np.concatenate([[0.0], np.cumsum(price[a:b])])
        lo = np.searchsorted(d, d - 30, "left")
        hi = np.searchsorted(d, d, "right")
        sum30[a:b] = pref[hi] - pref[lo]
    sorted_cols = {
        "rn": (rn, None), "rk": (rank, None), "drk": (dense, None),
        "prk": (np.where(npart > 1, (rank - 1) / np.maximum(npart - 1, 1),
                         0.0), None),
        "cd": ((qe - ps) / npart, None), "nt": (ntile, None),
        "lag_q": (qty[np.maximum(idx - 1, 0)], prev_ok),
        "lead_q": (qty[np.minimum(idx + 1, n - 1)], next_ok),
        "fv": (price[ps], None), "lv": (price[last], None),
        "nv": (price[np.minimum(nth, n - 1)], nth < qe),
        "run_sum": (run_sum, None), "run_avg": (run_sum / cnt, None),
        "run_min": (_per_segment(price, part, np.minimum.accumulate)[last],
                    None),
        "run_max": (_per_segment(price, part, np.maximum.accumulate)[last],
                    None),
        "run_cnt": (cnt, None), "sum7": (sum7, None), "min7": (min7, None),
        "sum30d": (sum30, None),
    }
    return {k: _to_arrival(v, valid, perm)
            for k, (v, valid) in sorted_cols.items()}


def _to_arrival(values, valid, perm):
    out = np.empty_like(values)
    out[perm] = values
    if valid is None:
        return out, None
    ova = np.empty_like(valid)
    ova[perm] = valid
    return out, ova


def oracle_w2(ss) -> Arrays:
    date = ss["ss_sold_date_sk"]
    price = ss["ss_ext_sales_price"]
    perm = np.lexsort((-price, date))
    d, p = date[perm], price[perm]
    part = _changes(d)
    peer = part | _changes(p)
    ps, _, qs, qe, _, _ = _ranks(part, peer)
    rank = qs - ps + 1
    run_sum = _per_segment(p, part, np.cumsum)[qe - 1]
    return {"ss_sold_date_sk": (date, None), "ss_ext_sales_price":
            (price, None), "rk": _to_arrival(rank, None, perm),
            "run_sum": _to_arrival(run_sum, None, perm)}


def _first_n(key, perm, limit):
    """Rows whose position in their ``key`` partition of the stable sort
    ``perm`` is at most ``limit``: (arrival rows, their row numbers)."""
    k = key[perm]
    ps, _, idx = _segments(_changes(k))
    rn = idx - ps + 1
    keep = rn <= limit
    rows = perm[keep]
    order = np.argsort(rows, kind="stable")
    return rows[order], rn[keep][order]


def oracle_w3_top_n(ss) -> Arrays:
    store, price = ss["ss_store_sk"], ss["ss_ext_sales_price"]
    rows, rn = _first_n(store, np.lexsort((-price, store)), 10)
    return {"ss_store_sk": (store[rows], None),
            "ss_ext_sales_price": (price[rows], None), "rn": (rn, None)}


def oracle_w3_row_number(ss) -> Arrays:
    item = ss["ss_item_sk"]
    rows, rn = _first_n(item, np.argsort(item, kind="stable"), 3)
    return {"ss_item_sk": (item[rows], None),
            "ss_customer_sk": (ss["ss_customer_sk"][rows], None),
            "rn": (rn, None)}


def oracle_w3_mark_distinct(ss) -> Arrays:
    pairs = ss["ss_customer_sk"] * (int(ss["ss_store_sk"].max()) + 1) \
        + ss["ss_store_sk"]
    return {"marked": (np.array([len(np.unique(pairs))]), None)}


def oracle_w3_group_id(ss) -> Arrays:
    store, promo = ss["ss_store_sk"], ss["ss_promo_sk"]
    price = ss["ss_ext_sales_price"]
    span = int(promo.max()) + 1
    pk, inv = np.unique(store * span + promo, return_inverse=True)
    sk, sinv = np.unique(store, return_inverse=True)
    n0, n1 = len(pk), len(sk)
    return {
        "ss_store_sk": (np.concatenate([pk // span, sk, [0]]),
                        np.concatenate([np.ones(n0 + n1, bool), [False]])),
        "ss_promo_sk": (np.concatenate([pk % span, np.zeros(n1 + 1,
                                                            np.int64)]),
                        np.arange(n0 + n1 + 1) < n0),
        "group_id": (np.repeat([0, 1, 2], [n0, n1, 1]), None),
        "s": (np.concatenate([np.bincount(inv, weights=price),
                              np.bincount(sinv, weights=price),
                              [price.sum()]]), None),
        "c": (np.concatenate([np.bincount(inv), np.bincount(sinv),
                              [len(price)]]), None),
    }


def oracle_w3_union_all(ss) -> Arrays:
    qty = ss["ss_quantity"]
    m = (qty <= 10) | (qty > 90)
    sk, inv = np.unique(ss["ss_store_sk"][m], return_inverse=True)
    return {"ss_store_sk": (sk, None),
            "s": (np.bincount(inv, weights=ss["ss_ext_sales_price"][m]),
                  None),
            "c": (np.bincount(inv), None)}


ORACLES = {"W1": oracle_w1, "W2": oracle_w2,
           "W3 top_n_row_number": oracle_w3_top_n,
           "W3 row_number": oracle_w3_row_number,
           "W3 mark_distinct": oracle_w3_mark_distinct,
           "W3 group_id": oracle_w3_group_id,
           "W3 union_all": oracle_w3_union_all}


# ---------------------------------------------------------- comparison

def result_arrays(plan, names) -> Arrays:
    """Run ``plan`` through the port's Task and take ``names`` from its
    result batches as numpy arrays (active rows, in emitted order), with
    validity masks (None where a column has no NULLs)."""
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.plan.builder import PlanBuilder
    from velox_tpu_torch.utils.syncs import nonzero, to_numpy

    if isinstance(plan, PlanBuilder):
        plan = plan.build()
    vals = {n: [] for n in names}
    valid = {n: [] for n in names}
    for b in Task(plan).run():
        idx = nonzero(b.sel)
        for n in names:
            c = b.column(n)
            vals[n].append(to_numpy(c.values.index_select(0, idx)))
            valid[n].append(None if c.valid is None
                            else to_numpy(c.valid.index_select(0, idx)))
    out = {}
    for n in names:
        masks = valid[n]
        if any(m is not None for m in masks):
            mask = np.concatenate([
                np.ones(len(v), bool) if m is None else m
                for v, m in zip(vals[n], masks)])
        else:
            mask = None
        out[n] = (np.concatenate(vals[n]), mask)
    return out


def compare(got: Arrays, want: Arrays, rtol: float = 1e-9) -> Optional[str]:
    """None when ``got`` equals ``want``: the same rows, the same NULLs,
    integer values exactly and floats to ``rtol``; else what differs."""
    for name, (wv, wm) in want.items():
        gv, gm = got[name]
        if len(gv) != len(wv):
            return f"{name}: {len(gv)} rows, want {len(wv)}"
        gmask = np.ones(len(gv), bool) if gm is None else gm
        wmask = np.ones(len(wv), bool) if wm is None else wm
        if not np.array_equal(gmask, wmask):
            bad = np.flatnonzero(gmask != wmask)
            return f"{name}: NULLs differ at {len(bad)} rows, first {bad[0]}"
        g, w = gv[wmask], wv[wmask]
        if np.asarray(w).dtype.kind == "f":
            ok = np.abs(g - w) <= rtol * np.abs(w)
        else:
            ok = g == w
        if not ok.all():
            i = int(np.flatnonzero(~ok)[0])
            return (f"{name}: {int((~ok).sum())} values differ, first at "
                    f"row {i}: {g[i]!r}, want {w[i]!r}")
    return None
