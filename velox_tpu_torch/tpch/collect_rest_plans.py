"""The last collect aggregates, the page form, session time zones and the
filter classes over TPC-H at full width, with numpy oracles computed on
the host from the generated arrays: the plans of ``chip_smoke.py``'s
phase 15.

**K** (``plan_kinds``): by Q1's keys (``l_returnflag``, ``l_linestatus``)
and by ``l_suppkey % 1000``, ``approx_most_frequent(3, l_linenumber)``,
``numeric_histogram(10, l_partkey)``, ``vector_sum`` of
``[l_linenumber, l_suppkey % 10]``, ``reservoir_sample(l_partkey, 5)``,
``classification_precision``/``_fall_out`` of ``l_linenumber > 3`` at
the prediction ``(l_partkey % 1000) / 1000.0`` in 10 buckets, and
``reduce_agg`` of ``l_partkey`` with a sum and a max lambda.
**T** (``plan_two_step``): ``array_agg(l_linenumber)`` and
``map_agg(l_linenumber, l_suppkey)`` by ``l_orderkey % 100000`` through
the PARTIAL/FINAL page form. **Z** (``plan_zone``): orders' dates as
timestamps (plus ``o_orderkey % 86400`` seconds) read under the session
zone America/Los_Angeles: ``hour``, ``minute``, ``timezone_hour``,
``at_timezone(ts, 'Asia/Kolkata')``. Its oracle applies the US daylight
rule of 1987-2006 directly (first Sunday of April to the last Sunday of
October, 2:00 local), not a zone file. **F** (``filter_cases``): every
filter class over ``l_quantity`` and ``l_shipdate`` against numpy's
comparisons.

Every aggregation is a hash aggregation (``optimize_plans`` off).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

GROUPINGS = {"q1": ["l_returnflag", "l_linestatus"],
             "supp1000": ["l_suppkey % 1000 AS s"]}
#: approx_most_frequent's k, numeric_histogram's and classification's
#: buckets, reservoir_sample's k
MF_K, NH_B, CL_B, RS_K = 3, 10, 10, 5
#: page-form groups
ORDER_MOD = 100_000
ZONE = "America/Los_Angeles"
US_DAY = 86_400_000_000
US_HOUR = 3_600_000_000

KIND_AGGS = [
    f"approx_most_frequent({MF_K}, l_linenumber) AS mf",
    f"numeric_histogram({NH_B}, l_partkey) AS nh",
    "vector_sum(array_constructor(l_linenumber, l_suppkey % 10)) AS vs",
    f"reservoir_sample(l_partkey, {RS_K}) AS rs",
    f"classification_precision({CL_B}, l_linenumber > 3, "
    "CAST(l_partkey % 1000 AS DOUBLE) / 1000.0) AS cp",
    f"classification_fall_out({CL_B}, l_linenumber > 3, "
    "CAST(l_partkey % 1000 AS DOUBLE) / 1000.0) AS cf",
    "reduce_agg(l_partkey, 0, (a, b) -> a + b) AS rsum",
    "reduce_agg(l_partkey, 0, (a, b) -> if(a > b, a, b)) AS rmax",
    "count(*) AS n"]


def plan_kinds(pb, grouping: str):
    return (pb().table_scan("lineitem", [
        "l_returnflag", "l_linestatus", "l_suppkey", "l_linenumber",
        "l_partkey"]).aggregate(GROUPINGS[grouping], KIND_AGGS))


def plan_two_step(pb, kind: str):
    agg = ("array_agg(l_linenumber) AS a" if kind == "array"
           else "map_agg(l_linenumber, l_suppkey) AS a")
    return (pb().table_scan("lineitem", ["l_orderkey", "l_linenumber",
                                         "l_suppkey"])
            .partial_aggregation([f"l_orderkey % {ORDER_MOD} AS o"], [agg])
            .final_aggregation())


def plan_zone(pb):
    return (pb().table_scan("orders", ["o_orderkey", "o_orderdate"])
            .project(["date_add('second', o_orderkey % 86400, "
                      "CAST(o_orderdate AS TIMESTAMP)) AS ts"])
            .project(["hour(ts) AS h", "minute(ts) AS mi",
                      "timezone_hour(ts) AS th",
                      "at_timezone(ts, 'Asia/Kolkata') AS k"]))


# ----------------------------------------------------------- oracles

def group_ids(li, grouping: str) -> tuple:
    """(group id a row, group count): groups in key order, as the hash
    aggregation emits them (string keys by their sorted values)."""
    if grouping == "q1":
        # the dictionaries are sorted, so codes order as the strings do
        comb = (li["l_returnflag"].astype(np.int64) * 64
                + li["l_linestatus"].astype(np.int64))
    else:
        comb = li["l_suppkey"].astype(np.int64) % 1000
    present = np.bincount(comb) > 0
    return (np.cumsum(present) - 1)[comb], int(present.sum())


def _chunked(fn, n: int, parts: int = 8) -> list:
    """``fn(rows)`` over ``parts`` slices of ``n`` rows, in threads
    (numpy releases the interpreter lock in its passes)."""
    from concurrent.futures import ThreadPoolExecutor

    bounds = np.linspace(0, n, parts + 1).astype(np.int64)
    with ThreadPoolExecutor(parts) as pool:
        return list(pool.map(lambda i: fn(slice(bounds[i], bounds[i + 1])),
                             range(parts)))


def kinds_oracle(li, grouping: str) -> Dict[str, list]:
    """Per group, in key order: each aggregate's expected value (lists of
    (key, value) pairs for a map, lists for an array; the reservoir
    sample's size). Counts, integer sums and extremes are exact (the
    float64 sums hold integers below 2^53); one pass over row slices,
    then a second for the histogram's buckets, which need each group's
    extremes."""
    g, G = group_ids(li, grouping)
    ln, pk, sk = li["l_linenumber"], li["l_partkey"], li["l_suppkey"]
    big = np.iinfo(np.int64)

    def first(rows):
        gs, k = g[rows], pk[rows].astype(np.int64)
        lines = ln[rows].astype(np.int64)
        cnt = np.bincount(gs, minlength=G)
        live = cnt > 0
        order = np.argsort(gs.astype(np.int16), kind="stable")
        at = (np.cumsum(cnt) - cnt)[live]
        lo, hi = np.full(G, big.max), np.full(G, big.min)
        lo[live] = np.minimum.reduceat(k[order], at)
        hi[live] = np.maximum.reduceat(k[order], at)
        p = (k % 1000).astype(np.float64) / 1000.0
        cb = np.minimum(np.maximum(np.floor(p * float(CL_B)), 0),
                        CL_B - 1).astype(np.int64)
        key = gs * CL_B + cb
        return {"n": cnt, "lo": lo, "hi": hi,
                "mf": np.bincount(gs * 8 + lines, minlength=G * 8),
                "vs_l": np.bincount(gs, weights=lines, minlength=G),
                "vs_s": np.bincount(gs, weights=sk[rows] % 10, minlength=G),
                "tw": np.bincount(key, weights=lines > 3,
                                  minlength=G * CL_B),
                "fw": np.bincount(key, weights=lines <= 3,
                                  minlength=G * CL_B),
                "rsum": np.bincount(gs, weights=k, minlength=G)}

    parts = _chunked(first, len(g))
    tot = {k: sum(p[k] for p in parts)
           for k in ("n", "mf", "vs_l", "vs_s", "tw", "fw", "rsum")}
    lo = np.minimum.reduce([p["lo"] for p in parts])
    hi = np.maximum.reduce([p["hi"] for p in parts])
    counts = tot["n"]
    out: Dict[str, list] = {"n": counts.tolist()}
    mf = []
    for row in tot["mf"].reshape(G, 8):
        vals = [(v, int(row[v])) for v in range(8) if row[v] > 0]
        vals.sort(key=lambda vc: (-vc[1], vc[0]))
        mf.append(vals[:MF_K])
    out["mf"] = mf

    gmin, gmax = lo.astype(np.float64), hi.astype(np.float64)

    def second(rows):
        gs = g[rows]
        x = pk[rows].astype(np.float64)
        low = gmin[gs]
        span = gmax[gs] - low
        pos = span > 0
        rel = np.where(pos, (x - low) / np.where(pos, span, 1.0), 0.0)
        b = float(NH_B)
        key = gs * NH_B + np.minimum(np.maximum(np.floor(rel * b), 0),
                                     b - 1).astype(np.int64)
        return (np.bincount(key, minlength=G * NH_B),
                np.bincount(key, weights=x, minlength=G * NH_B))

    hist = _chunked(second, len(g))
    cnt = sum(h[0] for h in hist).reshape(G, -1)
    sums = sum(h[1] for h in hist).reshape(G, -1)
    out["nh"] = [[(sums[i, j] / cnt[i, j], float(cnt[i, j]))
                  for j in range(NH_B) if cnt[i, j] > 0] for i in range(G)]
    out["vs"] = [[int(a), int(s)] for a, s in zip(tot["vs_l"],
                                                   tot["vs_s"])]
    out["rs_size"] = np.minimum(counts, RS_K).tolist()
    tw, fw = tot["tw"].reshape(G, -1), tot["fw"].reshape(G, -1)
    tp = np.cumsum(tw[:, ::-1], axis=1)[:, ::-1]
    fp = np.cumsum(fw[:, ::-1], axis=1)[:, ::-1]
    tn = fw.sum(axis=1, keepdims=True) - fp
    with np.errstate(divide="ignore", invalid="ignore"):
        out["cp"] = np.nan_to_num(tp / (tp + fp), nan=0.0).tolist()
        out["cf"] = np.nan_to_num(fp / (fp + tn), nan=0.0).tolist()
    out["rsum"] = [int(v) for v in tot["rsum"]]
    out["rmax"] = [int(v) for v in hi]
    return out


def two_step_oracle(li, kind: str) -> tuple:
    """(lengths a group, flat keys, flat values or None) by
    ``l_orderkey % ORDER_MOD`` ascending: array_agg's elements in row
    order; map_agg's first value of each key, in the order the keys first
    appear. Lineitem holds each order's lines together, numbered from 1,
    so the work is per order: the orders sorted by group, then expanded
    to their lines."""
    okey = li["l_orderkey"].astype(np.int64)
    ln = li["l_linenumber"].astype(np.int64)
    head = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
    lines = np.diff(np.r_[head, len(okey)])
    o = okey[head] % ORDER_MOD
    order = np.argsort(o, kind="stable")
    og, starts, c = o[order], head[order], lines[order]
    groups, first = np.unique(og, return_index=True)
    if kind == "array":
        idx = np.repeat(starts, c) + (np.arange(int(c.sum()))
                                      - np.repeat(np.cumsum(c) - c, c))
        return np.bincount(og, weights=c, minlength=ORDER_MOD).astype(
            np.int64)[groups], ln[idx], None
    # a key is new where an order has more lines than every earlier order
    # of its group: its new keys run from that maximum + 1 to its count
    run = np.maximum.accumulate(og * 8 + c) - og * 8
    prev = np.r_[0, run[:-1]]
    prev[first] = 0
    new = np.maximum(c - prev, 0)
    keys = np.repeat(prev, new) + (np.arange(int(new.sum()))
                                   - np.repeat(np.cumsum(new) - new, new)) + 1
    rows = np.repeat(starts, new) + keys - 1
    return (run[np.r_[first[1:], len(og)] - 1], keys,
            li["l_suppkey"].astype(np.int64)[rows])


def _us_dst(ts_us: np.ndarray) -> np.ndarray:
    """Whether US daylight time (1987-2006 rule) is in force at each UTC
    instant: from the first Sunday of April, 2:00 standard time (10:00
    UTC), to the last Sunday of October, 2:00 daylight time (09:00
    UTC)."""
    days = ts_us // US_DAY
    years = (np.datetime64("1970-01-01") + days.astype("timedelta64[D]")
             ).astype("datetime64[Y]").astype(np.int64) + 1970
    out = np.zeros(len(ts_us), bool)
    for y in np.unique(years):
        apr1 = (np.datetime64(f"{y}-04-01") - np.datetime64("1970-01-01")
                ).astype(np.int64)
        start = apr1 + (3 - apr1) % 7          # 1970-01-04 was a Sunday
        nov1 = (np.datetime64(f"{y}-11-01") - np.datetime64("1970-01-01")
                ).astype(np.int64)
        end = nov1 - 1 - (nov1 - 1 - 3) % 7    # the last Sunday of October
        lo = start * US_DAY + 10 * US_HOUR
        hi = end * US_DAY + 9 * US_HOUR
        m = years == y
        out[m] = (ts_us[m] >= lo) & (ts_us[m] < hi)
    return out


def zone_oracle(orders) -> Dict[str, np.ndarray]:
    ts = (orders["o_orderdate"].astype(np.int64) * US_DAY
          + (orders["o_orderkey"].astype(np.int64) % 86400) * 1_000_000)
    off = np.where(_us_dst(ts), -7, -8) * US_HOUR
    local = ts + off
    return {"h": (local // US_HOUR) % 24,
            "mi": (local // 60_000_000) % 60,
            "th": off // US_HOUR,
            "k": ts + 5 * US_HOUR + 30 * 60_000_000}


def filter_cases(F):
    """(name, filter, column, numpy test of the column's values) for
    every filter class, over ``l_quantity`` (cents) and ``l_shipdate``
    (days)."""
    return [
        ("AlwaysTrue", F.AlwaysTrue(), "l_quantity",
         lambda v: np.ones(len(v), bool)),
        ("AlwaysFalse", F.AlwaysFalse(), "l_quantity",
         lambda v: np.zeros(len(v), bool)),
        ("IsNull", F.IsNull(), "l_shipdate", None),
        ("IsNotNull", F.IsNotNull(), "l_shipdate", None),
        ("BigintRange", F.BigintRange(lower=1000, upper=2500),
         "l_quantity", lambda v: (v >= 1000) & (v <= 2500)),
        ("NegatedBigintRange", F.NegatedBigintRange(lower=9000, upper=9500),
         "l_shipdate", lambda v: (v < 9000) | (v > 9500)),
        ("DoubleRange", F.DoubleRange(lower=10.0, lower_exclusive=True,
                                      upper=20.0), "l_quantity",
         lambda v: (v / 100.0 > 10.0) & (v / 100.0 <= 20.0)),
        ("BigintValuesUsingHashTable",
         F.BigintValuesUsingHashTable(values=(100, 700, 5000)),
         "l_quantity", lambda v: np.isin(v, (100, 700, 5000))),
        ("MultiRange", F.MultiRange(filters=(
            F.BigintRange(lower=8100, upper=8200),
            F.BigintRange(lower=10000, upper=10100))), "l_shipdate",
         lambda v: ((v >= 8100) & (v <= 8200))
         | ((v >= 10000) & (v <= 10100))),
    ]
