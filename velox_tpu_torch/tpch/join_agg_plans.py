"""The outer, right-semi and filtered joins and the single-argument
aggregates over the TPC-H tables at full width, and their oracles
computed on the host from the generated arrays (cents, string codes).

**J, the join family.** Each plan runs with and without a filter that
reads one column of each side:

* ``full``: orders of 1995 (probe) FULL JOIN the customers of segment
  BUILDING (build) on the customer key, then TPC-DS q97's shape: the
  counts of probe-only, build-only and matched rows (and the sum of the
  build side's ``c_acctbal`` over the rows that carry it); filter
  ``o_totalprice > c_acctbal * 30``;
* ``right``: lineitem shipped in June 1995 (probe; every split holds
  such rows, so the build rows' matched flags are OR-ed over all of
  them) RIGHT JOIN the parts of size below 10 (build) on the part key,
  then per ``p_brand`` the matched and unmatched rows and
  ``sum(l_quantity)``; filter ``l_quantity > p_size * 5``;
* ``right_semi``: the urgent orders RIGHT SEMI JOIN customer: the
  customers who placed an urgent order, counted by segment; filter
  ``o_totalprice > c_acctbal * 30``.

**J-left**: TPC-H Q13 in its SQL form, the ``o_comment NOT LIKE
'%special%requests%'`` predicate in the left join's filter instead of
the orders scan; its rows are Q13's.

**A, the aggregates**: the 14 aggregates beyond sum/count/avg/min/max
over lineitem, grouped by Q1's keys (kArray), by ``l_suppkey`` (generic)
and by ``l_orderkey`` (streaming, where the optimizer picks it), each
grouping in three plans (``AGG_PARTS``) so that the generic mode's
per-split partials stay a few GiB. ``checksum`` has no oracle here: a
caller hashes with its own splitmix64.

The variance family and the moments use the raw power sums and the
extract formulas of the JAX package, which the port copies. Their
oracle (``oracle_aggregates``) applies those formulas to power sums
numpy computes, and gives each value a tolerance: 1e-9 relative plus the
rounding that summing the group's n terms in another order can leave,
as the formula's cancellation amplifies it (``_variance``,
``_moments``): a group whose spread is small against its mean loses
digits in both (a group of equal values has no defined skewness at
all), and a sum of 15M terms in one group (Q1's keys) carries a
relative rounding of up to about n * eps in either. ``geometric_mean``
gets the same bound for its sum of logarithms. ``scipy_agreement``
holds the formulas against scipy's sample statistics on
well-conditioned groups.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

Arrays = Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]

Y1995 = (9131, 9496)        # DATE '1995-01-01', '1996-01-01'
JUNE_1995 = (9282, 9312)    # DATE '1995-06-01', '1995-07-01'
PRICE_FILTER = "o_totalprice > c_acctbal * 30"
QTY_FILTER = "l_quantity > p_size * 5"
EPS = np.finfo(np.float64).eps


# ---------------------------------------------------------------- J plans

def plan_full(pb, filtered: bool):
    customers = (pb().table_scan(
        "customer", columns=["c_custkey", "c_mktsegment", "c_acctbal"],
        subfilter="c_mktsegment = 'BUILDING'")
        .project(["c_custkey", "c_acctbal"]))
    return (
        pb().table_scan(
            "orders", columns=["o_orderkey", "o_custkey", "o_orderdate",
                               "o_totalprice"],
            subfilter="o_orderdate >= DATE '1995-01-01' AND "
                      "o_orderdate < DATE '1996-01-01'")
        .project(["o_orderkey", "o_custkey", "o_totalprice"])
        .hash_join(customers, ["o_custkey"], ["c_custkey"], "full",
                   filter=PRICE_FILTER if filtered else None,
                   output=["o_orderkey", "c_custkey", "c_acctbal"])
        .project([
            "o_orderkey IS NOT NULL AND c_custkey IS NOT NULL AS m",
            "c_custkey IS NULL AS p", "o_orderkey IS NULL AS b",
            "c_acctbal"])
        .aggregate([], ["count_if(m) AS matched", "count_if(p) AS probe_only",
                        "count_if(b) AS build_only", "sum(c_acctbal) AS acct",
                        "count(*) AS row_count"]))


def plan_right(pb, filtered: bool):
    parts = pb().table_scan("part", columns=["p_partkey", "p_brand", "p_size"],
                            subfilter="p_size < 10")
    return (
        pb().table_scan(
            "lineitem", columns=["l_partkey", "l_quantity", "l_shipdate"],
            subfilter="l_shipdate >= DATE '1995-06-01' AND "
                      "l_shipdate < DATE '1995-07-01'")
        .project(["l_partkey", "l_quantity"])
        .hash_join(parts, ["l_partkey"], ["p_partkey"], "right",
                   filter=QTY_FILTER if filtered else None,
                   output=["l_partkey", "l_quantity", "p_brand"])
        .project(["p_brand", "l_partkey IS NOT NULL AS m",
                  "l_partkey IS NULL AS u", "l_quantity"])
        .aggregate(["p_brand"], ["count_if(m) AS matched",
                                 "count_if(u) AS unmatched",
                                 "sum(l_quantity) AS qty"])
        .order_by(["p_brand"]))


def plan_right_semi(pb, filtered: bool):
    customers = pb().table_scan(
        "customer", columns=["c_custkey", "c_mktsegment", "c_acctbal"])
    return (
        pb().table_scan(
            "orders", columns=["o_custkey", "o_orderpriority",
                               "o_totalprice"],
            subfilter="o_orderpriority = '1-URGENT'")
        .project(["o_custkey", "o_totalprice"])
        .hash_join(customers, ["o_custkey"], ["c_custkey"], "right_semi",
                   filter=PRICE_FILTER if filtered else None,
                   output=["c_custkey", "c_mktsegment"])
        .aggregate(["c_mktsegment"], ["count(*) AS customers",
                                      "sum(c_custkey) AS keys"])
        .order_by(["c_mktsegment"]))


def plan_q13_join_filter(pb):
    """TPC-H Q13 with its comment predicate in the left join's filter."""
    orders = pb().table_scan(
        "orders", columns=["o_orderkey", "o_custkey", "o_comment"])
    return (
        pb().table_scan("customer", columns=["c_custkey"])
        .hash_join(orders, ["c_custkey"], ["o_custkey"], "left",
                   filter="o_comment NOT LIKE '%special%requests%'",
                   output=["c_custkey", "o_orderkey"])
        .aggregate(["c_custkey"], ["count(o_orderkey) AS c_count"])
        .aggregate(["c_count"], ["count(*) AS custdist"])
        .order_by(["custdist DESC", "c_count DESC"]))


# ------------------------------------------------------------ J oracles

def _days(a: np.ndarray) -> np.ndarray:
    return a.astype("datetime64[D]").astype(np.int64)


def _lookup(build_keys: np.ndarray, probe_keys: np.ndarray):
    """Each probe key's row in the (unique) build keys, and whether it
    has one."""
    order = np.argsort(build_keys, kind="stable")
    pos = np.searchsorted(build_keys[order], probe_keys)
    pos = np.minimum(pos, len(order) - 1)
    hit = build_keys[order][pos] == probe_keys
    return order[pos], hit


def _dec(cents) -> object:
    import decimal

    return decimal.Decimal(int(cents)).scaleb(-2)


def oracle_full(tables, dicts, filtered: bool, split_rows: int):
    """(rows, kinds): the plan's one row, and the count of each kind of
    row and pair the join makes."""
    o, c = tables["orders"], tables["customer"]
    days = _days(o["o_orderdate"])
    pm = (days >= Y1995[0]) & (days < Y1995[1])
    bm = c["c_mktsegment"] == dicts["c_mktsegment"].index("BUILDING")
    bk, bal = c["c_custkey"][bm], c["c_acctbal"][bm]
    bi, hit = _lookup(bk, o["o_custkey"][pm])
    passing = hit.copy()
    if filtered:
        passing &= o["o_totalprice"][pm] > bal[bi] * 30
    reached = np.zeros(len(bk), bool)
    reached[bi[passing]] = True
    matched = int(passing.sum())
    failed = int((hit & ~passing).sum())
    probe_only = int((~hit).sum()) + failed
    build_only = int((~reached).sum())
    acct = int(bal[bi[passing]].sum()) + int(bal[~reached].sum())
    rows = {"matched": [matched], "probe_only": [probe_only],
            "build_only": [build_only], "acct": [_dec(acct)],
            "row_count": [matched + probe_only + build_only]}
    kinds = {"matched": matched, "probe_only": int((~hit).sum()),
             "build_only": build_only, "resurrected": failed,
             "filtered_out": failed}
    return rows, kinds


def oracle_right(tables, dicts, filtered: bool, split_rows: int):
    li, pa = tables["lineitem"], tables["part"]
    days = _days(li["l_shipdate"])
    prow = np.flatnonzero((days >= JUNE_1995[0]) & (days < JUNE_1995[1]))
    bm = pa["p_size"] < 10
    bk, brand, size = pa["p_partkey"][bm], pa["p_brand"][bm], pa["p_size"][bm]
    bi, hit = _lookup(bk, li["l_partkey"][prow])
    qty = li["l_quantity"][prow]
    passing = hit.copy()
    if filtered:
        passing &= qty > size[bi] * 5 * 100      # l_quantity is in cents
    reached = np.zeros(len(bk), bool)
    reached[bi[passing]] = True
    nb = len(dicts["p_brand"])
    matched = np.bincount(brand[bi[passing]], minlength=nb)
    unmatched = np.bincount(brand[~reached], minlength=nb)
    qsum = np.bincount(brand[bi[passing]], weights=qty[passing],
                       minlength=nb)
    present = np.flatnonzero(np.bincount(brand, minlength=nb))
    rows = {"p_brand": [dicts["p_brand"][b] for b in present],
            "matched": [int(matched[b]) for b in present],
            "unmatched": [int(unmatched[b]) for b in present],
            "qty": [_dec(qsum[b]) if matched[b] else None for b in present]}
    kinds = {"matched": int(passing.sum()),
             "build_only": int((~reached).sum()),
             "filtered_out": int((hit & ~passing).sum()),
             "probe_splits_matched": len(np.unique(
                 prow[passing] // split_rows))}
    return rows, kinds


def oracle_right_semi(tables, dicts, filtered: bool, split_rows: int):
    o, c = tables["orders"], tables["customer"]
    pm = o["o_orderpriority"] == dicts["o_orderpriority"].index("1-URGENT")
    bi, hit = _lookup(c["c_custkey"], o["o_custkey"][pm])
    passing = hit.copy()
    if filtered:
        passing &= o["o_totalprice"][pm] > c["c_acctbal"][bi] * 30
    reached = np.zeros(len(c["c_custkey"]), bool)
    reached[bi[passing]] = True
    seg = c["c_mktsegment"]
    ns = len(dicts["c_mktsegment"])
    count = np.bincount(seg[reached], minlength=ns)
    keys = np.bincount(seg[reached], weights=c["c_custkey"][reached],
                       minlength=ns)
    present = np.flatnonzero(count)
    rows = {"c_mktsegment": [dicts["c_mktsegment"][s] for s in present],
            "customers": [int(count[s]) for s in present],
            "keys": [int(keys[s]) for s in present]}
    kinds = {"matched": int(reached.sum()),
             "build_only": int((~reached).sum()),
             "filtered_out": int((hit & ~passing).sum())}
    return rows, kinds


def q13_kinds(tables, dicts) -> Dict[str, int]:
    """How many customers J-left keeps without an order, how many order
    pairs its filter drops, and how many customers come back because
    every order of theirs failed it."""
    o, c = tables["orders"], tables["customer"]
    pattern = re.compile("special.*requests", re.S)
    bad = np.array([pattern.search(s) is not None
                    for s in dicts["o_comment"]])
    failed = bad[o["o_comment"]]
    n = len(c["c_custkey"]) + 1
    orders = np.bincount(o["o_custkey"], minlength=n)
    passing = np.bincount(o["o_custkey"][~failed], minlength=n)
    keys = c["c_custkey"]
    return {"probe_only": int((orders[keys] == 0).sum()),
            "filtered_out": int(failed.sum()),
            "resurrected": int(((orders[keys] > 0)
                                & (passing[keys] == 0)).sum())}


#: name -> (plan(pb, filtered), oracle(tables, dicts, filtered,
#: split_rows) -> (rows, kinds), the kinds the family must show)
JOINS: Dict[str, Tuple[Callable, Callable, Tuple[str, ...]]] = {
    "full": (plan_full, oracle_full,
             ("matched", "probe_only", "build_only")),
    "right": (plan_right, oracle_right, ("matched", "build_only")),
    "right_semi": (plan_right_semi, oracle_right_semi,
                   ("matched", "build_only")),
}
#: the kinds a filtered form must show besides
FILTERED_KINDS = {"full": ("resurrected", "filtered_out"),
                  "right": ("filtered_out",),
                  "right_semi": ("filtered_out",)}


def run_rows(task) -> Dict[str, list]:
    """A Task's result as ``{column: [values]}`` (``run_plan``'s form)."""
    out: Dict[str, list] = {n: [] for n in task.plan.output_type.names}
    for b in task.run():
        for n, vals in b.to_pydict().items():
            out[n].extend(vals)
    return out


def pushed_filters(task) -> List[str]:
    """What each join probe of a run Task pushed into its scan, as
    ``"<operator> <join type>: <kinds>"``: the kinds of its filters
    (``in_table``, ``in_list``, ``range``, ``bloom``,
    ``nothing_matches``), or ``none``."""
    from velox_tpu_torch.exec.operators import HashProbeOp
    from velox_tpu_torch.expr.ir import Call, Literal

    names = {"__in_table": "in_table", "__bloom_contains": "bloom",
             "in": "in_list", "gte": "range", "lte": "range"}

    def kinds(e, out):
        if isinstance(e, Literal) and e.value is False:
            out.add("nothing_matches")
        if isinstance(e, Call):
            if e.name in names:
                out.add(names[e.name])
            for a in e.args:
                kinds(a, out)
        return out

    found = []
    for p in task.planner.pipelines:
        for op in p.operators:
            if not isinstance(op, HashProbeOp):
                continue
            got = set()
            if op.pushdown_scan is not None:
                for ev in op.pushdown_scan.dynamic_filters:
                    for e in ev.exprs:
                        kinds(e, got)
            found.append(f"{type(op).__name__} {op.jt.value}: "
                         f"{'+'.join(sorted(got)) or 'none'}")
    return found


def aggregation_mode(task) -> str:
    """Which aggregation a run Task used: kArray, generic or streaming."""
    from velox_tpu_torch.exec.fused import FusedScanAggOp
    from velox_tpu_torch.exec.operators import (
        HashAggregationOp, StreamingAggregationOp,
    )

    for p in task.planner.pipelines:
        for op in p.operators:
            if isinstance(op, FusedScanAggOp):
                op = op.agg
            if isinstance(op, StreamingAggregationOp):
                return "streaming"
            if isinstance(op, HashAggregationOp):
                return {"array": "kArray"}.get(op._mode, op._mode)
    return "none"


# ---------------------------------------------------------------- A plans

GROUPINGS = {"q1_keys": ["l_returnflag", "l_linestatus"],
             "suppkey": ["l_suppkey"], "orderkey": ["l_orderkey"]}

#: three plans a grouping; each aggregate is (name, function, argument)
AGG_PARTS: Dict[str, List[Tuple[str, str, str]]] = {
    "variance": [
        ("n_disc", "count_if", "disc"),
        ("var_price", "variance", "price"),
        ("vs_qty", "var_samp", "qty"),
        ("vp_price", "var_pop", "price"),
        ("sd_qty", "stddev", "qty"),
        ("ss_price", "stddev_samp", "price"),
        ("sp_qty", "stddev_pop", "qty")],
    "misc": [
        ("all_early", "bool_and", "early"),
        ("any_early", "bool_or", "early"),
        ("arb_part", "arbitrary", "l_partkey"),
        ("arb_mode", "arbitrary", "l_shipmode"),
        ("ck_key", "checksum", "l_orderkey"),
        ("ck_price", "checksum", "price"),
        ("gm_qty", "geometric_mean", "l_quantity")],
    "moments": [
        ("sk_price", "skewness", "price"),
        ("sk_qty", "skewness", "qty"),
        ("ku_price", "kurtosis", "price"),
        ("ku_qty", "kurtosis", "qty")],
}

AGG_ARGS = {
    "price": "CAST(l_extendedprice AS DOUBLE) AS price",
    "qty": "CAST(l_quantity AS DOUBLE) AS qty",
    "disc": "l_discount > 0.05 AS disc",
    "early": "l_shipdate < l_commitdate AS early",
    "l_partkey": "l_partkey", "l_shipmode": "l_shipmode",
    "l_orderkey": "l_orderkey", "l_quantity": "l_quantity",
}


def plan_aggregates(pb, grouping: str, part: str, skip=()):
    """One part's aggregates by one grouping (but the names in ``skip``)."""
    keys = GROUPINGS[grouping]
    aggs = [a for a in AGG_PARTS[part] if a[0] not in skip]
    args = list(dict.fromkeys(a for _, _, a in aggs))
    # the raw columns each projected argument reads
    cols = {"price": ["l_extendedprice"], "qty": ["l_quantity"],
            "disc": ["l_discount"], "early": ["l_shipdate", "l_commitdate"]}
    scan = list(dict.fromkeys(keys + [c for a in args
                                      for c in cols.get(a, [a])]))
    proj = list(dict.fromkeys(keys + [AGG_ARGS[a] for a in args]))
    return (pb().table_scan("lineitem", columns=scan).project(proj)
            .aggregate(keys, [f"{f}({a}) AS {n}" for n, f, a in aggs]))


# ------------------------------------------------------------ A oracles

def group_rows(li, grouping: str):
    """(perm, starts, keys): the rows in key order, each group's first
    position in that order, and each group's key columns."""
    cols = [li[k] for k in GROUPINGS[grouping]]
    key = cols[0].astype(np.int64)
    for c in cols[1:]:
        key = key * (int(c.max()) + 1) + c
    if np.all(key[1:] >= key[:-1]):
        perm = np.arange(len(key))
    elif key.min() >= 0 and key.max() < 1 << 32:
        # two stable radix passes of 16 bits (numpy radix-sorts 16-bit
        # keys), low half first
        perm = np.argsort((key & 0xFFFF).astype(np.uint16), kind="stable")
        perm = perm[np.argsort((key[perm] >> 16).astype(np.uint16),
                               kind="stable")]
    else:
        perm = np.argsort(key, kind="stable")
    ks = key[perm]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    return perm, starts, {k: c[perm[starts]]
                          for k, c in zip(GROUPINGS[grouping], cols)}


def agg_arguments(li) -> Dict[str, np.ndarray]:
    """Each argument as the port's projection makes it (the DOUBLE casts
    divide the cents by 100)."""
    return {
        "price": li["l_extendedprice"] / 100.0,
        "qty": li["l_quantity"] / 100.0,
        "disc": li["l_discount"] > 5,
        "early": _days(li["l_shipdate"]) < _days(li["l_commitdate"]),
        "l_partkey": li["l_partkey"], "l_shipmode": li["l_shipmode"],
        "l_orderkey": li["l_orderkey"], "l_quantity": li["l_quantity"],
    }


def _power_sums(v: np.ndarray, perm, starts):
    """Each group's row count, sums of v, v^2, v^3, v^4 (multiplied as
    the port multiplies) and sum of |v|^3."""
    vs = v[perm].astype(np.float64)
    n = np.diff(np.r_[starts, len(vs)])
    v2 = vs * vs
    v3 = v2 * vs
    sums = [np.add.reduceat(p, starts) for p in (vs, v2, v3, v2 * v2)]
    return n, sums, np.add.reduceat(np.abs(v3), starts)


def _variance(n, s, ss, sample: bool, stddev: bool):
    """The JAX package's extract, formula for formula, and the bound on
    the rounding its cancellation can amplify."""
    nf = n.astype(np.float64)
    safe = np.maximum(nf, 1.0)
    m2 = ss - s * s / safe
    denom = np.maximum(nf - 1.0, 1.0) if sample else safe
    var = np.maximum(m2, 0.0) / denom
    err = 8 * nf * EPS * (ss + s * s / safe) / denom
    if stddev:
        out = np.sqrt(var)
        with np.errstate(divide="ignore"):
            err = err / (2 * out)
    else:
        out = var
    return out, n >= (2 if sample else 1), err


def _moments(n, s1, s2, s3, s4, a3, kurt: bool):
    nf = np.maximum(n.astype(np.float64), 1.0)
    m = s1 / nf
    m2 = np.maximum(s2 / nf - m * m, 0.0)
    m3 = s3 / nf - 3 * m * s2 / nf + 2 * (m * (m * m))
    m4 = (s4 / nf - 4 * m * s3 / nf + 6 * m * m * s2 / nf
          - 3 * ((m * m) * (m * m)))
    sd = np.sqrt(np.maximum(m2, 1e-300))
    nn = nf
    # each central moment's rounding: the magnitudes of the terms that
    # cancel, times the rounding of n-term sums
    e = 8 * nf * EPS
    e2 = e * (s2 / nf + m * m)
    am = np.abs(m)
    with np.errstate(divide="ignore", invalid="ignore"):
        if kurt:
            e4 = e * (s4 / nf + 4 * am * a3 / nf + 6 * m * m * s2 / nf
                      + 3 * m ** 4)
            g2 = m4 / np.maximum(m2 * m2, 1e-300) - 3.0
            f = (nn - 1) / np.maximum((nn - 2) * (nn - 3), 1.0)
            out = f * ((nn + 1) * g2 + 6)
            err = f * (nn + 1) * (e4 / (m2 * m2)
                                  + 2 * np.abs(g2 + 3.0) * e2 / m2)
            ok = n >= 4
        else:
            e3 = e * (a3 / nf + 3 * am * s2 / nf + 2 * am ** 3)
            g1 = m3 / np.maximum(sd * (sd * sd), 1e-300)
            f = np.sqrt(np.maximum(nn * (nn - 1), 0.0)) / np.maximum(
                nn - 2, 1.0)
            out = f * g1
            err = f * (e3 / (sd * (sd * sd)) + 1.5 * np.abs(g1) * e2 / m2)
            ok = n >= 3
    err = np.where(np.isnan(err), np.inf, err)
    return out, ok, err


def oracle_aggregates(li, grouping: str, args=None, parts=None):
    """``{name: (values, mask, err)}`` for every aggregate of ``parts``
    but ``checksum`` (``err``: the absolute tolerance beyond 1e-9
    relative, None where the value must be exact), with the group keys,
    in key order; and ``(perm, starts)``. ``args``: ``agg_arguments(li)``
    when the caller has them."""
    perm, starts, keys = group_rows(li, grouping)
    if args is None:
        args = agg_arguments(li)
    out = {k: (v, None, None) for k, v in keys.items()}
    moments = {}

    def sums(a):
        if a not in moments:
            moments[a] = _power_sums(args[a], perm, starts)
        return moments[a]

    for part in parts or AGG_PARTS:
        for name, fn, a in AGG_PARTS[part]:
            if fn == "checksum":
                continue
            if fn == "count_if":
                out[name] = (np.add.reduceat(args[a][perm].astype(np.int64),
                                             starts), None, None)
            elif fn in ("bool_and", "bool_or"):
                red = np.logical_and if fn == "bool_and" else np.logical_or
                out[name] = (red.reduceat(args[a][perm], starts), None, None)
            elif fn == "arbitrary":
                out[name] = (np.maximum.reduceat(args[a][perm], starts),
                             None, None)
            elif fn == "geometric_mean":
                v = args[a][perm].astype(np.float64)
                ok = v > 0
                cnt = np.add.reduceat(ok.astype(np.int64), starts)
                logs = np.where(ok, np.log(np.maximum(v, 1e-300)), 0.0)
                sl = np.add.reduceat(logs, starts)
                mean = sl / np.maximum(cnt, 1)
                gm = np.exp(mean)
                # the rounding of an n-term sum of logs, through exp
                mag = np.add.reduceat(np.abs(logs), starts)
                out[name] = (gm, cnt > 0, gm * 8 * cnt * EPS * mag
                             / np.maximum(cnt, 1))
            elif fn in ("skewness", "kurtosis"):
                n, (s1, s2, s3, s4), a3 = sums(a)
                out[name] = _moments(n, s1, s2, s3, s4, a3,
                                     fn == "kurtosis")
            else:
                n, (s, ss, _, _), _ = sums(a)
                out[name] = _variance(n, s, ss, fn in (
                    "variance", "var_samp", "stddev", "stddev_samp"),
                    fn.startswith("stddev"))
    return out, (perm, starts)


def scipy_agreement(args, perm, starts, groups: int = 200) -> float:
    """The largest relative difference, over the first ``groups`` groups
    of at least 4 rows (``perm``, ``starts``: ``group_rows``), between
    the extract formulas (``_variance``, ``_moments``) and numpy's
    ``var``/``std`` with ``ddof`` and scipy's ``skew``/``kurtosis`` with
    ``bias=False`` (sample statistics) over ``args`` (``agg_arguments``)
    of the DOUBLE price and quantity. Skewness and kurtosis are numbers
    of order 1 that may lie near 0: their difference is taken relative
    to at least 1."""
    import scipy.stats as st

    ends = np.r_[starts[1:], len(perm)]
    pick = np.flatnonzero(ends - starts >= 4)[:groups]
    worst = 0.0
    for a in ("price", "qty"):
        v = args[a][perm]
        n, (s1, s2, s3, s4), a3 = _power_sums(v, np.arange(len(v)),
                                              starts)
        ours = {
            "var": _variance(n, s1, s2, True, False)[0],
            "var_pop": _variance(n, s1, s2, False, False)[0],
            "std": _variance(n, s1, s2, True, True)[0],
            "skew": _moments(n, s1, s2, s3, s4, a3, False)[0],
            "kurt": _moments(n, s1, s2, s3, s4, a3, True)[0]}
        for g in pick:
            x = v[starts[g]:ends[g]]
            if np.ptp(x) == 0:
                continue
            ref = {"var": np.var(x, ddof=1), "var_pop": np.var(x, ddof=0),
                   "std": np.std(x, ddof=1),
                   "skew": st.skew(x, bias=False),
                   "kurt": st.kurtosis(x, bias=False)}
            for k, r in ref.items():
                scale = max(abs(r), 1.0 if k in ("skew", "kurt") else 1e-300)
                worst = max(worst, abs(ours[k][g] - r) / scale)
    return worst


def check_aggregates(got, want, keys) -> Tuple[Optional[str], Dict]:
    """None when ``got`` (``result_columns`` of a plan, rows in any order)
    equals ``want`` (``oracle_aggregates``): keys, integers, booleans,
    string codes and NULL masks exactly, floats to 1e-9 relative plus
    their ``err``; and per float column its largest relative error and
    how many values needed more than 1e-9."""
    order = np.lexsort([got[k][0] for k in reversed(keys)])
    stats = {}
    for name, (wv, wm, err) in want.items():
        if name not in got:
            continue
        gv, gm = got[name][0][order], got[name][1]
        gm = None if gm is None else gm[order]
        if len(gv) != len(wv):
            return f"{name}: {len(gv)} rows, want {len(wv)}", stats
        gmask = np.ones(len(gv), bool) if gm is None else gm
        wmask = np.ones(len(wv), bool) if wm is None else wm
        if not np.array_equal(gmask, wmask):
            return (f"{name}: NULLs differ at "
                    f"{int((gmask != wmask).sum())} rows"), stats
        g, w = gv[wmask], wv[wmask]
        if err is None:
            bad = np.flatnonzero(g != w)
        else:
            e = err[wmask]
            with np.errstate(invalid="ignore"):
                diff = np.abs(g - w)
                rel = diff / np.maximum(np.abs(w), 1e-300)
                ok = diff <= 1e-9 * np.abs(w) + e
                ok |= (g == w) | (np.isnan(g) & np.isnan(w))
            bad = np.flatnonzero(~ok)
            finite = np.isfinite(rel)
            stats[name] = {
                "max_rel_err": float(rel[finite].max()) if finite.any()
                else 0.0,
                "over_1e-9": int((finite & (rel > 1e-9)).sum())}
        if len(bad):
            i = int(bad[0])
            return (f"{name}: {len(bad)} values differ, first {g[i]!r}, "
                    f"want {w[i]!r}"), stats
    return None, stats
