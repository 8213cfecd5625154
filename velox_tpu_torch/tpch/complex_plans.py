"""Complex types over TPC-H at full width, with numpy oracles computed on
the host from the generated arrays (cents, string codes): the plans of
``chip_smoke.py``'s phase 14.

**P1** (``plan_arrays``): by ``l_orderkey`` (15M groups at SF10, 60M
elements), ``array_agg(l_partkey)``, ``array_agg(l_extendedprice)`` and
``set_agg(l_suppkey)``, then one projection of ``cardinality``,
``array_sum``, ``contains``, ``element_at``, ``array_sort``,
``array_distinct``, ``transform``, ``any_match`` and ``filter`` with a
lambda. **P2** (``plan_unnest``): the prices' arrays unnested WITH
ORDINALITY and summed by ``l_orderkey`` again: the direct sums.
**P3** (``plan_maps``): ``map_agg(l_linenumber, l_quantity)`` by
``l_orderkey``, then ``map_keys``, ``map_values``, ``element_at(m, 1)``
and ``map_filter``. **P4** (``plan_q1_unnest``): Q1's filter,
``array_agg(l_extendedprice)`` by (``l_returnflag``, ``l_linestatus``),
unnest, and the sum by the same keys: Q1's ``sum_base_price``.

Every aggregation here is a hash aggregation (``optimize_plans`` off:
the optimizer would stream an aggregation by the sorted ``l_orderkey``,
and collect aggregates need the hash aggregation). Groups come out in key
order, and the elements of a group in row order (``set_agg``/
``array_distinct``: the first of each value; ``array_sort``: ascending).
Results are read as arrays (``complex_result``): per column the row
lengths and the flat elements in row order, never as Python lists.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: DATE '1998-12-01' - 90 days: Q1's ship date bound
SHIP_Q1 = 10471
#: any_match's threshold on l_extendedprice (dollars; cents above it)
BIG_PRICE = 100000
#: map_filter's threshold on l_quantity
QTY = 25


def plan_arrays(pb):
    return (pb().table_scan("lineitem", ["l_orderkey", "l_partkey",
                                         "l_suppkey", "l_extendedprice"])
            .aggregate(["l_orderkey"], [
                "array_agg(l_partkey) AS pk", "array_agg(l_extendedprice) AS ep",
                "set_agg(l_suppkey) AS sk"])
            .project([
                "l_orderkey", "cardinality(pk) AS n", "array_sum(ep) AS s",
                "contains(sk, 7) AS c7", "element_at(pk, 1) AS first",
                "array_sort(pk) AS spk", "array_distinct(pk) AS dpk",
                "transform(pk, x -> x * 2) AS t2",
                f"any_match(ep, x -> x > {BIG_PRICE}) AS big",
                "filter(pk, x -> x % 2 = 0) AS even", "sk"]))


def plan_unnest(pb):
    return (pb().table_scan("lineitem", ["l_orderkey", "l_extendedprice"])
            .aggregate(["l_orderkey"], ["array_agg(l_extendedprice) AS ep"])
            .unnest(["l_orderkey"], ["ep"], ordinality="o")
            .aggregate(["l_orderkey"], ["sum(ep) AS s", "max(o) AS n"]))


def plan_maps(pb):
    return (pb().table_scan("lineitem", ["l_orderkey", "l_linenumber",
                                         "l_quantity"])
            .aggregate(["l_orderkey"],
                       ["map_agg(l_linenumber, l_quantity) AS m"])
            .project(["l_orderkey", "map_keys(m) AS mk", "map_values(m) AS mv",
                      "element_at(m, 1) AS q1",
                      f"map_filter(m, (k, v) -> v > {QTY}) AS big"]))


def plan_q1_unnest(pb):
    return (pb().table_scan("lineitem", ["l_returnflag", "l_linestatus",
                                         "l_extendedprice", "l_shipdate"])
            .filter("l_shipdate <= DATE '1998-09-02'")
            .aggregate(["l_returnflag", "l_linestatus"],
                       ["array_agg(l_extendedprice) AS ep"])
            .unnest(["l_returnflag", "l_linestatus"], ["ep"])
            .aggregate(["l_returnflag", "l_linestatus"],
                       ["sum(ep) AS sum_base_price", "count(*) AS n"])
            .order_by(["l_returnflag", "l_linestatus"]))


PLANS = {"P1 arrays": plan_arrays, "P2 unnest": plan_unnest,
         "P3 maps": plan_maps, "P4 Q1 unnest": plan_q1_unnest}


# ------------------------------------------------------------- reading

def _canonical(col, idx):
    """An ARRAY or MAP column's selected rows ``idx`` as (lengths, row
    validity, flat lanes in row order): one expansion on the device."""
    from velox_tpu_torch.exec.complex_fns import expand, take
    from velox_tpu_torch.utils.syncs import to_numpy
    from velox_tpu_torch.vector.column import MapColumn

    starts, lengths = take(col.starts, idx), take(col.lengths, idx)
    valid = (torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
             if col.valid is None else take(col.valid, idx))
    ex = expand(starts, lengths, valid)
    lanes = ([col.keys, col.values] if isinstance(col, MapColumn)
             else [col.elements])
    out = []
    for lane in lanes:
        v = to_numpy(take(lane.values, ex.src_idx)[:ex.total])
        m = (None if lane.valid is None
             else to_numpy(take(lane.valid, ex.src_idx)[:ex.total]))
        out.append((v, m))
    return to_numpy(ex.lens), to_numpy(valid), out


def complex_result(plan) -> Dict[str, tuple]:
    """Run ``plan`` (a PlanNode or a Task) and read every column of its
    selected rows: a flat column as ``("flat", values, valid or None)``;
    an ARRAY or MAP column as ``("nested", lengths, row valid, [(values,
    valid or None) per flat lane])``, lanes in row order."""
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.utils.syncs import nonzero, to_numpy
    from velox_tpu_torch.vector.column import COMPLEX_COLUMNS

    task = plan if isinstance(plan, Task) else Task(plan)
    parts: Dict[str, list] = {}
    for b in task.run():
        idx = nonzero(b.sel)
        for n, c in b.columns.items():
            if isinstance(c, COMPLEX_COLUMNS):
                parts.setdefault(n, []).append(("nested",)
                                               + _canonical(c, idx))
            else:
                parts.setdefault(n, []).append((
                    "flat", to_numpy(c.values.index_select(0, idx)),
                    None if c.valid is None
                    else to_numpy(c.valid.index_select(0, idx))))
    out = {}
    for n, ps in parts.items():
        if ps[0][0] == "flat":
            vals = np.concatenate([p[1] for p in ps])
            valid = (None if all(p[2] is None for p in ps) else
                     np.concatenate([np.ones(len(p[1]), bool)
                                     if p[2] is None else p[2] for p in ps]))
            out[n] = ("flat", vals, valid)
            continue
        lanes = []
        for j in range(len(ps[0][3])):
            vs = [p[3][j][0] for p in ps]
            ms = [p[3][j][1] for p in ps]
            lanes.append((np.concatenate(vs), None if all(
                m is None for m in ms) else np.concatenate([
                    np.ones(len(v), bool) if m is None else m
                    for v, m in zip(vs, ms)])))
        out[n] = ("nested", np.concatenate([p[1] for p in ps]),
                  np.concatenate([p[2] for p in ps]), lanes)
    return out


# ------------------------------------------------------------- oracles

def order_runs(li) -> tuple:
    """Lineitem rows in (l_orderkey, row) order: (perm, group starts,
    group counts, the sorted keys' distinct values). The generator writes
    lineitem in order-key order, which spares the sort."""
    ok = li["l_orderkey"].astype(np.int64)
    perm = (np.arange(len(ok)) if np.all(ok[1:] >= ok[:-1])
            else np.argsort(ok, kind="stable"))
    s = ok[perm]
    starts = np.concatenate([[0], np.flatnonzero(s[1:] != s[:-1]) + 1])
    counts = np.diff(np.concatenate([starts, [len(s)]]))
    return perm, starts, counts, s[starts]


def _first_of_each(v, starts, counts):
    """The positions (in order-key order) of each order's first row of
    each distinct ``v``: a row repeats when an earlier row of its order,
    at most ``counts.max() - 1`` back (7 lines an order in TPC-H), holds
    the same value."""
    g = np.repeat(np.arange(len(starts)), counts)
    dup = np.zeros(len(v), bool)
    for d in range(1, int(counts.max())):
        dup[d:] |= (v[d:] == v[:-d]) & (g[d:] == g[:-d])
    return np.flatnonzero(~dup)


def _counts_in(starts, counts, pos) -> np.ndarray:
    """How many of the sorted positions ``pos`` fall in each group."""
    g = np.searchsorted(starts, pos, side="right") - 1
    return np.bincount(g, minlength=len(starts))


def arrays_oracle(li, runs) -> dict:
    """P1's columns, as ``complex_result`` gives them."""
    perm, starts, counts, keys = runs
    ok = li["l_orderkey"].astype(np.int64)
    pk = li["l_partkey"].astype(np.int64)[perm]
    ep = li["l_extendedprice"].astype(np.int64)[perm]
    sk_all = li["l_suppkey"].astype(np.int64)[perm]
    sk_pos = _first_of_each(sk_all, starts, counts)
    sk = sk_all[sk_pos]
    sk_n = _counts_in(starts, counts, sk_pos)
    sk_starts = np.cumsum(sk_n) - sk_n
    sorted_pk = np.sort((ok[perm] << 21) | pk) & ((1 << 21) - 1)
    d_pos = _first_of_each(pk, starts, counts)
    even = pk % 2 == 0
    rows = np.ones(len(keys), bool)

    def nested(lengths, *lanes):
        return ("nested", lengths, rows, [(v, None) for v in lanes])

    return {
        "l_orderkey": ("flat", keys, None),
        "n": ("flat", counts, None),
        "s": ("flat", np.add.reduceat(ep, starts), None),
        "c7": ("flat", np.add.reduceat((sk == 7).astype(np.int64),
                                       sk_starts) > 0, None),
        "first": ("flat", pk[starts], None),
        "spk": nested(counts, sorted_pk),
        "dpk": nested(_counts_in(starts, counts, d_pos), pk[d_pos]),
        "t2": nested(counts, pk * 2),
        "big": ("flat", np.add.reduceat(
            (ep > BIG_PRICE * 100).astype(np.int64), starts) > 0, None),
        "even": nested(np.add.reduceat(even.astype(np.int64), starts),
                       pk[even]),
        "sk": nested(sk_n, sk),
    }


def unnest_oracle(li, runs) -> dict:
    perm, starts, counts, keys = runs
    ep = li["l_extendedprice"].astype(np.int64)[perm]
    return {"l_orderkey": ("flat", keys, None),
            "s": ("flat", np.add.reduceat(ep, starts), None),
            "n": ("flat", counts, None)}


def maps_oracle(li, runs) -> dict:
    perm, starts, counts, keys = runs
    ln = li["l_linenumber"].astype(np.int64)[perm]
    q = li["l_quantity"].astype(np.int64)[perm]
    rows = np.ones(len(keys), bool)
    big = q > QTY * 100
    one = ln == 1
    q1 = np.zeros(len(keys), np.int64)
    has1 = np.add.reduceat(one.astype(np.int64), starts) > 0
    q1[np.searchsorted(starts, np.nonzero(one)[0], side="right") - 1] = q[one]
    return {"l_orderkey": ("flat", keys, None),
            "mk": ("nested", counts, rows, [(ln, None)]),
            "mv": ("nested", counts, rows, [(q, None)]),
            "q1": ("flat", q1, has1),
            "big": ("nested", np.add.reduceat(big.astype(np.int64), starts),
                    rows, [(ln[big], None), (q[big], None)])}


def same_result(got: dict, want: dict) -> list:
    """The names of the columns of ``want`` that ``got`` does not equal
    (row lengths, validity and flat lanes, exactly; a NULL slot's value
    is not compared)."""
    bad = []
    for n, w in want.items():
        g = got.get(n)
        if g is None or g[0] != w[0]:
            bad.append(n)
            continue
        if w[0] == "flat":
            gv, gm = g[1], g[2]
            wm = np.ones(len(w[1]), bool) if w[2] is None else w[2]
            gm = np.ones(len(gv), bool) if gm is None else gm
            if not (len(gv) == len(w[1]) and np.array_equal(gm, wm)
                    and np.array_equal(gv[wm], w[1][wm])):
                bad.append(n)
            continue
        ok = (np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])
              and len(g[3]) == len(w[3]))
        for (gv, gm), (wv, wm) in zip(g[3], w[3]):
            wm = np.ones(len(wv), bool) if wm is None else wm
            gm = np.ones(len(gv), bool) if gm is None else gm
            ok = ok and (len(gv) == len(wv) and np.array_equal(gm, wm)
                         and np.array_equal(gv[wm], wv[wm]))
        if not ok:
            bad.append(n)
    return bad
