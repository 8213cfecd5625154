"""Numpy answers of TPC-H Q2, Q4, Q5, Q7-Q17 and Q19-Q22 over the
generator's own arrays (``io/tpch.py``: money in int64 cents, strings as
codes into the returned value lists, keys dense from 1).

These are the oracles ``chip_smoke.py`` holds the card's results against
at SF10. They share no code with the engine: each query is written out in
plain numpy on the host, joins as lookups by dense key, with the
engine's result types (``decimal.Decimal`` at the plan's scale, ``str``,
``datetime.date``, ``int``, ``float``) and row order, ties included (a
top-N or ORDER BY keeps the order its input arrived in). Decimal
arithmetic follows the JAX package: ``l_extendedprice * (1.0 -
l_discount)`` is exact at scale 4, a decimal average rounds half away
from zero, a decimal times a DOUBLE literal stays decimal (the literal
becomes one), a decimal divided by one truncates, and a CASE that mixes a
decimal with a DOUBLE literal is DOUBLE. ``answer(q, tables,
dictionaries, sf)`` gives Q{q}'s columns as lists, as ``run_plan`` does.
"""

from __future__ import annotations

import datetime
import decimal
import re
from typing import Dict, List

import numpy as np

_EPOCH = datetime.date(1970, 1, 1)
_CTX = decimal.Context(prec=38)


def _days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


def _dec(unscaled, scale: int) -> decimal.Decimal:
    return decimal.Decimal(int(unscaled)).scaleb(-scale, _CTX)


def _date(days) -> datetime.date:
    return _EPOCH + datetime.timedelta(days=int(days))


def _day(a: np.ndarray) -> np.ndarray:
    return a.astype("datetime64[D]").astype(np.int64)


def _year(a: np.ndarray) -> np.ndarray:
    return a.astype("datetime64[Y]").astype(np.int64) + 1970


class _Strings:
    """A string column: its codes and the value list they index."""

    def __init__(self, codes: np.ndarray, values: List[str]):
        self.codes = codes
        self.values = np.asarray(values, dtype=object)

    def where(self, pred) -> np.ndarray:
        """Row mask of the rows whose value satisfies ``pred``."""
        table = np.fromiter((bool(pred(v)) for v in self.values), bool,
                            len(self.values))
        return table[self.codes]

    def code(self, value: str) -> int:
        hit = np.flatnonzero(self.values == value)
        return int(hit[0]) if len(hit) else -2

    def __getitem__(self, rows) -> np.ndarray:
        return self.values[self.codes[rows]]


def _like(pattern: str):
    rx = re.compile("^" + "".join(
        ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
        for ch in pattern) + "$", re.DOTALL)
    return lambda v: rx.match(v) is not None


def _revenue(li, rows) -> np.ndarray:
    """``l_extendedprice * (1.0 - l_discount)``, scale 4."""
    return li["l_extendedprice"][rows] * (100 - li["l_discount"][rows])


def _avg_half_away(s, c):
    """Decimal average: the integer quotient rounded half away from 0."""
    q = (np.abs(s) + c // 2) // c
    return np.sign(s) * q


def _decimal_literal(v: float):
    """(unscaled, scale) of a float literal as the JAX package's compiler
    turns it into a decimal: the least scale <= 6 that makes it whole."""
    for s in range(7):
        scaled = v * 10 ** s
        if abs(scaled - round(scaled)) < 1e-9:
            return int(round(scaled)), s
    raise ValueError(f"{v} is no exact decimal literal")


def _rank(values: np.ndarray) -> np.ndarray:
    """String values -> their ranks (sort keys for ``np.lexsort``)."""
    _, inv = np.unique(values.astype(str), return_inverse=True)
    return inv.reshape(-1)


def _order(keys) -> np.ndarray:
    """Stable lexicographic order; ``keys`` are major first, strings in
    code point order."""
    return np.lexsort(tuple(_rank(k) if k.dtype.kind in "OUS" else k
                            for k in reversed(keys)))


class _Q:
    """The tables of one run and helpers over them."""

    def __init__(self, tables, dictionaries, sf):
        self.t = tables
        self.d = dictionaries
        self.sf = sf

    def s(self, table: str, col: str) -> _Strings:
        return _Strings(self.t[table][col], self.d[col])

    def nation_in_region(self, region: str) -> np.ndarray:
        """Bool per nation key."""
        r = self.s("region", "r_name").code(region)
        rk = self.t["region"]["r_regionkey"][self.t["region"]["r_name"] == r]
        return np.isin(self.t["nation"]["n_regionkey"], rk)

    def nation_key(self, name: str) -> int:
        n = self.s("nation", "n_name")
        return int(self.t["nation"]["n_nationkey"][n.codes == n.code(name)][0])

    def nation_names(self, keys) -> np.ndarray:
        return self.s("nation", "n_name")[np.asarray(keys)]


def q2(q: _Q):
    ps, su, pa = q.t["partsupp"], q.t["supplier"], q.t["part"]
    eur = q.nation_in_region("EUROPE")
    ps_eur = eur[su["s_nationkey"][ps["ps_suppkey"] - 1]]
    n_part = len(pa["p_partkey"])
    min_cost = np.full(n_part + 1, np.iinfo(np.int64).max)
    np.minimum.at(min_cost, ps["ps_partkey"][ps_eur],
                  ps["ps_supplycost"][ps_eur])
    part_ok = ((pa["p_size"] == 15)
               & q.s("part", "p_type").where(_like("%BRASS")))
    rows = np.flatnonzero(
        ps_eur & part_ok[ps["ps_partkey"] - 1]
        & (ps["ps_supplycost"] == min_cost[ps["ps_partkey"]]))
    si = ps["ps_suppkey"][rows] - 1
    pk = ps["ps_partkey"][rows]
    nname = q.nation_names(su["s_nationkey"][si])
    sname = q.s("supplier", "s_name")[si]
    acct = su["s_acctbal"][si]
    top = _order([-acct, nname, sname, pk])[:100]
    return {
        "s_acctbal": [_dec(v, 2) for v in acct[top]],
        "s_name": list(sname[top]),
        "n_name": list(nname[top]),
        "p_partkey": [int(v) for v in pk[top]],
        "p_mfgr": list(q.s("part", "p_mfgr")[pk[top] - 1]),
        "s_address": list(q.s("supplier", "s_address")[si[top]]),
        "s_phone": list(q.s("supplier", "s_phone")[si[top]]),
        "s_comment": list(q.s("supplier", "s_comment")[si[top]]),
    }


def q4(q: _Q):
    li, o = q.t["lineitem"], q.t["orders"]
    late_lines = _day(li["l_commitdate"]) < _day(li["l_receiptdate"])
    late = np.zeros(len(o["o_orderkey"]) + 1, bool)
    late[li["l_orderkey"][late_lines]] = True
    od = _day(o["o_orderdate"])
    ok = ((od >= _days(1993, 7, 1)) & (od < _days(1993, 10, 1))
          & late[o["o_orderkey"]])
    pri = q.s("orders", "o_orderpriority")
    names = pri[np.flatnonzero(ok)]
    uniq, counts = np.unique(names.astype(str), return_counts=True)
    return {"o_orderpriority": list(uniq),
            "order_count": [int(c) for c in counts]}


def _grouped(keys: List[np.ndarray], values: List[np.ndarray]):
    """Group rows by ``keys`` (sorted ascending): the distinct key tuples
    and each value column summed per group."""
    if not len(keys[0]):
        return [k[:0] for k in keys], [v[:0] for v in values], np.zeros(0, int)
    order = _order(keys)
    ks = [k[order] for k in keys]
    new = np.ones(len(order), bool)
    new[1:] = np.any([k[1:] != k[:-1] for k in ks], axis=0)
    starts = np.flatnonzero(new)
    sums = [np.add.reduceat(v[order], starts) for v in values]
    counts = np.diff(np.append(starts, len(order)))
    return [k[starts] for k in ks], sums, counts


def q5(q: _Q):
    li, o, c, su = (q.t["lineitem"], q.t["orders"], q.t["customer"],
                    q.t["supplier"])
    asia = q.nation_in_region("ASIA")
    od = _day(o["o_orderdate"])
    o_ok = (od >= _days(1994, 1, 1)) & (od < _days(1995, 1, 1))
    oi = li["l_orderkey"] - 1
    cnat = c["c_nationkey"][o["o_custkey"][oi] - 1]
    snat = su["s_nationkey"][li["l_suppkey"] - 1]
    rows = np.flatnonzero(o_ok[oi] & (cnat == snat) & asia[snat])
    names = q.nation_names(snat[rows]).astype(str)
    (name,), (rev,), _ = _grouped([names], [_revenue(li, rows)])
    top = _order([-rev, name])
    return {"n_name": list(name[top]),
            "revenue": [_dec(v, 4) for v in rev[top]]}


def q7(q: _Q):
    li, o, c, su = (q.t["lineitem"], q.t["orders"], q.t["customer"],
                    q.t["supplier"])
    fr, de = q.nation_key("FRANCE"), q.nation_key("GERMANY")
    sd = _day(li["l_shipdate"])
    snat = su["s_nationkey"][li["l_suppkey"] - 1]
    cnat = c["c_nationkey"][o["o_custkey"][li["l_orderkey"] - 1] - 1]
    rows = np.flatnonzero(
        (sd >= _days(1995, 1, 1)) & (sd <= _days(1996, 12, 31))
        & (((snat == fr) & (cnat == de)) | ((snat == de) & (cnat == fr))))
    sn = q.nation_names(snat[rows]).astype(str)
    cn = q.nation_names(cnat[rows]).astype(str)
    (sn, cn, yr), (rev,), _ = _grouped(
        [sn, cn, _year(li["l_shipdate"][rows])], [_revenue(li, rows)])
    return {"supp_nation": list(sn), "cust_nation": list(cn),
            "l_year": [int(v) for v in yr],
            "revenue": [_dec(v, 4) for v in rev]}


def q8(q: _Q):
    li, o, c, su = (q.t["lineitem"], q.t["orders"], q.t["customer"],
                    q.t["supplier"])
    amer = q.nation_in_region("AMERICA")
    steel = q.s("part", "p_type").where(
        lambda v: v == "ECONOMY ANODIZED STEEL")
    oi = li["l_orderkey"] - 1
    od = _day(o["o_orderdate"])
    rows = np.flatnonzero(
        steel[li["l_partkey"] - 1]
        & (od[oi] >= _days(1995, 1, 1)) & (od[oi] <= _days(1996, 12, 31))
        & amer[c["c_nationkey"][o["o_custkey"][oi] - 1]])
    vol = _revenue(li, rows)
    brazil = su["s_nationkey"][li["l_suppkey"][rows] - 1] == \
        q.nation_key("BRAZIL")
    # CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0.0 END is DOUBLE
    bvol = np.where(brazil, vol / 1e4, 0.0)
    years = _year(o["o_orderdate"][oi[rows]])
    out = {"o_year": [], "mkt_share": []}
    for y in np.unique(years):
        m = years == y
        out["o_year"].append(int(y))
        out["mkt_share"].append(float(bvol[m].sum() / (vol[m].sum() / 1e4)))
    return out


def _ps_rows(q: _Q, partkey, suppkey) -> np.ndarray:
    """The partsupp row of each (part, supplier) pair (-1: none)."""
    ps = q.t["partsupp"]
    base = len(q.t["supplier"]["s_suppkey"]) + 1
    pk = ps["ps_partkey"] * base + ps["ps_suppkey"]
    order = np.argsort(pk, kind="stable")
    want = partkey * base + suppkey
    pos = np.searchsorted(pk[order], want).clip(max=len(pk) - 1)
    hit = pk[order][pos] == want
    return np.where(hit, order[pos], -1)


def q9(q: _Q):
    li, o, su, ps = (q.t["lineitem"], q.t["orders"], q.t["supplier"],
                     q.t["partsupp"])
    green = q.s("part", "p_name").where(lambda v: "green" in v)
    rows = np.flatnonzero(green[li["l_partkey"] - 1])
    psr = _ps_rows(q, li["l_partkey"][rows], li["l_suppkey"][rows])
    rows, psr = rows[psr >= 0], psr[psr >= 0]
    amount = (_revenue(li, rows)
              - ps["ps_supplycost"][psr] * li["l_quantity"][rows])
    nation = q.nation_names(
        su["s_nationkey"][li["l_suppkey"][rows] - 1]).astype(str)
    year = _year(o["o_orderdate"][li["l_orderkey"][rows] - 1])
    (nation, year), (profit,), _ = _grouped([nation, -year], [amount])
    return {"nation": list(nation), "o_year": [int(-y) for y in year],
            "sum_profit": [_dec(v, 4) for v in profit]}


def q10(q: _Q):
    li, o, c = q.t["lineitem"], q.t["orders"], q.t["customer"]
    od = _day(o["o_orderdate"])
    o_ok = (od >= _days(1993, 10, 1)) & (od < _days(1994, 1, 1))
    rf = q.s("lineitem", "l_returnflag")
    rows = np.flatnonzero((rf.codes == rf.code("R"))
                          & o_ok[li["l_orderkey"] - 1])
    ck = o["o_custkey"][li["l_orderkey"][rows] - 1]
    (cust,), (rev,), _ = _grouped([ck], [_revenue(li, rows)])
    top = _order([-rev, cust])[:20]
    ci = cust[top] - 1
    return {
        "c_custkey": [int(v) for v in cust[top]],
        "c_name": list(q.s("customer", "c_name")[ci]),
        "revenue": [_dec(v, 4) for v in rev[top]],
        "c_acctbal": [_dec(v, 2) for v in c["c_acctbal"][ci]],
        "n_name": list(q.nation_names(c["c_nationkey"][ci])),
        "c_address": list(q.s("customer", "c_address")[ci]),
        "c_phone": list(q.s("customer", "c_phone")[ci]),
        "c_comment": list(q.s("customer", "c_comment")[ci]),
    }


def q11(q: _Q):
    ps, su = q.t["partsupp"], q.t["supplier"]
    de = su["s_nationkey"][ps["ps_suppkey"] - 1] == q.nation_key("GERMANY")
    rows = np.flatnonzero(de)
    val = ps["ps_supplycost"][rows] * ps["ps_availqty"][rows]   # scale 2
    (part,), (value,), _ = _grouped([ps["ps_partkey"][rows]], [val])
    # total * <literal> at scale 2 + s against value rescaled to it
    u, s = _decimal_literal(float(f"{0.0001 / q.sf:.10f}"))
    keep = value * 10 ** s > int(val.sum()) * u
    part, value = part[keep], value[keep]
    top = _order([-value, part])
    return {"ps_partkey": [int(v) for v in part[top]],
            "value": [_dec(v, 2) for v in value[top]]}


def q12(q: _Q):
    li, o = q.t["lineitem"], q.t["orders"]
    mode = q.s("lineitem", "l_shipmode")
    sd, cd, rd = (_day(li["l_shipdate"]), _day(li["l_commitdate"]),
                  _day(li["l_receiptdate"]))
    rows = np.flatnonzero(
        np.isin(mode.codes, [mode.code("MAIL"), mode.code("SHIP")])
        & (cd < rd) & (sd < cd)
        & (rd >= _days(1994, 1, 1)) & (rd < _days(1995, 1, 1)))
    pri = q.s("orders", "o_orderpriority")[li["l_orderkey"][rows] - 1]
    high = np.isin(pri.astype(str), ["1-URGENT", "2-HIGH"]).astype(np.int64)
    (m,), (h, lo), _ = _grouped([mode[rows].astype(str)], [high, 1 - high])
    return {"l_shipmode": list(m), "high_line_count": [int(v) for v in h],
            "low_line_count": [int(v) for v in lo]}


def q13(q: _Q):
    o = q.t["orders"]
    special = q.s("orders", "o_comment").where(_like("%special%requests%"))
    n_cust = len(q.t["customer"]["c_custkey"])
    counts = np.bincount(o["o_custkey"][~special], minlength=n_cust + 1)[1:]
    c_count, custdist = np.unique(counts, return_counts=True)
    top = _order([-custdist, -c_count])
    return {"c_count": [int(v) for v in c_count[top]],
            "custdist": [int(v) for v in custdist[top]]}


def q14(q: _Q):
    li = q.t["lineitem"]
    sd = _day(li["l_shipdate"])
    rows = np.flatnonzero((sd >= _days(1995, 9, 1))
                          & (sd < _days(1995, 10, 1)))
    promo = q.s("part", "p_type").where(lambda v: v.startswith("PROMO"))
    vol = _revenue(li, rows)
    p = np.where(promo[li["l_partkey"][rows] - 1], vol / 1e4, 0.0).sum()
    return {"promo_revenue": [float(100.0 * p / (vol.sum() / 1e4))]
            if len(rows) else [None]}


def q15(q: _Q):
    li, su = q.t["lineitem"], q.t["supplier"]
    sd = _day(li["l_shipdate"])
    rows = np.flatnonzero((sd >= _days(1996, 1, 1))
                          & (sd < _days(1996, 4, 1)))
    (supp,), (rev,), _ = _grouped([li["l_suppkey"][rows]],
                                  [_revenue(li, rows)])
    best = supp[rev == rev.max()]
    si = best - 1
    return {"s_suppkey": [int(v) for v in best],
            "s_name": list(q.s("supplier", "s_name")[si]),
            "s_address": list(q.s("supplier", "s_address")[si]),
            "s_phone": list(q.s("supplier", "s_phone")[si]),
            "total_revenue": [_dec(rev.max(), 4)] * len(best)}


def q16(q: _Q):
    ps, pa = q.t["partsupp"], q.t["part"]
    bad = q.s("supplier", "s_comment").where(_like("%Customer%Complaints%"))
    brand, ptype = q.s("part", "p_brand"), q.s("part", "p_type")
    part_ok = ((brand.codes != brand.code("Brand#45"))
               & ~ptype.where(lambda v: v.startswith("MEDIUM POLISHED"))
               & np.isin(pa["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
    rows = np.flatnonzero(~bad[ps["ps_suppkey"] - 1]
                          & part_ok[ps["ps_partkey"] - 1])
    pi = ps["ps_partkey"][rows] - 1
    b, t = brand[pi].astype(str), ptype[pi].astype(str)
    size, supp = pa["p_size"][pi], ps["ps_suppkey"][rows]
    (b, t, size, supp), _, _ = _grouped([b, t, size, supp], [])
    (b, t, size), (cnt,), _ = _grouped([b, t, size],
                                       [np.ones(len(supp), np.int64)])
    top = _order([-cnt, b, t, size])
    return {"p_brand": list(b[top]), "p_type": list(t[top]),
            "p_size": [int(v) for v in size[top]],
            "supplier_cnt": [int(v) for v in cnt[top]]}


def q17(q: _Q):
    li = q.t["lineitem"]
    brand, cont = q.s("part", "p_brand"), q.s("part", "p_container")
    part_ok = ((brand.codes == brand.code("Brand#23"))
               & (cont.codes == cont.code("MED BOX")))
    rows = np.flatnonzero(part_ok[li["l_partkey"] - 1])
    pk, qty = li["l_partkey"][rows], li["l_quantity"][rows]
    n_part = len(part_ok) + 1
    s = np.zeros(n_part, np.int64)
    np.add.at(s, pk, qty)
    c = np.bincount(pk, minlength=n_part)
    avg = _avg_half_away(s, np.maximum(c, 1))          # scale 2
    u, sc = _decimal_literal(0.2)                      # 0.2 * avg_qty
    lim = u * avg[pk]                                  # scale 2 + sc
    keep = qty * 10 ** sc < lim
    if not keep.any():
        return {"avg_yearly": [None]}
    total = int(li["l_extendedprice"][rows][keep].sum())
    q_ = abs(total) // 7                               # s / 7.0 truncates
    return {"avg_yearly": [_dec(q_ if total >= 0 else -q_, 2)]}


def q19(q: _Q):
    li, pa = q.t["lineitem"], q.t["part"]
    mode = q.s("lineitem", "l_shipmode")
    instr = q.s("lineitem", "l_shipinstruct")
    base = (np.isin(mode.codes, [mode.code("AIR"), mode.code("REG AIR")])
            & (instr.codes == instr.code("DELIVER IN PERSON")))
    rows = np.flatnonzero(base)
    pi = li["l_partkey"][rows] - 1
    brand = q.s("part", "p_brand")[pi]
    cont = q.s("part", "p_container")[pi]
    size = pa["p_size"][pi]
    qty = li["l_quantity"][rows]

    def arm(b, conts, lo, hi, smax):
        return ((brand == b) & np.isin(cont.astype(str), conts)
                & (qty >= lo * 100) & (qty <= hi * 100)
                & (size >= 1) & (size <= smax))

    ok = (arm("Brand#12", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"],
              1, 11, 5)
          | arm("Brand#23", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"],
                10, 20, 10)
          | arm("Brand#34", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"],
                20, 30, 15))
    rev = _revenue(li, rows[ok])
    return {"revenue": [_dec(rev.sum(), 4) if ok.any() else None]}


def q20(q: _Q):
    li, ps, su = q.t["lineitem"], q.t["partsupp"], q.t["supplier"]
    forest = q.s("part", "p_name").where(lambda v: v.startswith("forest"))
    sd = _day(li["l_shipdate"])
    rows = np.flatnonzero((sd >= _days(1994, 1, 1))
                          & (sd < _days(1995, 1, 1))
                          & forest[li["l_partkey"] - 1])
    (pk, sk), (qty,), _ = _grouped(
        [li["l_partkey"][rows], li["l_suppkey"][rows]],
        [li["l_quantity"][rows]])
    psr = _ps_rows(q, pk, sk)
    u, s = _decimal_literal(0.5)                       # 0.5 * qty
    # ps_availqty > half: the integer at the product's scale 2 + s
    ok = (psr >= 0) & (ps["ps_availqty"][psr.clip(0)] * 10 ** (2 + s)
                       > u * qty)
    qualifying = np.zeros(len(su["s_suppkey"]) + 1, bool)
    qualifying[sk[ok]] = True
    canada = q.nation_key("CANADA")
    si = np.flatnonzero(qualifying[su["s_suppkey"]]
                        & (su["s_nationkey"] == canada))
    names = q.s("supplier", "s_name")[si].astype(str)
    top = _order([names])
    return {"s_name": list(names[top]),
            "s_address": list(q.s("supplier", "s_address")[si[top]])}


def q21(q: _Q):
    li, o, su = q.t["lineitem"], q.t["orders"], q.t["supplier"]
    status = q.s("orders", "o_orderstatus")
    late = _day(li["l_receiptdate"]) > _day(li["l_commitdate"])
    oi = li["l_orderkey"] - 1
    saudi = su["s_nationkey"] == q.nation_key("SAUDI ARABIA")
    cand = (late & (status.codes[oi] == status.code("F"))
            & saudi[li["l_suppkey"] - 1])
    # every line of the orders that hold a candidate
    in_cand = np.zeros(len(o["o_orderkey"]), bool)
    in_cand[oi[cand]] = True
    lines = np.flatnonzero(in_cand[oi])
    ok_, sk_, late_ = li["l_orderkey"][lines], li["l_suppkey"][lines], \
        late[lines]
    base = len(su["s_suppkey"]) + 1
    pair = ok_ * base + sk_

    def per_pair(mask):
        """Per line: lines of its order, and of its (order, supplier),
        among ``mask``."""
        n_o = np.bincount(ok_[mask] - ok_.min(),
                          minlength=ok_.max() - ok_.min() + 1)
        u, inv = np.unique(pair, return_inverse=True)
        n_p = np.bincount(inv.reshape(-1)[mask], minlength=len(u))
        return n_o[ok_ - ok_.min()], n_p[inv.reshape(-1)]

    all_o, all_p = per_pair(np.ones(len(lines), bool))
    late_o, late_p = per_pair(late_)
    c = cand[lines]
    keep = c & (all_o - all_p > 0) & (late_o - late_p == 0)
    names = q.s("supplier", "s_name")[sk_[keep] - 1].astype(str)
    name, cnt = np.unique(names, return_counts=True)
    top = _order([-cnt, name])[:100]
    return {"s_name": list(name[top]),
            "numwait": [int(v) for v in cnt[top]]}


def q22(q: _Q):
    c, o = q.t["customer"], q.t["orders"]
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    phone = q.s("customer", "c_phone")
    cc = np.asarray([v[:2] for v in phone.values], dtype=object)[phone.codes]
    cand = np.isin(cc.astype(str), codes)
    bal = c["c_acctbal"]
    pos = cand & (bal > 0)
    avg = _avg_half_away(int(bal[pos].sum()), int(pos.sum()))
    has_order = np.zeros(len(bal) + 1, bool)
    has_order[o["o_custkey"]] = True
    keep = cand & (bal > avg) & ~has_order[c["c_custkey"]]
    (code,), (n, total), _ = _grouped(
        [cc[keep].astype(str)], [np.ones(int(keep.sum()), np.int64),
                                 bal[keep]])
    return {"cntrycode": list(code), "numcust": [int(v) for v in n],
            "totacctbal": [_dec(v, 2) for v in total]}


ORACLES = {2: q2, 4: q4, 5: q5, 7: q7, 8: q8, 9: q9, 10: q10, 11: q11,
           12: q12, 13: q13, 14: q14, 15: q15, 16: q16, 17: q17, 19: q19,
           20: q20, 21: q21, 22: q22}


def answer(n: int, tables: Dict[str, Dict[str, np.ndarray]],
           dictionaries: Dict[str, list], sf: float) -> Dict[str, list]:
    """Q{n}'s result over the generated ``tables`` (cents, codes) as
    ``{column: [values]}``, in the engine's row order."""
    return ORACLES[n](_Q(tables, dictionaries, sf))
