"""Host-side numpy oracles for the 15 TPC-DS queries the spec-shaped
generator can feed (``SPEC_QUERIES``).

Each oracle computes its query's answer from the generated arrays
(``velox_tpu_torch.io.tpcds.tpcds_columns``) with numpy alone and shares
no code with the engine. It follows what the plan in ``queries.py``
means: dimension keys are dense (``*_sk`` = row + 1), so a join is an
index into the dimension, a semi join a lookup in a boolean table of the
dimension's filtered keys. String columns are codes into sorted value
lists, so code order is string order. Results come out as the engine's
``run_plan`` gives them: ``{column: [values]}``, DOUBLE as ``float``,
BIGINT as ``int``, strings as ``str``, NULL as ``None``, rows in the
plan's ORDER BY order; where the ORDER BY leaves a tie, in the order of
the grouping keys, which is the order the engine's aggregation emits its
groups in.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

Tables = Dict[str, Dict[str, np.ndarray]]
Dicts = Dict[str, List[str]]


class _Q:
    """The generated tables of one query, with helpers."""

    def __init__(self, tables: Tables, dicts: Dicts):
        self.t = tables
        self.d = dicts
        ss = tables["store_sales"]
        self.ss = ss
        #: each fact row's dimension row, per foreign key
        self.date = ss["ss_sold_date_sk"] - 1
        self.item = ss["ss_item_sk"] - 1
        self.cust = ss["ss_customer_sk"] - 1
        self.cdemo = ss["ss_cdemo_sk"] - 1
        self.store = ss["ss_store_sk"] - 1
        self.promo = ss["ss_promo_sk"] - 1

    def code(self, column: str, value: str) -> int:
        """The code of a string literal, -2 when absent (never equal)."""
        vals = self.d[column]
        return vals.index(value) if value in vals else -2

    def codes(self, column: str, values: Sequence[str]) -> List[int]:
        return [self.code(column, v) for v in values]

    def dim(self, table: str, column: str, rows: np.ndarray) -> np.ndarray:
        return self.t[table][column][rows]

    def decode(self, column: str, codes: np.ndarray) -> List:
        vals = self.d[column]
        return [None if c < 0 else vals[c] for c in codes.tolist()]


def _groups(keys: Sequence[np.ndarray]) -> Tuple[List[np.ndarray],
                                                 np.ndarray]:
    """Distinct key tuples in ascending key order, and each row's group.
    The tuples are packed into one int64 by mixed radix (every key here
    spans far less than 2^62 together), then made distinct."""
    keys = [np.asarray(k, dtype=np.int64) for k in keys]
    if len(keys[0]) == 0:
        return [k[:0] for k in keys], np.zeros(0, dtype=np.int64)
    lows = [int(k.min()) for k in keys]
    spans = [int(k.max()) - lo + 1 for k, lo in zip(keys, lows)]
    packed = np.zeros(len(keys[0]), dtype=np.int64)
    for k, lo, span in zip(keys, lows, spans):
        packed = packed * span + (k - lo)
    uniq, inv = np.unique(packed, return_inverse=True)
    out = []
    for lo, span in zip(reversed(lows), reversed(spans)):
        out.append(uniq % span + lo)
        uniq = uniq // span
    return out[::-1], inv.reshape(-1)


def _sums(inv: np.ndarray, values: np.ndarray, n: int) -> np.ndarray:
    if values.dtype.kind == "f":
        return np.bincount(inv, weights=values, minlength=n)
    # integer sums here stay far below 2^53, where float64 is exact
    return np.rint(np.bincount(inv, weights=values.astype(np.float64),
                               minlength=n)).astype(np.int64)


def _counts(inv: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(inv, minlength=n).astype(np.int64)


def _avg(total, count):
    return [None if c == 0 else float(s) / float(c)
            for s, c in zip(np.asarray(total).tolist(),
                            np.asarray(count).tolist())]


def _rows(order: np.ndarray, limit: int = 100) -> np.ndarray:
    return order[:limit]


def _floats(a: np.ndarray) -> List[float]:
    return [float(v) for v in a.tolist()]


def _ints(a: np.ndarray) -> List[int]:
    return [int(v) for v in a.tolist()]


# ------------------------------------------------------------- the stars

def q3(o: _Q) -> dict:
    m = ((o.dim("date_dim", "d_moy", o.date) == 11)
         & (o.dim("item", "i_manufact_id", o.item) == 128))
    year = o.dim("date_dim", "d_year", o.date)[m]
    bid = o.dim("item", "i_brand_id", o.item)[m]
    brand = o.dim("item", "i_brand", o.item)[m]
    (year, bid, brand), inv = _groups([year, bid, brand])
    s = _sums(inv, o.ss["ss_ext_sales_price"][m], len(year))
    top = _rows(np.lexsort((brand, bid, -s, year)))
    return {"d_year": _ints(year[top]), "i_brand_id": _ints(bid[top]),
            "i_brand": o.decode("i_brand", brand[top]),
            "sum_agg": _floats(s[top])}


def _brand_star(o: _Q, manager_id: int, moy: int, year_: int) -> dict:
    m = ((o.dim("date_dim", "d_moy", o.date) == moy)
         & (o.dim("date_dim", "d_year", o.date) == year_)
         & (o.dim("item", "i_manager_id", o.item) == manager_id))
    year = o.dim("date_dim", "d_year", o.date)[m]
    brand = o.dim("item", "i_brand", o.item)[m]
    bid = o.dim("item", "i_brand_id", o.item)[m]
    (year, brand, bid), inv = _groups([year, brand, bid])
    s = _sums(inv, o.ss["ss_ext_sales_price"][m], len(year))
    top = _rows(np.lexsort((brand, bid, -s, year)))
    return {"d_year": _ints(year[top]),
            "i_brand": o.decode("i_brand", brand[top]),
            "i_brand_id": _ints(bid[top]), "ext_price": _floats(s[top])}


def q52(o: _Q) -> dict:
    return _brand_star(o, 1, 11, 2000)


def q55(o: _Q) -> dict:
    return _brand_star(o, 28, 11, 1999)


def q42(o: _Q) -> dict:
    m = ((o.dim("date_dim", "d_moy", o.date) == 11)
         & (o.dim("date_dim", "d_year", o.date) == 2000)
         & (o.dim("item", "i_manager_id", o.item) == 1))
    year = o.dim("date_dim", "d_year", o.date)[m]
    cid = o.dim("item", "i_category_id", o.item)[m]
    cat = o.dim("item", "i_category", o.item)[m]
    (year, cid, cat), inv = _groups([year, cid, cat])
    s = _sums(inv, o.ss["ss_ext_sales_price"][m], len(year))
    top = _rows(np.lexsort((cat, cid, year, -s)))
    return {"d_year": _ints(year[top]), "i_category_id": _ints(cid[top]),
            "i_category": o.decode("i_category", cat[top]),
            "total": _floats(s[top])}


def _item_averages(o: _Q, m: np.ndarray, keys: List[np.ndarray]):
    """avg of quantity, list price, coupon and sales price per group."""
    keys, inv = _groups(keys)
    n = len(keys[0])
    c = _counts(inv, n)
    aggs = [_avg(_sums(inv, o.ss[col][m], n), c) for col in (
        "ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price")]
    return keys, aggs


def q7(o: _Q) -> dict:
    cd = o.t["customer_demographics"]
    pr = o.t["promotion"]
    cd_ok = ((cd["cd_gender"] == o.code("cd_gender", "M"))
             & (cd["cd_marital_status"] == o.code("cd_marital_status", "S"))
             & (cd["cd_education_status"]
                == o.code("cd_education_status", "College")))
    n_code = o.code("p_channel_email", "N")
    pr_ok = ((pr["p_channel_email"] == n_code)
             | (pr["p_channel_event"] == o.code("p_channel_event", "N")))
    m = (cd_ok[o.cdemo] & (o.dim("date_dim", "d_year", o.date) == 2000)
         & pr_ok[o.promo])
    (iid,), aggs = _item_averages(
        o, m, [o.dim("item", "i_item_id", o.item)[m]])
    top = _rows(np.argsort(iid, kind="stable"))
    out = {"i_item_id": o.decode("i_item_id", iid[top])}
    for k, a in enumerate(aggs, 1):
        out[f"agg{k}"] = [a[i] for i in top.tolist()]
    return out


def q27(o: _Q) -> dict:
    """GROUPING SETS ((i_item_id, s_state), (i_item_id), ()): a key a set
    lacks is NULL; ORDER BY i_item_id, s_state puts NULLs last."""
    cd = o.t["customer_demographics"]
    cd_ok = ((cd["cd_gender"] == o.code("cd_gender", "F"))
             & (cd["cd_marital_status"] == o.code("cd_marital_status", "S"))
             & (cd["cd_education_status"]
                == o.code("cd_education_status", "College")))
    m = cd_ok[o.cdemo] & (o.dim("date_dim", "d_year", o.date) == 2002)
    iid = o.dim("item", "i_item_id", o.item)[m]
    state = o.dim("store", "s_state", o.store)[m]
    null = np.full(len(iid), -1, dtype=np.int64)
    rows = {"i_item_id": [], "s_state": [], "group_id": [],
            "agg1": [], "agg2": [], "agg3": [], "agg4": []}
    for gid, keys in enumerate(([iid, state], [iid, null], [null, null])):
        (ki, ks), aggs = _item_averages(o, m, keys)
        rows["i_item_id"] += ki.tolist()
        rows["s_state"] += ks.tolist()
        rows["group_id"] += [gid] * len(ki)
        for k, a in enumerate(aggs, 1):
            rows[f"agg{k}"] += a
    ki = np.asarray(rows["i_item_id"], dtype=np.int64)
    ks = np.asarray(rows["s_state"], dtype=np.int64)
    big = np.iinfo(np.int64).max
    top = _rows(np.lexsort((np.where(ks < 0, big, ks),
                            np.where(ki < 0, big, ki))))
    out = {"i_item_id": o.decode("i_item_id", ki[top]),
           "s_state": o.decode("s_state", ks[top]),
           "group_id": [rows["group_id"][i] for i in top.tolist()]}
    for k in range(1, 5):
        out[f"agg{k}"] = [rows[f"agg{k}"][i] for i in top.tolist()]
    return out


def q19(o: _Q) -> dict:
    # the customer, address and store joins are inner joins on dense keys
    # that every fact row matches: they select nothing
    m = ((o.dim("date_dim", "d_moy", o.date) == 11)
         & (o.dim("date_dim", "d_year", o.date) == 1999)
         & (o.dim("item", "i_manager_id", o.item) == 8))
    bid = o.dim("item", "i_brand_id", o.item)[m]
    brand = o.dim("item", "i_brand", o.item)[m]
    mid = o.dim("item", "i_manufact_id", o.item)[m]
    (bid, brand, mid), inv = _groups([bid, brand, mid])
    s = _sums(inv, o.ss["ss_ext_sales_price"][m], len(bid))
    top = _rows(np.lexsort((mid, brand, bid, -s)))
    return {"i_brand_id": _ints(bid[top]),
            "i_brand": o.decode("i_brand", brand[top]),
            "i_manufact_id": _ints(mid[top]), "ext_price": _floats(s[top])}


def q96(o: _Q) -> dict:
    st_ok = o.t["store"]["s_state"] == o.code("s_state", "TX")
    m = (o.dim("date_dim", "d_dom", o.date) == 25) & st_ok[o.store]
    return {"cnt": [int(m.sum())]}


def _banded(o: _Q, year: int, demo_bands, state_bands) -> np.ndarray:
    """q13/q48's selection: the year, a (marital, education, sales price)
    band and a (state set, discount amount) band."""
    sp = o.ss["ss_sales_price"]
    disc = o.ss["ss_ext_discount_amt"]
    marital = o.dim("customer_demographics", "cd_marital_status", o.cdemo)
    edu = o.dim("customer_demographics", "cd_education_status", o.cdemo)
    m_demo = np.zeros(len(sp), dtype=bool)
    for ms, es, lo, hi in demo_bands:
        m_demo |= ((marital == o.code("cd_marital_status", ms))
                   & (edu == o.code("cd_education_status", es))
                   & (sp >= lo) & (sp <= hi))
    addr = o.dim("customer", "c_current_addr_sk", o.cust) - 1
    state = o.dim("customer_address", "ca_state", addr)
    m_state = np.zeros(len(sp), dtype=bool)
    for states, lo, hi in state_bands:
        m_state |= (np.isin(state, o.codes("ca_state", states))
                    & (disc >= lo) & (disc <= hi))
    return ((o.dim("date_dim", "d_year", o.date) == year) & m_demo
            & m_state)


def q13(o: _Q) -> dict:
    m = _banded(o, 2001, [("M", "Advanced Degree", 100.0, 150.0),
                          ("S", "College", 50.0, 100.0),
                          ("W", "2 yr Degree", 150.0, 200.0)],
                [(("TX", "OH", "CA"), 0.0, 200.0),
                 (("NY", "KS", "MI"), 150.0, 300.0),
                 (("AL", "GA", "TN"), 50.0, 250.0)])
    c = int(m.sum())

    def avg(col):
        v = o.ss[col][m]
        return None if c == 0 else float(v.sum()) / c

    return {"a1": [avg("ss_quantity")], "a2": [avg("ss_ext_sales_price")],
            "a3": [avg("ss_wholesale_cost")],
            "s1": [float(o.ss["ss_wholesale_cost"][m].sum()) if c else None]}


def q48(o: _Q) -> dict:
    m = _banded(o, 2001, [("M", "4 yr Degree", 100.0, 150.0),
                          ("D", "2 yr Degree", 50.0, 100.0),
                          ("S", "College", 150.0, 200.0)],
                [(("TX", "NY"), 0.0, 2000.0),
                 (("CA", "OH"), 150.0, 3000.0),
                 (("GA", "IL"), 50.0, 25000.0)])
    return {"total_qty": [int(o.ss["ss_quantity"][m].sum())
                          if m.any() else None]}


def q43(o: _Q) -> dict:
    m = o.dim("date_dim", "d_year", o.date) == 2000
    day = o.dim("date_dim", "d_day_name", o.date)[m]
    sid = o.dim("store", "s_store_id", o.store)[m]
    sname = o.dim("store", "s_store_name", o.store)[m]
    price = o.ss["ss_sales_price"][m]
    (sid, sname), inv = _groups([sid, sname])
    top = _rows(np.lexsort((sname, sid)))
    out = {"s_store_id": o.decode("s_store_id", sid[top]),
           "s_store_name": o.decode("s_store_name", sname[top])}
    for abbr, full in (("sun", "Sunday"), ("mon", "Monday"),
                       ("tue", "Tuesday"), ("wed", "Wednesday"),
                       ("thu", "Thursday"), ("fri", "Friday"),
                       ("sat", "Saturday")):
        v = np.where(day == o.code("d_day_name", full), price, 0.0)
        out[f"{abbr}_sales"] = _floats(_sums(inv, v, len(sid))[top])
    return out


def _deviation(o: _Q, year: int, item_mask: np.ndarray, item_key: str,
               period: str, key_out: str, period_out: str, avg_out: str,
               order_key: Callable) -> dict:
    """q53/q63: per (item key, period) sum of sales price; the average of
    those sums over the item key's periods (a window with no ORDER BY
    covers the whole partition); keep sums that deviate from it by more
    than 10%."""
    m = (o.dim("date_dim", "d_year", o.date) == year) & item_mask[o.item]
    key = o.dim("item", item_key, o.item)[m]
    per = o.dim("date_dim", period, o.date)[m]
    (key, per), inv = _groups([key, per])
    s = _sums(inv, o.ss["ss_sales_price"][m], len(key))
    (pk,), pinv = _groups([key])
    avg = (_sums(pinv, s, len(pk)) / _counts(pinv, len(pk)))[pinv]
    keep = (avg > 0.0) & (np.abs(s - avg) / avg > 0.1)
    key, per, s, avg = key[keep], per[keep], s[keep], avg[keep]
    top = _rows(order_key(key, per, s, avg))
    return {key_out: _ints(key[top]), period_out: _ints(per[top]),
            "sum_sales": _floats(s[top]), avg_out: _floats(avg[top])}


def q53(o: _Q) -> dict:
    mid = o.t["item"]["i_manufact_id"]
    return _deviation(
        o, 2000, (mid >= 100) & (mid <= 140), "i_manufact_id", "d_qoy",
        "i_manufact_id", "d_qoy", "avg_quarterly_sales",
        lambda k, p, s, a: np.lexsort((p, k, s, a)))


def q63(o: _Q) -> dict:
    return _deviation(
        o, 2001, np.isin(o.t["item"]["i_manager_id"], np.arange(1, 9)),
        "i_manager_id", "d_moy", "i_manager_id", "d_moy",
        "avg_monthly_sales", lambda k, p, s, a: np.lexsort((p, s, a, k)))


def q65(o: _Q) -> dict:
    m = o.dim("date_dim", "d_year", o.date) == 2000
    (store, item), inv = _groups([o.store[m], o.item[m]])
    rev = _sums(inv, o.ss["ss_sales_price"][m], len(store))
    (st,), sinv = _groups([store])
    ave = (_sums(sinv, rev, len(st)) / _counts(sinv, len(st)))[sinv]
    keep = rev <= 0.1 * ave
    store, item, rev = store[keep], item[keep], rev[keep]
    sname = o.t["store"]["s_store_name"][store]
    iid = o.t["item"]["i_item_id"][item]
    top = _rows(np.lexsort((iid, sname)))
    return {"s_store_name": o.decode("s_store_name", sname[top]),
            "i_item_id": o.decode("i_item_id", iid[top]),
            "i_current_price": _floats(
                o.t["item"]["i_current_price"][item[top]]),
            "revenue": _floats(rev[top])}


def q28(o: _Q) -> dict:
    qty = o.ss["ss_quantity"]
    lp = o.ss["ss_list_price"]
    coup = o.ss["ss_coupon_amt"]
    whole = o.ss["ss_wholesale_cost"]
    out = {}
    for i, (qlo, qhi, p, c, w) in enumerate(
            [(0, 5, 8.0, 459.0, 57.0), (6, 10, 90.0, 2323.0, 31.0),
             (11, 15, 142.0, 12214.0, 79.0), (16, 20, 135.0, 6071.0, 38.0),
             (21, 25, 122.0, 836.0, 17.0), (26, 30, 154.0, 7326.0, 7.0)],
            start=1):
        m = ((qty >= qlo) & (qty <= qhi)
             & (((lp >= p) & (lp <= p + 10))
                | ((coup >= c) & (coup <= c + 1000))
                | ((whole >= w) & (whole <= w + 20))))
        v = lp[m]
        out[f"b{i}_lp"] = [float(v.sum()) / len(v) if len(v) else None]
        out[f"b{i}_cnt"] = [int(len(v))]
        out[f"b{i}_cntd"] = [int(len(np.unique(v)))]
    return out


ORACLES = {3: q3, 7: q7, 13: q13, 19: q19, 27: q27, 28: q28, 42: q42,
           43: q43, 48: q48, 52: q52, 53: q53, 55: q55, 63: q63, 65: q65,
           96: q96}


def answer(q: int, tables: Tables, dicts: Dicts) -> dict:
    """The rows of TPC-DS query ``q`` with the spec's default constants."""
    return ORACLES[q](_Q(tables, dicts))
