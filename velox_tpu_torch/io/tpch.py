"""TPC-H's eight tables, generated from an explicit seed.

The distributions are those of the JAX package's ``io/tpch.py``
(``gen_region`` .. ``gen_partsupp``, ``gen_orders_lineitem``: spec-shaped,
not dbgen-exact), restricted to the columns the 22 queries read. Unlike
that generator, the streams are seeded by the caller, so two processes
given one seed produce the same tables. Money is emitted as int64 cents
and string columns as int32 codes into a dictionary, so the generator
holds Python strings only for distinct values (``o_comment`` at SF10:
15M rows, about 14M distinct values).

Each group of columns draws from its own stream, so adding a column never
moves an existing one:

* ``default_rng(seed)``: every lineitem value of Q1/Q3/Q6/Q18's columns,
  plus ``l_partkey`` and ``l_receiptdate``, which those draws already
  make (the extended price is computed from the part key, the return
  flag from the receipt date);
* ``default_rng([seed, 1])``: ``o_custkey`` and ``c_mktsegment``;
* ``default_rng([seed, 2])``: the other lineitem and orders columns;
* ``[seed, 3]`` customer, ``[seed, 4]`` supplier, ``[seed, 5]`` part,
  ``[seed, 6]`` partsupp. Region and nation are fixed.
"""

from __future__ import annotations

import datetime
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


START_DATE = _days(1992, 1, 1)
CURRENT_DATE = _days(1995, 6, 17)
END_DATE = _days(1998, 12, 1)

RETURNFLAGS = ["A", "N", "R"]
LINESTATUSES = ["F", "O"]
ORDERSTATUSES = ["F", "O", "P"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
SHIP_INSTRUCT = [
    "COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]

# 25 nations -> region (TPC-H spec, in nationkey order)
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

_P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
    "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
    "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
    "goldenrod", "green", "grey", "honeydew", "hot", "hotpink", "indian",
    "ivory", "khaki", "lace", "lavender", "lawn", "lemon", "light",
    "lime", "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow",
    "spring", "steel", "tan", "thistle", "tomato", "turquoise", "violet",
    "wheat", "white", "yellow",
]
_TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_CONT_SYL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
_CONT_SYL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

_COMMENT_WORDS = [
    "furiously", "quickly", "carefully", "blithely", "slyly", "final",
    "ironic", "pending", "regular", "express", "special", "bold", "even",
    "silent", "unusual", "requests", "deposits", "accounts", "packages",
    "instructions", "foxes", "theodolites", "pinto", "beans", "dependencies",
    "excuses", "platelets", "asymptotes", "courts", "dolphins", "multipliers",
    "sauternes", "warhorses", "sheaves", "realms", "ideas", "Customer",
    "Complaints", "Tiresias", "hockey", "players", "grouches", "sentiments",
]

#: the tables and what each one holds
TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")

MONEY_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "o_totalprice", "s_acctbal", "c_acctbal", "p_retailprice",
                 "ps_supplycost")

#: unscaled-cents decimal lanes of the "cents" schema: the overrides the
#: JAX package's narrow-lane tests register, and its benchmark mode's
#: (7, 2) for the dimension money columns
CENTS_OVERRIDES = {
    "l_extendedprice": (9, 2), "l_discount": (3, 2),
    "l_quantity": (4, 2), "l_tax": (3, 2), "o_totalprice": (12, 2),
    "s_acctbal": (7, 2), "c_acctbal": (7, 2), "p_retailprice": (7, 2),
    "ps_supplycost": (7, 2)}

Columns = Dict[str, np.ndarray]


# ------------------------------------------------------------ strings

def _encode(values: np.ndarray) -> Tuple[np.ndarray, list]:
    """Python strings -> (int32 codes, sorted distinct values)."""
    uniq, codes = np.unique(np.asarray(values, dtype=object),
                            return_inverse=True)
    return codes.astype(np.int32).reshape(-1), list(uniq)


def _word_columns(idx: np.ndarray, words: Sequence[str]
                  ) -> Tuple[np.ndarray, list]:
    """Rows of word indices ``(n, k)`` -> the space-joined strings as
    (int32 codes, sorted distinct values), building a string only for
    each distinct row. A row's key is its words' ranks in base
    ``len(words)``: one word ordering before another orders the joined
    strings the same way (a shorter word that prefixes a longer one
    meets a space, which sorts below every letter), so the keys sort as
    the strings do."""
    order = np.argsort(np.asarray(words, dtype=object).astype(str),
                       kind="stable")
    rank = np.empty(len(words), dtype=np.int64)
    rank[order] = np.arange(len(words))
    base = len(words)
    key = np.zeros(idx.shape[0], dtype=np.int64)
    for k in range(idx.shape[1]):
        key = key * base + rank[idx[:, k]]
    uniq, codes = np.unique(key, return_inverse=True)
    sorted_words = np.asarray(words, dtype=object)[order]
    digits = []
    rest = uniq
    for _ in range(idx.shape[1]):
        digits.append(rest % base)
        rest = rest // base
    out = sorted_words[digits[-1]]
    for d in reversed(digits[:-1]):
        out = out + " " + sorted_words[d]
    return codes.astype(np.int32).reshape(-1), list(out)


def _comments(rng: np.random.Generator, n: int, nwords: int = 5
              ) -> Tuple[np.ndarray, list]:
    """Comments of ``nwords`` words from the fixed vocabulary."""
    idx = rng.integers(0, len(_COMMENT_WORDS), size=(n, nwords))
    return _word_columns(idx, _COMMENT_WORDS)


def _phones(rng: np.random.Generator, nationkey: np.ndarray
            ) -> Tuple[np.ndarray, list]:
    """``cc-aaa-bbb-cccc`` with cc = nation key + 10. The fields have
    fixed widths, so the numeric key sorts as the strings do."""
    n = len(nationkey)
    a = rng.integers(100, 1000, n)
    b = rng.integers(100, 1000, n)
    c = rng.integers(1000, 10000, n)
    key = ((nationkey.astype(np.int64) + 10) * 1000 + a) * 1000 + b
    key = key * 10000 + c
    uniq, codes = np.unique(key, return_inverse=True)
    values = [f"{k // 10**10}-{k // 10**7 % 1000}-{k // 10**4 % 1000}-"
              f"{k % 10**4}" for k in uniq.tolist()]
    return codes.astype(np.int32).reshape(-1), values


def _acctbal(rng: np.random.Generator, n: int) -> np.ndarray:
    """Cents uniform over [-999.99, 9999.99]."""
    return rng.integers(-99999, 999999 + 1, n).astype(np.int64)


def _part_suppliers(partkeys: np.ndarray, i: np.ndarray, num_supp: int
                    ) -> np.ndarray:
    """Spec 4.2.3 supplier selection: the i-th (0..3) supplier of part p."""
    p = partkeys.astype(np.int64)
    s = np.int64(num_supp)
    return (p + i * (s // 4 + (p - 1) // s)) % s + 1


# ------------------------------------------------------------ lineitem

#: the last scale's lineitem draws, kept for the next caller at that
#: scale: the Q1/Q6 columns in both money schemas and then the eight
#: tables draw them once (``tpch_columns`` takes them out)
_DRAWN: Dict[Tuple[float, int], tuple] = {}


def _lineitem(sf: float, seed: int, keep: bool = True):
    """Lineitem's Q1/Q3/Q6/Q18 columns at scale ``sf``, each order's date
    and line count, and the part keys and receipt dates those draws
    made; each call gets dicts of its own over the same arrays. With
    ``keep`` the draws stay for the next call at this scale."""
    key = (sf, seed)
    drawn = _DRAWN.pop(key, None) or _draw_lineitem(sf, seed)
    _DRAWN.clear()
    if keep:
        _DRAWN[key] = drawn
    columns, odate, nlines, extra = drawn
    return dict(columns), odate, nlines, dict(extra)


def _draw_lineitem(sf: float, seed: int):
    rng = np.random.default_rng(seed)
    num_orders = int(1_500_000 * sf)
    num_part = int(200_000 * sf)

    odate = rng.integers(START_DATE, END_DATE - 151 + 1, num_orders
                         ).astype(np.int32)
    nlines = rng.integers(1, 8, num_orders)
    l_odate = np.repeat(odate, nlines)
    nl = len(l_odate)

    partkey = rng.integers(1, num_part + 1, nl)
    quantity = rng.integers(1, 51, nl)
    retail_cents = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    extprice = quantity * retail_cents
    del retail_cents
    discount = rng.integers(0, 11, nl)
    tax = rng.integers(0, 9, nl)

    shipdate = (l_odate + rng.integers(1, 122, nl)).astype(np.int32)
    del l_odate
    receiptdate = shipdate + rng.integers(1, 31, nl).astype(np.int32)
    returned = receiptdate <= CURRENT_DATE
    rf_choice = rng.integers(0, 2, nl)
    # codes into RETURNFLAGS: R if returned and choice 0, A if returned
    # otherwise, N if not returned
    returnflag = np.where(returned, np.where(rf_choice == 0, 2, 0),
                          1).astype(np.int32)
    del returned, rf_choice
    linestatus = (shipdate > CURRENT_DATE).astype(np.int32)

    columns = {
        "l_orderkey": np.repeat(
            np.arange(1, num_orders + 1, dtype=np.int64), nlines),
        "l_quantity": (quantity * 100).astype(np.int64),
        "l_extendedprice": extprice.astype(np.int64),
        "l_discount": discount.astype(np.int64),
        "l_tax": tax.astype(np.int64),
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipdate.astype("datetime64[D]"),
    }
    extra = {"l_partkey": partkey.astype(np.int64),
             "l_receiptdate": receiptdate}
    return columns, odate, nlines, extra


def lineitem_columns(sf: float, seed: int
                     ) -> Tuple[Columns, Dict[str, list]]:
    """The lineitem columns Q1 and Q6 read, at scale ``sf``: money as
    int64 cents, ``l_shipdate`` as ``datetime64[D]``, flags as int32
    codes into the returned dictionaries. About 6M rows per unit of
    ``sf``."""
    columns, _, _, _ = _lineitem(sf, seed)
    dictionaries = {"l_returnflag": list(RETURNFLAGS),
                    "l_linestatus": list(LINESTATUSES)}
    return columns, dictionaries


# ------------------------------------------------------------ dimensions

def _region() -> Tuple[Columns, Dict[str, list]]:
    return ({"r_regionkey": np.arange(5, dtype=np.int64),
             "r_name": np.arange(5, dtype=np.int32)},
            {"r_name": list(REGIONS)})


def _nation() -> Tuple[Columns, Dict[str, list]]:
    return ({"n_nationkey": np.arange(25, dtype=np.int64),
             "n_name": np.arange(25, dtype=np.int32),
             "n_regionkey": np.asarray([r for _, r in NATIONS], np.int64)},
            {"n_name": [n for n, _ in NATIONS]})


def _supplier(sf: float, seed: int) -> Tuple[Columns, Dict[str, list]]:
    n = int(10_000 * sf)
    rng = np.random.default_rng([seed, 4])
    keys = np.arange(1, n + 1, dtype=np.int64)
    nationkey = rng.integers(0, 25, n).astype(np.int64)
    idx = rng.integers(0, len(_COMMENT_WORDS), size=(n, 5))
    words = np.asarray(_COMMENT_WORDS, dtype=object)
    comments = words[idx[:, 0]]
    for k in range(1, 5):
        comments = comments + " " + words[idx[:, k]]
    # spec: SF*5 suppliers carry "Customer Complaints" (Q16's filter)
    bad = rng.choice(n, size=max(int(5 * sf), 1), replace=False)
    comments[bad] = comments[bad] + " Customer Complaints"
    address, address_d = _comments(rng, n, 3)
    phone, phone_d = _phones(rng, nationkey)
    comment, comment_d = _encode(comments)
    columns = {
        "s_suppkey": keys,
        "s_name": np.arange(n, dtype=np.int32),
        "s_address": address,
        "s_nationkey": nationkey,
        "s_phone": phone,
        "s_acctbal": _acctbal(rng, n),
        "s_comment": comment,
    }
    return columns, {"s_name": [f"Supplier#{k:09d}" for k in range(1, n + 1)],
                     "s_address": address_d, "s_phone": phone_d,
                     "s_comment": comment_d}


def _customer_more(sf: float, seed: int) -> Tuple[Columns, Dict[str, list]]:
    """The customer columns beyond Q3/Q18's."""
    n = int(150_000 * sf)
    rng = np.random.default_rng([seed, 3])
    nationkey = rng.integers(0, 25, n).astype(np.int64)
    address, address_d = _comments(rng, n, 3)
    phone, phone_d = _phones(rng, nationkey)
    acctbal = _acctbal(rng, n)
    comment, comment_d = _comments(rng, n)
    return ({"c_address": address, "c_nationkey": nationkey,
             "c_phone": phone, "c_acctbal": acctbal, "c_comment": comment},
            {"c_address": address_d, "c_phone": phone_d,
             "c_comment": comment_d})


def _part(sf: float, seed: int) -> Tuple[Columns, Dict[str, list]]:
    n = int(200_000 * sf)
    rng = np.random.default_rng([seed, 5])
    names, names_d = _word_columns(
        rng.integers(0, len(_P_NAME_WORDS), size=(n, 5)), _P_NAME_WORDS)
    mfgr = rng.integers(1, 6, n)
    brand = mfgr * 10 + rng.integers(1, 6, n)
    types = [f"{a} {b} {c}" for a in _TYPE_SYL1 for b in _TYPE_SYL2
             for c in _TYPE_SYL3]
    containers = [f"{a} {b}" for a in _CONT_SYL1 for b in _CONT_SYL2]
    p_type = rng.integers(0, len(types), n).astype(np.int32)
    size = rng.integers(1, 51, n).astype(np.int64)
    container = rng.integers(0, len(containers), n).astype(np.int32)
    # codes index the value lists below: m - 1, and the 25 brands in
    # (m, b) order
    brand_code = ((brand // 10 - 1) * 5 + brand % 10 - 1).astype(np.int32)
    columns = {
        "p_partkey": np.arange(1, n + 1, dtype=np.int64),
        "p_name": names,
        "p_mfgr": (mfgr - 1).astype(np.int32),
        "p_brand": brand_code,
        "p_type": p_type,
        "p_size": size,
        "p_container": container,
    }
    return columns, {
        "p_name": names_d,
        "p_mfgr": [f"Manufacturer#{m}" for m in range(1, 6)],
        "p_brand": [f"Brand#{m}{b}" for m in range(1, 6)
                    for b in range(1, 6)],
        "p_type": types, "p_container": containers}


def _partsupp(sf: float, seed: int) -> Columns:
    parts = int(200_000 * sf)
    num_supp = int(10_000 * sf)
    rng = np.random.default_rng([seed, 6])
    partkeys = np.repeat(np.arange(1, parts + 1, dtype=np.int64), 4)
    i = np.tile(np.arange(4, dtype=np.int64), parts)
    n = len(partkeys)
    return {
        "ps_partkey": partkeys,
        "ps_suppkey": _part_suppliers(partkeys, i, num_supp),
        "ps_availqty": rng.integers(1, 10_000, n).astype(np.int64),
        # cents uniform over [1.00, 1000.00]
        "ps_supplycost": rng.integers(100, 100_000 + 1, n).astype(np.int64),
    }


# ------------------------------------------------------------ all tables

def tpch_columns(sf: float, seed: int,
                 tables: Optional[Iterable[str]] = None
                 ) -> Tuple[Dict[str, Columns], Dict[str, list]]:
    """The columns of ``tables`` (default: all eight) at scale ``sf`` and
    the dictionaries of their string columns.

    * ``o_custkey`` follows the spec rule the JAX package applies: only
      customers whose key is not a multiple of 3 place orders.
    * ``o_totalprice`` is the sum over the order's lines of
      ``l_extendedprice * (1 + l_tax) * (1 - l_discount)``, each line
      rounded to cents half up (all amounts are positive) before the sum,
      computed exactly in int64.
    * ``o_orderstatus`` is F when every line's status is F, O when every
      one is O, else P.
    * ``l_suppkey`` is one of the part's four suppliers (spec 4.2.3), the
      same four partsupp lists, so Q9's partsupp join always matches.
    * ``c_name`` is ``Customer#%09d`` of the key, ``s_name``
      ``Supplier#%09d``: their sorted dictionaries are in key order.
    """
    want = list(TABLES if tables is None else tables)
    unknown = set(want) - set(TABLES)
    if unknown:
        raise ValueError(f"no TPC-H tables {sorted(unknown)}")
    out: Dict[str, Columns] = {}
    dictionaries: Dict[str, list] = {}
    if "region" in want:
        out["region"], d = _region()
        dictionaries.update(d)
    if "nation" in want:
        out["nation"], d = _nation()
        dictionaries.update(d)
    if "supplier" in want:
        out["supplier"], d = _supplier(sf, seed)
        dictionaries.update(d)
    if "part" in want:
        out["part"], d = _part(sf, seed)
        dictionaries.update(d)
    if "partsupp" in want:
        out["partsupp"] = _partsupp(sf, seed)
    if not {"customer", "orders", "lineitem"} & set(want):
        return {t: out[t] for t in want}, dictionaries

    lineitem, odate, nlines, extra = _lineitem(sf, seed, keep=False)
    rng = np.random.default_rng([seed, 1])
    num_orders = len(odate)
    num_cust = int(150_000 * sf)
    num_supp = int(10_000 * sf)

    ck = rng.integers(1, num_cust + 1, num_orders)
    ck = np.where(ck % 3 == 0, (ck % (num_cust - 1)) + 1, ck)
    ck = np.where(ck % 3 == 0, ck + 1, ck)
    ck = np.where(ck > num_cust, 1, ck)
    segment = rng.integers(0, 5, num_cust).astype(np.int32)

    starts = np.concatenate([[0], np.cumsum(nlines)[:-1]])
    if "lineitem" in want or "orders" in want:
        rng2 = np.random.default_rng([seed, 2])
        nl = len(extra["l_partkey"])
        l_odate = np.repeat(odate, nlines)
        supp_i = rng2.integers(0, 4, nl).astype(np.int64)
        lineitem["l_partkey"] = extra["l_partkey"]
        # each order's lines numbered from 1 (no draw: the other columns
        # keep their values)
        lineitem["l_linenumber"] = (
            np.arange(nl) - np.repeat(starts, nlines) + 1).astype(np.int32)
        lineitem["l_suppkey"] = _part_suppliers(extra["l_partkey"], supp_i,
                                                num_supp)
        del supp_i
        lineitem["l_commitdate"] = (
            l_odate + rng2.integers(30, 91, nl)).astype("datetime64[D]")
        del l_odate
        lineitem["l_receiptdate"] = extra["l_receiptdate"].astype(
            "datetime64[D]")
        lineitem["l_shipinstruct"] = rng2.integers(
            0, len(SHIP_INSTRUCT), nl).astype(np.int32)
        lineitem["l_shipmode"] = rng2.integers(
            0, len(SHIP_MODES), nl).astype(np.int32)
        priority = rng2.integers(0, 5, num_orders).astype(np.int32)
        o_comment, o_comment_d = _comments(rng2, num_orders)
    del extra

    if "orders" in want:
        # per line: cents * (100 + tax) * (100 - discount) is in units of
        # 1e-6 dollars; + 5000 and floor-divide by 1e4 rounds to cents
        # half up
        amount = (lineitem["l_extendedprice"] * (100 + lineitem["l_tax"])
                  * (100 - lineitem["l_discount"]) + 5000) // 10000
        open_lines = np.add.reduceat(lineitem["l_linestatus"].astype(
            np.int64), starts)
        status = np.where(open_lines == 0, 0,
                          np.where(open_lines == nlines, 1, 2))
        out["orders"] = {
            "o_orderkey": np.arange(1, num_orders + 1, dtype=np.int64),
            "o_custkey": ck.astype(np.int64),
            "o_orderstatus": status.astype(np.int32),
            "o_orderdate": odate.astype("datetime64[D]"),
            "o_orderpriority": priority,
            "o_shippriority": np.zeros(num_orders, dtype=np.int64),
            "o_totalprice": np.add.reduceat(amount, starts).astype(np.int64),
            "o_comment": o_comment,
        }
        del amount
        dictionaries.update({"o_orderstatus": list(ORDERSTATUSES),
                             "o_orderpriority": list(PRIORITIES),
                             "o_comment": o_comment_d})
    if "customer" in want:
        more, d = _customer_more(sf, seed)
        out["customer"] = {
            "c_custkey": np.arange(1, num_cust + 1, dtype=np.int64),
            "c_name": np.arange(num_cust, dtype=np.int32),
            "c_mktsegment": segment,
            **more,
        }
        dictionaries.update(d)
        dictionaries.update({
            "c_name": [f"Customer#{k:09d}" for k in range(1, num_cust + 1)],
            "c_mktsegment": list(SEGMENTS)})
    if "lineitem" in want:
        out["lineitem"] = lineitem
        dictionaries.update({"l_returnflag": list(RETURNFLAGS),
                             "l_linestatus": list(LINESTATUSES),
                             "l_shipinstruct": list(SHIP_INSTRUCT),
                             "l_shipmode": list(SHIP_MODES)})
    return {t: out[t] for t in want}, dictionaries


def as_money_schema(columns: Columns, money: str
                    ) -> Tuple[Columns, Optional[dict]]:
    """Columns and decimal overrides of one money schema: ``"cents"``
    (DECIMAL lanes of unscaled cents) or ``"double"`` (cents / 100 as
    float64)."""
    if money == "cents":
        return dict(columns), {c: ps for c, ps in CENTS_OVERRIDES.items()
                               if c in columns}
    if money == "double":
        out = dict(columns)
        for c in MONEY_COLUMNS:
            if c in columns:
                out[c] = columns[c] / 100.0
        return out, None
    raise ValueError(f"money schema {money!r}: expected 'cents' or 'double'")


def table_dictionaries(columns: Columns, dictionaries: Dict[str, list]):
    """The dictionaries of one table's string columns."""
    return {c: v for c, v in dictionaries.items() if c in columns}


def register_tpch_lineitem(
    sf: float, seed: int, money: str = "cents",
    batch_rows: int = 1 << 23,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Columns, Dict[str, list]]:
    """Generate lineitem's Q1/Q6 columns and register them as
    ``lineitem`` in either money schema (Q1 and Q6 read nothing else).
    Returns the generated cents columns and dictionaries, from which
    callers compute their oracles."""
    from velox_tpu_torch.io.catalog import register_columns

    columns, dictionaries = lineitem_columns(sf, seed)
    cols, overrides = as_money_schema(columns, money)
    register_columns("lineitem", cols, dictionaries, batch_rows, overrides,
                     device)
    return columns, dictionaries


def register_tpch_tables(
    sf: float, seed: int, money: str = "cents",
    batch_rows: int = 1 << 23,
    device: Optional[Union[str, torch.device]] = None,
    tables: Optional[Iterable[str]] = None,
) -> Tuple[Dict[str, Columns], Dict[str, list]]:
    """Generate and register ``tables`` (default: all eight) in either
    money schema, each in splits of at most ``batch_rows`` rows. Returns
    the generated cents columns of every table and the dictionaries, for
    the callers' oracles."""
    from velox_tpu_torch.io.catalog import register_columns

    data, dictionaries = tpch_columns(sf, seed, tables)
    for name, columns in data.items():
        cols, overrides = as_money_schema(columns, money)
        register_columns(name, cols, table_dictionaries(columns, dictionaries),
                         batch_rows, overrides, device)
    return data, dictionaries
