"""The string-function families over the TPC-H tables at full width, and
their oracles computed on the host from the generated arrays.

Each family is one plan over real string columns:

* ``short``: lineitem's short dictionaries (``l_shipmode``,
  ``l_shipinstruct``) through the one-argument and multi-argument
  transforms, the hashes and codecs, and ``date_format``,
  ``format_datetime``, ``day_name`` and ``month_name`` over
  ``l_shipdate``;
* ``cross``: the filter ``l_shipinstruct > l_shipmode``, a compare of two
  columns with different dictionaries;
* ``customer``: ``c_phone``, ``c_name``, ``c_address`` and ``c_comment``
  (about 1.5M distinct values each at SF10 but the address's 80,000),
  among them two string casts whose answers the generator fixes: the
  phone's country code is ``c_nationkey + 10`` and the name's digits
  are ``c_custkey``;
* ``part``: regex, ``split_part``, ``ends_with``, JSON built by
  ``concat`` and a base64 round trip over ``p_type``;
* ``comment``: ``orders.o_comment``, the largest dictionary of the
  tables (about 14M distinct values at SF10).

``plan_aggregate`` sums money and counts rows grouped by two transformed
keys, ``lower(l_returnflag)`` and ``concat(l_linestatus, '-')``: kArray
keys, which under narrow lanes is one launch of the grouped-sum kernel
B2 per split.

Oracles apply Python's own functions (``str``, ``re``, ``hashlib``,
``zlib``, ``base64``, ``urllib``, ``json``, ``datetime``) to each
distinct input string of the generator's dictionaries; ``soundex``,
``levenshtein_distance`` and XXH64 come from ``functions/hostfns.py``.
A column's oracle is a ``Keyed``: one result per distinct input, and
each row's input. ``check`` holds a result's rows against it: a string
result through its result dictionary, every row.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import json
import re
import urllib.parse
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from velox_tpu_torch.tpcds.window_plans import Arrays, compare

_EPOCH = datetime.date(1970, 1, 1)

SHORT = {
    "upper_mode": "upper(l_shipmode)",
    "lower_instr": "lower(l_shipinstruct)",
    "lpad_mode": "lpad(l_shipmode, 9, '*')",
    "concat_mode": "concat('<', l_shipmode, '>')",
    "replace_instr": "replace(l_shipinstruct, ' ', '_')",
    "len_instr": "length(l_shipinstruct)",
    "strpos_instr": "strpos(l_shipinstruct, 'IN')",
    "starts_mode": "starts_with(l_shipmode, 'RE')",
    "md5_mode": "md5(l_shipmode)",
    "hex_mode": "to_hex(l_shipmode)",
    "soundex_instr": "soundex(l_shipinstruct)",
    "xx_mode": "xxhash64(l_shipmode)",
    "crc_instr": "crc32(l_shipinstruct)",
    "fmt_ship": "date_format(l_shipdate, '%Y-%m')",
    "fdt_ship": "format_datetime(l_shipdate, 'yyyy-MM-dd')",
    "day_ship": "day_name(l_shipdate)",
    "month_ship": "month_name(l_shipdate)",
}

CROSS_FILTER = "l_shipinstruct > l_shipmode"
CROSS = {"l_orderkey": "l_orderkey", "l_partkey": "l_partkey"}

CUSTOMER = {
    "split_phone": "split_part(c_phone, '-', 2)",
    "rx_phone": "regexp_extract(c_phone, '[0-9]+$')",
    "replace_phone": "replace(c_phone, '-', '')",
    "nation_cast": "CAST(substr(c_phone, 1, 2) AS INTEGER)",
    "key_cast": "CAST(substr(c_name, 10) AS BIGINT)",
    "trim_addr": "trim(c_address)",
    "rev_addr": "reverse(c_address)",
    "lev_addr": "levenshtein_distance(split_part(c_address, ' ', 1), "
                "'furiously')",
    "url_addr": "url_encode(c_address)",
    "addr_lt_comment": "c_address < c_comment",
}

PART = {
    "rx_type": "regexp_like(p_type, '^(STANDARD|PROMO) ')",
    "type3": "split_part(p_type, ' ', 3)",
    "ends_type": "ends_with(p_type, 'BRASS')",
    "json_type": "json_extract_scalar(concat('{\"t\": \"', p_type, '\"}'), "
                 "'$.t')",
    "json_words": "json_array_length(concat('[\"', "
                  "replace(p_type, ' ', '\",\"'), '\"]'))",
    "b64_type": "from_base64(to_base64(p_type))",
}

COMMENT = {
    "upper_comment": "upper(o_comment)",
    "len_comment": "length(o_comment)",
    "rx_comment": "regexp_like(o_comment, 'special.*requests')",
}


def _project(exprs: Dict[str, str]) -> List[str]:
    return [f"{e} AS {n}" for n, e in exprs.items()]


def plan_short(pb):
    return pb().table_scan("lineitem", columns=[
        "l_shipmode", "l_shipinstruct", "l_shipdate"]).project(
        _project(SHORT))


def plan_cross(pb):
    return (pb().table_scan("lineitem", columns=[
        "l_orderkey", "l_partkey", "l_shipinstruct", "l_shipmode"])
        .filter(CROSS_FILTER).project(_project(CROSS)))


def plan_customer(pb):
    return pb().table_scan("customer", columns=[
        "c_phone", "c_name", "c_address", "c_comment"]).project(
        _project(CUSTOMER))


def plan_part(pb):
    return pb().table_scan("part", columns=["p_type"]).project(
        _project(PART))


def plan_comment(pb):
    return pb().table_scan("orders", columns=["o_comment"]).project(
        _project(COMMENT))


AGGREGATE_KEYS = {"rf": "lower(l_returnflag)",
                  "ls": "concat(l_linestatus, '-')"}


def plan_aggregate(pb):
    return (pb().table_scan("lineitem", columns=[
        "l_returnflag", "l_linestatus", "l_extendedprice", "l_quantity"])
        .project(_project(AGGREGATE_KEYS) + ["l_extendedprice",
                                             "l_quantity"])
        .aggregate(["rf", "ls"], ["sum(l_extendedprice) AS s_price",
                                  "sum(l_quantity) AS s_qty",
                                  "count(*) AS n"])
        .order_by(["rf", "ls"]))


# ------------------------------------------------------------- oracles

class Keyed:
    """An oracle column: ``per_key[k]`` is the result for input ``k``
    (None for NULL) and ``keys[i]`` row i's input (-1 for NULL)."""

    __slots__ = ("per_key", "keys")

    def __init__(self, per_key, keys: np.ndarray):
        self.per_key = np.empty(len(per_key), dtype=object)
        self.per_key[:] = list(per_key)
        self.keys = np.asarray(keys)

    def gather(self, dtype) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Each row's result in lane ``dtype``, with its NULL mask."""
        ok = np.not_equal(self.per_key, None).astype(bool)
        vals = np.zeros(len(self.per_key), dtype=dtype)
        vals[ok] = self.per_key[ok].tolist()
        k = np.clip(self.keys, 0, None)
        mask = ok[k] & (self.keys >= 0)
        return vals[k], None if mask.all() else mask


def _keyed(strings: list, codes: np.ndarray, fn: Callable) -> Keyed:
    return Keyed([fn(s) for s in strings], codes)


def _day_keyed(days: np.ndarray, fn: Callable) -> Keyed:
    lo, hi = int(days.min()), int(days.max())
    return Keyed([fn(_EPOCH + datetime.timedelta(days=d))
                  for d in range(lo, hi + 1)], days - lo)


def _days(a: np.ndarray) -> np.ndarray:
    return a.astype("datetime64[D]").astype(np.int64)


def _lpad(s: str, n: int, pad: str) -> str:
    return s[:n] if len(s) >= n else s.rjust(n, pad)


def oracle_short(li, dicts) -> Dict[str, Keyed]:
    from velox_tpu_torch.functions import hostfns as H

    mode, instr = li["l_shipmode"], li["l_shipinstruct"]
    modes, instrs = dicts["l_shipmode"], dicts["l_shipinstruct"]
    ship = _days(li["l_shipdate"])
    return {
        "upper_mode": _keyed(modes, mode, str.upper),
        "lower_instr": _keyed(instrs, instr, str.lower),
        "lpad_mode": _keyed(modes, mode, lambda s: _lpad(s, 9, "*")),
        "concat_mode": _keyed(modes, mode, lambda s: "<" + s + ">"),
        "replace_instr": _keyed(instrs, instr,
                                lambda s: s.replace(" ", "_")),
        "len_instr": _keyed(instrs, instr, len),
        "strpos_instr": _keyed(instrs, instr, lambda s: s.find("IN") + 1),
        "starts_mode": _keyed(modes, mode, lambda s: s.startswith("RE")),
        "md5_mode": _keyed(modes, mode,
                           lambda s: hashlib.md5(s.encode()).hexdigest()),
        "hex_mode": _keyed(modes, mode, lambda s: s.encode().hex().upper()),
        "soundex_instr": _keyed(instrs, instr, H.soundex),
        "xx_mode": _keyed(modes, mode, lambda s: H._xxh64_int(
            s.encode()).to_bytes(8, "big").hex()),
        "crc_instr": _keyed(instrs, instr,
                            lambda s: zlib.crc32(s.encode())),
        "fmt_ship": _day_keyed(ship, lambda d: d.strftime("%Y-%m")),
        "fdt_ship": _day_keyed(ship, lambda d: d.strftime("%Y-%m-%d")),
        "day_ship": _day_keyed(ship, lambda d: d.strftime("%A")),
        "month_ship": _day_keyed(ship, lambda d: d.strftime("%B")),
    }


def oracle_cross(li, dicts) -> Arrays:
    instrs = np.asarray(dicts["l_shipinstruct"], dtype=object)
    modes = np.asarray(dicts["l_shipmode"], dtype=object)
    greater = instrs[:, None] > modes[None, :]
    keep = greater[li["l_shipinstruct"], li["l_shipmode"]]
    return {"l_orderkey": (li["l_orderkey"][keep], None),
            "l_partkey": (li["l_partkey"][keep], None)}


def oracle_customer(cu, dicts) -> Dict[str, object]:
    from velox_tpu_torch.functions import hostfns as H

    phone, phones = cu["c_phone"], dicts["c_phone"]
    addr, addrs = cu["c_address"], dicts["c_address"]
    comments = np.asarray(dicts["c_comment"], dtype=object)
    addr_rows = np.asarray(addrs, dtype=object)[addr]
    # each address's first word, numbered by first appearance
    first: Dict[str, int] = {}
    word_of = np.asarray([first.setdefault(s.split(" ")[0], len(first))
                          for s in addrs], dtype=np.int64)
    words = list(first)
    return {
        "split_phone": _keyed(phones, phone, lambda s: s.split("-")[1]),
        "rx_phone": _keyed(phones, phone,
                           lambda s: re.search("[0-9]+$", s).group(0)),
        "replace_phone": _keyed(phones, phone,
                                lambda s: s.replace("-", "")),
        "nation_cast": (cu["c_nationkey"].astype(np.int32) + 10, None),
        "key_cast": (cu["c_custkey"].astype(np.int64), None),
        "trim_addr": _keyed(addrs, addr, str.strip),
        "rev_addr": _keyed(addrs, addr, lambda s: s[::-1]),
        "lev_addr": Keyed([H.levenshtein_distance(w, "furiously")
                           for w in words], word_of[addr]),
        "url_addr": _keyed(addrs, addr, urllib.parse.quote_plus),
        "addr_lt_comment": (addr_rows < comments[cu["c_comment"]], None),
    }


def oracle_part(pa, dicts) -> Dict[str, Keyed]:
    ptype, types = pa["p_type"], dicts["p_type"]
    rx = re.compile("^(STANDARD|PROMO) ")
    return {
        "rx_type": _keyed(types, ptype, lambda s: rx.search(s) is not None),
        "type3": _keyed(types, ptype, lambda s: s.split(" ")[2]),
        "ends_type": _keyed(types, ptype, lambda s: s.endswith("BRASS")),
        "json_type": _keyed(types, ptype, lambda s: json.loads(
            json.dumps({"t": s}))["t"]),
        "json_words": _keyed(types, ptype, lambda s: len(json.loads(
            json.dumps(s.split(" "))))),
        "b64_type": _keyed(types, ptype, lambda s: base64.b64decode(
            base64.b64encode(s.encode())).decode()),
    }


def oracle_comment(orders, dicts) -> Dict[str, Keyed]:
    c, comments = orders["o_comment"], dicts["o_comment"]
    rx = re.compile("special.*requests")
    return {
        "upper_comment": _keyed(comments, c, str.upper),
        "len_comment": _keyed(comments, c, len),
        "rx_comment": _keyed(comments, c, lambda s: rx.search(s) is not None),
    }


def oracle_aggregate(li, dicts) -> Dict[str, list]:
    """The aggregation's rows, in ``order_by`` order, the sums exact in
    cents as ``Decimal``."""
    from decimal import Decimal

    rf = [s.lower() for s in dicts["l_returnflag"]]
    ls = [s + "-" for s in dicts["l_linestatus"]]
    pair = (li["l_returnflag"].astype(np.int64) * len(ls)
            + li["l_linestatus"])
    present, gid = np.unique(pair, return_inverse=True)
    names = [(rf[p // len(ls)], ls[p % len(ls)]) for p in present.tolist()]
    order = sorted(range(len(names)), key=names.__getitem__)
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    gid = rank[gid.reshape(-1)]
    out: Dict[str, list] = {"rf": [names[i][0] for i in order],
                            "ls": [names[i][1] for i in order]}
    for name, col in (("s_price", "l_extendedprice"),
                      ("s_qty", "l_quantity")):
        sums = np.zeros(len(order), dtype=np.int64)
        np.add.at(sums, gid, li[col].astype(np.int64))
        out[name] = [Decimal(int(v)).scaleb(-2) for v in sums]
    out["n"] = np.bincount(gid, minlength=len(order)).tolist()
    return out


#: family -> (plan, table, oracle(table columns, dictionaries))
FAMILIES: Dict[str, Tuple[Callable, str, Callable]] = {
    "short": (plan_short, "lineitem", oracle_short),
    "cross": (plan_cross, "lineitem", oracle_cross),
    "customer": (plan_customer, "customer", oracle_customer),
    "part": (plan_part, "part", oracle_part),
    "comment": (plan_comment, "orders", oracle_comment),
}


def _check_coded(name, gv, gm, dictionary, want: Keyed) -> Optional[str]:
    values = dictionary.values
    if len(values) > 1 and not (values[1:] > values[:-1]).all():
        return f"{name}: the result dictionary is not sorted and unique"
    index = {v: i for i, v in enumerate(values.tolist())}
    exp = np.asarray([-1 if v is None else index.get(v, -2)
                      for v in want.per_key.tolist()], dtype=np.int64)
    want_codes = np.where(want.keys >= 0,
                          exp[np.clip(want.keys, 0, None)], -1)
    got = gv.astype(np.int64)
    if gm is not None:
        got = np.where(gm, got, -1)
    bad = np.flatnonzero(got != want_codes)
    if bad.size == 0:
        return None
    i = int(bad[0])
    k = int(want.keys[i])
    return (f"{name} row {i}: {dictionary.decode(got[i:i + 1])[0]!r}, "
            f"want {want.per_key[k] if k >= 0 else None!r} "
            f"({bad.size} rows differ)")


def check(got: Dict[str, tuple], want: Dict[str, object],
          rtol: float = 1e-9) -> Optional[str]:
    """None when every column of ``want`` equals ``got``'s, else what
    differs. ``got`` maps a name to (values, NULL mask or None,
    dictionary or None); a string column is compared through its
    dictionary, which must be sorted and unique."""
    for name, w in want.items():
        gv, gm, d = got[name]
        if len(gv) != (len(w.keys) if isinstance(w, Keyed) else len(w[0])):
            return f"{name}: {len(gv)} rows"
        if isinstance(w, Keyed) and d is not None:
            err = _check_coded(name, gv, gm, d, w)
        else:
            if isinstance(w, Keyed):
                w = w.gather(gv.dtype)
            err = compare({name: (gv, gm)}, {name: w}, rtol=rtol)
        if err is not None:
            return err
    return None
