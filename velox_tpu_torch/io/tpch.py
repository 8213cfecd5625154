"""TPC-H lineitem, orders and customer generator, from an explicit seed.

The distributions are those of ``gen_orders_lineitem`` and ``gen_customer``
in the JAX package's ``io/tpch.py`` (spec-shaped, not dbgen-exact),
restricted to the columns Q1, Q3, Q6 and Q18 read. Unlike that generator,
the stream is seeded by the caller, so two processes given one seed
produce the same tables. Money is emitted as int64 cents and string
columns as int32 codes into a sorted dictionary, so the generator holds no
Python strings per row at SF10's 60M rows.

Two generators share the seed: ``default_rng(seed)`` draws every lineitem
value (so the Q1/Q6 columns do not depend on whether orders and customer
are generated), ``default_rng([seed, 1])`` draws the orders and customer
values.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Tuple, Union

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
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]

MONEY_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "o_totalprice")

#: unscaled-cents decimal lanes of the "cents" schema (the overrides the
#: JAX package's narrow-lane tests register)
CENTS_OVERRIDES = {
    "l_extendedprice": (9, 2), "l_discount": (3, 2),
    "l_quantity": (4, 2), "l_tax": (3, 2), "o_totalprice": (12, 2)}

Columns = Dict[str, np.ndarray]


def _lineitem(sf: float, seed: int) -> Tuple[Columns, np.ndarray, np.ndarray]:
    """Lineitem at scale ``sf``, plus each order's date and line count."""
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
    del partkey
    extprice = quantity * retail_cents
    del retail_cents
    discount = rng.integers(0, 11, nl)
    tax = rng.integers(0, 9, nl)

    shipdate = (l_odate + rng.integers(1, 122, nl)).astype(np.int32)
    del l_odate
    receiptdate = shipdate + rng.integers(1, 31, nl).astype(np.int32)
    returned = receiptdate <= CURRENT_DATE
    del receiptdate
    rf_choice = rng.integers(0, 2, nl)
    # codes into RETURNFLAGS: R if returned and choice 0, A if returned
    # otherwise, N if not returned
    returnflag = np.where(returned, np.where(rf_choice == 0, 2, 0),
                          1).astype(np.int32)
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
    return columns, odate, nlines


def lineitem_columns(sf: float, seed: int
                     ) -> Tuple[Columns, Dict[str, list]]:
    """The lineitem columns at scale ``sf``: money as int64 cents,
    ``l_shipdate`` as ``datetime64[D]``, flags as int32 codes into the
    returned dictionaries. About 6M rows per unit of ``sf``."""
    columns, _, _ = _lineitem(sf, seed)
    dictionaries = {"l_returnflag": list(RETURNFLAGS),
                    "l_linestatus": list(LINESTATUSES)}
    return columns, dictionaries


def tpch_columns(sf: float, seed: int
                 ) -> Tuple[Dict[str, Columns], Dict[str, list]]:
    """``{"lineitem", "orders", "customer"}`` columns at scale ``sf`` and
    the dictionaries of their string columns.

    * ``o_custkey`` follows the spec rule the JAX package applies: only
      customers whose key is not a multiple of 3 place orders.
    * ``o_totalprice`` is the sum over the order's lines of
      ``l_extendedprice * (1 + l_tax) * (1 - l_discount)``, each line
      rounded to cents half up (all amounts are positive) before the sum,
      computed exactly in int64.
    * ``c_name`` is ``Customer#%09d`` of the key, so its sorted dictionary
      is in key order; ``c_mktsegment`` codes index ``SEGMENTS``.
    """
    lineitem, odate, nlines = _lineitem(sf, seed)
    rng = np.random.default_rng([seed, 1])
    num_orders = len(odate)
    num_cust = int(150_000 * sf)

    ck = rng.integers(1, num_cust + 1, num_orders)
    ck = np.where(ck % 3 == 0, (ck % (num_cust - 1)) + 1, ck)
    ck = np.where(ck % 3 == 0, ck + 1, ck)
    ck = np.where(ck > num_cust, 1, ck)
    segment = rng.integers(0, 5, num_cust).astype(np.int32)

    # per line: cents * (100 + tax) * (100 - discount) is in units of
    # 1e-6 dollars; + 5000 and floor-divide by 1e4 rounds to cents half up
    amount = (lineitem["l_extendedprice"] * (100 + lineitem["l_tax"])
              * (100 - lineitem["l_discount"]) + 5000) // 10000
    starts = np.concatenate([[0], np.cumsum(nlines)[:-1]])
    orders = {
        "o_orderkey": np.arange(1, num_orders + 1, dtype=np.int64),
        "o_custkey": ck.astype(np.int64),
        "o_orderdate": odate.astype("datetime64[D]"),
        "o_shippriority": np.zeros(num_orders, dtype=np.int64),
        "o_totalprice": np.add.reduceat(amount, starts).astype(np.int64),
    }
    del amount
    customer = {
        "c_custkey": np.arange(1, num_cust + 1, dtype=np.int64),
        "c_name": np.arange(num_cust, dtype=np.int32),
        "c_mktsegment": segment,
    }
    dictionaries = {
        "l_returnflag": list(RETURNFLAGS),
        "l_linestatus": list(LINESTATUSES),
        "c_name": [f"Customer#{k:09d}" for k in range(1, num_cust + 1)],
        "c_mktsegment": list(SEGMENTS),
    }
    return {"lineitem": lineitem, "orders": orders,
            "customer": customer}, dictionaries


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


def _table_dicts(columns: Columns, dictionaries: Dict[str, list]):
    return {c: v for c, v in dictionaries.items() if c in columns}


def register_tpch_lineitem(
    sf: float, seed: int, money: str = "cents",
    batch_rows: int = 1 << 23,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Columns, Dict[str, list]]:
    """Generate lineitem and register it as ``lineitem`` in either money
    schema (Q1 and Q6 read nothing else). Returns the generated cents
    columns and dictionaries, from which callers compute their oracles."""
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
) -> Tuple[Dict[str, Columns], Dict[str, list]]:
    """Generate and register ``lineitem``, ``orders`` and ``customer``
    (what Q1, Q3, Q6 and Q18 read) in either money schema, each in splits
    of at most ``batch_rows`` rows. Returns the generated cents columns of
    every table and the dictionaries, for the callers' oracles."""
    from velox_tpu_torch.io.catalog import register_columns

    tables, dictionaries = tpch_columns(sf, seed)
    for name, columns in tables.items():
        cols, overrides = as_money_schema(columns, money)
        register_columns(name, cols, _table_dicts(columns, dictionaries),
                         batch_rows, overrides, device)
    return tables, dictionaries
