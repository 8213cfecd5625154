"""TPC-H lineitem generator for Q1 and Q6, from an explicit seed.

The distributions are those of ``gen_orders_lineitem`` in the JAX
package's ``io/tpch.py`` (spec-shaped, not dbgen-exact), restricted to the
columns Q1 and Q6 read. Unlike that generator, the stream is seeded by the
caller, so two processes given one seed produce the same table. Money is
emitted as int64 cents and string columns as int32 codes into a sorted
dictionary, so the generator holds no Python strings per row at SF10's
60M rows.
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

MONEY_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")

#: unscaled-cents decimal lanes of the "cents" schema (the overrides the
#: JAX package's narrow-lane tests register)
CENTS_OVERRIDES = {
    "l_extendedprice": (9, 2), "l_discount": (3, 2),
    "l_quantity": (4, 2), "l_tax": (3, 2)}


def lineitem_columns(sf: float, seed: int
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, list]]:
    """The Q1/Q6 lineitem columns at scale ``sf``: money as int64 cents,
    ``l_shipdate`` as ``datetime64[D]``, flags as int32 codes into the
    returned dictionaries. About 6M rows per unit of ``sf``."""
    rng = np.random.default_rng(seed)
    num_orders = int(1_500_000 * sf)
    num_part = int(200_000 * sf)

    odate = rng.integers(START_DATE, END_DATE - 151 + 1, num_orders
                         ).astype(np.int32)
    nlines = rng.integers(1, 8, num_orders)
    l_odate = np.repeat(odate, nlines)
    nl = len(l_odate)
    del odate, nlines

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
        "l_quantity": (quantity * 100).astype(np.int64),
        "l_extendedprice": extprice.astype(np.int64),
        "l_discount": discount.astype(np.int64),
        "l_tax": tax.astype(np.int64),
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipdate.astype("datetime64[D]"),
    }
    dictionaries = {"l_returnflag": list(RETURNFLAGS),
                    "l_linestatus": list(LINESTATUSES)}
    return columns, dictionaries


def as_money_schema(columns: Dict[str, np.ndarray], money: str
                    ) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """Columns and decimal overrides of one money schema: ``"cents"``
    (DECIMAL lanes of unscaled cents) or ``"double"`` (cents / 100 as
    float64)."""
    if money == "cents":
        return dict(columns), dict(CENTS_OVERRIDES)
    if money == "double":
        out = dict(columns)
        for c in MONEY_COLUMNS:
            out[c] = columns[c] / 100.0
        return out, None
    raise ValueError(f"money schema {money!r}: expected 'cents' or 'double'")


def register_tpch_lineitem(
    sf: float, seed: int, money: str = "cents",
    batch_rows: int = 1 << 23,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, list]]:
    """Generate lineitem and register it as ``lineitem`` in either money
    schema. Returns the generated cents columns and dictionaries, from
    which callers compute their oracles."""
    from velox_tpu_torch.io.catalog import register_columns

    columns, dictionaries = lineitem_columns(sf, seed)
    cols, overrides = as_money_schema(columns, money)
    register_columns("lineitem", cols, dictionaries, batch_rows, overrides,
                     device)
    return columns, dictionaries
