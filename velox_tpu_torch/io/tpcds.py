"""TPC-DS data generation (the spec-shaped subset), without pyarrow.

A numpy copy of the JAX package's ``io/tpcds.py``: the eight tables the
star-join reporting queries read (store_sales, date_dim, item, customer,
customer_address, customer_demographics, store, promotion), with the
spec's schemas, domains and referential integrity but not dsdgen's exact
rows. Every value is drawn from ``np.random.default_rng(seed)`` in the
reference's order, so the columns equal the reference's value for value.
String columns come out as int32 codes into one value list per column
(``dictionaries``), dates as ``datetime64[D]``.

Scale: store_sales holds 2.88M rows per unit of SF (the spec's per-SF
cardinality); the dimensions reach their caps by SF 1 (item 18,000,
customer 100,000, address 50,000, demographics 7,200), and store and
promotion grow with SF (120 stores and 3,000 promotions at SF 10).
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Columns = Dict[str, np.ndarray]

_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
               "Men", "Music", "Shoes", "Sports", "Women"]
_STATES = ["AL", "CA", "GA", "IL", "KS", "MI", "NY", "OH", "TN", "TX"]
_GENDERS = ["M", "F"]
_MARITAL = ["S", "M", "D", "W", "U"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_CHANNELS = ["N", "Y"]

#: the tables, in the order the generator makes them
TABLES = ("date_dim", "item", "customer", "customer_address",
          "customer_demographics", "store", "promotion", "store_sales")


def _strings(values: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
    """int32 codes into the sorted distinct values."""
    uniq, codes = np.unique(np.asarray(values, dtype=object).astype(str),
                            return_inverse=True)
    return codes.astype(np.int32), [str(v) for v in uniq]


def _dates() -> Dict[str, Union[np.ndarray, list]]:
    """date_dim: calendar rows 1998-01-01 .. 2003-12-31 (the spec's
    query windows all land in here)."""
    start = np.datetime64("1998-01-01")
    n = int((np.datetime64("2003-12-31") - start).astype(int)) + 1
    days = start + np.arange(n)
    py = [_dt.date(1998, 1, 1) + _dt.timedelta(days=i) for i in range(n)]
    months = np.array([d.month for d in py], dtype=np.int64)
    return {
        "d_date_sk": np.arange(1, n + 1, dtype=np.int64),
        "d_date": days.astype("datetime64[D]"),
        "d_year": np.array([d.year for d in py], dtype=np.int64),
        "d_moy": months,
        "d_dom": np.array([d.day for d in py], dtype=np.int64),
        "d_qoy": (months - 1) // 3 + 1,
        "d_day_name": [d.strftime("%A") for d in py],
    }


def generate_tpcds(sf: float = 0.01, seed: int = 7
                   ) -> Dict[str, Dict[str, Union[np.ndarray, list]]]:
    """The eight tables as ``{table: {column: values}}``; a string column
    is a list of ``str``. The draws are the reference's, in its order."""
    rng = np.random.default_rng(seed)
    n_item = max(int(18000 * min(sf * 55, 1.0)), 200)
    n_cust = max(int(100000 * min(sf * 10, 1.0)), 500)
    n_addr = max(n_cust // 2, 250)
    n_demo = 7200
    n_store = max(int(12 * max(sf, 0.1)), 2)
    n_promo = max(int(300 * max(sf, 0.1)), 30)
    n_ss = max(int(2_880_000 * sf), 2000)

    dd = _dates()
    n_date = len(dd["d_date_sk"])

    item = {"i_item_sk": np.arange(1, n_item + 1, dtype=np.int64)}
    item["i_item_id"] = [f"AAAAAAAA{k:08d}" for k in range(1, n_item + 1)]
    item["i_brand_id"] = rng.integers(1000001, 1010000, n_item)
    item["i_brand"] = [f"brand#{int(b) % 97}"
                       for b in rng.integers(0, 10_000, n_item)]
    item["i_category_id"] = rng.integers(1, len(_CATEGORIES) + 1, n_item)
    item["i_category"] = [str(rng.choice(_CATEGORIES))
                          for _ in range(n_item)]
    item["i_manufact_id"] = rng.integers(1, 1001, n_item)
    item["i_manager_id"] = rng.integers(1, 101, n_item)
    item["i_current_price"] = np.round(rng.uniform(0.09, 99.99, n_item), 2)

    customer = {
        "c_customer_sk": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_customer_id": [f"CUST{k:011d}" for k in range(1, n_cust + 1)],
    }
    customer["c_current_addr_sk"] = rng.integers(1, n_addr + 1, n_cust)
    customer["c_current_cdemo_sk"] = rng.integers(1, n_demo + 1, n_cust)
    customer["c_first_name"] = [f"fn{int(x)}"
                                for x in rng.integers(0, 500, n_cust)]
    customer["c_last_name"] = [f"ln{int(x)}"
                               for x in rng.integers(0, 800, n_cust)]
    customer["c_birth_month"] = rng.integers(1, 13, n_cust)
    customer["c_birth_year"] = rng.integers(1930, 2000, n_cust)

    address = {"ca_address_sk": np.arange(1, n_addr + 1, dtype=np.int64)}
    address["ca_state"] = [str(rng.choice(_STATES)) for _ in range(n_addr)]
    address["ca_zip"] = [f"{int(z):05d}"
                         for z in rng.integers(10000, 99999, n_addr)]
    address["ca_gmt_offset"] = np.array(
        [float(rng.choice([-5.0, -6.0, -7.0, -8.0]))
         for _ in range(n_addr)], dtype=np.float64)

    k = np.arange(n_demo)
    demographics = {
        "cd_demo_sk": np.arange(1, n_demo + 1, dtype=np.int64),
        "cd_gender": [_GENDERS[i % 2] for i in k],
        "cd_marital_status": [_MARITAL[i % 5] for i in k],
        "cd_education_status": [_EDUCATION[i % 7] for i in k],
    }

    store = {
        "s_store_sk": np.arange(1, n_store + 1, dtype=np.int64),
        "s_store_id": [f"STORE{k:08d}" for k in range(1, n_store + 1)],
        "s_store_name": [f"store{k}" for k in range(1, n_store + 1)],
    }
    store["s_state"] = [str(rng.choice(_STATES)) for _ in range(n_store)]
    store["s_gmt_offset"] = np.array(
        [float(rng.choice([-5.0, -6.0, -7.0])) for _ in range(n_store)],
        dtype=np.float64)

    promotion = {"p_promo_sk": np.arange(1, n_promo + 1, dtype=np.int64)}
    promotion["p_channel_email"] = [
        str(rng.choice(_CHANNELS, p=[0.9, 0.1])) for _ in range(n_promo)]
    promotion["p_channel_event"] = [
        str(rng.choice(_CHANNELS, p=[0.5, 0.5])) for _ in range(n_promo)]

    qty = rng.integers(1, 101, n_ss)
    price = np.round(rng.uniform(1.0, 200.0, n_ss), 2)
    disc = np.round(price * rng.uniform(0, 0.3, n_ss), 2)
    ss = {"ss_sold_date_sk": np.sort(rng.integers(1, n_date + 1, n_ss))}
    ss["ss_item_sk"] = rng.integers(1, n_item + 1, n_ss)
    ss["ss_customer_sk"] = rng.integers(1, n_cust + 1, n_ss)
    ss["ss_cdemo_sk"] = rng.integers(1, n_demo + 1, n_ss)
    ss["ss_store_sk"] = rng.integers(1, n_store + 1, n_ss)
    ss["ss_promo_sk"] = rng.integers(1, n_promo + 1, n_ss)
    ss["ss_quantity"] = qty
    ss["ss_list_price"] = price
    ss["ss_sales_price"] = np.round(price - disc, 2)
    ss["ss_ext_sales_price"] = np.round((price - disc) * qty, 2)
    ss["ss_ext_discount_amt"] = np.round(disc * qty, 2)
    ss["ss_coupon_amt"] = np.round(disc * rng.uniform(0, 1, n_ss), 2)
    ss["ss_wholesale_cost"] = np.round(
        price * rng.uniform(0.3, 0.7, n_ss), 2)

    return {"date_dim": dd, "item": item, "customer": customer,
            "customer_address": address,
            "customer_demographics": demographics, "store": store,
            "promotion": promotion, "store_sales": ss}


def tpcds_columns(sf: float = 0.01, seed: int = 7
                  ) -> Tuple[Dict[str, Columns], Dict[str, List[str]]]:
    """``generate_tpcds`` with every string column encoded: ``(tables,
    dictionaries)``, a table's string column holding int32 codes into
    ``dictionaries[column]`` (column names are unique across tables)."""
    tables: Dict[str, Columns] = {}
    dictionaries: Dict[str, List[str]] = {}
    for name, cols in generate_tpcds(sf, seed).items():
        out: Columns = {}
        for c, v in cols.items():
            if isinstance(v, list):
                out[c], dictionaries[c] = _strings(v)
            else:
                out[c] = np.asarray(v)
        tables[name] = out
    return tables, dictionaries


def register_tpcds(sf: float = 0.01, batch_rows: int = 1 << 20,
                   seed: int = 7, prefix: str = "",
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Tuple[Dict[str, Columns], Dict[str, List[str]]]:
    """Generate and register the eight tables as ``prefix + name``, in
    splits of at most ``batch_rows`` rows, on ``device`` (None: the CUDA
    card). Returns ``tpcds_columns``' arrays for the callers' oracles."""
    from velox_tpu_torch.io.catalog import register_columns

    tables, dictionaries = tpcds_columns(sf, seed)
    for name, cols in tables.items():
        register_columns(prefix + name, cols,
                         {c: dictionaries[c] for c in cols
                          if c in dictionaries}, batch_rows, None, device)
    return tables, dictionaries
