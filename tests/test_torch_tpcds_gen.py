"""The port's 24-table TPC-DS generator (``velox_tpu_torch.io.tpcds_full``)
and NULL ingest (``register_columns(..., nulls=)``).

The generator's schemas must be the JAX package's ``_SCHEMAS`` name for
name and code for code; a seed must give the same arrays and another
seed other ones; every non-NULL foreign key must find its primary key and
every return its sale; the NULL rates and the specification's money
identities must hold; and every string literal the 99 plans compare a
column with must lie in that column's value list. The catalog test holds
the port's splits of columns with NULLs (int64, int32, float64, DATE and
strings, an all-NULL string column among them) against the JAX package's
``register_arrow`` of the same values with Arrow NULL masks: values,
``valid``, dictionaries, ``stats``, ``sorted_cols`` and ``unique_cols``.
Last, a LEFT nested-loop join raises ``NotImplementedError`` in both
packages alike."""

import numpy as np
import pytest
import torch

from torch_tpch_data import TPCDS_FULL_SEED, full_arrow_table, table_in_both
from velox_tpu.io import catalog as jax_catalog
from velox_tpu.io.dsdgen import _SCHEMAS
from velox_tpu_torch.io import catalog as torch_catalog
from velox_tpu_torch.io.tpcds_full import (
    DIM_NULL_RATE, DOMAINS, FACT_NULL_RATE, SCHEMAS, TABLES, float_view,
    generate_full, register_full, row_counts,
)

SF = 0.01

#: (table, foreign key column, referenced table, its key column)
FOREIGN_KEYS = [
    (fact, fk, dim, key)
    for fact, pfx in (("store_sales", "ss"), ("catalog_sales", "cs"),
                      ("web_sales", "ws"))
    for fk, dim, key in (
        (f"{pfx}_sold_date_sk", "date_dim", "d_date_sk"),
        (f"{pfx}_sold_time_sk", "time_dim", "t_time_sk"),
        (f"{pfx}_item_sk", "item", "i_item_sk"),
        (f"{pfx}_promo_sk", "promotion", "p_promo_sk"))
] + [
    ("store_sales", "ss_customer_sk", "customer", "c_customer_sk"),
    ("store_sales", "ss_cdemo_sk", "customer_demographics", "cd_demo_sk"),
    ("store_sales", "ss_hdemo_sk", "household_demographics", "hd_demo_sk"),
    ("store_sales", "ss_addr_sk", "customer_address", "ca_address_sk"),
    ("store_sales", "ss_store_sk", "store", "s_store_sk"),
    ("catalog_sales", "cs_bill_customer_sk", "customer", "c_customer_sk"),
    ("catalog_sales", "cs_ship_addr_sk", "customer_address",
     "ca_address_sk"),
    ("catalog_sales", "cs_call_center_sk", "call_center",
     "cc_call_center_sk"),
    ("catalog_sales", "cs_catalog_page_sk", "catalog_page",
     "cp_catalog_page_sk"),
    ("catalog_sales", "cs_ship_mode_sk", "ship_mode", "sm_ship_mode_sk"),
    ("catalog_sales", "cs_warehouse_sk", "warehouse", "w_warehouse_sk"),
    ("web_sales", "ws_bill_customer_sk", "customer", "c_customer_sk"),
    ("web_sales", "ws_web_page_sk", "web_page", "wp_web_page_sk"),
    ("web_sales", "ws_web_site_sk", "web_site", "web_site_sk"),
    ("store_returns", "sr_returned_date_sk", "date_dim", "d_date_sk"),
    ("store_returns", "sr_reason_sk", "reason", "r_reason_sk"),
    ("catalog_returns", "cr_returning_customer_sk", "customer",
     "c_customer_sk"),
    ("web_returns", "wr_web_page_sk", "web_page", "wp_web_page_sk"),
    ("inventory", "inv_date_sk", "date_dim", "d_date_sk"),
    ("inventory", "inv_item_sk", "item", "i_item_sk"),
    ("inventory", "inv_warehouse_sk", "warehouse", "w_warehouse_sk"),
    ("customer", "c_current_addr_sk", "customer_address", "ca_address_sk"),
    ("customer", "c_current_cdemo_sk", "customer_demographics",
     "cd_demo_sk"),
    ("household_demographics", "hd_income_band_sk", "income_band",
     "ib_income_band_sk"),
]

#: (returns table, its sales table, returns keys, sales keys)
RETURNS = [
    ("store_returns", "store_sales",
     ("sr_ticket_number", "sr_item_sk", "sr_customer_sk"),
     ("ss_ticket_number", "ss_item_sk", "ss_customer_sk")),
    ("catalog_returns", "catalog_sales",
     ("cr_order_number", "cr_item_sk", "cr_refunded_customer_sk"),
     ("cs_order_number", "cs_item_sk", "cs_bill_customer_sk")),
    ("web_returns", "web_sales",
     ("wr_order_number", "wr_item_sk", "wr_refunded_customer_sk"),
     ("ws_order_number", "ws_item_sk", "ws_bill_customer_sk")),
]


@pytest.fixture(scope="module")
def full():
    return generate_full(SF, TPCDS_FULL_SEED)


def test_schemas_are_the_jax_packages():
    assert list(SCHEMAS) == list(_SCHEMAS) == list(TABLES)
    for t in TABLES:
        assert SCHEMAS[t] == _SCHEMAS[t], t


def test_row_counts_at_sf1_and_sf001(full):
    sf1 = row_counts(1.0)
    assert sf1["store_sales"] == 2_880_404
    assert sf1["catalog_sales"] == 1_441_548
    assert sf1["web_sales"] == 719_384
    assert sf1["inventory"] == 11_745_000
    assert sf1["customer_demographics"] == 1_920_800
    assert sf1["date_dim"] == 73_049 and sf1["time_dim"] == 86_400
    assert sf1["household_demographics"] == 7_200
    assert (sf1["income_band"], sf1["ship_mode"], sf1["reason"]) == (20, 20,
                                                                     35)
    assert [sf1[t] for t in ("item", "customer", "customer_address",
                             "store", "promotion", "warehouse", "web_site",
                             "web_page", "call_center", "catalog_page")] == [
        18_000, 100_000, 50_000, 12, 300, 5, 30, 60, 6, 11_718]
    for r, s in (("store_returns", "store_sales"),
                 ("catalog_returns", "catalog_sales"),
                 ("web_returns", "web_sales")):
        assert sf1[r] == sf1[s] // 10
    tables, _, _ = full
    small = row_counts(SF)
    assert small["store_sales"] == 28_804 and small["item"] == 300
    for t in TABLES:
        assert list(tables[t]) == [c for c, _ in SCHEMAS[t]], t
        assert {len(v) for v in tables[t].values()} == {small[t]}, t


def test_a_seed_gives_the_same_arrays_and_another_seed_others(full):
    tables, dicts, nulls = full
    again, dicts2, nulls2 = generate_full(SF, TPCDS_FULL_SEED)
    other, _, _ = generate_full(SF, TPCDS_FULL_SEED + 1)
    assert dicts == dicts2
    for t in TABLES:
        assert nulls[t].keys() == nulls2[t].keys(), t
        for c, v in tables[t].items():
            np.testing.assert_array_equal(again[t][c], v, err_msg=f"{t}.{c}")
    for t in ("store_sales", "item", "customer", "inventory"):
        assert any(not np.array_equal(other[t][c], v)
                   for c, v in tables[t].items()), t
    # the fixed dimensions draw nothing
    for t in ("date_dim", "customer_demographics", "income_band"):
        for c, v in tables[t].items():
            np.testing.assert_array_equal(other[t][c], v)


def test_calendar_and_fixed_dimensions(full):
    tables, dicts, _ = full
    dd = tables["date_dim"]
    days = dd["d_date"]
    assert str(days[0]) == "1900-01-02" and dd["d_date_sk"][0] == 2_415_022
    jan2000 = days == np.datetime64("2000-01-01")
    assert dd["d_date_sk"][jan2000][0] == 2_451_545
    assert dd["d_month_seq"][jan2000][0] == 1200
    names = np.asarray(dicts["d_day_name"])[dd["d_day_name"]]
    assert names[jan2000][0] == "Saturday" and dd["d_dow"][jan2000][0] == 6
    assert np.asarray(dicts["d_quarter_name"])[
        dd["d_quarter_name"][jan2000]][0] == "2000Q1"
    ly = dd["d_same_day_ly"][jan2000][0]
    assert ly == dd["d_date_sk"][days == np.datetime64("1999-01-01")][0]
    weeks = np.diff(dd["d_week_seq"])
    assert set(weeks) == {0, 1} and (names[1:][weeks == 1] == "Sunday").all()
    cd = tables["customer_demographics"]
    keys = np.stack([cd[c] for c, _ in SCHEMAS["customer_demographics"][1:]])
    assert len(np.unique(keys, axis=1).T) == 1_920_800
    hd = tables["household_demographics"]
    assert len(np.unique(np.stack([hd["hd_income_band_sk"],
                                   hd["hd_buy_potential"],
                                   hd["hd_dep_count"],
                                   hd["hd_vehicle_count"]]), axis=1).T) == 7200


def test_referential_integrity(full):
    tables, _, nulls = full
    for fact, fk, dim, key in FOREIGN_KEYS:
        v = tables[fact][fk]
        live = ~nulls[fact].get(fk, np.zeros(len(v), bool))
        assert np.isin(v[live], tables[dim][key]).all(), (fact, fk)
    for ret, sale, rkeys, skeys in RETURNS:
        r, s = tables[ret], tables[sale]
        rn, sn = nulls[ret], nulls[sale]
        sold = {tuple(row) for row in np.stack(
            [np.where(sn.get(c, np.zeros(len(s[c]), bool)), -1, s[c])
             for c in skeys], axis=1)}
        got = np.stack([np.where(rn.get(c, np.zeros(len(r[c]), bool)), -1,
                                 r[c]) for c in rkeys], axis=1)
        assert all(tuple(row) in sold for row in got), ret
    # returned on or after the sale
    sr, ss = tables["store_returns"], tables["store_sales"]
    sold_on = dict(zip(zip(ss["ss_ticket_number"], ss["ss_item_sk"]),
                       ss["ss_sold_date_sk"]))
    sold_null = dict(zip(zip(ss["ss_ticket_number"], ss["ss_item_sk"]),
                         nulls["store_sales"]["ss_sold_date_sk"]))
    live = ~nulls["store_returns"]["sr_returned_date_sk"]
    for t, i, d, ok in zip(sr["sr_ticket_number"], sr["sr_item_sk"],
                           sr["sr_returned_date_sk"], live):
        if ok and not sold_null[(t, i)]:
            assert d >= sold_on[(t, i)]


def test_null_rates_and_keys(full):
    tables, dicts, nulls = full
    keys = {"store_sales": ("ss_item_sk", "ss_ticket_number"),
            "catalog_sales": ("cs_item_sk", "cs_order_number"),
            "web_sales": ("ws_item_sk", "ws_order_number"),
            "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk")}
    for t, cols in keys.items():
        for c, code in SCHEMAS[t]:
            if code == "s":
                continue
            share = nulls[t][c].mean() if c in nulls[t] else 0.0
            if c in cols:
                assert share == 0.0, (t, c)
            else:
                assert abs(share - FACT_NULL_RATE) < 0.01, (t, c, share)
    facts = {"store_returns", "catalog_returns", "web_returns", *keys}
    for t in TABLES:
        # a dimension's first column is its surrogate key
        assert t in facts or SCHEMAS[t][0][0] not in nulls[t], t
        for c, code in SCHEMAS[t]:
            if code != "s":
                v = tables[t][c]
                if c in nulls[t] and v.dtype.kind != "M":
                    assert (v[nulls[t][c]] == 0).all(), (t, c)
    customers = tables["customer"]
    shares = [(customers[c] < 0).mean() for c, code in SCHEMAS["customer"]
              if code == "s" and c not in ("c_customer_id", "c_login")]
    assert abs(np.mean(shares) - DIM_NULL_RATE) < 0.01
    assert (customers["c_login"] == -1).all() and dicts["c_login"] == []


def test_money_identities(full):
    tables, _, nulls = full
    for t, p in (("store_sales", "ss"), ("catalog_sales", "cs"),
                 ("web_sales", "ws")):
        s, n = tables[t], nulls[t]
        cols = ["quantity", "sales_price", "list_price", "wholesale_cost",
                "ext_sales_price", "ext_discount_amt", "ext_list_price",
                "ext_wholesale_cost", "coupon_amt", "net_paid",
                "net_profit", "net_paid_inc_tax", "ext_tax"]
        live = ~np.any([n.get(f"{p}_{c}", np.zeros(len(s[f"{p}_item_sk"]),
                                                   bool)) for c in cols],
                       axis=0)
        v = {c: s[f"{p}_{c}"][live].astype(np.int64) for c in cols}
        q = v["quantity"]
        assert (v["ext_sales_price"] == q * v["sales_price"]).all()
        assert (v["ext_list_price"] == q * v["list_price"]).all()
        assert (v["ext_discount_amt"]
                == q * (v["list_price"] - v["sales_price"])).all()
        assert (v["net_paid"] == v["ext_sales_price"] - v["coupon_amt"]).all()
        assert (v["net_profit"]
                == v["net_paid"] - q * v["wholesale_cost"]).all()
        assert (v["net_paid_inc_tax"] == v["net_paid"] + v["ext_tax"]).all()
        assert (np.abs(s[f"{p}_net_paid"]) < 10**7).all()   # DECIMAL(7, 2)
        dates = s[f"{p}_sold_date_sk"][~n[f"{p}_sold_date_sk"]]
        assert dates.min() >= 2_450_816 and dates.max() <= 2_452_642
    view = float_view("store_sales", tables["store_sales"])
    np.testing.assert_array_equal(
        view["ss_net_paid"],
        tables["store_sales"]["ss_net_paid"].astype(np.float64) * 0.01)


def _string_literals(expr, out):
    """(column, literal) of every ``eq``/``neq``/``in`` of a column (or a
    ``substr`` of one) with string literals under ``expr``."""
    from velox_tpu_torch.expr.ir import Call, FieldRef, Literal

    if isinstance(expr, Call):
        if expr.name in ("eq", "neq", "in") and expr.args:
            col = expr.args[0]
            if isinstance(col, Call) and col.name == "substr":
                col = col.args[0]
            lits = [a.value for a in expr.args[1:]
                    if isinstance(a, Literal) and isinstance(a.value, str)]
            if isinstance(col, FieldRef) and lits:
                out.extend((col.name, v) for v in lits)
        for a in expr.args:
            _string_literals(a, out)


def test_every_plan_literal_is_in_its_columns_domain():
    from velox_tpu_torch.plan.nodes import FilterNode, TableScanNode
    from velox_tpu_torch.tpcds import (
        FULL_PARAMS, SUPPORTED_QUERIES, tpcds_plan,
    )

    def nodes(n):
        yield n
        for s in getattr(n, "sources", ()) or ():
            yield from nodes(s)

    # the plans read column types from the catalog
    register_full(SF, 1 << 14, TPCDS_FULL_SEED, device="cpu")
    try:
        pairs = []
        for q in SUPPORTED_QUERIES:
            for params in ({}, FULL_PARAMS.get(q, {})):
                for n in nodes(tpcds_plan(q, **params).build()):
                    if isinstance(n, TableScanNode) and n.subfilter:
                        _string_literals(n.subfilter, pairs)
                    elif isinstance(n, FilterNode):
                        _string_literals(n.predicate, pairs)
    finally:
        for t in TABLES:
            torch_catalog.drop_table(t)
    assert len(pairs) > 100
    missing = sorted({(c, v) for c, v in pairs
                      if v not in DOMAINS.get(c, ())})
    assert missing == []


def _same_splits(name):
    jt, tt = jax_catalog.get_table(name), torch_catalog.get_table(name)
    assert jt.sorted_cols == tt.sorted_cols, name
    assert jt.unique_cols == tt.unique_cols, name
    assert len(jt.batches) == len(tt.batches), name
    for jb, tb in zip(jt.batches, tt.batches):
        assert jb.names == tb.names
        for c in jb.names:
            j, t = jb.column(c), tb.column(c)
            assert str(j.dtype) == str(t.dtype), (name, c)
            np.testing.assert_array_equal(t.values.numpy(),
                                          np.asarray(j.values),
                                          err_msg=f"{name}.{c}")
            if j.valid is None:
                assert t.valid is None, (name, c)
            else:
                np.testing.assert_array_equal(
                    t.valid.numpy(), np.asarray(j.valid), err_msg=(name, c))
            assert j.stats == t.stats, (name, c, j.stats, t.stats)
            if j.dictionary is not None:
                assert list(t.dictionary.values) == list(
                    j.dictionary.values), (name, c)


def test_null_ingest_equals_register_arrow(full):
    """Module 1: ``register_columns(..., nulls=)`` against
    ``register_arrow`` of the same values with Arrow NULL masks, on a
    hand-made table (a sorted column with a NULL, a last row NULL, an
    all-NULL column of each kind, a NULL past 2^31 in int64) and on four
    generated tables with NULLs in every kind of column."""
    rng = np.random.default_rng(3)
    n = 300
    cols = {
        "k": np.arange(n, dtype=np.int64),
        "sorted_null": np.arange(n, dtype=np.int64),
        "i64": rng.integers(-(1 << 40), 1 << 40, n),
        "i32": rng.integers(-1000, 1000, n).astype(np.int32),
        "f64": rng.normal(size=n),
        "day": (np.datetime64("1999-01-01")
                + rng.integers(0, 2000, n)).astype("datetime64[D]"),
        "all_null": rng.integers(0, 9, n).astype(np.int32),
        "s": rng.integers(-1, 4, n).astype(np.int32),
        "s_null": np.full(n, -1, dtype=np.int32),
    }
    nulls = {"sorted_null": np.arange(n) == 7,
             "i64": rng.random(n) < 0.1, "i32": np.arange(n) == n - 1,
             "f64": rng.random(n) < 0.2, "day": rng.random(n) < 0.05,
             "all_null": np.ones(n, dtype=bool)}
    dicts = {"s": ["x", "b", "yy", "a"], "s_null": ["unused"]}
    masked = {c: np.where(nulls[c], np.zeros((), v.dtype), v)
              if c in nulls else v for c, v in cols.items()}
    torch_catalog.register_columns("nulls_t", masked, dicts, 128,
                                   device="cpu", nulls=nulls)
    jax_catalog.register_arrow("nulls_t", full_arrow_table(
        masked, {c: list(v) for c, v in dicts.items()}, nulls), 128)
    try:
        _same_splits("nulls_t")
        t = torch_catalog.get_table("nulls_t")
        assert "k" in t.unique_cols and "sorted_null" not in t.sorted_cols
        assert t.batches[0].column("all_null").stats is None
    finally:
        jax_catalog.drop_table("nulls_t")
        torch_catalog.drop_table("nulls_t")
    tables, dictionaries, all_nulls = full
    for name in ("customer", "store_returns", "web_page", "item"):
        cols = float_view(name, tables[name])
        torch_catalog.register_columns(
            "g_" + name, cols, {c: dictionaries[c] for c in cols
                                if c in dictionaries}, 256, device="cpu",
            nulls=all_nulls[name])
        jax_catalog.register_arrow("g_" + name, full_arrow_table(
            cols, dictionaries, all_nulls[name]), 256)
        try:
            _same_splits("g_" + name)
        finally:
            jax_catalog.drop_table("g_" + name)
            torch_catalog.drop_table("g_" + name)
    with pytest.raises(ValueError):
        torch_catalog.register_columns(
            "bad", {"s": np.zeros(3, np.int32)}, {"s": ["a"]}, 128,
            device="cpu", nulls={"s": np.ones(3, bool)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            register_full(SF, 1 << 14, TPCDS_FULL_SEED, prefix="nocard_")


def test_left_nested_loop_join_raises_in_both_packages():
    """A non-INNER nested-loop join is unsupported in the JAX package
    (its ``CrossProbeOp``), and the port says the same."""
    from velox_tpu.exec import run_plan as jax_run_plan
    from velox_tpu.plan import PlanBuilder as JaxBuilder
    from velox_tpu_torch.exec import run_plan as torch_run_plan
    from velox_tpu_torch.plan import PlanBuilder as TorchBuilder

    left = {"a": np.arange(5, dtype=np.int64)}
    right = {"b": np.arange(3, dtype=np.int64)}
    with table_in_both("nl_left", left), table_in_both("nl_right", right):
        for builder, run in ((JaxBuilder, lambda p: jax_run_plan(p)),
                             (TorchBuilder, torch_run_plan)):
            plan = (builder().table_scan("nl_left")
                    .cross_join(builder().table_scan("nl_right"),
                                filter="a > b", join_type="left").build())
            with pytest.raises(NotImplementedError,
                               match="nested-loop join type"):
                run(plan)
