"""Unnest, the ARRAY/MAP-valued collect aggregates and complex batches:
the port against the JAX package.

The table of ``tests/test_torch_complex_project.py`` (NULL rows, NULL
elements, empty arrays) in three literal batches of each package.
Unnest runs with ordinality and over several columns of different
lengths; the eight collect aggregates (``array_agg``, ``set_agg``,
``set_union``, ``map_agg``, ``multimap_agg``, ``map_union``,
``map_union_sum``, ``histogram``) run by key and keyless over the three
splits; one plan goes collect -> project -> unnest -> aggregate and is
held against numpy too. String-keyed maps and string arrays run in one
batch: the JAX package cannot concatenate element columns of different
dictionaries. Every result must equal the JAX package's element for
element (DOUBLE to rtol=1e-9).
"""

import numpy as np
import pytest

from test_torch_complex_project import batches_of, make_rows, same
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.vector.batch import concat_batches


@pytest.fixture(scope="module")
def table():
    rows = make_rows()
    return rows, batches_of(rows), batches_of(rows, split=len(rows["id"]))


def run_both(batches, build):
    jb, tb = batches
    want = jax_run_plan(build(JaxPlanBuilder().values(jb)).build()
                        ).to_pydict()
    got = torch_run_plan(build(TorchPlanBuilder().values(tb)))
    assert list(got) == list(want)
    for c in want:
        same(got[c], want[c], c)
    return got


def test_batch_round_trip_concat_and_compact(table):
    """``Batch.from_pydict`` -> ``to_pydict`` gives the rows back, in both
    packages; ``concat_batches`` shifts offsets by element capacity, and
    ``compact`` gathers offsets only."""
    rows, (jb, tb), _ = table
    cols = ["xs", "fs", "ss", "m", "mi", "r", "nested"]
    for j, t in zip(jb, tb):
        got, want = t.to_pydict(), j.to_pydict()
        for c in cols:
            same(got[c], want[c], c)
    whole = concat_batches(tb).to_pydict()
    for c in ("xs", "fs", "nested", "r"):
        same(whole[c], rows[c], c)
    same(whole["mi"], [None if v is None else list(v.items())
                       for v in rows["mi"]], "mi")
    b = tb[0].with_sel(tb[0].sel & (tb[0].column("id").values % 3 == 0))
    same(b.compact().to_pydict()["xs"],
         [v for i, v in enumerate(rows["xs"][:20]) if i % 3 == 0], "compact")


@pytest.mark.parametrize("case", ["one", "several"])
def test_unnest_equals_jax(table, case):
    _, batches, _ = table
    if case == "one":
        got = run_both(batches, lambda pb: pb.unnest(["id", "k"], ["xs"]))
        assert all(v is not None for v in got["id"])
    else:
        # xs, ys, fs of different lengths: the short ones pad with NULLs
        run_both(batches, lambda pb: pb.unnest(
            ["id"], ["xs", "ys", "fs"], ordinality="ord"))


AGGS = ["array_agg(id) AS a", "set_agg(k) AS sa", "histogram(k) AS h",
        "map_agg(id, k) AS ma", "multimap_agg(k, id) AS mm",
        "set_union(xs) AS su", "map_union(mi) AS mu",
        "map_union_sum(mi) AS mus", "count(*) AS n"]


@pytest.mark.parametrize("keys", [["k"], []], ids=["by_key", "keyless"])
def test_collect_aggregates_over_splits_equal_jax(table, keys):
    _, batches, _ = table
    run_both(batches, lambda pb: pb.aggregate(keys, AGGS))


def test_collect_aggregates_over_strings_equal_jax(table):
    _, _, one = table
    aggs = ["array_agg(s) AS a", "histogram(s) AS h", "map_agg(s, id) AS ma",
            "set_union(ss) AS su", "map_union(m) AS mu",
            "map_union_sum(m) AS mus", "set_agg(s) AS ss2",
            "set_union(fs) AS sf", "multimap_agg(s, id) AS mm"]
    for keys in (["k"], []):
        run_both(one, lambda pb: pb.aggregate(keys, aggs))


def test_collect_project_unnest_aggregate(table):
    """array_agg by key, a projection over the arrays, unnest, and a sum
    by the same key: equal to the JAX package and to numpy's direct
    sums."""
    rows, batches, _ = table

    def build(pb):
        return (pb.aggregate(["k"], ["array_agg(id) AS ids",
                                     "array_agg(k) AS ks"])
                .project(["k", "transform(ids, x -> x * 2) AS d",
                          "cardinality(ids) AS n", "ks"])
                .unnest(["k", "n"], ["d", "ks"], ordinality="o")
                .aggregate(["k"], ["sum(d) AS s", "count(*) AS c",
                                   "max(o) AS mo", "max(n) AS mn"])
                .order_by(["k"]))

    got = run_both(batches, build)
    ids, ks = np.asarray(rows["id"]), rows["k"]
    for key, s, c, mo in zip(got["k"], got["s"], got["c"], got["mo"]):
        hit = np.asarray([k == key for k in ks])
        assert s == int(ids[hit].sum()) * 2
        assert c == mo == int(hit.sum())


@pytest.mark.parametrize("agg", [
    "numeric_histogram(4, id) AS r", "reduce_agg(id, 0, (a, b) -> a + b) AS r",
    "array_agg(id) AS r @partial"])
def test_what_waits_for_slice_12_says_so(table, agg):
    """What this pin once held refused is ported: each plan equals the
    JAX package's (the page form in two steps, by key)."""
    _, batches, _ = table
    if agg.endswith("@partial"):
        run_both(batches, lambda pb: pb.partial_aggregation(
            ["k"], [agg.split(" @")[0]]).final_aggregation())
    else:
        run_both(batches, lambda pb: pb.aggregate(["k"], [agg]))


def test_phase_14_plans_at_sf_0_01_against_oracles(monkeypatch):
    """``chip_smoke.py``'s phase 14 (``tpch/complex_plans.py``) over the
    port's lineitem at SF 0.01: P1-P3 read as arrays and equal to their
    numpy oracles, P4 equal to Q1's sums of cents."""
    from velox_tpu_torch.io import catalog as torch_catalog
    from velox_tpu_torch.io.tpch import (
        as_money_schema, table_dictionaries, tpch_columns,
    )
    from velox_tpu_torch.tpch import complex_plans as cx
    from velox_tpu_torch.utils.config import config as torch_config

    monkeypatch.setattr(torch_config, "optimize_plans", False)
    monkeypatch.setattr(torch_config, "narrow_lanes", True)
    tables, dicts = tpch_columns(0.01, 20240601, ["lineitem"])
    li = tables["lineitem"]
    cols, overrides = as_money_schema(li, "cents")
    torch_catalog.register_columns("lineitem", cols,
                                   table_dictionaries(li, dicts), 1 << 14,
                                   overrides, device="cpu")
    try:
        runs = cx.order_runs(li)
        for make, oracle in ((cx.plan_arrays, cx.arrays_oracle),
                             (cx.plan_unnest, cx.unnest_oracle),
                             (cx.plan_maps, cx.maps_oracle)):
            got = cx.complex_result(make(TorchPlanBuilder).build())
            assert cx.same_result(got, oracle(li, runs)) == [], make
        got = torch_run_plan(cx.plan_q1_unnest(TorchPlanBuilder))
    finally:
        torch_catalog.drop_table("lineitem")
    live = li["l_shipdate"].astype(np.int64) <= cx.SHIP_Q1
    gid = (li["l_returnflag"][live] * len(dicts["l_linestatus"])
           + li["l_linestatus"][live])
    price = li["l_extendedprice"][live].astype(np.int64)
    want = [int(price[gid == g].sum()) for g in np.unique(gid)]
    assert [int(v.scaleb(2)) for v in got["sum_base_price"]] == want
    assert got["n"] == [int((gid == g).sum()) for g in np.unique(gid)]
