"""The port's RowNumber, TopNRowNumber, MarkDistinct, GroupId, Expand,
UnionAll, LocalMerge, Values and AssignUniqueId operators against the JAX
package on the CPU: the same literal batches (NULLs in a value column
and in a string key, ties, a one-row partition) through both packages'
``run_plan``, equal row for row (integers, strings and booleans exactly,
DOUBLE to rtol=1e-9)."""

import numpy as np
import pytest

from torch_tpch_data import assert_same, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.plan import nodes as jax_nodes
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.plan import nodes as torch_nodes

N = 300
DICT = ["ash", "birch", "cedar", "elm", "fir", "oak"]


def _columns(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 20, n)
    p[5] = 77                       # a one-row partition
    return ({"p": p, "ps": rng.integers(-1, 6, n).astype(np.int32),
             "o": rng.integers(0, 8, n),
             "v": np.round(rng.normal(size=n) * 10, 1),
             "q": rng.integers(0, 1000, n)},
            {"v": rng.random(n) < 0.1})


@pytest.fixture(scope="module")
def batches():
    cols, nulls = _columns(3)
    return values_in_both(cols, nulls, {"ps": DICT})


def _both(batches, build):
    """``build(PlanBuilder class, batches)`` through each package."""
    jax_batches, torch_batches = batches
    exp = jax_run_plan(build(JaxPlanBuilder, jax_batches).build())
    got = torch_run_plan(build(TorchPlanBuilder, torch_batches))
    return got, exp.to_pydict()


def test_values(batches):
    got, exp = _both(batches, lambda pb, b: pb().values(b))
    assert_same(got, exp, "values")
    assert len(got["p"]) == N


def test_row_number_with_limit(batches):
    got, exp = _both(batches, lambda pb, b: pb().values(b).row_number(
        ["p"], "rn", limit=3))
    assert_same(got, exp, "row_number limit 3")
    got, exp = _both(batches, lambda pb, b: pb().values(b).row_number(
        ["ps", "o"], "rn"))
    assert_same(got, exp, "row_number over a string key with NULLs")


def test_top_n_row_number(batches):
    for keys, order, n in ((["p"], ["v DESC"], 2), (["ps"], ["o", "q"], 5),
                           (["p", "o"], ["v"], 1)):
        got, exp = _both(batches, lambda pb, b: pb().values(b)
                         .top_n_row_number(keys, order, n, "rn"))
        assert_same(got, exp, f"top_n_row_number {keys} {order} {n}")


def test_mark_distinct(batches):
    for keys in (["p", "o"], ["ps"], ["v", "ps"]):
        got, exp = _both(batches, lambda pb, b: pb().values(b)
                         .mark_distinct("first", keys))
        assert_same(got, exp, f"mark_distinct {keys}")


def test_group_id_with_aggregation(batches):
    got, exp = _both(batches, lambda pb, b: pb().values(b)
                     .group_id([["p", "ps"], ["ps"], []])
                     .aggregate(["p", "ps", "group_id"],
                                ["sum(v) AS s", "count(*) AS c",
                                 "avg(q) AS a"])
                     .order_by(["group_id", "p", "ps"]))
    assert_same(got, exp, "group_id")
    assert set(got["group_id"]) == {0, 1, 2}


def test_expand(batches):
    def build(pb, b):
        src = pb().values(b)
        first = pb(src.node).project(["p", "ps", "v", "0 AS tag"]).build()
        second = pb(src.node).project(
            ["p + 100 AS p", "ps", "v * 2.0 AS v", "1 AS tag"]).build()
        nodes = jax_nodes if pb is JaxPlanBuilder else torch_nodes
        return pb(nodes.ExpandNode(
            nodes.new_id(), first.output_type, src.node,
            (first.exprs, second.exprs), first.names))

    got, exp = _both(batches, build)
    assert_same(got, exp, "expand")
    assert len(got["p"]) == 2 * N


def test_union_all_over_differing_dictionaries():
    a_cols, a_nulls = _columns(4, 200)
    b_cols, b_nulls = _columns(5, 150)
    a = values_in_both(a_cols, a_nulls, {"ps": DICT})
    b = values_in_both(b_cols, b_nulls,
                       {"ps": ["aspen", "cedar", "larch", "oak", "pine",
                               "yew"]})

    def build(i):
        def make(pb, _):
            return (pb().values(a[i])
                    .union_all([pb().values(b[i]).filter("q > 200")])
                    .aggregate(["ps"], ["count(*) AS c", "sum(v) AS s"])
                    .order_by(["ps"]))
        return make

    exp = jax_run_plan(build(0)(JaxPlanBuilder, None).build()).to_pydict()
    got = torch_run_plan(build(1)(TorchPlanBuilder, None))
    assert_same(got, exp, "union_all")
    assert "aspen" in got["ps"] and "ash" in got["ps"]


def test_local_merge():
    streams = []
    for seed in (6, 7, 8):
        cols, nulls = _columns(seed, 120)
        order = np.lexsort((cols["o"], cols["p"]))
        cols = {c: v[order] for c, v in cols.items()}
        streams.append(values_in_both(cols, {"v": nulls["v"][order]},
                                      {"ps": DICT}, batch_rows=64))

    def build(i, pb):
        s = [pb().values(st[i]) for st in streams]
        return s[0].local_merge(s[1:], ["p", "o"])

    exp = jax_run_plan(build(0, JaxPlanBuilder).build()).to_pydict()
    got = torch_run_plan(build(1, TorchPlanBuilder))
    assert_same(got, exp, "local_merge")
    assert got["p"] == sorted(got["p"]) and len(got["p"]) == 360


def test_assign_unique_id(batches):
    got, exp = _both(batches, lambda pb, b: pb().values(b)
                     .filter("q > 300").assign_unique_id("uid", 3))
    assert_same(got, exp, "assign_unique_id")
    assert len(set(got["uid"])) == len(got["uid"])
    assert all(u >> 40 == 3 for u in got["uid"])
