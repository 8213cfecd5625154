"""Long decimals (DECIMAL(38, s) past int64) in the port against the JAX
package on the CPU: the ingest shred into three digit lanes and its round
trip, a narrow column keeping one lane, ``count``/``sum``/``avg``/
``min``/``max`` keyed, keyless and in two steps, compares against
literals, NULL past 10^38, and the two places the port departs: a sum of
2^21 + 1 rows, where the JAX package's digit lanes wrap and the port's
carry, and a literal past 2^53, whose digits the port keeps.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest

from torch_tpch_data import assert_same
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.io import catalog as jax_catalog
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.io import catalog as torch_catalog
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

_CTX = decimal.Context(prec=60)

AGGS = ["sum(x) AS s", "avg(x) AS a", "min(x) AS mn", "max(x) AS mx",
        "count(x) AS c", "count(*) AS n"]


def _decimals(values, scale=2):
    return pa.array([None if v is None else
                     decimal.Decimal(v).scaleb(-scale, _CTX)
                     for v in values], pa.decimal128(38, scale))


def register_both(name, k, values, batch_rows, scale=2):
    """``values`` (Python ints, unscaled, None = NULL) as DECIMAL(38,
    scale) column ``x`` beside the int64 key ``k``, in both catalogs."""
    torch_catalog.register_columns(
        name, {"k": k, "x": np.asarray(values, dtype=object)}, None,
        batch_rows, {"x": (38, scale)}, device="cpu")
    jax_catalog.register_arrow(
        name, pa.table({"k": k, "x": _decimals(values, scale)}), batch_rows)


def _values(n, seed):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 10 ** 15, n)
    lo = rng.integers(0, 10 ** 15, n)
    sign = rng.integers(0, 2, n) * 2 - 1
    vals = [int(s) * (int(h) * 10 ** 15 + int(m))
            for s, h, m in zip(sign, hi, lo)]
    for i in range(0, n, 97):
        vals[i] = None
    vals[5] = 10 ** 38 - 1              # the largest DECIMAL(38)
    vals[6] = -(10 ** 30)
    vals[7] = 3                         # and some small ones
    return vals


@pytest.fixture(scope="module")
def wide():
    """A 3000-row table of magnitudes up to 10^30 (1% NULL, 30 keys) in
    1024-row splits, and a second whose values all fit int64."""
    n = 3000
    k = np.random.default_rng(1).integers(0, 30, n).astype(np.int64)
    vals = _values(n, 2)
    register_both("w", k, vals, 1024)
    narrow = [None if v is None else v % (10 ** 17) for v in vals]
    register_both("wn", k, narrow, 1024)
    try:
        yield k, vals
    finally:
        for t in ("w", "wn"):
            jax_catalog.drop_table(t)
            torch_catalog.drop_table(t)


def _both(plan):
    return (torch_run_plan(plan(TorchPlanBuilder).build()),
            jax_run_plan(plan(JaxPlanBuilder).build()).to_pydict())


def test_shred_and_round_trip(wide):
    k, vals = wide
    t = torch_catalog.get_table("w")
    assert t.wide_groups == jax_catalog.get_table("w").wide_groups == {
        "x": ["x#w2s2", "x#w1s2", "x#w0s2"]}
    assert list(t.schema.names) == list(
        jax_catalog.get_table("w").batches[0].schema.names)
    got, want = _both(lambda pb: pb().table_scan("w"))
    assert_same(got, want, "scan")
    assert got["x"] == [None if v is None else
                        decimal.Decimal(v).scaleb(-2, _CTX) for v in vals]


def test_narrow_decimal_keeps_one_lane(wide):
    t = torch_catalog.get_table("wn")
    assert t.wide_groups == {} and str(t.schema.find_child("x")) == \
        "DECIMAL(38,2)"
    got, want = _both(lambda pb: pb().table_scan("wn").aggregate(
        ["k"], AGGS))
    assert_same(got, want, "narrow")


@pytest.mark.parametrize("keys", [["k"], []])
def test_aggregates_equal_the_reference(wide, keys):
    got, want = _both(lambda pb: pb().table_scan("w").aggregate(keys, AGGS))
    assert_same(got, want, str(keys))
    assert list(got) == keys + ["s", "a", "mn", "mx", "c", "n"]


@pytest.mark.parametrize("keys", [["k"], []])
def test_two_step_equals_the_single_step(wide, keys):
    got, want = _both(lambda pb: pb().table_scan("w").partial_aggregation(
        keys, AGGS).final_aggregation())
    assert_same(got, want, f"two-step {keys}")
    single = torch_run_plan(TorchPlanBuilder().table_scan("w").aggregate(
        keys, AGGS))
    assert_same(got, single, f"two-step {keys} against one")


def test_compares_equal_the_reference(wide):
    _k, vals = wide
    filters = ["x > 123456789012345678901234", "x >= 1.5e20",
               "x <= 5.5", "x < 3", "x = 0.03", "x <> 0.03",
               "x BETWEEN 1e20 AND 1e30", "x IS NULL", "x IS NOT NULL"]
    for f in filters:
        got, want = _both(lambda pb: pb().table_scan("w").filter(f))
        assert_same(got, want, f)
    got = torch_run_plan(TorchPlanBuilder().table_scan("w").filter(
        "x > 123456789012345678901234"))
    bound = 123456789012345678901234 * 100
    assert len(got["x"]) == sum(v is not None and v > bound for v in vals)


def test_literal_past_2_53_keeps_its_digits():
    """``x <= 12345678901234567890123.45``: the JAX package reads the
    literal through ``round(float * 100)`` (1234567890123456824475648
    unscaled) and keeps rows above 1234567890123456789012345; the port
    reads the numeral's digits and keeps exactly those at or below it."""
    exact = 1234567890123456789012345
    lossy = int(round(12345678901234567890123.45 * 100))
    assert lossy > exact + 1
    vals = [exact, exact + 1, lossy, lossy + 1, exact - 1]
    register_both("wl", np.zeros(len(vals), np.int64), vals, 128)
    try:
        f = "x <= 12345678901234567890123.45"
        got, want = _both(lambda pb: pb().table_scan("wl").filter(f))
        assert [int(v.scaleb(2)) for v in got["x"]] == [exact, exact - 1]
        assert [int(v.scaleb(2)) for v in want["x"]] == [
            exact, exact + 1, lossy, exact - 1]
    finally:
        jax_catalog.drop_table("wl")
        torch_catalog.drop_table("wl")


def test_null_past_10_38():
    """A sum or average whose magnitude reaches 10^38 is NULL in both
    packages; an average of such values is not."""
    big = 10 ** 38 - 1
    vals = [big, big, 5, -big, -big, -3]
    k = np.array([0, 0, 1, 2, 2, 3], np.int64)
    register_both("wo", k, vals, 128)
    try:
        got, want = _both(lambda pb: pb().table_scan("wo").aggregate(
            ["k"], ["sum(x) AS s", "avg(x) AS a", "max(x) AS m"]))
        assert_same(got, want, "overflow")
        assert got["s"][0] is None and got["s"][2] is None
        assert got["a"][0] == decimal.Decimal(big).scaleb(-2, _CTX)
    finally:
        jax_catalog.drop_table("wo")
        torch_catalog.drop_table("wo")


def test_sum_past_2_21_rows_is_exact():
    """2^21 + 1 rows of unscaled 2^84 + 2^42 - 1: the JAX package sums
    each digit lane on its own and its d0 lane wraps int64; the port
    carries between the lanes and equals Python's ints."""
    n = (1 << 21) + 1
    v = (1 << 84) + (1 << 42) - 1
    torch_catalog.register_columns(
        "wr", {"x": np.full(n, v, dtype=object)}, None, 1 << 20,
        {"x": (38, 2)}, device="cpu")
    arr = pa.array(np.full(n, decimal.Decimal(v).scaleb(-2, _CTX)),
                   pa.decimal128(38, 2))
    jax_catalog.register_arrow("wr", pa.table({"x": arr}), 1 << 20)
    try:
        aggs = ["sum(x) AS s", "avg(x) AS a"]
        got, want = _both(lambda pb: pb().table_scan("wr").aggregate(
            [], aggs))
        exact = decimal.Decimal(n * v).scaleb(-2, _CTX)
        assert got == {"s": [exact],
                       "a": [decimal.Decimal(v).scaleb(-2, _CTX)]}
        assert want["s"] == [decimal.Decimal(
            "405648385501072313143224875089.91")] != got["s"]
    finally:
        jax_catalog.drop_table("wr")
        torch_catalog.drop_table("wr")
