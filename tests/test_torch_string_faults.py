"""Two string faults of the port, pinned against the JAX package.

* A compare of two string columns with different dictionaries compared
  the raw codes, which mean different strings on each side: it must
  compare the strings (ranks in the union of both dictionaries), NULL
  where either side is NULL, in a filter and in a projection.
* ``CAST(varchar AS ...)`` cast the dictionary codes: it must parse each
  distinct string (surrounding blanks ignored; a value that does not
  parse is NULL) into BOOLEAN, INTEGER, BIGINT, DOUBLE, DECIMAL and
  DATE.

Strings, integers, booleans and NULL masks must be equal, DOUBLE to
rtol=1e-9. The JAX rows are computed once per module."""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

N = 64
#: two dictionaries that share values under different codes
DICT_A = ["apple", "kiwi", "pear", "zebra"]
DICT_B = ["banana", "kiwi", "pear", "plum", "zebra"]
COMPARES = {"eq": "a = b", "neq": "a <> b", "lt": "a < b", "lte": "a <= b",
            "gt": "a > b", "gte": "a >= b"}

#: strings each cast parses, with padded, unparseable and NULL values
CASTS = {
    "BOOLEAN": ["true", "T", " 1 ", "false", "f", "0", "FALSE ", "yes", "",
                "2"],
    "INTEGER": ["12", " 7 ", "-3", "x7", "", "1.5", "2.5e1", "+40",
                "2147483647", "-2147483648", "0x10"],
    "BIGINT": ["12", " -9 ", "99999999999", "-9223372036854775808", "1e3",
               "abc", "3.99", ""],
    "DOUBLE": ["1.5", " -2.25 ", "1e-3", "NaN", "inf", "-inf", "x", "",
               "3"],
    "DECIMAL(12,2)": ["12.34", " 5 ", "-0.5", "7.1", "1e2", "abc", "",
                      "99999.99"],
    "DATE": ["2024-03-01", " 1999-12-31 ", "1970-01-01", "1900-02-28",
             "2024-02-30", "03/01/2024", "", "2000-02-29"],
}


def _codes(rng, values, n, null_share=0.15):
    codes = rng.integers(0, len(values), n).astype(np.int32)
    codes[rng.random(n) < null_share] = -1
    return codes


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(20241017)
    pair = {"k": np.arange(N, dtype=np.int64),
            "a": _codes(rng, DICT_A, N), "b": _codes(rng, DICT_B, N)}
    casts = {"k": np.arange(N, dtype=np.int64)}
    cast_dicts = {}
    for i, values in enumerate(CASTS.values()):
        vals = sorted(set(values))
        casts[f"s{i}"] = _codes(rng, vals, N)
        cast_dicts[f"s{i}"] = vals
    with table_in_both("pair", pair, {"a": DICT_A, "b": DICT_B},
                       batch_rows=16), \
            table_in_both("casts", casts, cast_dicts, batch_rows=16):
        yield _Both()


class _Both:
    """Each plan through both packages, the JAX rows computed once."""

    def __init__(self):
        self._jax = {}

    def run(self, key, make):
        if key not in self._jax:
            self._jax[key] = jax_run_plan(
                make(JaxPlanBuilder).build()).to_pydict()
        return torch_run_plan(make(TorchPlanBuilder).build()), self._jax[key]


@pytest.mark.parametrize("op", list(COMPARES))
def test_cross_dictionary_compare_filter_matches_jax(tables, op):
    """The rows a filter keeps, in order; at least one is kept and one
    dropped, and every NULL pair is dropped."""
    predicate = COMPARES[op]
    got, exp = tables.run(predicate, lambda pb: pb().table_scan("pair")
                          .filter(predicate).project(["k", "a", "b"]))
    assert 0 < len(exp["k"]) < N, predicate
    assert all(a is not None and b is not None
               for a, b in zip(exp["a"], exp["b"])), predicate
    assert_same(got, exp, predicate)


def test_cross_dictionary_compares_project_matches_jax(tables):
    """All six compares as BOOLEAN columns, NULL where a side is NULL."""
    got, exp = tables.run("project", lambda pb: pb().table_scan("pair")
                          .project([f"{e} AS {n}"
                                    for n, e in COMPARES.items()]))
    assert any(v is None for v in exp["eq"])
    assert_same(got, exp, "compares")


#: the casts of each test (INTEGER and BIGINT share one)
CAST_GROUPS = [("BOOLEAN",), ("INTEGER", "BIGINT"), ("DOUBLE",),
               ("DECIMAL(12,2)",), ("DATE",)]


@pytest.mark.parametrize("targets", CAST_GROUPS, ids="-".join)
def test_string_cast_matches_jax(tables, targets):
    """Each distinct string parsed into its target; NULL where it does
    not parse and where the string is NULL."""
    cols = [f"s{list(CASTS).index(t)}" for t in targets]
    exprs = [f"CAST({c} AS {t}) AS v{i}"
             for i, (c, t) in enumerate(zip(cols, targets))]
    got, exp = tables.run(str(targets), lambda pb: pb().table_scan("casts")
                          .project(["k", *cols, *exprs]))
    for i in range(len(targets)):
        assert any(v is None for v in exp[f"v{i}"]), targets
        assert any(v is not None for v in exp[f"v{i}"]), targets
    assert_same(got, exp, str(targets))
