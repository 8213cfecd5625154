"""The port's string functions against the JAX package, family by
family (``torch_string_exprs.FAMILIES``), projected over one hand-made
table whose string column holds NULL, ``''``, leading and trailing
blanks, ``é``, ``ß``, a 4-byte code point and values each family
parses; plus constants, nested transforms and string filters. Strings,
integers, booleans and NULL masks must be equal, DOUBLE to rtol=1e-9.
The JAX rows are computed once per module."""

import pytest

from torch_string_exprs import FAMILIES, string_table
from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

#: constants, nested transforms and type rules
SHAPES = {
    "lit": "'web'", "typeof_i": "typeof(i)", "typeof_s": "typeof(s)",
    "size": "data_size_for_stats(s)", "folded_md5": "md5('abc')",
    "folded_chr": "chr(66)", "folded_null": "regexp_extract('x', 'y')",
    "nested": "upper(trim(s))", "len_upper": "length(upper(s))",
    "cast_len": "CAST(length(s) AS DOUBLE) / 2.0",
    "iso": "to_iso8601(d)", "sub_cmp": "substr(s, 1, 2) = 'ap'",
}

#: string predicates in a filter
FILTERS = ["starts_with(s, 'a') OR ends_with(s, ' ')",
           "regexp_like(s, '[0-9]') AND length(s) > 2",
           "upper(s) > 'B'"]


@pytest.fixture(scope="module")
def both():
    cols, dicts = string_table()
    with table_in_both("strs", cols, dicts, batch_rows=16):
        yield _Both()


class _Both:
    def __init__(self):
        self._jax = {}

    def run(self, key, make):
        if key not in self._jax:
            self._jax[key] = jax_run_plan(
                make(JaxPlanBuilder).build()).to_pydict()
        return torch_run_plan(make(TorchPlanBuilder).build()), self._jax[key]


def _project(exprs):
    return ["k"] + [f"{e} AS {n}" for n, e in exprs.items()]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_jax(both, family):
    """Every function of the family, NULL where the input is NULL or the
    function gives none."""
    exprs = FAMILIES[family]
    got, exp = both.run(family, lambda pb: pb().table_scan("strs")
                        .project(_project(exprs)))
    assert any(v is None for c in exp.values() for v in c), family
    assert_same(got, exp, family)


def test_constants_and_nesting_match_jax(both):
    got, exp = both.run("shapes", lambda pb: pb().table_scan("strs")
                        .project(_project(SHAPES)))
    assert exp["lit"][0] == "web" and exp["folded_chr"][0] == "B"
    assert_same(got, exp, "shapes")


def test_string_filters_match_jax(both):
    for predicate in FILTERS:
        got, exp = both.run(predicate, lambda pb: pb().table_scan("strs")
                            .filter(predicate).project(["k", "s"]))
        assert 0 < len(exp["k"]) < len(string_table()[0]["k"]), predicate
        assert_same(got, exp, predicate)


def test_where_the_port_departs_from_the_reference(both):
    """Two answers of the JAX package the port does not copy: a NULL
    that ``split_part`` makes reads as NULL under ``IS NULL`` (the
    reference leaves the row valid with code -1, so ``IS NULL`` is
    false), and ``concat`` of two columns raises (the reference drops
    every column after the first)."""
    cols, dicts = string_table()
    got = torch_run_plan(TorchPlanBuilder().table_scan("strs").project(
        ["split_part(s, ' ', 3) IS NULL AS n"]).build())
    values = [None if c < 0 else dicts["s"][c] for c in cols["s"]]
    assert got["n"] == [v is None or len(v.split(" ")) < 3 for v in values]
    with pytest.raises(TypeError, match="one string column"):
        torch_run_plan(TorchPlanBuilder().table_scan("strs").project(
            ["concat(s, s) AS c"]).build())
