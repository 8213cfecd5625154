"""The grammar's operators and the NULL functions of the port's scalar
surface against the JAX package, on one small hand-made table with
NULLs and edge values (0, +-0.0, NaN, +-inf, int64 extremes): ``negate``,
``%``, ``IS [NOT] NULL``, ``coalesce``, ``nullif``, ``greatest``,
``least``, ``IS DISTINCT FROM`` and their result types over mixed
numeric and decimal arguments; the filters that raised before these
functions were ported; a missing function's error; ``min``/``max`` over
strings against a numpy oracle; and the two registries side by side.
Integer, decimal, boolean and NULL results must be equal, DOUBLE ones to
rtol=1e-9. The JAX rows are computed once per module."""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.utils.config import config as torch_config

N = 96
I64 = np.iinfo(np.int64)
DICT = ["x", "yy", "zzz"]
DECIMALS = {"m": (7, 2), "m2": (12, 3)}

#: every projection, by the case that reads it
PROJECTIONS = {
    "operators": {
        "neg_i": "-i", "neg_f": "-f", "neg_m": "-m", "neg_sum": "-(3 + j)",
        "mod_i": "i % 7", "mod_neg": "i % -3", "mod_zero": "i % z",
        "mod_j": "j % 4", "mod_f": "f % 1.5", "mod_m": "m % 3",
        "neg_k": "-k", "mod_k": "k % j",
        "is_null_k": "k IS NULL", "is_not_null_f": "f IS NOT NULL",
        "is_null_s": "s IS NULL", "is_not_null_j": "j IS NOT NULL",
        "is_null_lit": "NULL IS NULL",
    },
    "null_functions": {
        "coalesce_kj": "coalesce(k, j)", "coalesce_jz": "coalesce(j, z, 7)",
        "coalesce_lit": "coalesce(f, 0.5)",
        "coalesce_null": "coalesce(j, NULL)",
        "nullif_k": "nullif(k, 0)", "nullif_f": "nullif(f, 0.0)",
        "nullif_jz": "nullif(j, z)",
        "greatest_kj": "greatest(k, j)", "least_ij": "least(i, j)",
        "greatest_f": "greatest(f, 0.0, -1.5)", "least_f": "least(f, 2.5)",
        "distinct_kj": "distinct_from(k, j)",
        "distinct_f": "distinct_from(f, f)",
        "distinct_jz": "distinct_from(j, z)",
    },
    "mixed_types": {
        "greatest_m": "greatest(m, m)", "least_m2": "least(m2, m2)",
        "coalesce_m_int": "coalesce(m, j)", "coalesce_m_f": "coalesce(m, f)",
        "coalesce_j_k": "coalesce(j, k)", "coalesce_mm": "coalesce(m2, m)",
        "coalesce_j_f": "coalesce(j, f)",
        "nullif_m": "nullif(m, 0.00)", "greatest_j_lit": "greatest(j, 5)",
    },
}

#: ROADMAP C.1's probes and their kin, which raised in the port before
#: this slice
C1_FILTERS = ["f > -10.0 AND f < 10.0", "j BETWEEN -5 AND 5",
              "j IN (3, -3, 7)", "k IS NULL", "j % 3 = -1",
              "NOT (f IS NOT NULL) OR -j > 2"]


def _columns():
    rng = np.random.default_rng(20240611)
    i = rng.integers(-50, 50, N)
    i[:6] = [0, 1, -1, I64.max, I64.min, 7]
    f = np.round(rng.normal(0, 20, N), 2)
    f[:9] = [0.0, -0.0, np.nan, np.inf, -np.inf, 2.5, -2.5, 0.5, 1e300]
    m = rng.integers(-99999, 99999, N)
    m[:3] = [0, 0, -1]
    # the JAX package ingests a nullable int64 column through float64,
    # so the int64 extremes go in a column without NULLs
    cols = {"i": i, "k": rng.integers(-50, 50, N),
            "j": rng.integers(-9, 10, N).astype(np.int32),
            "z": rng.integers(0, 3, N).astype(np.int32),
            "f": f, "m": m, "m2": rng.integers(-9999, 9999, N),
            "s": rng.integers(-1, 3, N).astype(np.int32)}
    nulls = {c: rng.random(N) < 0.15 for c in ("k", "j", "f", "m", "z")}
    nulls["f"][:9] = False
    return cols, nulls


@pytest.fixture(scope="module")
def both():
    cols, nulls = _columns()
    return _Both(values_in_both(cols, nulls, {"s": DICT},
                                overrides=DECIMALS))


class _Both:
    """The table as literal batches of both packages; each plan's JAX
    result is computed once."""

    def __init__(self, batches):
        self.batches = batches
        self._jax = {}

    def run(self, key, make):
        """``make(PlanBuilder, batches)`` through both packages: (port
        rows, JAX rows, port plan, JAX plan)."""
        jax_plan = make(JaxPlanBuilder, self.batches[0]).build()
        if key not in self._jax:
            self._jax[key] = jax_run_plan(jax_plan).to_pydict()
        plan = make(TorchPlanBuilder, self.batches[1]).build()
        return torch_run_plan(plan), self._jax[key], plan, jax_plan

    def project(self, group):
        exprs = PROJECTIONS[group]
        return self.run(group, lambda pb, b: pb().values(b).project(
            [f"{e} AS {n}" for n, e in exprs.items()]))


@pytest.mark.parametrize("group", list(PROJECTIONS))
def test_projections_match_jax(both, group):
    """Each group's values, NULL masks and result types."""
    got, exp, plan, jax_plan = both.project(group)
    assert_same(got, exp, group)
    assert [str(t) for t in plan.output_type.children] == \
        [str(t) for t in jax_plan.output_type.children], group
    assert any(v is None for c in got.values() for v in c), group


@pytest.mark.parametrize("predicate", C1_FILTERS)
def test_grammar_filters_match_jax(both, predicate):
    got, exp, _, _ = both.run(predicate, lambda pb, b: pb().values(b)
                              .filter(predicate).project(["i", "k", "j", "f"]))
    assert len(exp["i"]) > 0, predicate
    assert_same(got, exp, predicate)


def test_missing_function_names_the_gap(both):
    """The gap this pinned is closed: ``__tz_adjust`` over instants made
    from the integer column ``i`` (the JAX package's zone as two array
    literals, the port's as one zone-table literal) gives the same
    instants."""
    from velox_tpu.expr.ir import Call as JCall, FieldRef as JField
    from velox_tpu.expr.ir import Literal as JLiteral
    from velox_tpu.types import BIGINT as J_BIGINT
    from velox_tpu.utils.tz import zone_tables_us
    from velox_tpu_torch.expr.ir import Call, FieldRef, Literal
    from velox_tpu_torch.types import BIGINT
    from velox_tpu_torch.utils.tz import zone_table

    zone = "Asia/Kolkata"
    tr, of = zone_tables_us(zone)
    jadjust = JCall(None, "__tz_adjust", (JField(None, "t"),
                                          JLiteral(J_BIGINT, tr),
                                          JLiteral(J_BIGINT, of)))
    adjust = Call(None, "__tz_adjust", (FieldRef(None, "t"),
                                        Literal(BIGINT, zone_table(zone))))
    instants = ["i % 4000000000000000 AS t"]
    want = jax_run_plan(JaxPlanBuilder().values(both.batches[0]).project(
        instants).project([("c", jadjust)]).build()).to_pydict()
    got = torch_run_plan(TorchPlanBuilder().values(both.batches[1]).project(
        instants).project([("c", adjust)]))
    assert got == want


def test_min_max_over_strings_against_numpy(monkeypatch):
    """``min``/``max`` of a string column return strings in every
    aggregation form, keyed and keyless, over several splits."""
    values = ["Zed", "a%c", "a_b", "abc", "b"]
    rng = np.random.default_rng(5)
    n = 1000
    k = np.sort(rng.integers(0, 40, n))
    s = rng.integers(-1, len(values), n).astype(np.int32)
    s[k == 7] = -1                       # a group with no string at all
    arr = np.asarray(values, dtype=object)
    want_min, want_max = [], []
    for g in np.unique(k):
        live = s[(k == g) & (s >= 0)]
        want_min.append(min(arr[live]) if live.size else None)
        want_max.append(max(arr[live]) if live.size else None)
    keyed = {"k": list(np.unique(k)), "a": want_min, "z": want_max}
    live = arr[s[s >= 0]]
    keyless = {"a": [min(live)], "z": [max(live)]}
    with table_in_both("mm", {"k": k, "s": s}, {"s": values},
                       batch_rows=128):
        for optimize in (True, False):
            monkeypatch.setattr(torch_config, "optimize_plans", optimize)
            scan = TorchPlanBuilder().table_scan("mm", ["k", "s"])
            got = torch_run_plan(scan.aggregate(
                ["k"], ["min(s) AS a", "max(s) AS z"]).order_by(["k"]))
            assert got == keyed, f"optimize={optimize}"
            got = torch_run_plan(TorchPlanBuilder().table_scan(
                "mm", ["k", "s"]).streaming_aggregate(
                ["k"], ["min(s) AS a", "max(s) AS z"]))
            assert got == keyed, f"streaming optimize={optimize}"
            got = torch_run_plan(TorchPlanBuilder().table_scan(
                "mm", ["k", "s"]).aggregate(
                [], ["min(s) AS a", "max(s) AS z"]))
            assert got == keyless, f"keyless optimize={optimize}"


#: what the JAX package registers and the port does not: nothing since
#: the time-zone names (``utils/tz.py``) and the complex types' 26 names
#: were ported
NOT_PORTED = set()


def test_registry_gap_is_complex_types_and_time_zones():
    import velox_tpu.expr.compiler  # noqa: F401  (registers its forms)
    import velox_tpu.functions.scalar  # noqa: F401
    import velox_tpu_torch.expr.compiler  # noqa: F401
    from velox_tpu.functions.registry import registry as jax_registry
    from velox_tpu_torch.functions import registry

    assert len(NOT_PORTED) == 0
    assert set(jax_registry) - set(registry) == NOT_PORTED
    assert len(set(jax_registry) & set(registry)) == 186
    for name in set(jax_registry) & set(registry):
        assert registry[name].default_nulls == \
            jax_registry[name].default_nulls, name
        assert registry[name].deterministic == \
            jax_registry[name].deterministic, name
