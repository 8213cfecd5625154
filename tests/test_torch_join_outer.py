"""The right, full and right-semi joins, and filters on left, right, full
and right-semi joins, held against the JAX package on the CPU, row order
included, on small hand-made tables in 24-row splits (so the build rows'
matched flags are OR-ed over several probe batches): NULL keys on both
sides, string keys over two dictionaries, an empty probe side (every
build row comes out) and an empty build side. Each plan runs with
``optimize_plans`` on (the build ascends on its key, so the join becomes
a merge join) and off (a hash join), and again with ``_EXPAND_CHUNK =
7``, so that a probe batch's pairs, its filter's per-row pass counts,
its resurrected rows and the matched flags cross expansion chunks.

Row order is the reference's: for each probe batch its joined rows
(probe-major, with a left or full join's unmatched probe rows among
them), then that batch's resurrected rows (probe rows whose every match
failed the filter), then, after the last probe batch, the build side's
rows (unmatched for right and full, matched for right semi), in build
order."""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.exec import task as torch_task
from velox_tpu_torch.exec.operators import HashProbeOp
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.plan.nodes import JoinType
from velox_tpu_torch.utils.config import config as torch_config

PROBE_WORDS = ["ant", "bee", "cat", "dog", "eel"]
BUILD_WORDS = ["bee", "cat", "cow", "eel", "fox", "yak"]

#: k NULL where it is 7 (the catalog ingests no NULL integers)
NULL_K = "CASE WHEN k = 7 THEN NULL ELSE k END AS k"


def _tables():
    rng = np.random.default_rng(20240619)
    n_p, n_b = 96, 60
    probe = {
        "k": rng.integers(0, 18, n_p).astype(np.int64),
        "s": rng.integers(-1, len(PROBE_WORDS), n_p).astype(np.int32),
        "v": rng.integers(0, 30, n_p).astype(np.int64),
    }
    build = {
        "k": np.sort(rng.integers(5, 26, n_b)).astype(np.int64),
        "s": rng.integers(-1, len(BUILD_WORDS), n_b).astype(np.int32),
        "w": rng.integers(0, 30, n_b).astype(np.int64),
    }
    return probe, build


def probe(b, null_keys=False, where=None):
    p = b().table_scan("op", columns=["k", "s", "v"])
    if where:
        p = p.filter(where)
    return p.project([NULL_K, "s", "v"]) if null_keys else p


def build(b, null_keys=False, where=None):
    p = b().table_scan("ob", columns=["k", "s", "w"])
    if where:
        p = p.filter(where)
    if null_keys:
        p = p.project([NULL_K, "s", "w"])
    return p.project(["k AS bk", "s AS bs", "w"])


def join(jt, keys=("k", "bk"), filter=None, output=None, **sides):
    """A plan of join type ``jt`` over ``probe``/``build`` with the
    keyword arguments of each side (``probe_null``, ``build_where``, ...)."""
    def plan(b):
        p = probe(b, sides.get("probe_null", False), sides.get("probe_where"))
        q = build(b, sides.get("build_null", False), sides.get("build_where"))
        out = output or (["bk", "bs", "w"] if jt == "right_semi"
                         else ["k", "s", "v", "bk", "bs", "w"])
        return p.hash_join(q, [keys[0]], [keys[1]], jt, filter=filter,
                           output=out)
    return plan


F = "w > v"
CASES = {
    "right": [join("right")],
    "full": [join("full")],
    "right_semi": [join("right_semi")],
    "right_filter": [join("right", filter=F),
                     join("right", filter="bs <> s")],
    "full_filter": [join("full", filter=F), join("full", filter="w + v < 25")],
    "left_filter": [join("left", filter=F),
                    join("left", filter="v < w", output=["k", "v", "w"])],
    "right_semi_filter": [join("right_semi", filter=F),
                          join("right_semi", filter="bs = s")],
    "null_keys": [join(jt, probe_null=True, build_null=True, filter=f)
                  for jt in ("right", "full", "right_semi")
                  for f in (None, F)],
    "string_keys": [join(jt, keys=("s", "bs"), filter=f)
                    for jt in ("right", "full", "right_semi", "left")
                    for f in (None, F) if (jt, f) != ("left", None)],
    "empty_probe": [join(jt, probe_where="v > 1000", filter=f)
                    for jt in ("right", "full", "right_semi")
                    for f in (None, F)],
    "empty_build": [join(jt, build_where="w > 1000", filter=f)
                    for jt in ("right", "full", "right_semi", "left")
                    for f in (None, F)],
}


@pytest.fixture(scope="module")
def jax_rows():
    """Both tables in both catalogs (24-row splits), and each plan's JAX
    rows, computed once."""
    p, b = _tables()
    rows = {}
    with table_in_both("op", p, {"s": PROBE_WORDS}, batch_rows=24), \
            table_in_both("ob", b, {"s": BUILD_WORDS}, batch_rows=24):

        def expected(case, i):
            if (case, i) not in rows:
                rows[(case, i)] = jax_run_plan(
                    CASES[case][i](JaxPlanBuilder).build()).to_pydict()
            return rows[(case, i)]

        yield expected


def _kinds(rows) -> set:
    """Which kinds of joined row a result holds."""
    out = set()
    probe = rows.get("k", rows.get("s"))
    build = rows.get("bk", rows.get("bs"))
    if probe is None or build is None:
        return {"semi"} if rows[next(iter(rows))] else set()
    for p, q in zip(rows.get("v", probe), rows.get("w", build)):
        out.add("matched" if p is not None and q is not None
                else "probe_only" if p is not None else "build_only")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_outer_join_matches_jax(jax_rows, case, monkeypatch):
    for i, plan in enumerate(CASES[case]):
        exp = jax_rows(case, i)
        for optimize in (True, False):
            for chunk in (HashProbeOp._EXPAND_CHUNK, 7):
                monkeypatch.setattr(torch_config, "optimize_plans", optimize)
                monkeypatch.setattr(HashProbeOp, "_EXPAND_CHUNK", chunk)
                assert_same(torch_run_plan(plan(TorchPlanBuilder)), exp,
                            f"{case}[{i}] optimize={optimize} chunk={chunk}")
    kinds = [_kinds(jax_rows(case, i)) for i in range(len(CASES[case]))]
    # each family holds every kind of row it claims
    want = {"right": {"matched", "build_only"},
            "full": {"matched", "probe_only", "build_only"},
            "right_filter": {"matched", "build_only"},
            "full_filter": {"matched", "probe_only", "build_only"},
            "left_filter": {"matched", "probe_only"},
            "right_semi": {"semi"}, "right_semi_filter": {"semi"},
            "empty_probe": {"build_only"}}.get(case, set())
    assert want <= set().union(*kinds), (case, kinds)


def test_pushdown_joins(monkeypatch):
    """The probe pushes build-side key filters into its scan for inner,
    left-semi, right and right-semi joins, never for left or full (they
    keep probe rows without a match); a right join gives the same rows
    with the pushdown and without it."""
    from velox_tpu_torch.exec.task import Task

    p, b = _tables()
    with table_in_both("op", p, {"s": PROBE_WORDS}, batch_rows=24), \
            table_in_both("ob", b, {"s": BUILD_WORDS}, batch_rows=24):
        for jt in JoinType:
            if jt in (JoinType.ANTI, JoinType.ANTI_SIMPLE):
                continue
            out = (["bk", "w"] if jt == JoinType.RIGHT_SEMI
                   else ["k", "v"] if jt == JoinType.LEFT_SEMI
                   else ["k", "v", "w"])
            task = Task(join(jt.value, output=out)(TorchPlanBuilder).build())
            probes = [op for p_ in task.planner.pipelines
                      for op in p_.operators if isinstance(op, HashProbeOp)]
            pushes = probes[0].pushdown_scan is not None
            assert pushes == (jt in (JoinType.INNER, JoinType.LEFT_SEMI,
                                     JoinType.RIGHT, JoinType.RIGHT_SEMI)), jt
        plan = join("right", filter=F)
        with_push = torch_run_plan(plan(TorchPlanBuilder))
        monkeypatch.setattr(torch_task, "_PUSHDOWN_JOINS",
                            (JoinType.INNER, JoinType.LEFT_SEMI))
        without = torch_run_plan(plan(TorchPlanBuilder))
        assert with_push == without and len(with_push["k"]) > 0
