"""Plan fuzzer: randomized scan/filter/join/aggregate plans vs a plain
Python oracle (the port of ``velox_tpu/fuzzer/plan_fuzzer.py``).

Analog of velox's JoinFuzzer + AggregationFuzzer
(velox/exec/fuzzer/JoinFuzzer.h, AggregationFuzzer.h): generate random
relational plans over random tables, execute through the engine, and
compare against an independently computed result with SQL null
semantics (null join keys never match; aggregates skip nulls; the sum,
min, max and avg of no non-NULL value are NULL). For a seed the tables
and plans are the JAX package's; where its pandas oracle departs from
SQL (ROADMAP, the reference's differences), this one keeps SQL.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from velox_tpu_torch import resolve_device
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.types import BIGINT, DOUBLE
from velox_tpu_torch.vector.batch import Batch

_JOINS = ["inner", "left", "left_semi", "anti_simple"]
#: (SQL aggregate, the reference's pandas reduction)
_AGGS = [("sum", "sum"), ("count", "count"), ("min", "min"),
         ("max", "max"), ("avg", "mean")]
_TYPES = {"k": BIGINT, "v": DOUBLE, "g": BIGINT}


def _table(rng, n, key_space, null_p):
    return {
        "k": [None if rng.random() < null_p else int(x)
              for x in rng.integers(0, key_space, n)],
        "v": [None if rng.random() < null_p else
              float(np.round(x, 3)) for x in rng.normal(size=n)],
        "g": [int(x) for x in rng.integers(0, 5, n)],
    }


def _cuts(rng, n: int) -> List[int]:
    """Split bounds into 1-3 batches to exercise multi-split paths."""
    cuts = sorted(rng.choice(range(1, n), size=int(rng.integers(0, 3)),
                             replace=False)) if n > 3 else []
    return [0] + [int(c) for c in cuts] + [n]


def _batches(bounds, data, device) -> List[Batch]:
    return [
        Batch.from_pydict(
            {c: data[c][lo:hi] for c in data}, _TYPES, device=device)
        for lo, hi in zip(bounds, bounds[1:])]


class Case:
    """One iteration's tables, split bounds and plan parameters."""

    def __init__(self, left, right, jt, thresh, use_filter, agg_keyed,
                 agg_fn, lbounds, rbounds):
        self.left, self.right, self.jt = left, right, jt
        self.thresh, self.use_filter = thresh, use_filter
        self.agg_keyed, self.agg_fn = agg_keyed, agg_fn
        self.lbounds, self.rbounds = lbounds, rbounds

    def plan(self, device) -> PlanBuilder:
        pb = PlanBuilder().values(_batches(self.lbounds, self.left, device))
        if self.use_filter:
            pb = pb.filter(f"v > {self.thresh}")
        rb = (PlanBuilder()
              .values(_batches(self.rbounds, self.right, device))
              .project(["k as rk", "v as rv"]))
        pb = pb.hash_join(rb, ["k"], ["rk"], self.jt)
        aggs = [f"{self.agg_fn}(v) as a", "count(*) as c"]
        return pb.aggregate(["g"] if self.agg_keyed else [], aggs)

    def describe(self) -> str:
        return (f"join={self.jt} filter={self.use_filter} "
                f"agg={self.agg_fn} keyed={self.agg_keyed}")


def draw_case(rng: np.random.Generator) -> Case:
    """One iteration, drawn from ``rng`` in the reference fuzzer's
    order."""
    nl = int(rng.integers(5, 120))
    nr = int(rng.integers(3, 60))
    ks = int(rng.integers(2, 40))
    left = _table(rng, nl, ks, float(rng.uniform(0, 0.3)))
    right = _table(rng, nr, ks, float(rng.uniform(0, 0.3)))
    jt = str(rng.choice(_JOINS))
    thresh = float(np.round(rng.normal(), 2))
    use_filter = bool(rng.random() < 0.5)
    agg_keyed = bool(rng.random() < 0.6)
    agg_fn = _AGGS[int(rng.integers(0, len(_AGGS)))][0]
    lbounds = _cuts(rng, nl)
    rbounds = _cuts(rng, nr)
    return Case(left, right, jt, thresh, use_filter, agg_keyed, agg_fn,
                lbounds, rbounds)


def _reduce(fn: str, vals: list):
    """SQL ``fn(v)`` over a group's values: NULLs skipped; ``count`` of
    none is 0, the others NULL."""
    xs = [v for v in vals if v is not None]
    if fn == "count":
        return len(xs)
    if not xs:
        return None
    if fn == "sum":
        return sum(xs)
    if fn == "avg":
        return sum(xs) / len(xs)
    return min(xs) if fn == "min" else max(xs)


def oracle(case: Case) -> Dict[str, list]:
    """The plan's result as ``run_plan`` gives it (keyed: ordered by
    ``g``), by SQL semantics over plain lists."""
    left = [dict(zip(case.left, r)) for r in zip(*case.left.values())]
    if case.use_filter:
        left = [r for r in left
                if r["v"] is not None and r["v"] > case.thresh]
    right = [dict(zip(case.right, r)) for r in zip(*case.right.values())]
    rkeys = {r["k"] for r in right if r["k"] is not None}
    if case.jt == "inner":
        j = [lr for lr in left if lr["k"] is not None
             for rr in right if rr["k"] == lr["k"]]
    elif case.jt == "left":
        j = [lr for lr in left if lr["k"] is not None
             for rr in right if rr["k"] == lr["k"]] + [
            lr for lr in left if lr["k"] not in rkeys]
    elif case.jt == "left_semi":
        j = [lr for lr in left if lr["k"] in rkeys]
    else:  # anti_simple (NOT EXISTS): a NULL probe key never matches
        j = [lr for lr in left if lr["k"] not in rkeys]
    if not case.agg_keyed:
        return {"a": [_reduce(case.agg_fn, [r["v"] for r in j])],
                "c": [len(j)]}
    groups: Dict[int, list] = {}
    for r in j:
        groups.setdefault(r["g"], []).append(r["v"])
    keys = sorted(groups)
    return {"g": keys,
            "a": [_reduce(case.agg_fn, groups[g]) for g in keys],
            "c": [len(groups[g]) for g in keys]}


def _close(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) < 1e-9 + 1e-9 * abs(b)


def check(i: int, case: Case, got: Dict[str, list],
          want: Dict[str, list]) -> None:
    """Groups and counts exactly, the aggregate within 1e-9 (NULL for
    NULL)."""
    if case.agg_keyed:
        order = sorted(range(len(got["g"])), key=lambda r: got["g"][r])
        got = {c: [got[c][r] for r in order] for c in ("g", "a", "c")}
        assert got["g"] == want["g"] and got["c"] == want["c"], \
            _fail(i, case, got, want)
    else:
        assert got["c"] == want["c"], _fail(i, case, got, want)
    ok = [_close(x, y) for x, y in zip(got["a"], want["a"])]
    assert all(ok), _fail(i, case, got, want)


def run_plan_fuzz(iterations: int = 50, seed: int = 0,
                  verbose: bool = False, device=None) -> None:
    """``iterations`` random plans on ``device`` (default: the card)
    against the oracle."""
    from velox_tpu_torch.exec import run_plan

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    for i in range(iterations):
        case = draw_case(rng)
        check(i, case, run_plan(case.plan(device).build()), oracle(case))
        if verbose:
            print(f"iter {i}: {case.describe()} ok")


def _fail(i: int, case: Case, got, want: Optional[dict]) -> str:
    return f"iter {i}: {case.describe()}\ngot={got}\nexp={want}"
