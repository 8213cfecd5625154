"""Join fuzzer with a plan-equivalence oracle (the port of
``velox_tpu/fuzzer/join_fuzzer.py``).

The velox JoinFuzzer design (velox/exec/fuzzer/JoinFuzzer.cpp:160
makeDefaultPlan + makeAlternativePlans): the same random join query is
executed through every available physical strategy — hash join, merge
join (inputs pre-sorted) and the spilled-partitioned path (tiny memory
budget) — and all results must be identical. Equivalence across
independent implementations is the oracle; a plain-Python join with SQL
null semantics anchors the hash plan to ground truth where the query has
one key and no filter. For a seed the tables and queries are the JAX
package's.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np

from velox_tpu_torch import resolve_device
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.types import BIGINT, DOUBLE, VARCHAR
from velox_tpu_torch.utils.config import config
from velox_tpu_torch.vector.batch import Batch

_JOIN_TYPES = ["inner", "left", "right", "full", "left_semi",
               "right_semi", "anti", "anti_simple"]

_WORDS = ["red", "green", "blue", "teal", "plum", "gray"]

def _table(rng, n, key_space, null_p, two_keys):
    d = {
        "k": [None if rng.random() < null_p else int(x)
              for x in rng.integers(0, key_space, n)],
        "v": [float(np.round(x, 3)) for x in rng.normal(size=n)],
        "s": [str(rng.choice(_WORDS)) for _ in range(n)],
    }
    if two_keys:
        d["k2"] = [int(x) for x in rng.integers(0, 4, n)]
    return d


def _sorted_records(out: Dict[str, list]) -> List[tuple]:
    cols = sorted(out)
    rows = list(zip(*[out[c] for c in cols]))
    return sorted(
        rows, key=lambda r: tuple((x is None, x) for x in r))


def _norm(out: Dict[str, list]) -> List[tuple]:
    def canon(x):
        if isinstance(x, float):
            return round(x, 9)
        return x

    return [tuple(canon(x) for x in r) for r in _sorted_records(out)]


class Case:
    """One iteration's tables and query."""

    def __init__(self, left, right, jt, two_keys, filt, out_cols):
        self.left, self.right, self.jt = left, right, jt
        self.two_keys, self.filter, self.out_cols = two_keys, filt, out_cols
        self.ltypes = {"k": BIGINT, "v": DOUBLE, "s": VARCHAR}
        if two_keys:
            self.ltypes["k2"] = BIGINT
        self.lkeys = ["k"] + (["k2"] if two_keys else [])
        self.rkeys = ["rk"] + (["rk2"] if two_keys else [])

    def _rename(self, pb: PlanBuilder) -> PlanBuilder:
        cols = ["k as rk", "v as rv"]
        if self.two_keys:
            cols.append("k2 as rk2")
        return pb.project(cols)

    def hash_plan(self, device) -> PlanBuilder:
        return (PlanBuilder()
                .values([Batch.from_pydict(self.left, self.ltypes,
                                           device=device)])
                .hash_join(
                    self._rename(PlanBuilder().values(
                        [Batch.from_pydict(self.right, self.ltypes,
                                           device=device)])),
                    self.lkeys, self.rkeys, self.jt, filter=self.filter,
                    output=self.out_cols))

    def merge_plan(self, device) -> PlanBuilder:
        lpb = (PlanBuilder()
               .values([Batch.from_pydict(self.left, self.ltypes,
                                          device=device)])
               .order_by(self.lkeys))
        rpb = self._rename(
            PlanBuilder()
            .values([Batch.from_pydict(self.right, self.ltypes,
                                       device=device)])
            .order_by(["k"] + (["k2"] if self.two_keys else [])))
        return lpb.merge_join(rpb, self.lkeys, self.rkeys, self.jt,
                              filter=self.filter, output=self.out_cols)

    def describe(self) -> str:
        return (f"jt={self.jt} filter={self.filter} "
                f"two_keys={self.two_keys}")


def draw_case(rng: np.random.Generator) -> Case:
    """One iteration, drawn from ``rng`` in the reference fuzzer's
    order."""
    two_keys = bool(rng.random() < 0.3)
    nl = int(rng.integers(4, 100))
    nr = int(rng.integers(2, 60))
    ks = int(rng.integers(2, 30))
    null_p = float(rng.uniform(0, 0.25))
    jt = str(rng.choice(_JOIN_TYPES))
    use_filter = bool(rng.random() < 0.4) and jt not in (
        "right_semi",)
    left = _table(rng, nl, ks, null_p, two_keys)
    right = _table(rng, nr, ks, null_p if jt != "anti" else 0.0,
                   two_keys)
    semi_like = jt in ("left_semi", "anti", "anti_simple")
    out_cols = (["k", "v"] if semi_like
                else ["k", "v", "rv"] if jt != "right_semi"
                else ["rk", "rv"])
    filt = "v + rv > 0.0" if use_filter and not semi_like else (
        "v > 0.0" if use_filter else None)
    return Case(left, right, jt, two_keys, filt, out_cols)


def run_join_fuzz(iterations: int = 50, seed: int = 0,
                  verbose: bool = False, device=None) -> Counter:
    """``iterations`` random joins on ``device`` (default: the card),
    each through every strategy; returns the strategies run, counted."""
    from velox_tpu_torch.exec import run_plan

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    strategies: Counter = Counter()
    for i in range(iterations):
        case = draw_case(rng)
        results = {"hash": run_plan(case.hash_plan(device).build())}
        try:
            results["merge"] = run_plan(case.merge_plan(device).build())
        except NotImplementedError:
            pass
        old = config.spill_memory_budget_bytes
        config.spill_memory_budget_bytes = 1 << 11
        try:
            results["spilled"] = run_plan(case.hash_plan(device).build())
        finally:
            config.spill_memory_budget_bytes = old
        strategies.update(list(results))

        base = _norm(results["hash"])
        for name, res in results.items():
            got = _norm(res)
            assert got == base, (
                f"iter {i}: {case.describe()} plan {name} disagrees with "
                f"hash plan\n{name}: {got[:10]}\nhash: {base[:10]}")

        # plain ground truth for the filterless single-key cases
        if case.filter is None and not case.two_keys:
            want = _oracle(case.left, case.right, case.jt, case.out_cols)
            assert base == want, (
                f"iter {i}: jt={case.jt} hash plan != oracle\n"
                f"got {base[:10]}\nexp {want[:10]}")
        if verbose:
            print(f"iter {i}: {case.describe()} "
                  f"plans={sorted(results)} ok")
    return strategies


def _oracle(left, right, jt, out_cols) -> List[tuple]:
    """The join of ``left.k`` to ``right.k`` (named ``rk``, its ``v``
    ``rv``) with SQL null semantics: a NULL key never matches; the
    null-aware anti join returns nothing once the build side holds a
    NULL key, and a NULL probe key never qualifies for it. Rows come as
    the fuzzer's normalized records of ``out_cols``."""
    lrows = [{"k": k, "v": v} for k, v in zip(left["k"], left["v"])]
    rrows = [{"rk": k, "rv": v} for k, v in zip(right["k"], right["v"])]
    rkeys = {r["rk"] for r in rrows if r["rk"] is not None}
    lkeys = {r["k"] for r in lrows if r["k"] is not None}
    matched = [{**lr, **rr} for lr in lrows if lr["k"] is not None
               for rr in rrows if rr["rk"] == lr["k"]]
    lun = [{**lr, "rk": None, "rv": None} for lr in lrows
           if lr["k"] not in rkeys]
    run_ = [{"k": None, "v": None, **rr} for rr in rrows
            if rr["rk"] not in lkeys]
    if jt == "inner":
        rows = matched
    elif jt == "left":
        rows = matched + lun
    elif jt == "right":
        rows = matched + run_
    elif jt == "full":
        rows = matched + lun + run_
    elif jt == "left_semi":
        rows = [lr for lr in lrows if lr["k"] in rkeys]
    elif jt == "right_semi":
        rows = [rr for rr in rrows if rr["rk"] in lkeys]
    elif jt == "anti_simple":
        rows = [lr for lr in lrows if lr["k"] not in rkeys]
    elif any(rr["rk"] is None for rr in rrows):
        rows = []     # null-aware anti: a NULL build key kills every row
    else:
        rows = [lr for lr in lrows
                if lr["k"] is not None and lr["k"] not in rkeys]
    return _norm({c: [r[c] for r in rows] for c in out_cols})

