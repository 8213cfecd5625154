"""Aggregation fuzzer: every registered aggregate x distinct x masks x
execution strategy, with a plan-equivalence oracle (the port of
``velox_tpu/fuzzer/aggregation_fuzzer.py``).

The velox AggregationFuzzer design (velox/exec/fuzzer/
AggregationFuzzer.cpp:247 verify(): the same aggregation runs as (a)
single-step, (b) partial -> final, (c) streaming over key-sorted input,
and (d) single-step under a tiny spill budget — all results must agree.
For a seed the aggregates, tables and plans are the JAX package's.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from velox_tpu_torch import resolve_device
from velox_tpu_torch.functions.aggregates import aggregate_registry
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE
from velox_tpu_torch.utils.config import config
from velox_tpu_torch.vector.batch import Batch

#: aggregate -> args template (None: not fuzzed here)
#: args use columns: i (int), x (float), y (float), b (bool), q (pos int)
_AGG_ARGS: Dict[str, Optional[str]] = {
    "sum": "x", "count": "x", "count_if": "b", "min": "x", "max": "x",
    "avg": "x", "variance": "x", "var_samp": "x", "var_pop": "x",
    "stddev": "x", "stddev_samp": "x", "stddev_pop": "x", "geometric_mean": "q",
    "skewness": "x", "kurtosis": "x", "checksum": "i",
    "bool_and": "b", "bool_or": "b", "arbitrary": "i",
    "min_by": "x, i", "max_by": "x, i",
    "covar_samp": "x, y", "covar_pop": "x, y", "corr": "x, y",
    "regr_slope": "x, y", "regr_intercept": "x, y",
    "bitwise_and_agg": "i", "bitwise_or_agg": "i",
    "bitwise_xor_agg": "i",
    "approx_distinct": "i", "product": "q", "entropy": "q",
    "array_agg": "i", "map_agg": "i, x", "map_union": None,
    "approx_percentile": "x, 0.5",
    "every": "b", "sum_distinct": None, "count_distinct": None,
    "histogram": None, "avg_x": None,
    "tdigest_agg": "x", "qdigest_agg": "i",
    "approx_winsorized_mean": "x, 0.1, 0.9",
    "numeric_histogram": "4, x",
    "vector_sum": None,            # ARRAY input (tests cover it)
    "classification_precision": "4, b, q",
    "classification_recall": None, "classification_miss_rate": None,
    "classification_fall_out": None, "classification_thresholds": None,
    # covered by test_digest.py; 'merge' needs a digest-typed input
    # column the fuzzer's random schema doesn't produce
    "merge": None,
    "set_agg": "i", "set_union": None, "map_union_sum": None,
    "approx_most_frequent": None, "reduce_agg": None,
    "noisy_count_gaussian": "i, 0.5, 7", "noisy_count_if_gaussian": "b, 0.5, 7",
    "noisy_sum_gaussian": "x, 0.5, 7", "noisy_avg_gaussian": "x, 0.5, 7",
}

#: aggregates whose multi-run equivalence can't use partial/final.
#: approx_percentile is NOT here: its digest-lane companions
#: (functions/aggregates_digest.py) are exact while every group holds
#: <= K=64 rows — so there the partial/final and spilled strategies must
#: match the exact single path bit-for-bit. A keyless aggregation of up
#: to 150 rows holds more: there they must lie within the digest's rank
#: error (``_past_exact_digest``).
_SINGLE_ONLY = {"approx_distinct", "bitwise_and_agg", "bitwise_or_agg",
                "bitwise_xor_agg", "map_union",
                "tdigest_agg", "qdigest_agg",
                "approx_winsorized_mean",
                "numeric_histogram", "classification_precision"}
#: no streaming (collect/matrix lanes; noisy_*: the gaussian draw is
#: keyed by final group slot, and streaming assigns slots by arrival
#: order instead of sorted-key rank — same contract as Presto, where
#: seeded draws are per-accumulator and not strategy-stable)
_NOISY = {"noisy_count_gaussian", "noisy_count_if_gaussian",
          "noisy_sum_gaussian", "noisy_avg_gaussian"}
_NO_STREAMING = _SINGLE_ONLY | _NOISY | {
    "approx_percentile", "array_agg", "map_agg", "set_agg"}
#: spilled partitions renumber group slots at extract, so slot-keyed
#: gaussian draws differ (same reasoning as _NO_STREAMING)
_NO_SPILL = _NOISY

def _data(rng, n):
    return {
        "g": [int(v) for v in rng.integers(0, 6, n)],
        "i": [None if rng.random() < 0.1 else int(v)
              for v in rng.integers(-50, 50, n)],
        "x": [None if rng.random() < 0.1 else
              float(np.round(v, 3)) for v in rng.normal(size=n)],
        "y": [float(np.round(v, 3)) for v in rng.normal(size=n)],
        "b": [bool(v) for v in rng.integers(0, 2, n)],
        "q": [float(v) for v in rng.uniform(0.1, 9.0, n)],
        "m": [bool(v) for v in rng.integers(0, 2, n)],
    }


_TYPES = {"g": BIGINT, "i": BIGINT, "x": DOUBLE, "y": DOUBLE,
          "b": BOOLEAN, "q": DOUBLE, "m": BOOLEAN}


def _canon_value(x):
    if isinstance(x, float):
        # 10 significant digits: strategies reassociate float
        # sums/products, exact equality is not the contract
        return None if math.isnan(x) else float(f"{x:.10g}")
    if isinstance(x, tuple):
        return tuple(_canon_value(e) for e in x)
    return x


def _canon(out: Dict[str, list]):
    rows = []
    for r in zip(*[out[c] for c in sorted(out)]):
        row = []
        for x in r:
            if isinstance(x, list):
                # an ARRAY or MAP: its elements as a multiset, a float
                # element (numeric_histogram's bucket means, sums
                # reassociated on the card) rounded as a float value is
                row.append(tuple(sorted(
                    (_canon_value(e) for e in x if e is not None),
                    key=str)))
            else:
                row.append(_canon_value(x))
        rows.append(tuple(row))
    return sorted(rows, key=lambda r: tuple(
        (x is None, str(type(x)), str(x) if isinstance(x, tuple) else x)
        for x in r))


def _values_match(x, y) -> bool:
    if isinstance(x, float) and isinstance(y, float):
        return math.isclose(x, y, rel_tol=1e-8, abs_tol=1e-9)
    if isinstance(x, tuple) and isinstance(y, tuple):
        return len(x) == len(y) and all(
            _values_match(a, b) for a, b in zip(x, y))
    return x == y


def _rows_match(a, b) -> bool:
    """Row-set equality with float tolerance: string rounding alone can
    flip the last kept digit on a 1-ulp reassociation difference at ANY
    precision, so floats compare via isclose on top of the canon (inside
    ARRAY and MAP values too)."""
    return len(a) == len(b) and all(
        _values_match(ra, rb) for ra, rb in zip(a, b))


def fuzzed_aggregates() -> List[str]:
    """The registered aggregates the fuzzer draws from, sorted."""
    return sorted(n for n, a in _AGG_ARGS.items()
                  if a is not None and n in aggregate_registry)


#: the port's exact long-decimal sums (``functions/aggregates_wide.py``),
#: which the plan builder emits for ``sum`` of a DECIMAL(38) column where
#: the JAX package sums each digit lane with ``sum``: no user names them
_PORT_ONLY = {"sum_wide0", "sum_wide1", "sum_wide2"}


def missing_aggregates() -> List[str]:
    """Registered aggregates the fuzzer has no entry for (``$`` names
    are internal companions)."""
    return [n for n in aggregate_registry
            if n not in _AGG_ARGS and "$" not in n and n not in _PORT_ONLY]


def _percentile_groups(case: "Case") -> Dict[object, List[float]]:
    """approx_percentile's input values by group key (``None`` keyless),
    sorted: the non-NULL ``x`` of the rows its mask passes."""
    d = case.data
    groups: Dict[object, List[float]] = {}
    for r in range(len(d["g"])):
        key = d["g"][r] if case.keyed else None
        vals = groups.setdefault(key, [])
        if d["x"][r] is not None and (not case.masked or d["m"][r]):
            vals.append(d["x"][r])
    return {k: sorted(v) for k, v in groups.items()}


def _past_exact_digest(case: "Case") -> bool:
    """Whether an approx_percentile group holds more values than the
    two-step digest keeps exactly (``aggregates_digest.K``): past that
    the digest's result is an approximation, within its rank error, and
    need not equal the exact single step's."""
    from velox_tpu_torch.functions.aggregates_digest import K

    return case.fn == "approx_percentile" and any(
        len(v) > K for v in _percentile_groups(case).values())


def _digest_rank_errors(case: "Case", out: Dict[str, list]) -> list:
    """The groups whose ``approx_percentile(x, 0.5)`` lies more than
    n / K ranks from the 0.5 (n - 1) position of the group's n sorted
    values (the bound phase 13 of chip_smoke holds the digest lanes to)
    or is NULL where a value exists."""
    from velox_tpu_torch.functions.aggregates_digest import K

    groups = _percentile_groups(case)
    keys = out["g"] if case.keyed else [None] * len(out["a"])
    bad = []
    for key, a in zip(keys, out["a"]):
        vals = groups.get(key, [])
        if a is None or not vals:
            if (a is None) != (not vals):
                bad.append((key, a, len(vals)))
            continue
        lo = sum(1 for v in vals if v < a)
        hi = sum(1 for v in vals if v <= a)
        pos, tol = 0.5 * (len(vals) - 1), len(vals) / K
        if not lo - 1 - tol <= pos <= hi + tol:
            bad.append((key, a, len(vals), lo, hi))
    return bad


class Case:
    """One iteration's aggregate, table and strategies."""

    def __init__(self, fn, data, keyed, masked, distinct, agg):
        self.fn, self.data, self.keyed = fn, data, keyed
        self.masked, self.distinct, self.agg = masked, distinct, agg
        self.keys = ["g"] if keyed else []
        self.masks = {"a": "m"} if masked else None

    def batches(self, device) -> List[Batch]:
        n = len(self.data["g"])
        cut = n // 2 if n > 3 else n
        if cut >= n:
            return [Batch.from_pydict(self.data, _TYPES, device=device)]
        return [Batch.from_pydict({c: v[:cut] for c, v in self.data.items()},
                                  _TYPES, device=device),
                Batch.from_pydict({c: v[cut:] for c, v in self.data.items()},
                                  _TYPES, device=device)]

    def plans(self, device) -> Dict[str, tuple]:
        """strategy -> (plan maker, spill budget or None), in the
        reference's order."""
        def single():
            return (PlanBuilder().values(self.batches(device))
                    .aggregate(self.keys, [self.agg], masks=self.masks))

        out = {"single": (single, None)}
        if self.fn not in _SINGLE_ONLY and not self.distinct:
            out["partial_final"] = (lambda: (
                PlanBuilder().values(self.batches(device))
                .partial_aggregation(self.keys, [self.agg],
                                     masks=self.masks)
                .final_aggregation()), None)
        if (self.keyed and self.fn not in _NO_STREAMING
                and not self.distinct):
            out["streaming"] = (lambda: (
                PlanBuilder().values(self.batches(device))
                .order_by(self.keys)
                .streaming_aggregate(self.keys, [self.agg],
                                     masks=self.masks)), None)
        if self.fn not in _NO_SPILL:
            out["spilled"] = (single, 1 << 11)
        return out

    def describe(self) -> str:
        return (f"{self.agg} keyed={self.keyed} masked={self.masked} "
                f"distinct={self.distinct}")


def draw_case(rng: np.random.Generator, i: int, fns: List[str]) -> Case:
    """Iteration ``i``, drawn from ``rng`` in the reference fuzzer's
    order: the first ``len(fns)`` iterations take each aggregate once."""
    fn = fns[i % len(fns)] if i < len(fns) else str(rng.choice(fns))
    args = _AGG_ARGS[fn]
    n = int(rng.integers(6, 150))
    data = _data(rng, n)
    keyed = bool(rng.random() < 0.7)
    masked = bool(rng.random() < 0.3)
    distinct = (bool(rng.random() < 0.25)
                and "," not in args
                and fn not in _SINGLE_ONLY
                and fn not in ("array_agg", "set_agg", "map_agg"))
    call = (f"{fn}(distinct {args})" if distinct
            else f"{fn}({args})")
    return Case(fn, data, keyed, masked, distinct, f"{call} as a")


def run_aggregation_fuzz(iterations: int = 60, seed: int = 0,
                         verbose: bool = False, device=None,
                         strategies: Optional[Counter] = None) -> List[str]:
    """``iterations`` random aggregations on ``device`` (default: the
    card), each through every strategy it allows; returns the registered
    aggregates the fuzzer has no entry for. The strategies run are
    counted into ``strategies`` where given."""
    from velox_tpu_torch.exec import run_plan

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    fns = fuzzed_aggregates()
    missing = missing_aggregates()
    strategies = Counter() if strategies is None else strategies
    for i in range(iterations):
        case = draw_case(rng, i, fns)
        results = {}
        for name, (make, budget) in case.plans(device).items():
            old = config.spill_memory_budget_bytes
            if budget is not None:
                config.spill_memory_budget_bytes = budget
            try:
                results[name] = run_plan(make().build())
            finally:
                config.spill_memory_budget_bytes = old
        strategies.update(list(results))

        base = _canon(results["single"])
        for name, res in results.items():
            if name != "single" and _past_exact_digest(case):
                bad = _digest_rank_errors(case, res)
                assert not bad, (
                    f"iter {i}: {case.describe()} strategy {name} is "
                    f"past the digest's rank error: {bad[:6]}")
                continue
            got = _canon(res)
            assert _rows_match(got, base), (
                f"iter {i}: {case.describe()} strategy {name} disagrees\n"
                f"{name}: {got[:6]}\nsingle: {base[:6]}")
        if verbose:
            print(f"iter {i}: {case.describe()} "
                  f"strategies={sorted(results)} ok")
    return missing
