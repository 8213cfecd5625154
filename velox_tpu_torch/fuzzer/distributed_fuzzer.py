"""Distributed-execution fuzzer: ``run_plan_distributed`` == serial (the
port of ``velox_tpu/fuzzer/distributed_fuzzer.py``).

Random scan -> [filter] -> [semi join] -> [inner join | outer join] ->
project -> aggregation, PARTIAL/FINAL aggregation, ORDER BY, TopN or a
window run through the mesh runner (``parallel/``) and through the
serial ``run_plan``; the rows must be the same as multisets. Per-shard
partial aggregation, replicated builds, the one sync per expansion and
the shuffles must not show in the results. For a seed the draws are the
JAX package's, so both packages fuzz the same plans.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np

from velox_tpu_torch import resolve_device
from velox_tpu_torch.plan import PlanBuilder
from velox_tpu_torch.types import BIGINT, DOUBLE
from velox_tpu_torch.vector.batch import Batch

TABLE = "dfz_t"


def _canon(result: Dict[str, list]) -> List[tuple]:
    rows = []
    for r in zip(*[result[c] for c in sorted(result)]):
        rows.append(tuple(
            (None if x is None or (isinstance(x, float) and math.isnan(x))
             else float(f"{x:.10g}") if isinstance(x, float) else x)
            for x in r))
    return sorted(rows, key=lambda r: tuple((x is None, str(x)) for x in r))


def draw_case(rng: np.random.Generator, device=None
              ) -> Tuple[Dict[str, np.ndarray], Callable[[], PlanBuilder],
                         str]:
    """One iteration's table columns, its plan maker and a description,
    drawn from ``rng`` in the reference fuzzer's order; the plan's
    literal batches live on ``device`` (default: the card)."""
    device = resolve_device(device)
    n = int(rng.integers(500, 6000))
    ks = int(rng.integers(5, 400))
    columns = {
        "k": rng.integers(0, ks, n),
        "k2": rng.integers(0, 7, n),
        "v": np.round(rng.normal(size=n), 4),
    }
    nb = int(rng.integers(2, max(ks, 3)))
    build = Batch.from_pydict(
        {"bk": [int(x) for x in rng.choice(ks, nb, replace=False)],
         "w": [float(np.round(x, 4)) for x in rng.normal(size=nb)]},
        {"bk": BIGINT, "w": DOUBLE}, device=device)
    semi = Batch.from_pydict(
        {"sk": [int(x) for x in rng.integers(0, 7, 4)]}, {"sk": BIGINT},
        device=device)
    use_semi = bool(rng.random() < 0.5)
    use_inner = bool(rng.random() < 0.7) or not use_semi
    use_filter = bool(rng.random() < 0.5)
    keyed = bool(rng.random() < 0.7)
    tail = str(rng.choice(["agg", "agg2", "orderby", "topn", "outer",
                           "window"]))
    join_type = ("inner" if tail != "outer"
                 else str(rng.choice(["right", "full", "left"])))
    agg_fns = ["sum(x) AS s", "count(*) AS c"]
    if rng.random() < 0.5:
        agg_fns.append("min(x) AS lo")
    if rng.random() < 0.3:
        agg_fns.append("avg(x) AS m")

    def plan() -> PlanBuilder:
        pb = PlanBuilder().table_scan(TABLE, columns=["k", "k2", "v"])
        if use_filter:
            pb = pb.filter("v > -0.5")
        if use_semi:
            pb = pb.hash_join(PlanBuilder().values([semi]), ["k2"], ["sk"],
                              "left_semi")
        if use_inner or tail == "outer":
            out = ["k", "k2", "v", "w"] + (["bk"] if tail == "outer" else [])
            pb = pb.hash_join(PlanBuilder().values([build]), ["k"], ["bk"],
                              join_type, output=out)
            if tail == "outer":
                return pb
            pb = pb.project(["k", "v + w AS x"])
        else:
            pb = pb.project(["k", "v AS x"])
        if tail == "window":
            return (pb.window(["k"], ["x"], ["row_number() AS rn",
                                              "sum(x) AS sx"])
                    .order_by(["k", "x", "rn"]))
        if tail == "orderby":
            return pb.order_by(["x DESC", "k"])
        if tail == "topn":
            return pb.top_n(["x", "k DESC"], 13)
        if tail == "agg2":
            return (pb.partial_aggregation(["k"] if keyed else [], agg_fns)
                    .final_aggregation())
        return pb.aggregate(["k"] if keyed else [], agg_fns)

    what = (f"semi={use_semi} inner={use_inner} tail={tail} "
            f"jt={join_type} filter={use_filter} keyed={keyed}")
    return columns, plan, what


def run_distributed_fuzz(iterations: int = 20, seed: int = 0, mesh=None,
                         verbose: bool = False) -> List[str]:
    """``iterations`` random plans, each distributed over ``mesh``
    (default: one shard a card) against serial, the table on the mesh's
    first device; returns the strategy each took."""
    from velox_tpu_torch.exec import run_plan
    from velox_tpu_torch.io.catalog import drop_table, register_columns
    from velox_tpu_torch.parallel import runner
    from velox_tpu_torch.parallel.mesh import make_mesh

    mesh = mesh or make_mesh()
    device = mesh.devices[0]
    rng = np.random.default_rng(seed)
    strategies = []
    for i in range(iterations):
        columns, plan, what = draw_case(rng, device)
        register_columns(TABLE, columns, {}, 1 << 9, device=device)
        try:
            serial = _canon(run_plan(plan().build()))
            dist = _canon(runner.run_plan_distributed(plan().build(), mesh))
            strategies.append(runner.last_strategy)
            assert dist == serial, (
                f"iter {i}: distributed != serial ({what})\n"
                f"dist {dist[:5]}\nserial {serial[:5]}")
            if verbose:
                print(f"iter {i}: {what} rows={len(serial)} "
                      f"{runner.last_strategy} ok")
        finally:
            drop_table(TABLE)
    return strategies
