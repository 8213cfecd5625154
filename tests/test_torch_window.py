"""The port's window operators against the JAX package on the CPU.

One seeded table, in three literal batches of each package: 60
partitions of uneven size (one holds a single row), order keys with
ties, NULLs in the value columns and a string partition key with NULLs.
Every window function and frame of ``tests/test_window.py`` runs through
both packages' ``run_plan``, and the results must be equal row for row
(integers exactly, DOUBLE to rtol=1e-9). Then the streaming window
equals the blocking one over a table clustered on the partition key,
the optimizer picks the streaming window there, and the
``ops/window.py`` helpers equal the JAX package's on random segments.
"""

import numpy as np
import pytest
import torch

from torch_tpch_data import assert_same, table_in_both, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.utils.config import config as torch_config

N = 400


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(11)
    p = rng.integers(0, 60, N)
    p[17] = 99                      # a one-row partition
    cols = {
        "p": p,
        "ps": rng.integers(-1, 6, N).astype(np.int32),
        "o": rng.integers(0, 12, N),   # many ties within a partition
        "rid": np.arange(N),
        "v": np.round(rng.normal(size=N) * 100, 2),
        "q": rng.integers(0, 1000, N),
    }
    nulls = {"v": rng.random(N) < 0.1, "q": rng.random(N) < 0.1}
    dicts = {"ps": ["ash", "birch", "cedar", "elm", "fir", "oak"]}
    return values_in_both(cols, nulls, dicts)


#: (partition keys, sort keys, functions): every function and frame of
#: tests/test_window.py, over NULLs, ties and a one-row partition
CASES = {
    "ranking": (["p"], ["o"], [
        "row_number() AS rn", "rank() AS r", "dense_rank() AS dr",
        "percent_rank() AS pr", "cume_dist() AS cd", "ntile(4) AS nt",
        "ntile(7) AS nt7"]),
    "running_aggregates": (["p"], ["o"], [
        "sum(v) AS s", "count(v) AS c", "min(v) AS lo", "max(v) AS hi",
        "avg(v) AS m", "sum(q) AS sq", "min(q) AS mq", "count(q) AS cq",
        "avg(q) AS aq"]),
    "value_functions": (["p"], ["o", "rid"], [
        "lead(v) AS ld", "lag(v) AS lg", "lag(v, 2) AS lg2",
        "lead(q, 3) AS lq", "first_value(v) AS fv", "last_value(v) AS lv",
        "nth_value(q, 2) AS nq"]),
    "rows_frames": (["p"], ["o", "rid"], [
        "sum(v) ROWS BETWEEN 2 PRECEDING AND CURRENT ROW AS s",
        "avg(v) ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING AS a",
        "count(v) ROWS BETWEEN UNBOUNDED PRECEDING AND 1 FOLLOWING AS c",
        "sum(q) ROWS BETWEEN 6 PRECEDING AND CURRENT ROW AS sq",
        "min(v) ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING AS lo",
        "max(q) ROWS BETWEEN 4 PRECEDING AND CURRENT ROW AS hi",
        "min(q) ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING AS mq",
        "first_value(v) ROWS BETWEEN 2 PRECEDING AND CURRENT ROW AS f",
        "last_value(q) ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING AS l",
        "nth_value(v, 2) ROWS BETWEEN 3 PRECEDING AND CURRENT ROW AS nv"]),
    "range_frames": (["p"], ["o", "rid"], [
        "sum(v) RANGE BETWEEN 2 PRECEDING AND CURRENT ROW AS s",
        "count(v) RANGE BETWEEN 1 PRECEDING AND 1 FOLLOWING AS c",
        "min(v) RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING AS lo",
        "max(q) RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW AS hi",
        "sum(q) RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW AS sq",
        "avg(q) RANGE BETWEEN 2 PRECEDING AND 1 FOLLOWING AS aq"]),
    "descending_range": (["p"], ["o DESC", "rid"], [
        "sum(v) RANGE BETWEEN 2 PRECEDING AND CURRENT ROW AS s",
        "max(q) RANGE BETWEEN 1 PRECEDING AND 3 FOLLOWING AS hi",
        "rank() AS r", "sum(q) AS sq",
        "sum(v) ROWS BETWEEN 1 PRECEDING AND CURRENT ROW AS s1"]),
    "string_partition_with_nulls": (["ps"], ["o", "rid"], [
        "row_number() AS rn", "rank() AS r", "sum(v) AS s",
        "lag(q) AS lq", "max(v) ROWS BETWEEN 3 PRECEDING AND CURRENT ROW "
        "AS mx"]),
    "no_partition_no_order": ([], [], [
        "avg(v) AS a", "count(q) AS c", "min(q) AS lo", "rank() AS r",
        "cume_dist() AS cd"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_matches_jax(batches, case):
    jax_batches, torch_batches = batches
    keys, order, fns = CASES[case]
    exp = jax_run_plan(JaxPlanBuilder().values(jax_batches)
                       .window(keys, order, fns).build()).to_pydict()
    got = torch_run_plan(TorchPlanBuilder().values(torch_batches)
                         .window(keys, order, fns))
    assert_same(got, exp, case)


STREAM_FNS = ["row_number() AS rn", "rank() AS r", "sum(v) AS s",
              "sum(v) ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING AS s1",
              "min(v) RANGE BETWEEN 2 PRECEDING AND CURRENT ROW AS lo",
              "lag(q) AS lq", "count(*) AS c"]


@pytest.fixture(scope="module")
def clustered():
    """A table ascending on ``p`` in splits of 128 rows, so partitions
    span splits, in both catalogs, and the JAX package's rows of the
    blocking window over it."""
    rng = np.random.default_rng(6)
    n = 700
    cols = {"p": np.sort(rng.integers(0, 25, n)),
            "o": rng.integers(0, 30, n), "rid": np.arange(n),
            "v": np.round(rng.normal(size=n), 3),
            "q": rng.integers(0, 50, n)}
    with table_in_both("swin", cols):
        exp = jax_run_plan(
            JaxPlanBuilder().table_scan("swin")
            .window(["p"], ["o", "rid"], STREAM_FNS).build()).to_pydict()
        yield exp


def test_streaming_window_equals_blocking(clustered, monkeypatch):
    for optimize in (True, False):
        monkeypatch.setattr(torch_config, "optimize_plans", optimize)
        got = torch_run_plan(TorchPlanBuilder().table_scan("swin")
                             .window(["p"], ["o", "rid"], STREAM_FNS))
        assert_same(got, clustered, f"optimize_plans={optimize}")


def test_optimizer_picks_streaming_window(clustered):
    from velox_tpu_torch.exec.task import Task
    from velox_tpu_torch.exec.window_ops import StreamingWindowOp
    from velox_tpu_torch.plan.nodes import StreamingWindowNode, WindowNode
    from velox_tpu_torch.plan.optimizer import optimize_plan

    plan = (TorchPlanBuilder().table_scan("swin")
            .window(["p"], ["o"], ["sum(v) AS s"]).build())
    opt = optimize_plan(plan)
    assert type(opt) is StreamingWindowNode
    assert isinstance(Task(plan).planner.operators[-1], StreamingWindowOp)
    # a window not partitioned on the clustering key stays blocking
    other = optimize_plan(TorchPlanBuilder().table_scan("swin")
                          .window(["q"], ["o"], ["sum(v) AS s"]).build())
    assert type(other) is WindowNode


def test_window_helpers_match_jax():
    import jax.numpy as jnp

    from velox_tpu.ops import window as jw
    from velox_tpu_torch.ops import window as tw

    rng = np.random.default_rng(5)
    for n, p_new in ((1, 0.5), (257, 0.02), (1000, 0.3), (4096, 0.001)):
        part = rng.random(n) < p_new
        peer = part | (rng.random(n) < 0.4)
        n_valid = int(rng.integers(0, n + 1))
        ints = rng.integers(-1000, 1000, n)
        floats = rng.normal(size=n) * 1e6
        jp, tp = jnp.asarray(part), torch.from_numpy(part)
        jpe, tpe = jnp.asarray(peer), torch.from_numpy(peer)
        pairs = [
            (jw.segment_starts(jp), tw.segment_starts(tp)),
            (jw.segment_ends(jp, jnp.int32(n_valid)),
             tw.segment_ends(tp, torch.tensor(n_valid))),
            (jw.segmented_cumsum(jnp.asarray(ints), jp),
             tw.segmented_cumsum(torch.from_numpy(ints), tp)),
            (jw.segmented_scan(jnp.asarray(ints), jp, jnp.minimum),
             tw.segmented_scan(torch.from_numpy(ints), tp, "min")),
            (jw.segmented_scan(jnp.asarray(floats), jp, jnp.maximum),
             tw.segmented_scan(torch.from_numpy(floats), tp, "max")),
            (jw.row_numbers(jp), tw.row_numbers(tp)),
            *zip(jw.ranks(jp, jpe), tw.ranks(tp, tpe)),
        ]
        for i, (j, t) in enumerate(pairs):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"n={n} helper {i}")
        # positive values: running sums without cancellation, so the two
        # summation orders agree to rtol
        pos = np.abs(floats)
        np.testing.assert_allclose(
            tw.segmented_cumsum(torch.from_numpy(pos), tp).numpy(),
            np.asarray(jw.segmented_cumsum(jnp.asarray(pos), jp)),
            rtol=1e-9, err_msg=f"n={n} float cumsum")
