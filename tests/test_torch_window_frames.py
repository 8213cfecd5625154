"""Framed window sums over DOUBLE against ``math.fsum`` per frame.

A frame's ``sum``/``avg`` over DOUBLE must be local to the frame: a NaN
or an infinity reaches only the frames that hold it, and a large value
does not wipe the digits of the small frames after it. The oracle is
Python's ``math.fsum`` over each frame (NaN where the frame holds a NaN
or both infinities); the JAX package is wrong on both probes, as the
last test pins. Each case runs in the blocking ``WindowOp`` and in the
``StreamingWindowOp`` the optimizer picks over a table clustered on the
partition key (splits of 64 rows, so partitions span splits).
"""

import math

import numpy as np
import pytest

from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.exec.task import Task
from velox_tpu_torch.exec.window_ops import StreamingWindowOp, WindowOp
from velox_tpu_torch.io import catalog as torch_catalog
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.utils.config import config as torch_config

INF = float("inf")
NAN = float("nan")


def _fsum(vals):
    if any(math.isnan(v) for v in vals) or (INF in vals and -INF in vals):
        return NAN
    return math.fsum(vals)


def _oracle(p, o, v, fn, frame_type, lo, hi):
    """``fn`` over each row's frame ``lo`` PRECEDING .. ``hi`` FOLLOWING
    (None: unbounded), rows in (p, o, arrival) order."""
    out = []
    for i in range(len(v)):
        part = [j for j in range(len(v)) if p[j] == p[i]]
        part.sort(key=lambda j: (o[j], j))
        k = part.index(i)
        if frame_type == "rows":
            a = 0 if lo is None else max(k - lo, 0)
            b = len(part) - 1 if hi is None else min(k + hi, len(part) - 1)
            frame = [v[part[m]] for m in range(a, b + 1)]
        else:
            frame = [v[j] for j in part
                     if (lo is None or o[j] >= o[i] - lo)
                     and (hi is None or o[j] <= o[i] + hi)]
        s = _fsum(frame)
        out.append(s if fn == "sum" else s / len(frame))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (math.isnan(g) and math.isnan(w)) or g == w, (i, g, w)


def _run(name, cols, fns, streaming, monkeypatch):
    """The window over ``cols`` registered as ``name`` (ascending on
    ``p``), blocking or streaming, in arrival order."""
    monkeypatch.setattr(torch_config, "optimize_plans", streaming)
    torch_catalog.register_columns(name, cols, batch_rows=64, device="cpu")
    try:
        plan = (TorchPlanBuilder().table_scan(name)
                .window(["p"], ["o"], fns).order_by(["rid"]))
        kinds = {type(op) for op in Task(plan.build()).planner.operators}
        assert (StreamingWindowOp if streaming else WindowOp) in kinds
        return torch_run_plan(plan)
    finally:
        torch_catalog.drop_table(name)


PROBE_FNS = [
    "sum(v) ROWS BETWEEN 1 PRECEDING AND CURRENT ROW AS s1",
    "sum(v) RANGE BETWEEN 1 PRECEDING AND CURRENT ROW AS r1",
    "sum(v) ROWS BETWEEN CURRENT ROW AND CURRENT ROW AS s0",
    "avg(v) ROWS BETWEEN 1 PRECEDING AND CURRENT ROW AS a1",
]


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["blocking", "streaming"])
@pytest.mark.parametrize("poison", [INF, NAN], ids=["inf", "nan"])
def test_probes_equal_fsum(poison, streaming, monkeypatch):
    """ROADMAP C7's probes: [1, x, 1, 2, 3, 4] then [0.5, 0.25, 0.125, 3]
    in a second partition and [1e20, 1, 1, 2.5] in a third."""
    v = [1.0, poison, 1.0, 2.0, 3.0, 4.0, 0.5, 0.25, 0.125, 3.0,
         1e20, 1.0, 1.0, 2.5]
    p = [0] * 6 + [1] * 4 + [2] * 4
    o = [0, 1, 2, 3, 4, 5, 0, 1, 2, 3, 0, 1, 2, 3]
    cols = {"p": np.asarray(p), "o": np.asarray(o),
            "rid": np.arange(len(v)), "v": np.asarray(v)}
    got = _run("c7_probe", cols, PROBE_FNS, streaming, monkeypatch)
    _same(got["s1"], _oracle(p, o, v, "sum", "rows", 1, 0))
    _same(got["r1"], _oracle(p, o, v, "sum", "range", 1, 0))
    _same(got["s0"], _oracle(p, o, v, "sum", "rows", 0, 0))
    _same(got["a1"], _oracle(p, o, v, "avg", "rows", 1, 0))
    # the probes' exact answers, as ROADMAP C7 states them
    assert got["s1"][3:6] == [3.0, 5.0, 7.0]
    assert got["s1"][6:10] == [0.5, 0.75, 0.375, 3.125]
    assert got["s0"][10:14] == [1e20, 1.0, 1.0, 2.5]
    assert got["a1"][12:14] == [1.0, 1.75]


@pytest.fixture(scope="module")
def table300():
    """300 rows in 7 partitions, ascending on ``p``, with a NaN, an inf
    and a -inf, order keys with ties, and values of mixed magnitude."""
    rng = np.random.default_rng(707)
    n = 300
    p = np.sort(rng.integers(0, 7, n))
    o = rng.integers(0, 40, n)
    v = rng.normal(size=n) * 10.0 ** rng.integers(-3, 17, n)
    v[[41, 130, 222]] = [NAN, INF, -INF]
    return {"p": p, "o": o, "rid": np.arange(n), "v": v}


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["blocking", "streaming"])
@pytest.mark.parametrize("frame_type", ["rows", "range"])
def test_300_rows_equal_fsum(table300, frame_type, streaming, monkeypatch):
    kw = frame_type.upper()
    fns = [f"sum(v) {kw} BETWEEN 2 PRECEDING AND CURRENT ROW AS s2",
           f"sum(v) {kw} BETWEEN 3 PRECEDING AND 2 FOLLOWING AS s32",
           f"avg(v) {kw} BETWEEN 1 PRECEDING AND 1 FOLLOWING AS a11",
           f"sum(v) {kw} BETWEEN UNBOUNDED PRECEDING AND 1 FOLLOWING AS su"]
    got = _run(f"c7_{frame_type}", table300, fns, streaming, monkeypatch)
    p, o, v = (table300[c].tolist() for c in ("p", "o", "v"))
    _same(got["s2"], _oracle(p, o, v, "sum", frame_type, 2, 0))
    _same(got["s32"], _oracle(p, o, v, "sum", frame_type, 3, 2))
    _same(got["a11"], _oracle(p, o, v, "avg", frame_type, 1, 1))
    _same(got["su"], _oracle(p, o, v, "sum", frame_type, None, 1))


def test_the_reference_differs_on_the_probes():
    """The JAX package subtracts running sums: after the inf, every
    later frame of its partition is NaN where the exact sums are
    3, 5, 7."""
    import pyarrow as pa

    from velox_tpu.exec import run_plan as jax_run_plan
    from velox_tpu.io.catalog import drop_table, register_arrow
    from velox_tpu.plan import PlanBuilder as JaxPlanBuilder

    v = [1.0, INF, 1.0, 2.0, 3.0, 4.0, 0.5, 0.25, 0.125, 3.0]
    register_arrow("c7_ref", pa.table({
        "p": pa.array([0] * 6 + [1] * 4, pa.int64()),
        "o": pa.array([0, 1, 2, 3, 4, 5, 0, 1, 2, 3], pa.int64()),
        "v": pa.array(v, pa.float64())}), 16)
    try:
        got = jax_run_plan(JaxPlanBuilder().table_scan("c7_ref").window(
            ["p"], ["o"], [PROBE_FNS[0]]).build()).to_pydict()
    finally:
        drop_table("c7_ref")
    assert got["s1"][:3] == [1.0, INF, INF]
    assert all(math.isnan(x) for x in got["s1"][3:6])
