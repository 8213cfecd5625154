"""The last collect aggregates and the PARTIAL/FINAL page form: the port
against the JAX package.

One seeded table (NULL keys, NULL values, NULL and empty arrays, a
boolean outcome and a probability column) in three literal batches of
each package. ``approx_most_frequent``, ``numeric_histogram``,
``vector_sum``, ``reservoir_sample``, the five ``classification_*`` and
``reduce_agg`` run by key and keyless; the page form of ``array_agg``,
``set_agg`` and ``map_agg`` runs in two steps, with a mask and keyless,
against the JAX package's two steps and the port's single step. Every
result must equal the JAX package's element for element: exact for
integers and order, rtol=1e-9 for DOUBLE (``reduce_agg`` over DOUBLE
depends on its scan's association order).
"""

import numpy as np
import pytest

from test_torch_complex_project import same
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.types import BIGINT as J_BIGINT, BOOLEAN as J_BOOLEAN
from velox_tpu.types import DOUBLE as J_DOUBLE, VARCHAR as J_VARCHAR
from velox_tpu.types.types import array as j_array
from velox_tpu.vector.batch import Batch as JaxBatch
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.ops.hash import _shr, hash_i64
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, VARCHAR
from velox_tpu_torch.types.types import array
from velox_tpu_torch.vector.batch import Batch as TorchBatch

N = 180
SPLIT = 60
WORDS = ["ash", "birch", "cedar", "elm", "fir"]


def make_rows(seed: int = 20261018, n: int = N):
    rng = np.random.default_rng(seed)

    def maybe(p, v):
        return None if rng.random() < p else v

    return {
        "id": list(range(n)),
        "k": [maybe(0.1, int(v)) for v in rng.integers(0, 6, n)],
        "v": [maybe(0.1, int(v)) for v in rng.integers(-20, 40, n)],
        "x": [maybe(0.1, float(np.round(v, 3)))
              for v in rng.normal(size=n) * 30],
        "o": [bool(v) for v in rng.integers(0, 2, n)],
        "p": [maybe(0.05, float(np.round(v, 4))) for v in rng.random(n)],
        "m": [int(v) for v in rng.integers(0, 2, n)],
        "s": [maybe(0.1, str(w)) for w in rng.choice(WORDS, n)],
        "xs": [None if rng.random() < 0.1 else
               [maybe(0.1, int(v))
                for v in rng.integers(-9, 30, rng.integers(0, 5))]
               for _ in range(n)],
        "fs": [None if rng.random() < 0.1 else
               [maybe(0.1, float(np.round(v, 3)))
                for v in rng.normal(size=rng.integers(0, 4)) * 10]
               for _ in range(n)],
    }


def types_of(pkg):
    if pkg == "jax":
        B, D, V, L, A = J_BIGINT, J_DOUBLE, J_VARCHAR, J_BOOLEAN, j_array
    else:
        B, D, V, L, A = BIGINT, DOUBLE, VARCHAR, BOOLEAN, array
    return {"id": B, "k": B, "v": B, "x": D, "o": L, "p": D, "m": B,
            "s": V, "xs": A(B), "fs": A(D)}


def batches_of(rows, cols, split=SPLIT):
    out = ([], [])
    for lo in range(0, len(rows["id"]), split):
        part = {c: rows[c][lo:lo + split] for c in cols}
        types = {c: types_of("jax")[c] for c in cols}
        out[0].append(JaxBatch.from_pydict(part, types))
        out[1].append(TorchBatch.from_pydict(
            part, {c: types_of("torch")[c] for c in cols}, device="cpu"))
    return out


NUMERIC = ["id", "k", "v", "x", "o", "p", "m", "xs", "fs"]


@pytest.fixture(scope="module")
def table():
    rows = make_rows()
    return (rows, batches_of(rows, NUMERIC),
            batches_of(rows, NUMERIC + ["s"], split=N),
            batches_of(rows, ["id", "k", "v", "x", "m"]))


def run_both(batches, build):
    """The plan through both packages; the results equal column by
    column. The JAX package's OrderBy moves ARRAY/MAP columns to the
    front; the port keeps the plan's column order."""
    jb, tb = batches
    want = jax_run_plan(build(JaxPlanBuilder().values(jb)).build()
                        ).to_pydict()
    plan = build(TorchPlanBuilder().values(tb))
    got = torch_run_plan(plan)
    assert list(got) == list(plan.node.output_type.names)
    assert sorted(got) == sorted(want)
    for c in want:
        same(got[c], want[c], c)
    return got


KINDS = ["approx_most_frequent(2, v) AS mf",
         "numeric_histogram(4, x) AS nh",
         "vector_sum(xs) AS vs", "vector_sum(fs) AS vf",
         "reservoir_sample(v, 3) AS rs",
         "classification_precision(5, o, p) AS cp",
         "reduce_agg(v, 0, (a, b) -> a + b) AS rd",
         "count(*) AS n"]


@pytest.mark.parametrize("keys", [["k"], []], ids=["by_key", "keyless"])
def test_the_six_kinds_equal_jax(table, keys):
    _, batches, _, _ = table
    got = run_both(batches, lambda pb: pb.aggregate(keys, KINDS))
    assert any(r for r in got["rs"])


def test_most_frequent_and_reservoir_over_strings(table):
    """String values decode through their dictionary (one batch: the JAX
    package cannot concatenate string columns of different
    dictionaries)."""
    _, _, one, _ = table
    run_both(one, lambda pb: pb.aggregate(["k"], [
        "approx_most_frequent(3, s) AS mf", "reservoir_sample(s, 2) AS rs"]))


def test_classification_family_in_one_plan(table):
    _, batches, _, _ = table
    names = ["precision", "recall", "miss_rate", "fall_out", "thresholds"]
    got = run_both(batches, lambda pb: pb.aggregate(
        ["k"], [f"classification_{n}(10, o, p) AS c{i}"
                for i, n in enumerate(names)]))
    assert all(r is None or len(r) == 10 for r in got["c0"])


def test_reservoir_is_the_bottom_k_by_row_hash(table):
    """A keyless one-batch sample: the k non-NULL values whose row's
    ``hash_i64`` priority is smallest (ties by row)."""
    import torch

    rows, _, one, _ = table
    got = run_both(one, lambda pb: pb.aggregate(
        [], ["reservoir_sample(v, 5) AS rs"]))
    cap = one[1][0].capacity
    pri = _shr(hash_i64(torch.arange(cap, dtype=torch.int64)), 33).to(
        torch.int32).numpy()
    live = [i for i, v in enumerate(rows["v"]) if v is not None]
    order = sorted(live, key=lambda i: (pri[i], i))[:5]
    assert got["rs"][0] == [rows["v"][i] for i in order]


def test_reduce_agg(table):
    """Associative integer lambdas are exact; a DOUBLE sum depends on
    the association order of the scan (rtol=1e-9)."""
    rows, batches, _, _ = table
    aggs = ["reduce_agg(v, 0, (a, b) -> a + b) AS s",
            "reduce_agg(v, 1, (a, b) -> if(a > b, a, b)) AS mx",
            "reduce_agg(v, 7, (a, b) -> a * 0 + b) AS last",
            "reduce_agg(x, 0.5, (a, b) -> a + b) AS xs",
            "reduce_agg(x, 0.0, (a, b) -> if(a < b, a, b)) AS xmn"]
    got = run_both(batches, lambda pb: pb.aggregate(["k"], aggs))
    for key, s in zip(got["k"], got["s"]):
        vals = [v for kk, v in zip(rows["k"], rows["v"])
                if kk == key and v is not None]
        assert s == sum(vals)


PAGE_AGGS = {"array_agg": "array_agg(x) AS a", "set_agg": "set_agg(v) AS a",
             "map_agg": "map_agg(v, x) AS a"}


def _canon(v, fn):
    if v is None:
        return None
    if fn == "map_agg":
        return sorted(v, key=lambda kv: kv[0])
    return sorted(v, key=lambda x: (x is None, x))


@pytest.mark.parametrize("fn", sorted(PAGE_AGGS))
def test_page_form_equals_jax_and_single_step(table, fn):
    """PARTIAL emits ``a$0`` pages; FINAL expands and collects again. By
    key with a mask, and keyless: equal to the JAX package's two steps
    (row for row) and to the port's SINGLE step (element multisets)."""
    batches = table[3]
    agg = PAGE_AGGS[fn]
    part = torch_run_plan(TorchPlanBuilder().values(batches[1])
                          .partial_aggregation(["k"], [agg],
                                               masks={"a": "m"}))
    assert list(part) == ["k", "a$0"]
    # a collect node's groups come out in key order in both packages
    for keys, masks in ((["k"], {"a": "m"}), ([], None)):
        def two_step(pb):
            return pb.partial_aggregation(keys, [agg], masks=masks) \
                .final_aggregation()

        def single_step(pb):
            return pb.aggregate(keys, [agg], masks=masks)

        two = run_both(batches, two_step)
        single = torch_run_plan(single_step(
            TorchPlanBuilder().values(batches[1])))
        assert single.get("k") == two.get("k")
        assert [_canon(v, fn) for v in single["a"]] == \
            [_canon(v, fn) for v in two["a"]]


def test_collect_over_an_array_built_from_a_scan():
    """A scan whose projection builds an ARRAY stays unfused (the fused
    stages evaluate scalar expressions only) and feeds ``vector_sum``."""
    from torch_tpch_data import table_in_both

    rng = np.random.default_rng(4)
    cols = {"k": rng.integers(0, 5, 700).astype(np.int64),
            "a": rng.integers(-9, 9, 700).astype(np.int64),
            "b": rng.integers(0, 99, 700).astype(np.int64)}
    with table_in_both("vs_scan", cols, batch_rows=256):
        aggs = ["vector_sum(array_constructor(a, b, a * b)) AS v",
                "numeric_histogram(3, b) AS h"]
        want = jax_run_plan(JaxPlanBuilder().table_scan("vs_scan").aggregate(
            ["k"], aggs).build()).to_pydict()
        got = torch_run_plan(TorchPlanBuilder().table_scan(
            "vs_scan").aggregate(["k"], aggs))
    for c in want:
        same(got[c], want[c], c)


def test_mixed_node_refusal_raises_as_the_reference(table):
    _, (jb, tb), _, _ = table
    aggs = ["array_agg(x) AS a", "sum(x) AS s"]
    with pytest.raises(NotImplementedError):
        jax_run_plan(JaxPlanBuilder().values(jb).partial_aggregation(
            ["k"], aggs).final_aggregation().build())
    with pytest.raises(NotImplementedError, match="ALL array_agg"):
        torch_run_plan(TorchPlanBuilder().values(tb).partial_aggregation(
            ["k"], aggs).final_aggregation())
    with pytest.raises(NotImplementedError, match="one collect"):
        torch_run_plan(TorchPlanBuilder().values(tb).partial_aggregation(
            ["k"], ["array_agg(x) AS a", "set_agg(v) AS b"])
            .final_aggregation())
