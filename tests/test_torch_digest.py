"""Quantile digests in the port against the JAX package on the CPU:
``tdigest_agg``/``qdigest_agg`` blobs equal as strings (DOUBLE, BIGINT and
DECIMAL sources, keyed and keyless, NULLs and masks), ``merge`` over a
second aggregation, the four digest readers of the binder and of
``functions/hostfns.py``, and ``approx_percentile``'s two-step form (its
K = 64 digest lanes) against the JAX package's two steps over the same
splits to rtol 1e-9, exact in groups of at most 64 rows.
"""

import numpy as np
import pytest

import velox_tpu.functions.digest as ref_digest
import velox_tpu.functions.hostfns as ref_host
import velox_tpu_torch.functions.digest as port_digest
import velox_tpu_torch.functions.hostfns as port_host
from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

WORDS = ["kiwi", "apple", "pear", "fig", "plum"]

PROJECT = ["k", "s", "m",
           "CASE WHEN f = 1 THEN NULL ELSE x END AS x",
           "CASE WHEN f = 2 THEN NULL ELSE i END AS i", "d"]

DIGESTS = ["tdigest_agg(x) AS tx", "qdigest_agg(i) AS qi",
           "tdigest_agg(d) AS td", "count(*) AS n"]
MASKS = {"td": "m"}

#: the readers of a digest column ``tx`` (DOUBLE source) and ``qi``
READERS = ["value_at_quantile(tx, 0.5) AS v5",
           "value_at_quantile(qi, 0.9) AS q9",
           "quantile_at_value(tx, 40.0) AS r40",
           "quantile_at_value(qi, 0.0) AS r0",
           "trimmed_mean(tx, 0.1, 0.9) AS tm",
           "scale_tdigest(tx, 2.0) AS sc"]

SIZES = [1, 3, 7, 20, 64, 65, 150, 400, 900]


def _table():
    rng = np.random.default_rng(20261019)
    sizes = np.resize(SIZES, 18)
    k = rng.permutation(np.repeat(np.arange(len(sizes)), sizes)).astype(
        np.int64)
    n = len(k)
    return {
        "k": k,
        "s": rng.integers(0, len(WORDS), n).astype(np.int32),
        "m": rng.integers(0, 2, n).astype(bool),
        "f": rng.integers(0, 9, n).astype(np.int64),
        "x": np.round(rng.standard_normal(n) * 10 + 40, 3),
        "i": rng.integers(-50, 500, n).astype(np.int64),
        "d": rng.integers(-99999, 99999, n).astype(np.int64),
    }


def _scan(pb):
    return pb().table_scan("dg").project(PROJECT)


@pytest.fixture(scope="module")
def dg_table():
    """The table in both catalogs (256-row splits) and each package's
    rows per plan, computed once."""
    rows = {}
    with table_in_both("dg", _table(), {"s": sorted(WORDS)},
                       overrides={"d": (12, 2)}, batch_rows=256):

        def both(make):
            key = make.__name__
            if key not in rows:
                rows[key] = (torch_run_plan(make(TorchPlanBuilder).build()),
                             jax_run_plan(make(JaxPlanBuilder).build())
                             .to_pydict())
            return rows[key]

        yield both


@pytest.mark.parametrize("keys", [["k"], ["s"], []])
def test_digest_blobs_equal_the_reference(dg_table, keys):
    def digests(pb, keys=tuple(keys)):
        return _scan(pb).aggregate(list(keys), DIGESTS, masks=MASKS)

    digests.__name__ = f"digests{keys}"
    got, want = dg_table(digests)
    assert_same(got, want, str(keys))
    blobs = [b for b in got["tx"] + got["qi"] if b is not None]
    assert blobs and all(b[:4] in ("TD1|", "QD1|") for b in blobs)


def test_merge_over_a_second_aggregation(dg_table):
    def merged(pb):
        return (_scan(pb).aggregate(["k"], DIGESTS, masks=MASKS)
                .project(["k % 4 AS g", "tx", "qi"])
                .aggregate(["g"], ["merge(tx) AS mt", "merge(qi) AS mq",
                                   "count(tx) AS c"]))

    got, want = dg_table(merged)
    assert_same(got, want, "merge")
    assert len(got["g"]) == 4


def test_digest_readers_equal_the_reference(dg_table):
    def read(pb):
        return (_scan(pb).aggregate(["k"], ["tdigest_agg(x) AS tx",
                                            "qdigest_agg(i) AS qi"])
                .project(["k"] + READERS))

    got, want = dg_table(read)
    assert_same(got, want, "readers")
    assert all(v is not None for v in got["v5"])


def test_hostfns_digest_readers_equal_the_reference():
    """The two ``hostfns`` readers and the ``digest.py`` functions under
    them, called directly over built blobs, and their errors on text
    that is no digest."""
    rng = np.random.default_rng(3)
    counts = np.array([0, 1, 5, 64, 300, 1000])
    starts = np.cumsum(counts) - counts
    vals = np.concatenate([np.sort(rng.standard_normal(c) * 5)
                           for c in counts])
    for kind in ("f", "i"):
        v = vals if kind == "f" else np.round(vals)
        blobs = port_digest.build_group_digests(counts, starts, v, kind)
        assert blobs == ref_digest.build_group_digests(counts, starts, v,
                                                       kind)
        for b in blobs[1:]:
            for q in (0.0, 0.25, 0.5, 0.99, 1.0):
                assert (port_host.digest_value_at_quantile(b, q)
                        == ref_host.digest_value_at_quantile(b, q))
            for x in (-20.0, 0.0, 0.5, 20.0):
                assert (port_host.digest_quantile_at_value(b, x)
                        == ref_host.digest_quantile_at_value(b, x))
            assert (port_digest.trimmed_mean_blob(b, 0.2, 0.7)
                    == ref_digest.trimmed_mean_blob(b, 0.2, 0.7))
        assert (port_digest.merge_digests(blobs[1:])
                == ref_digest.merge_digests(blobs[1:]))
    for fn in (port_host.digest_value_at_quantile,
               ref_host.digest_value_at_quantile):
        with pytest.raises(ValueError):
            fn("apple", 0.5)


def test_device_bucketing_equals_the_host_path():
    """``exec/collect_agg._device_digests`` (buckets gathered from the
    host's table per group size, sums by scatter) against
    ``build_group_digests`` over the same sorted runs, string for string;
    sums that could round fall back (None)."""
    import torch

    from velox_tpu_torch.exec.collect_agg import _device_digests
    from velox_tpu_torch.functions.aggregates_collect import collect_runs

    rng = np.random.default_rng(11)
    n = 5000
    gids = torch.from_numpy(rng.integers(0, 40, n))
    mask = torch.from_numpy(rng.random(n) < 0.9)
    vals = torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, n))
    perm, counts, starts = collect_runs(gids, mask, [vals])
    got = _device_digests(vals, perm, counts, starts, 40, "QD1")
    c, st = counts[:40].numpy(), starts[:40].numpy()
    sv = vals[perm[:int(c.sum())]].numpy()
    assert got == port_digest.build_group_digests(c, st, sv, "i", "QD1")
    assert got == ref_digest.build_group_digests(c, st, sv, "i", "QD1")
    big = vals * (1 << 44)
    assert _device_digests(big, perm, counts, starts, 40, "TD1") is None


@pytest.mark.parametrize("keys", [["k"], []])
def test_two_step_percentile_equals_the_reference(dg_table, keys):
    """The digest lanes' two steps against the JAX package's two steps to
    rtol 1e-9 (the same 256-row splits, so the same merges). A group of at
    most 64 rows keeps every value as its own centroid, so its result is
    exactly the value at the two-step rank ``floor(q * (n - 1))``, where
    ``q`` is the float32 quantile lane widened to float64 (for q = 0.9 at
    n - 1 = 10 that is rank 8; the single step's float32 product gives 9).
    (Keys that are all dictionary-coded would take the kArray PARTIAL
    step, which emits nothing in the JAX package.)"""
    aggs = ["approx_percentile(x, 0.5) AS px", "approx_percentile(i, 0.9) "
            "AS pi", "count(x) AS nx", "count(i) AS ni"]

    def two_step(pb, keys=tuple(keys)):
        return _scan(pb).partial_aggregation(list(keys), aggs) \
            .final_aggregation()

    two_step.__name__ = f"two_step{keys}"
    got, want = dg_table(two_step)
    assert_same(got, want, f"two-step {keys}")
    t = _table()
    values = {"px": (t["x"], t["f"] != 1, 0.5),
              "pi": (t["i"], t["f"] != 2, 0.9)}
    small = 0
    for r in range(len(got["nx"])):
        rows = np.ones(len(t["k"]), bool)
        for c in keys:
            code = (sorted(WORDS).index(got[c][r]) if c == "s"
                    else got[c][r])
            rows &= t[c] == code
        for p, (v, ok, q) in values.items():
            run = np.sort(v[rows & ok])
            if len(run) == 0:
                assert got[p][r] is None
            elif len(run) <= 64:
                rank = int(np.floor(float(np.float32(q)) * (len(run) - 1)))
                assert got[p][r] == run[rank], (p, len(run))
                small += 1
    assert small >= (4 if keys else 0)
