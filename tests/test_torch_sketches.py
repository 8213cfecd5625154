"""Set sketches in the port against the JAX package on the CPU:
``approx_set``, ``make_set_digest`` and ``khyperloglog_agg`` blobs byte
for byte over integers, doubles and strings of two columns with different
dictionaries (one hash domain), keyed and keyless, past the SetDigest's
2048 and the KHyperLogLog's 512 capacities; the three merges over a
second aggregation; every reader (``cardinality`` of a blob, the
SetDigest and KHyperLogLog readers, the pair functions across
dictionaries); the device BLAKE2b against ``hashlib``; and the
collect helpers ``collect_runs`` and ``dedupe_first`` against the
reference's.
"""

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

#: two string columns over overlapping vocabularies, coded apart
WORDS_A = [f"w{i:03d}" for i in range(0, 300)]
WORDS_B = [f"w{i:03d}" for i in range(150, 500)]

SKETCHES = ["approx_set(i) AS hi", "approx_set(x) AS hx",
            "approx_set(a) AS ha", "make_set_digest(i) AS di",
            "make_set_digest(b) AS db", "khyperloglog_agg(i, u) AS ki",
            "khyperloglog_agg(a, u) AS ka"]


def _table():
    rng = np.random.default_rng(20261020)
    n = 6000
    k = rng.integers(0, 6, n).astype(np.int64)
    k[:40] = 6                    # a small group
    return {
        "k": rng.permutation(k),
        "i": rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64),
        # integral doubles hash as their ints; the rest as their repr
        "x": np.where(rng.integers(0, 2, n) == 1,
                      rng.integers(0, 50, n).astype(np.float64),
                      np.round(rng.standard_normal(n), 3)),
        "u": rng.integers(0, 40, n).astype(np.int64),
        "a": rng.integers(-1, len(WORDS_A), n).astype(np.int32),
        "b": rng.integers(0, len(WORDS_B), n).astype(np.int32),
    }


@pytest.fixture(scope="module")
def sk_table():
    """The table in both catalogs (1000-row splits) and each package's
    rows per plan, computed once."""
    rows = {}
    with table_in_both("sk", _table(), {"a": WORDS_A, "b": WORDS_B},
                       batch_rows=1000):

        def both(make):
            key = make.__name__
            if key not in rows:
                rows[key] = (torch_run_plan(make(TorchPlanBuilder).build()),
                             jax_run_plan(make(JaxPlanBuilder).build())
                             .to_pydict())
            return rows[key]

        yield both


def _sketches(keys):
    def make(pb):
        return pb().table_scan("sk").aggregate(keys, SKETCHES)

    make.__name__ = f"sketches{keys}"
    return make


@pytest.mark.parametrize("keys", [["k"], ["a"], []])
def test_sketch_blobs_equal_the_reference(sk_table, keys):
    got, want = sk_table(_sketches(keys))
    assert_same(got, want, str(keys))
    if not keys:
        # past the capacities: 2048 min-hashes, 512 x-hash records
        import velox_tpu_torch.functions.sketch as SK

        assert len(SK._sd_parse(got["di"][0])[1]) == SK.SD_K
        assert len(SK._khll_parse(got["ki"][0])) == SK.KHLL_K


def test_merges_over_a_second_aggregation(sk_table):
    def merged(pb):
        return (pb().table_scan("sk").aggregate(["k"], SKETCHES)
                .project(["k % 3 AS g", "hi", "di", "ki"])
                .aggregate(["g"], ["merge(hi) AS mh",
                                   "merge_set_digest(di) AS md",
                                   "merge_khll(ki) AS mk",
                                   "merge(di) AS m2"]))

    got, want = sk_table(merged)
    assert_same(got, want, "merges")
    assert len(got["g"]) == 3


def test_readers_equal_the_reference(sk_table):
    def read(pb):
        return (pb().table_scan("sk").aggregate(["k"], SKETCHES)
                .project(["k", "cardinality(hi) AS c1",
                          "sketch_cardinality(di) AS c2",
                          "cardinality(ki) AS c3", "hash_counts(db) AS hc",
                          "uniqueness_distribution(ki) AS ud",
                          "reidentification_potential(ka, 3) AS rp"]))

    got, want = sk_table(read)
    assert_same(got, want, "readers")
    t = _table()
    for g, c2 in zip(got["k"], got["c2"]):
        # a SetDigest below its capacity counts exactly
        exact = len(np.unique(t["i"][t["k"] == g]))
        assert c2 == exact or exact >= 2048


def test_pair_readers_across_dictionaries(sk_table):
    """``intersection_cardinality`` and ``jaccard_index`` of SetDigests of
    two string columns coded over different dictionaries: one hash
    domain, so below capacity the intersection is exact."""
    def pairs(pb):
        return (pb().table_scan("sk").aggregate(
            ["k"], ["make_set_digest(a) AS sa", "make_set_digest(b) AS sb"])
            .project(["k", "intersection_cardinality(sa, sb) AS ic",
                      "jaccard_index(sa, sb) AS jj",
                      "intersection_cardinality(sa, sa) AS ii"]))

    got, want = sk_table(pairs)
    assert_same(got, want, "pairs")
    t = _table()
    wa, wb = np.asarray(WORDS_A), np.asarray(WORDS_B)
    for g, ic, jj in zip(got["k"], got["ic"], got["jj"]):
        rows = t["k"] == g
        sa = set(wa[t["a"][rows & (t["a"] >= 0)]])
        sb = set(wb[t["b"][rows]])
        assert ic == len(sa & sb)
        assert jj == pytest.approx(len(sa & sb) / len(sa | sb), rel=1e-12)


def test_device_hash_equals_blake2b():
    """``hash64_ints`` (BLAKE2b over the decimal digits in int64 ops)
    against ``hashlib`` through the reference's ``hash64``, at every
    digit count, both signs and the int64 extremes."""
    import torch

    import velox_tpu.functions.sketch as ref
    from velox_tpu_torch.functions.sketch import hash64_ints

    vals = [0, 1, -1, 2 ** 63 - 1, -2 ** 63, -2 ** 63 + 1]
    vals += [s * (10 ** d - r) for d in range(1, 19) for r in (0, 1)
             for s in (1, -1)]
    vals += list(np.random.default_rng(5).integers(-2 ** 63, 2 ** 63 - 1,
                                                   500))
    v = np.asarray(vals, dtype=np.int64)
    got = hash64_ints(torch.from_numpy(v)).numpy().view(np.uint64)
    assert np.array_equal(got, ref.hash64_array(v))


def test_collect_helpers_equal_the_reference():
    """``dedupe_first`` and ``collect_runs`` of the port against the JAX
    package's over the same gids, keys and mask (ties in the key keep the
    lowest row; runs are stable by row)."""
    import jax.numpy as jnp
    import torch

    from velox_tpu.functions import aggregates_collect as ref
    from velox_tpu_torch.functions import aggregates_collect as port

    rng = np.random.default_rng(9)
    n = 500
    gids = rng.integers(0, 30, n).astype(np.int32)
    keys = rng.integers(-5, 5, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    got = port.dedupe_first(torch.from_numpy(gids), [torch.from_numpy(keys)],
                            torch.from_numpy(mask))
    want = ref.dedupe_first(jnp.asarray(gids), [jnp.asarray(keys)],
                            jnp.asarray(mask))
    assert np.array_equal(got.numpy(), np.asarray(want))
    perm, counts, starts = port.collect_runs(
        torch.from_numpy(gids), torch.from_numpy(mask),
        [torch.from_numpy(keys)])
    rperm, rcounts, rstarts = ref.collect_runs(
        jnp.asarray(gids), jnp.asarray(mask), [jnp.asarray(keys)])
    live = int(mask.sum())
    assert np.array_equal(perm[:live].numpy(), np.asarray(rperm)[:live])
    assert np.array_equal(counts.numpy(), np.asarray(rcounts))
    assert np.array_equal(starts.numpy(), np.asarray(rstarts))
