"""The port's join, group-by and top-N ops against their JAX counterparts
on seeded numpy inputs: duplicate keys, null keys, the int64 max key (the
build index's own sentinel), inactive rows and ties. Integer results
must be equal; float64 segmented sums agree to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu.functions import scalar as jax_scalar
from velox_tpu.ops import bloom as jax_bloom
from velox_tpu.ops import groupby as jax_groupby
from velox_tpu.ops import join as jax_join
from velox_tpu.ops import sort as jax_sort
from velox_tpu_torch.functions import scalar as torch_scalar
from velox_tpu_torch.ops import bloom as torch_bloom
from velox_tpu_torch.ops import groupby as torch_groupby
from velox_tpu_torch.ops import join as torch_join
from velox_tpu_torch.ops import sort as torch_sort

I64_MAX = np.iinfo(np.int64).max
N_BUILD, N_PROBE = 700, 1500

# the reference ops run jitted: one compile each instead of one per
# primitive of an eager run
_jax_probe = jax.jit(jax_join.probe_join_index)
_jax_expand = jax.jit(jax_join.expand_matches, static_argnums=3)
_jax_group = jax.jit(jax_groupby.group_ids_sorted)
_jax_scan = jax.jit(jax_groupby.segment_scan, static_argnums=2)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _eq(got, exp, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exp),
                                  err_msg=what)


def _keys(rng, n, hi=200):
    """int64 keys with many duplicates, the int64 max, and negatives."""
    k = rng.integers(-20, hi, n).astype(np.int64)
    k[rng.random(n) < 0.02] = I64_MAX
    return k


@pytest.fixture(scope="module")
def join_inputs():
    rng = np.random.default_rng(20240601)
    bk = _keys(rng, N_BUILD)
    bvalid = rng.random(N_BUILD) > 0.1          # null build keys
    bsel = rng.random(N_BUILD) > 0.2            # inactive build rows
    pk = _keys(rng, N_PROBE, hi=260)
    pvalid = rng.random(N_PROBE) > 0.1
    psel = rng.random(N_PROBE) > 0.2
    return bk, bvalid, bsel, pk, pvalid, psel


@pytest.fixture(scope="module")
def build_index(join_inputs):
    bk, bvalid, bsel = join_inputs[:3]
    exp = jax_join.build_join_index(_j(bk), _j(bvalid), _j(bsel))
    got = torch_join.build_join_index(_t(bk), _t(bvalid), _t(bsel))
    return exp, got


def test_build_join_index(build_index):
    exp, got = build_index
    for e, g, what in zip(exp, got, ("sorted_keys", "perm", "n_active")):
        _eq(g, e, what)


@pytest.mark.parametrize("probe", ["hash", "presorted"])
def test_probe_join_index(join_inputs, build_index, probe):
    _, _, _, pk, pvalid, psel = join_inputs
    (sk, _, n), (tsk, _, tn) = build_index
    jfn, tfn = {
        "hash": (_jax_probe, torch_join.probe_join_index),
        "presorted": (jax_join.probe_join_index_presorted,
                      torch_join.probe_join_index_presorted)}[probe]
    ef, ec = jfn(sk, n, _j(pk), _j(pvalid), _j(psel))
    gf, gc = tfn(tsk, tn, _t(pk), _t(pvalid), _t(psel))
    _eq(gc, ec, "count")
    assert int(np.asarray(ec).sum()) > 0
    hit = np.asarray(ec) > 0
    _eq(gf.numpy()[hit], np.asarray(ef)[hit], "first")


def test_build_join_index_presorted(join_inputs):
    rng = np.random.default_rng(3)
    key = np.sort(_keys(rng, N_BUILD))
    valid, sel = join_inputs[1], join_inputs[2]
    exp = jax_join.build_join_index_presorted(_j(key), _j(valid), _j(sel))
    got = torch_join.build_join_index_presorted(_t(key), _t(valid), _t(sel))
    _eq(got[0], exp[0], "sorted_keys")
    n = int(exp[2])
    _eq(got[1][:n], np.asarray(exp[1])[:n], "perm")
    _eq(got[2], exp[2], "n_active")


def _ascending_probe(rng, n, dtype=np.int64):
    return np.sort(rng.integers(-30, 280, n)).astype(dtype)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("packed", [True, False])
def test_rank_in_sorted(build_index, side, packed):
    rng = np.random.default_rng(11)
    pk = _ascending_probe(rng, 4000)
    (sk, _, n), (tsk, _, _) = build_index
    lo, hi = -20, 199
    rng_arg = (lo, hi) if packed else None
    exp = jax_join._rank_in_sorted(_j(pk), sk, side, rng_arg)
    got = torch_join._rank_in_sorted(_t(pk), tsk, side, rng_arg)
    act = np.arange(sk.shape[0]) < int(n)
    _eq(got.numpy()[act], np.asarray(exp)[act], f"{side} packed={packed}")
    # the packed form clamps values into [lo - 1, hi + 1], which is exact
    # for build keys inside the range the codec reports
    inside = act & (np.asarray(sk) >= lo) & (np.asarray(sk) <= hi)
    _eq(got.numpy()[inside],
        np.searchsorted(pk, np.asarray(sk)[inside], side), "vs numpy")


@pytest.mark.parametrize("repair", [False, True])
def test_probe_join_index_merge(build_index, repair):
    rng = np.random.default_rng(5)
    (sk, _, n), (tsk, _, tn) = build_index
    pk = _ascending_probe(rng, N_PROBE)
    pvalid = None
    psel = np.ones(N_PROBE, bool)
    if repair:
        # an ascending active prefix, an arbitrary tail (a padded batch)
        psel[1200:] = False
        pk[1200:] = rng.integers(-100, 100, N_PROBE - 1200)
        pvalid = np.ones(N_PROBE, bool)
        pvalid[1190:1200] = False
    fn = ("probe_join_index_merge_repair" if repair
          else "probe_join_index_merge")
    ef, ec = getattr(jax_join, fn)(sk, n, _j(pk), _j(pvalid), _j(psel),
                                   (-20, 199))
    gf, gc = getattr(torch_join, fn)(tsk, tn, _t(pk), _t(pvalid),
                                     _t(psel))
    _eq(gc, ec, "count")
    hit = np.asarray(ec) > 0
    assert hit.sum() > 100
    _eq(gf.numpy()[hit], np.asarray(ef)[hit], "first")


def test_merge_repair_folds_match_valid_after_the_fill(build_index):
    """The merge-join operator's repair: rows the key codec marks as
    unable to match stay in the lane's order (only padding and null keys
    take the fill), as the reference operator repairs the lane before it
    folds ``match_valid`` in."""
    rng = np.random.default_rng(43)
    (sk, _, n), (tsk, _, tn) = build_index
    pk = _ascending_probe(rng, N_PROBE)
    psel = np.arange(N_PROBE) < 1200
    pk[1200:] = rng.integers(-100, 100, N_PROBE - 1200)
    null_valid = np.ones(N_PROBE, bool)
    null_valid[1190:1200] = False
    match_valid = rng.random(N_PROBE) > 0.3
    cnt = int((psel & null_valid).sum())
    repaired = np.where(np.arange(N_PROBE) < cnt, pk, I64_MAX)
    ef, ec = jax_join.probe_join_index_merge(
        sk, n, _j(repaired), _j(null_valid & match_valid), _j(psel),
        (-20, 199))
    gf, gc = torch_join.probe_join_index_merge_repair(
        tsk, tn, _t(pk), _t(null_valid), _t(psel),
        match_valid=_t(match_valid))
    _eq(gc, ec, "count")
    hit = np.asarray(ec) > 0
    assert hit.sum() > 100
    _eq(gf.numpy()[hit], np.asarray(ef)[hit], "first")


def test_merge_repair_casts_before_the_fill():
    """int64 probe into an int32 build: the tail filler must be the int32
    max, not an int64 max that wraps below every key."""
    build = np.arange(0, 40, 2, dtype=np.int32)
    sel_b = np.ones(20, bool)
    jk, _, jn = jax_join.build_join_index_presorted(_j(build), None,
                                                    _j(sel_b))
    tk, _, tn = torch_join.build_join_index_presorted(_t(build), None,
                                                      _t(sel_b))
    pk = np.concatenate([np.arange(30, dtype=np.int64),
                         np.full(10, -5, np.int64)])
    psel = np.arange(40) < 30
    ef, ec = jax_join.probe_join_index_merge_repair(jk, jn, _j(pk), None,
                                                    _j(psel))
    gf, gc = torch_join.probe_join_index_merge_repair(tk, tn, _t(pk), None,
                                                      _t(psel))
    _eq(gc, ec)
    _eq(gc[:30], (np.arange(30) % 2 == 0).astype(np.int64))


@pytest.mark.parametrize("case", ["raw", "prefix", "unsorted", "holes"])
def test_valid_ascending_code(case):
    v = np.arange(300, dtype=np.int64)
    ok = np.ones(300, bool)
    if case == "prefix":
        v[250:] = 3
        ok[250:] = False
    elif case == "unsorted":
        v[10], v[11] = v[11], v[10]
    elif case == "holes":
        v[250:] = 3
        ok[100] = False
        ok[250:] = False
    exp = int(jax_join.valid_ascending_code(_j(v), _j(ok)))
    got = int(torch_join.valid_ascending_code(_t(v), _t(ok)))
    assert got == exp == {"raw": 2, "prefix": 1, "unsorted": 0,
                          "holes": 0}[case]


def test_join_table(join_inputs, build_index):
    _, _, _, pk, pvalid, psel = join_inputs
    (sk, _, n), (tsk, _, tn) = build_index
    lo, span = -20, 220
    et = jax_join.build_join_table(sk, n, lo, span)
    gt = torch_join.build_join_table(tsk, tn, lo, span)
    _eq(gt[0], et[0], "tfirst")
    _eq(gt[1], et[1], "tcount")
    ef, ec = jax_join.probe_join_table(et[0], et[1], lo, _j(pk), _j(pvalid),
                                       _j(psel))
    gf, gc = torch_join.probe_join_table(gt[0], gt[1], lo, _t(pk),
                                         _t(pvalid), _t(psel))
    _eq(gc, ec, "count")
    hit = np.asarray(ec) > 0
    _eq(gf.numpy()[hit], np.asarray(ef)[hit], "first")


@pytest.mark.parametrize("selective", [False, True])
@pytest.mark.parametrize("left_outer", [False, True])
def test_expand_matches(join_inputs, build_index, selective, left_outer):
    _, _, _, pk, pvalid, psel = join_inputs
    (sk, jperm, n), (tsk, tperm, tn) = build_index
    if selective:
        psel = psel & (np.arange(N_PROBE) < 40)
    ef, ec = _jax_probe(sk, n, _j(pk), _j(pvalid), _j(psel))
    gf, gc = torch_join.probe_join_index(tsk, tn, _t(pk), _t(pvalid),
                                         _t(psel))
    emit = psel if left_outer else None
    total = int(jax_join.match_total(ec, _j(emit)))
    assert int(torch_join.match_total(gc, _t(emit))) == total
    out_cap = max(128, 1 << (total - 1).bit_length())
    assert (out_cap * 8 <= N_PROBE) == selective
    exp = _jax_expand(ef, ec, jperm, out_cap, _j(emit))
    got = torch_join.expand_matches(gf, gc, tperm, out_cap, _t(emit))
    live = np.asarray(exp[3])
    assert live.sum() == total
    for e, g, what in zip(exp, got, ("probe_rows", "build_rows", "matched",
                                     "out_sel")):
        _eq(g.numpy()[live], np.asarray(e)[live], what)
    _eq(got[3], exp[3], "out_sel")
    flags_e = jax_join.build_matched_flags(N_BUILD, exp[1], exp[2], exp[3])
    flags_g = torch_join.build_matched_flags(N_BUILD, got[1], got[2], got[3])
    _eq(flags_g, flags_e, "matched flags")


@pytest.mark.parametrize("bits", [(3, 7, 9), (20, 30, 13)])
def test_pack_normalized_key(bits):
    rng = np.random.default_rng(sum(bits))
    ids = [rng.integers(0, 1 << b, 500).astype(np.int32) for b in bits]
    exp = jax_join.pack_normalized_key([_j(i) for i in ids], bits)
    got = torch_join.pack_normalized_key([_t(i) for i in ids], bits)
    assert str(got.dtype).endswith(str(exp.dtype))
    _eq(got, exp)


@pytest.fixture(scope="module")
def group_inputs():
    rng = np.random.default_rng(7)
    n = 1024
    a = rng.integers(0, 6, n).astype(np.int64)
    a[rng.random(n) < 0.01] = I64_MAX
    av = rng.random(n) > 0.1
    b = rng.integers(-3, 3, n).astype(np.int32)
    c = rng.choice([-0.0, 0.0, 1.5, -2.25, np.nan], n)
    sel = rng.random(n) > 0.15
    return [(a, av), (b, None), (c, None)], sel


def test_group_ids_sorted(group_inputs):
    keys, sel = group_inputs
    exp = _jax_group([(_j(v), _j(m)) for v, m in keys], _j(sel))
    got = torch_groupby.group_ids_sorted([(_t(v), _t(m)) for v, m in keys],
                                         _t(sel))
    ng = int(exp[3])
    assert int(got[3]) == ng and 50 < ng < int(sel.sum())
    _eq(got[0].numpy()[sel], np.asarray(exp[0])[sel], "gids")
    _eq(got[1][:ng], np.asarray(exp[1])[:ng], "group_rows")
    _eq(got[2], exp[2], "group_sel")


def test_group_ids_sorted_keyless(group_inputs):
    _, sel = group_inputs
    exp = _jax_group([], _j(sel))
    got = torch_groupby.group_ids_sorted([], _t(sel))
    _eq(got[0].numpy()[sel], np.asarray(exp[0])[sel])
    _eq(got[2], exp[2])
    assert int(got[3]) == int(exp[3]) == 1


def _segments(rng, n):
    head = rng.random(n) < 0.05
    head[0] = True
    return head


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_segment_scan_int64_exact(op):
    rng = np.random.default_rng(13)
    n = 5000
    v = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    head = _segments(rng, n)
    exp = _jax_scan(_j(v), _j(head), op)
    got = torch_groupby.segment_scan(_t(v), _t(head), op)
    _eq(got, exp, op)


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_segment_scan_float64(op):
    """Large positive prefixes before small segments: a cumsum-difference
    form would lose the segments' low digits."""
    rng = np.random.default_rng(17)
    n = 5000
    v = rng.uniform(0.0, 1e3, n)
    v[:100] = 1e13
    head = _segments(rng, n)
    head[100] = True
    exp = np.asarray(_jax_scan(_j(v), _j(head), op))
    got = torch_groupby.segment_scan(_t(v), _t(head), op).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_top", [10, 100])
def test_top_n_indices(n_top):
    """revenue DESC, date ASC with many exact ties, nulls last: ties keep
    input order (a stable sort)."""
    rng = np.random.default_rng(19)
    cap = 512
    rev = rng.integers(0, 8, cap).astype(np.int64)
    rvalid = rng.random(cap) > 0.1
    date = rng.integers(0, 3, cap).astype(np.int32)
    sel = rng.random(cap) > 0.3
    spec = [(rev, rvalid, True, False), (date, None, False, False)]
    ei, es = jax_sort.top_n_indices(
        [(_j(v), _j(m), d, nf) for v, m, d, nf in spec], _j(sel), n_top)
    gi, gs = torch_sort.top_n_indices(
        [(_t(v), _t(m), d, nf) for v, m, d, nf in spec], _t(sel), n_top)
    _eq(gi, ei, "indices")
    _eq(gs, es, "out_sel")


def test_pack_and_compact_indices(group_inputs):
    _, sel = group_inputs
    _eq(torch_sort.pack_indices(_t(sel)), jax_sort.pack_indices(_j(sel)))
    _eq(torch_sort.pack_indices(_t(sel), fill=-1),
        jax_sort.pack_indices(_j(sel), fill=-1))
    _eq(torch_sort.compact_indices(_t(sel)),
        jax_sort.compact_indices(_j(sel)))


def test_bloom_matches_reference():
    rng = np.random.default_rng(23)
    vals = np.unique(rng.integers(-(1 << 62), 1 << 62, 3000))
    words = torch_bloom.build_bloom(vals)
    _eq(words, jax_bloom.build_bloom(vals))
    probe = np.concatenate([vals, rng.integers(-(1 << 62), 1 << 62, 9000),
                            [I64_MAX, np.iinfo(np.int64).min, 0, -1]])
    exp = jax_bloom.bloom_contains_device(_j(probe), _j(words))
    got = torch_bloom.bloom_contains_device(
        _t(probe), _t(words.view(np.int64)))
    _eq(got, exp)
    assert got[:len(vals)].all()


@pytest.mark.parametrize("table", ["bitmask", "or_chain", "search", "bloom"])
def test_in_table(table):
    """The pushed filter's tables, made once on the device
    (``in_table_literal``, ``bloom_literal``), answer as the reference's
    host tables do."""
    rng = np.random.default_rng(29)
    if table == "bitmask":
        tb = np.unique(rng.integers(0, 5000, 300))
    elif table == "or_chain":
        tb = np.unique(rng.integers(0, 1 << 40, 200))
    else:
        tb = np.unique(rng.integers(0, 1 << 40, 2000))
    v = np.concatenate([tb, rng.integers(0, 1 << 40, 1000),
                        rng.integers(-10, 5010, 1000)]).astype(np.int64)
    if table == "bloom":
        words = torch_bloom.build_bloom(tb)
        exp = jax_scalar._bloom_contains_impl(_j(v), _j(words))
        got = torch_scalar._bloom_contains_impl(
            _t(v), torch_scalar.bloom_literal(words, "cpu"))
    else:
        exp = jax_scalar._in_table_impl(_j(v), tb)
        lit = torch_scalar.in_table_literal(tb, "cpu")
        assert (lit.tensor is None) == (table == "or_chain")
        got = torch_scalar._in_table_impl(_t(v), lit)
    _eq(got, exp)
    assert got[:len(tb)].all()


def test_distinct_matches_unique():
    from velox_tpu_torch.exec.operators import _distinct

    rng = np.random.default_rng(31)
    for a in (rng.integers(-50, 50, 3000), _keys(rng, 2000),
              np.arange(5, dtype=np.int32), np.array([7], np.int64)):
        _eq(_distinct(a), np.unique(a))


def _batches(seed, cap=512):
    """The same two batches (an int64 lane with nulls, a string lane with
    its own dictionary each, a selection with holes) in both packages."""
    from velox_tpu.types.types import BIGINT as JB, VARCHAR as JV
    from velox_tpu.vector.batch import Batch as JBatch
    from velox_tpu.vector.column import Column as JCol, Dictionary as JDict
    from velox_tpu_torch.types.types import BIGINT as TB, VARCHAR as TV
    from velox_tpu_torch.vector.batch import Batch as TBatch
    from velox_tpu_torch.vector.column import (
        Column as TCol, Dictionary as TDict,
    )

    rng = np.random.default_rng(seed)
    out = ([], [])
    for words in (["ant", "cow", "eel"], ["bee", "cow", "dog", "fox"]):
        v = rng.integers(-9, 9, cap).astype(np.int64)
        va = rng.random(cap) > 0.2
        codes = rng.integers(-1, len(words), cap).astype(np.int32)
        sel = rng.random(cap) > 0.6
        out[0].append(JBatch({
            "v": JCol(JB, _j(v), _j(va)),
            "s": JCol(JV, _j(codes), None, JDict(words))}, _j(sel)))
        out[1].append(TBatch({
            "v": TCol(TB, _t(v), _t(va)),
            "s": TCol(TV, _t(codes), None, TDict(words))}, _t(sel)))
    return out


def _same_batch(got, exp):
    _eq(got.sel, exp.sel, "sel")
    assert got.capacity == exp.capacity and got.num_rows == exp.num_rows
    for n in exp.columns:
        g, e = got.columns[n], exp.columns[n]
        live = np.asarray(exp.sel)
        _eq(g.values.numpy()[live], np.asarray(e.values)[live], n)
        if e.valid is not None:
            _eq(g.valid.numpy()[live], np.asarray(e.valid)[live], n)
        if e.dictionary is not None:
            assert list(g.dictionary.values) == list(e.dictionary.values)


def test_compact_and_harmonize_match_reference():
    from velox_tpu.vector.batch import (
        harmonize_dictionaries as jax_harmonize,
    )
    from velox_tpu_torch.vector.batch import (
        harmonize_dictionaries as torch_harmonize,
    )

    (jb, _), (tb, _) = _batches(37)
    _same_batch(tb.compact(), jb.compact())
    n = int(np.asarray(jb.sel).sum())
    dense = np.arange(jb.capacity) < n
    _same_batch(tb.with_sel(_t(dense)).compact_prefix(n),
                jb.with_sel(_j(dense)).compact_prefix(n))
    jax_pair, torch_pair = _batches(41)
    for g, e in zip(torch_harmonize(torch_pair), jax_harmonize(jax_pair)):
        _same_batch(g, e)
