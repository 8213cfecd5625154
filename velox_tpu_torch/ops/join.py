"""Equi-join kernels: sorted build index + probe (the port of the JAX
package's ``ops/join.py``).

The build side is sorted by key once; a probe row's matches are the run
``[first, first + count)`` of equal keys in that order (velox's duplicate
lists). The probe forms are those of the reference:

* ``probe_join_index``: a binary search of every probe key into the sorted
  build keys (the reference co-sorts instead; both give the left/right
  bounds of the equal-key run);
* the ``_presorted`` pair for merge joins: the build is already ascending,
  so its index is a front-pack of the usable rows;
* ``probe_join_index_merge``: the "flipped" merge probe for an ascending
  probe lane, which ranks each BUILD key into the probe lane and rebuilds
  per-probe runs with a difference array and prefix sums;
* ``build_join_table``/``probe_join_table``: a direct-address (kArray)
  table over a host-known key range, two gathers per probe row.

Index tensors are int64 (torch's index dtype). The expand step needs the
match total on the host once per probe batch, to size its output.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from velox_tpu_torch.ops.sort import lex_sort, pack_indices

Tensor = torch.Tensor


def _imax(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).max


def _key_lane(key: Tensor) -> Tensor:
    return key if key.dtype in (torch.int32, torch.int64) else key.to(
        torch.int64)


def _active(sel: Tensor, valid: Optional[Tensor]) -> Tensor:
    return sel if valid is None else sel & valid


def build_join_index(key: Tensor, valid: Optional[Tensor], sel: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Sort build rows by key; null-key and padding rows never match.

    Returns ``(sorted_keys, perm, n_active)``. Trailing (unmatchable)
    slots hold the lane's max so the array ascends for a binary search;
    match counts clamp by ``n_active`` so real max-value keys stay exact.
    Equal keys keep their input order, active rows before inactive ones
    (the reference's ``(key, row + cap if inactive)`` sort order). The
    key lane's width is kept.
    """
    cap = sel.shape[0]
    key = _key_lane(key)
    active = _active(sel, valid)
    big = _imax(key.dtype)
    key2 = torch.where(active, key, torch.full_like(key, big))
    perm = lex_sort([key2, (~active).to(torch.int32)])
    n_active = active.sum()
    idx = torch.arange(cap, device=sel.device)
    sorted_keys = torch.where(idx < n_active, key2.index_select(0, perm),
                              torch.full_like(key2, big))
    return sorted_keys, perm, n_active


def _probe_ok(probe_sel: Tensor, probe_valid: Optional[Tensor]) -> Tensor:
    return _active(probe_sel, probe_valid)


def probe_join_index(sorted_keys: Tensor, n_active: Tensor,
                     probe_key: Tensor, probe_valid: Optional[Tensor],
                     probe_sel: Tensor) -> Tuple[Tensor, Tensor]:
    """Per probe row: (first match position in the build sort, match
    count). Probe keys are cast to the build lane's dtype first."""
    pk = probe_key.to(sorted_keys.dtype).contiguous()
    first = torch.searchsorted(sorted_keys, pk, side="left")
    last = torch.searchsorted(sorted_keys, pk, side="right")
    first = torch.minimum(first, n_active)
    count = torch.minimum(last, n_active) - first
    count = torch.where(_probe_ok(probe_sel, probe_valid), count,
                        torch.zeros_like(count))
    return first, count


def build_join_index_presorted(key: Tensor, valid: Optional[Tensor],
                               sel: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Merge-join build index: the input already ascends on the key
    (nulls anywhere: they cannot match and are packed out). The usable
    rows are front-packed in order; no sort. Same contract as
    ``build_join_index``."""
    cap = sel.shape[0]
    key = _key_lane(key)
    active = _active(sel, valid)
    perm = pack_indices(active)
    n_active = active.sum()
    big = _imax(key.dtype)
    idx = torch.arange(cap, device=sel.device)
    taken = key.index_select(0, perm.clamp(max=cap - 1))
    sorted_keys = torch.where(idx < n_active, taken,
                              torch.full_like(key, big))
    return sorted_keys, perm, n_active


#: the merge join's binary-search probe: both build indexes ascend with
#: the same tail, so the hash probe's search serves it unchanged
probe_join_index_presorted = probe_join_index


def _rank_in_sorted(pk: Tensor, bk: Tensor, side: str,
                    key_range=None) -> Tensor:
    """For every ``bk[i]``, the count of ``pk`` entries ``<`` it (side
    "left") or ``<=`` it (side "right"): searchsorted semantics by ONE
    sort of the concatenation, where a build element's merged position
    minus its build rank is its probe rank. A tag breaks value ties per
    side (left: build after equal probe values is wrong, so build sorts
    before them; right: after), and the stable sort keeps ids in order.

    With host ``key_range`` (the build codec's ``(lo, hi)``) and a span
    under 2^29, ``(value, tag)`` packs into ONE int32 key: probe values
    clamp to ``[lo - 1, hi + 1]`` first, which keeps every probe value's
    order against every build key.

    The reference's merge probe ranks this way at wide probe lanes; the
    port's searches instead, and ``chip_smoke.py`` times both forms."""
    npr, nb = pk.shape[0], bk.shape[0]
    n = npr + nb
    tag_probe = 1 if side == "left" else 0
    device = pk.device
    if key_range is not None:
        lo, hi = key_range
        if (hi - lo + 3) * 2 < (1 << 31) - 2:
            lo1 = lo - 1
            pk2 = (pk.clamp(lo1, hi + 1) - lo1).to(torch.int32)
            bk2 = (bk.to(pk.dtype).clamp(lo1, hi + 1) - lo1).to(torch.int32)
            vals = torch.cat([pk2 * 2 + tag_probe,
                              bk2 * 2 + (1 - tag_probe)])
            sid = torch.sort(vals, stable=True).indices
            pos_of = torch.empty(n, dtype=torch.int64, device=device)
            pos_of[sid] = torch.arange(n, device=device)
            return pos_of[npr:] - torch.arange(nb, device=device)
    vals = torch.cat([pk, bk.to(pk.dtype)])
    tag = torch.cat([
        torch.full((npr,), tag_probe, dtype=torch.int32, device=device),
        torch.full((nb,), 1 - tag_probe, dtype=torch.int32, device=device)])
    sid = lex_sort([vals, tag])
    pos_of = torch.empty(n, dtype=torch.int64, device=device)
    pos_of[sid] = torch.arange(n, device=device)
    return pos_of[npr:] - torch.arange(nb, device=device)


def probe_join_index_merge(sorted_keys: Tensor, n_active: Tensor,
                           probe_key: Tensor, probe_valid: Optional[Tensor],
                           probe_sel: Tensor) -> Tuple[Tensor, Tensor]:
    """Flipped merge probe; the probe KEY LANE itself must ascend (callers
    check with ``valid_ascending_code``). Each build key is ranked into
    the probe lane (its matching probe run ``[pl, pr)``); per-probe
    ``count`` is the prefix sum of a difference array and ``first`` the
    last build position whose run starts at or before the row, less the
    count (a prefix sum too: no running max, which torch's CUDA scan runs
    slowly).

    The ranks come from ``torch.searchsorted`` at every probe width. The
    reference switches to ``_rank_in_sorted`` from 2^20 probe rows, where
    XLA lowers a search to dependent gathers; on the H100 the search is
    the faster form (``chip_smoke.py`` times both)."""
    nb = sorted_keys.shape[0]
    npr = probe_key.shape[0]
    device = probe_key.device
    pk = probe_key.to(sorted_keys.dtype).contiguous()
    bi = torch.arange(nb, device=device)
    act = bi < n_active
    pl = torch.searchsorted(pk, sorted_keys, side="left")
    pr = torch.searchsorted(pk, sorted_keys, side="right")
    pl = torch.where(act, pl, torch.full_like(pl, npr))
    pr = torch.where(act, pr, torch.full_like(pr, npr))
    one = act.to(torch.int64)
    delta = torch.zeros(npr + 1, dtype=torch.int64, device=device)
    delta.index_add_(0, pl, one)
    delta.index_add_(0, pr, -one)
    count = torch.cumsum(delta, 0)[:npr]
    # the last build position whose run starts at or before each probe
    # row: pl ascends over the active build rows, so that position is the
    # count of active rows with pl <= j, less one (-1 where there is none)
    starts = torch.zeros(npr + 1, dtype=torch.int64, device=device)
    starts.index_add_(0, pl, one)
    last = torch.cumsum(starts, 0)[:npr] - 1
    first = (last + 1 - count).clamp(min=0)
    count = torch.where(_probe_ok(probe_sel, probe_valid), count,
                        torch.zeros_like(count))
    return first, count


def probe_join_index_merge_repair(sorted_keys: Tensor, n_active: Tensor,
                                  probe_key: Tensor,
                                  probe_valid: Optional[Tensor],
                                  probe_sel: Tensor,
                                  match_valid: Optional[Tensor] = None
                                  ) -> Tuple[Tensor, Tensor]:
    """Flipped merge probe for a lane whose active rows are an ascending
    PREFIX (a batch tail padded to capacity): the suffix fills with the
    build lane's max, which keeps the lane ascending. The cast to the
    build lane's dtype comes BEFORE the fill: an int64 max cast to int32
    would wrap to -1 and land below every real key.

    ``match_valid`` (the key codec's mask of rows that cannot match)
    joins the output mask only AFTER the repair: it marks real, sorted
    rows, and filling those would break the run boundaries."""
    ok = _probe_ok(probe_sel, probe_valid)
    cnt = ok.sum()
    idx = torch.arange(probe_key.shape[0], device=probe_key.device)
    pk = probe_key.to(sorted_keys.dtype)
    repaired = torch.where(idx < cnt, pk, torch.full_like(pk, _imax(pk.dtype)))
    if match_valid is not None:
        probe_valid = _active(match_valid, probe_valid)
    return probe_join_index_merge(sorted_keys, n_active, repaired,
                                  probe_valid, probe_sel)


def valid_ascending_code(values: Tensor, ok: Optional[Tensor]) -> Tensor:
    """0-d device int: 0 unsorted; 1 the active rows are a PREFIX whose
    values ascend (the suffix-fill repair applies); 2 the raw lane
    ascends."""
    asc_pairs = values[1:] >= values[:-1]
    raw = asc_pairs.all()
    two = torch.tensor(2, device=values.device)
    zero = torch.tensor(0, device=values.device)
    if ok is None:
        return torch.where(raw, two, zero)
    n = values.shape[0]
    idx = torch.arange(n, device=values.device)
    cnt = ok.sum()
    is_prefix = (ok == (idx < cnt)).all()
    asc_prefix = torch.where(idx[:-1] < cnt - 1, asc_pairs,
                             torch.ones_like(asc_pairs)).all()
    fixable = is_prefix & asc_prefix
    return torch.where(raw, two, torch.where(
        fixable, torch.ones_like(two), zero))


def build_join_table(sorted_keys: Tensor, n_active: Tensor, lo: int,
                     span: int) -> Tuple[Tensor, Tensor]:
    """Direct-address (kArray) index over the host-known key range
    ``[lo, lo + span)``: ``tfirst[v - lo]`` is the first position of
    ``v`` in the build sort, ``tcount[v - lo]`` its run length."""
    cap = sorted_keys.shape[0]
    device = sorted_keys.device
    idx = torch.arange(cap, device=device)
    in_tab = (idx < n_active) & (sorted_keys >= lo) & (
        sorted_keys < lo + span)
    off = torch.where(in_tab, sorted_keys.to(torch.int64) - lo,
                      torch.full_like(idx, span))
    tfirst = torch.full((span + 1,), cap, dtype=torch.int64, device=device)
    tfirst.scatter_reduce_(0, off, idx, reduce="amin")
    tcount = torch.zeros(span + 1, dtype=torch.int64, device=device)
    tcount.index_add_(0, off, torch.ones_like(idx))
    return tfirst[:span], tcount[:span]


def probe_join_table(tfirst: Tensor, tcount: Tensor, lo: int,
                     probe_key: Tensor, probe_valid: Optional[Tensor],
                     probe_sel: Tensor) -> Tuple[Tensor, Tensor]:
    """kArray probe: two gathers. Out-of-range keys cannot match."""
    span = tfirst.shape[0]
    off = probe_key.to(torch.int64) - lo
    in_range = (off >= 0) & (off < span)
    o = torch.where(in_range, off, torch.zeros_like(off))
    first = tfirst.index_select(0, o)
    count = tcount.index_select(0, o)
    ok = _probe_ok(probe_sel, probe_valid) & in_range
    count = torch.where(ok, count, torch.zeros_like(count))
    return first, count


def _emit(count: Tensor, emit_unmatched: Optional[Tensor]) -> Tensor:
    if emit_unmatched is None:
        return count
    return torch.where(emit_unmatched & (count == 0),
                       torch.ones_like(count), count)


def match_total(count: Tensor, emit_unmatched: Optional[Tensor] = None
                ) -> Tensor:
    """0-d device tensor: the number of output rows (the caller reads it
    on the host to size the expansion)."""
    return _emit(count, emit_unmatched).sum()


def expand_matches(first: Tensor, count: Tensor, build_perm: Tensor,
                   out_cap: int, emit_unmatched: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Expand ``(first, count)`` runs into flat output rows, probe-major:
    ``(probe_rows, build_rows, matched, out_sel)``, each ``(out_cap,)``.
    ``emit_unmatched`` (left-outer) makes zero-count rows emit one row
    with ``matched`` False. Rows past the total are masked by
    ``out_sel``; ``out_cap`` must be at least ``match_total``."""
    device = first.device
    emit = _emit(count, emit_unmatched).to(torch.int64)
    offsets = torch.cumsum(emit, 0) - emit
    total = offsets[-1] + emit[-1]
    j = torch.arange(out_cap, device=device)
    n_probe = first.shape[0]
    if out_cap * 8 <= n_probe:
        # few output rows from a wide probe: binary-search the output
        # ordinals into the ascending run ends
        ends = (offsets + emit).contiguous()
        probe_rows = torch.searchsorted(ends, j, side="right").clamp(
            max=n_probe - 1)
    else:
        # each emitting probe row's run starts at its offset: the count of
        # run starts at or before an output slot ranks the slot's row
        # among the emitting rows, in order
        emitting = emit > 0
        heads = torch.where(emitting, offsets,
                            torch.full_like(offsets, out_cap))
        starts = torch.zeros(out_cap + 1, dtype=torch.int64, device=device)
        starts.index_add_(0, heads.clamp(max=out_cap),
                          emitting.to(torch.int64))
        rank = (torch.cumsum(starts[:out_cap], 0) - 1).clamp(min=0)
        probe_rows = pack_indices(emitting, fill=0).index_select(0, rank)
    ordinal = j - offsets.index_select(0, probe_rows)
    cnt = count.index_select(0, probe_rows)
    matched = ordinal < cnt
    build_pos = first.index_select(0, probe_rows) + ordinal
    build_rows = build_perm.index_select(
        0, build_pos.clamp(0, build_perm.shape[0] - 1))
    out_sel = j < total
    return probe_rows, build_rows, matched, out_sel


def build_matched_flags(build_cap: int, build_rows: Tensor, matched: Tensor,
                        out_sel: Tensor) -> Tensor:
    """Which build rows matched at least once (right/full outer joins)."""
    hit = matched & out_sel
    rows = torch.where(hit, build_rows, torch.full_like(build_rows,
                                                        build_cap))
    out = torch.zeros(build_cap + 1, dtype=torch.bool,
                      device=build_rows.device)
    out[rows] = True
    return out[:build_cap]


def pack_normalized_key(value_ids: Sequence[Tensor],
                        bits: Sequence[int]) -> Tensor:
    """Pack per-column value ids into one normalized key: int32 when the
    bits total at most 31, else int64 (at most 63)."""
    if sum(bits) > 63:
        raise ValueError("normalized key overflow")
    lane = torch.int32 if sum(bits) <= 31 else torch.int64
    key = torch.zeros_like(value_ids[0], dtype=lane)
    shift = 0
    for vid, b in zip(value_ids, bits):
        key = key | (vid.to(lane) << shift)
        shift += b
    return key
