"""Group-id assignment and segmented scans (the port of the JAX package's
``ops/groupby.py``).

* ``group_ids_array``: when every grouping key is dictionary-coded and the
  product of the dictionary sizes is small, a row's group id is the
  mixed-radix combination of its keys' value ids (velox VectorHasher
  value-id mode). Ids are stable across batches, so accumulators persist.
  Inactive or out-of-range rows get the sentinel id ``num_groups``.
* ``group_ids_sorted``: the generic mode. One stable lexicographic sort of
  the key operands (chained stable sorts, ``ops/sort.lex_sort``), segment
  boundaries, a cumsum. Group ids are batch-local and groups come out in
  key order; inactive rows get the sentinel ``capacity``.
* ``segment_scan``: an inclusive scan restarted at segment heads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from velox_tpu_torch.ops.sort import lex_sort
from velox_tpu_torch.ops.sortkey import encode_sort_key

#: (values, valid); valid None means all valid
KeyCol = Tuple[torch.Tensor, Optional[torch.Tensor]]

#: the combine of each ``segment_scan`` op, for callers that join two
#: partial reductions of one segment
SCAN_COMBINE = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


def group_ids_array(value_ids: Sequence[torch.Tensor],
                    radices: Sequence[int], sel: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """int32 gid per row: sum of ``value_ids[k] * stride_k``, sentinel
    ``num_groups`` where unselected or out of range."""
    gid = torch.zeros(sel.shape, dtype=torch.int32, device=sel.device)
    stride = 1
    for vid, radix in zip(value_ids, radices):
        gid = gid + vid.to(torch.int32) * stride
        stride *= radix
    ok = sel & (gid >= 0) & (gid < num_groups)
    return torch.where(ok, gid, torch.full_like(gid, num_groups))


def _key_operands(keys: Sequence[KeyCol]) -> List[torch.Tensor]:
    ops: List[torch.Tensor] = []
    for values, valid in keys:
        if valid is not None:
            # SQL GROUP BY: nulls are one group; zero the lane so what
            # lies under a null does not split it
            values = torch.where(valid, values, torch.zeros_like(values))
        ops.extend(encode_sort_key(values, valid))
    return ops


def group_ids_sorted(keys: Sequence[KeyCol], sel: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Sort-based batch-local grouping.

    Returns ``(gids, group_rows, group_sel, num_groups)``:

    * ``gids`` (cap,) int64: group id per row, ``cap`` for inactive rows;
    * ``group_rows`` (cap,) int64: the first row (in input order) of each
      group, through which callers gather the key values;
    * ``group_sel`` (cap,) bool: which group slots are live;
    * ``num_groups``: a 0-d device tensor (no host sync).
    """
    cap = sel.shape[0]
    device = sel.device
    r = torch.arange(cap, device=device)
    if not keys:
        # keyless (global aggregation): one group holding every active row
        any_active = sel.any()
        gids = torch.where(sel, torch.zeros_like(r), torch.full_like(r, cap))
        group_sel = (r == 0) & any_active
        return gids, torch.zeros_like(r), group_sel, any_active.to(
            torch.int64)

    inactive = (~sel).to(torch.int32)
    ops = [inactive] + _key_operands(keys)
    perm = lex_sort(ops)
    active_sorted = sel.index_select(0, perm)
    diff = torch.zeros(cap, dtype=torch.bool, device=device)
    for k in ops[1:]:
        ks = k.index_select(0, perm)
        diff[1:] |= ks[1:] != ks[:-1]
    diff[0] = True
    boundary = active_sorted & diff

    sid = torch.cumsum(boundary, 0) - 1
    num_groups = boundary.sum()
    sid = torch.where(active_sorted, sid, torch.full_like(sid, cap))
    gids = torch.empty_like(sid)
    gids[perm] = sid
    slot = torch.where(boundary, sid, torch.full_like(sid, cap))
    group_rows = torch.zeros(cap + 1, dtype=torch.int64, device=device)
    group_rows.scatter_(0, slot, perm)
    group_sel = r < num_groups
    return gids, group_rows[:cap], group_sel, num_groups


def segment_scan(values: torch.Tensor, head: torch.Tensor,
                 op: str) -> torch.Tensor:
    """Inclusive segmented scan over group-contiguous rows: ``head[i]``
    marks the first row of a segment, and the value at a segment's last
    row is the segment's whole reduction (``op``: add, min or max).

    Integer sums are a cumsum minus the prefix before the segment head,
    exact in int64. Floating sums never subtract prefixes: a table-wide
    float64 prefix grows far past a group's own sum, and the difference
    of two such prefixes loses the group's low digits. They, and min/max,
    run a log-step (Hillis-Steele) segmented scan, which combines only
    values of one segment.
    """
    n = values.shape[0]
    if n == 0:
        return values
    head = head.clone()
    head[0] = True
    if op == "add" and not values.dtype.is_floating_point:
        incl = torch.cumsum(values, 0, dtype=values.dtype)
        excl = incl - values
        # each row's segment number, and the exclusive prefix at its
        # segment's head scattered to that number and gathered back
        seg = torch.cumsum(head, 0) - 1
        base = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
        base.scatter_(0, torch.where(head, seg, torch.full_like(seg, n)),
                      excl)
        return incl - base.index_select(0, seg)
    comb = SCAN_COMBINE[op]
    vals = values.clone()
    done = head          # row i's running value already starts at a head
    d = 1
    while d < n:
        prev_vals = vals[:-d]
        take = ~done[d:]
        new_tail = torch.where(take, comb(prev_vals, vals[d:]), vals[d:])
        new_done = done.clone()
        new_done[d:] |= done[:-d]
        vals = torch.cat([vals[:d], new_tail])
        done = new_done
        d *= 2
    return vals
