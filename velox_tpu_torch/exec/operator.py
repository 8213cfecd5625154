"""Operator base + shared expression-evaluation machinery.

The port of ``velox_tpu/exec/operator.py``. The Operator ABI mirrors
velox/exec/Operator.h (addInput / needsInput / getOutput / noMoreInput /
isFinished) in serial pull mode. ``ExprEvaluator`` binds an expression
list once per dictionary/stats signature and evaluates it eagerly over
``(values, valid)`` pairs; there is no tracing or program cache.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from velox_tpu_torch.types.types import RowType
from velox_tpu_torch.expr.compiler import ExprSet
from velox_tpu_torch.expr.ir import Expr
from velox_tpu_torch.exec.complex_fns import and_valid
from velox_tpu_torch.vector.batch import Batch
from velox_tpu_torch.vector.column import (
    ArrayColumn, Column, MapColumn, RowColumn,
)


class Operator:
    """Base operator. Subclasses override add_input/get_output/is_finished."""

    #: blocking operators emit output only after no_more_input
    blocking = False

    def __init__(self, node):
        self.node = node
        self.output_type: RowType = node.output_type
        self.no_more_input_seen = False

    def needs_input(self) -> bool:
        return not self.no_more_input_seen

    def add_input(self, batch: Batch) -> None:
        raise NotImplementedError

    def no_more_input(self) -> None:
        self.no_more_input_seen = True

    def get_output(self) -> Optional[Batch]:
        raise NotImplementedError

    def is_finished(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        """Release buffered state (spill registrations, device and host
        copies) when the task ends, so no query's leftovers count against
        the next one's budget (velox Operator::close)."""
        for attr in ("_buffer", "_probe_buf", "_store"):
            buf = getattr(self, attr, None)
            if buf is not None and hasattr(buf, "close"):
                buf.close()


ValuePair = Tuple[torch.Tensor, Optional[torch.Tensor]]


def eval_pairs(batch: Batch) -> Dict[str, ValuePair]:
    """Every ``(values, valid)`` pair expression evaluation can read. An
    ARRAY column gives three flat lanes (``x#start``, ``x#len`` with the
    row validity, ``x#elemv``) and a MAP four (``x#kv``, ``x#vv`` for the
    elements), which the compiler's ``bind_array_funcs`` targets; a ROW
    column gives its scalar children under dotted names (``r.a``), each
    with the row's own NULL mask ANDed in."""
    out: Dict[str, ValuePair] = {}

    def add_row(prefix: str, rc: RowColumn, parent_valid) -> None:
        rv = and_valid(rc.valid, parent_valid)
        for nm, kid in zip(rc.dtype.names, rc.children):
            key = f"{prefix}.{nm}"
            if isinstance(kid, RowColumn):
                add_row(key, kid, rv)
            elif isinstance(kid, Column):
                out[key] = (kid.values, and_valid(kid.valid, rv))

    for n, c in batch.columns.items():
        if isinstance(c, (ArrayColumn, MapColumn)):
            out[f"{n}#start"] = (c.starts, None)
            out[f"{n}#len"] = (c.lengths, c.valid)
            for lane, col in _lanes(c):
                if isinstance(col, Column):
                    out[f"{n}#{lane}"] = (col.values, col.valid)
        elif isinstance(c, RowColumn):
            add_row(n, c, None)
        else:
            out[n] = (c.values, c.valid)
    return out


def _lanes(c):
    """The flat lanes of an ARRAY or MAP column, by their name suffix."""
    if isinstance(c, MapColumn):
        return (("kv", c.keys), ("vv", c.values))
    return (("elemv", c.elements),)


def eval_dicts(batch: Batch) -> Dict[str, object]:
    """Dictionaries visible at bind time, those of element lanes and ROW
    children included."""
    out: Dict[str, object] = {}

    def add_row(prefix: str, rc: RowColumn) -> None:
        for nm, kid in zip(rc.dtype.names, rc.children):
            key = f"{prefix}.{nm}"
            if isinstance(kid, RowColumn):
                add_row(key, kid)
            elif isinstance(kid, Column) and kid.dictionary is not None:
                out[key] = kid.dictionary

    for n, c in batch.columns.items():
        if isinstance(c, (ArrayColumn, MapColumn)):
            for lane, col in _lanes(c):
                if isinstance(col, Column) and col.dictionary is not None:
                    out[f"{n}#{lane}"] = col.dictionary
        elif isinstance(c, RowColumn):
            add_row(n, c)
        elif c.dictionary is not None:
            out[n] = c.dictionary
    return out


def batch_ranges(batch: Batch) -> Dict[str, tuple]:
    """Column stats visible to the decimal interval analysis."""
    return {n: c.stats for n, c in batch.columns.items()
            if c.stats is not None}


class ExprEvaluator:
    """Bind-and-cache ExprSets per (dictionary, stats) signature.

    The signature matters because string predicates bind against host
    dictionaries and decimal lanes widen by table stats; the catalog's
    table-global dictionaries make this one binding in practice.
    """

    def __init__(self, exprs: Sequence[Expr], schema: RowType):
        self.exprs = list(exprs)
        self.schema = schema
        self._cache: Dict[tuple, Tuple[ExprSet, Callable]] = {}

    def pure(self, dicts: Dict[str, object], mode: str = "eval",
             ranges: Optional[Dict[str, tuple]] = None
             ) -> Tuple[ExprSet, Callable]:
        """(ExprSet, run fn) for this signature; ``run(arrays, sel)``."""
        from velox_tpu_torch.utils.config import config

        ranges = ranges or {}
        sig = (mode, config.narrow_lanes) + tuple(
            sorted((n, id(d)) for n, d in dicts.items())) + tuple(
            sorted(ranges.items()))
        hit = self._cache.get(sig)
        if hit is None:
            expr_set = ExprSet(self.exprs, self.schema, dicts, ranges)
            hit = (expr_set, self._make_run(expr_set, mode))
            self._cache[sig] = hit
        return hit

    @staticmethod
    def _make_run(expr_set: ExprSet, mode: str) -> Callable:
        if mode == "filter":
            def run(arrays, sel):
                vals, valid = expr_set.evaluate(arrays)[0]
                out = torch.logical_and(sel, vals)
                if valid is not None:
                    out = torch.logical_and(out, valid)
                return out
        elif mode == "project":
            def run(arrays, sel):
                cap = sel.shape[0]
                out = []
                for vals, valid in expr_set.evaluate(arrays):
                    if vals.ndim == 0:
                        vals = vals.expand(cap)
                    if valid is not None and valid.ndim == 0:
                        valid = valid.expand(cap)
                    out.append((vals, valid))
                return out
        else:
            def run(arrays, sel):
                return expr_set.evaluate(arrays)
        return run

    def _get(self, batch: Batch, mode: str) -> Tuple[ExprSet, Callable]:
        return self.pure(eval_dicts(batch), mode, batch_ranges(batch))

    def filter_sel(self, batch: Batch) -> torch.Tensor:
        """Predicate evaluation intersected with the selection."""
        _, run = self._get(batch, "filter")
        return run(eval_pairs(batch), batch.sel)

    def evaluate(self, batch: Batch):
        """The expressions' ``(values, valid)`` pairs (0-d for a
        constant)."""
        _, run = self._get(batch, "eval")
        return run(eval_pairs(batch), batch.sel)

    def project_pairs(self, batch: Batch):
        """((values, valid) pairs, result dictionaries)."""
        expr_set, run = self._get(batch, "project")
        return run(eval_pairs(batch), batch.sel), \
            expr_set.result_dictionaries
