"""Expression fuzzer: engine vs an independent host evaluator (the port of
``velox_tpu/fuzzer/expression_fuzzer.py``).

Analog of velox/expression/fuzzer/ExpressionFuzzer.h:33 with the
reference-runner role (velox/exec/fuzzer/ReferenceQueryRunner.h:53)
played by a from-scratch plain-Python evaluator over lists implementing
Presto null semantics: default-null functions, Kleene AND/OR, and a
float NaN read as NULL wherever the reference's pandas evaluator reads it
so. Any value/validity mismatch on any generated tree is a bug in one of
the two evaluators. For a seed the trees, the batches and the skipped
(untyped) trees are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from velox_tpu_torch import resolve_device
from velox_tpu_torch.expr.compiler import ExprSet
from velox_tpu_torch.expr.ir import Call, Expr, FieldRef, Literal
from velox_tpu_torch.functions import hostfns as H
from velox_tpu_torch.fuzzer.vector_fuzzer import KIND_TYPES, VectorFuzzer
from velox_tpu_torch.vector.batch import Batch

_NUM_COLS = {"a": "bigint", "b": "bigint", "x": "double", "y": "double"}


class ExpressionFuzzer:
    def __init__(self, seed: int = 0, num_cols=None, str_col="s",
                 bool_col="flag", int_col="a"):
        self.rng = np.random.default_rng(seed)
        self.num_cols = list(num_cols or _NUM_COLS)
        self.str_col = str_col
        self.bool_col = bool_col
        self.int_col = int_col

    # ------------------------------------------------------- generation
    def gen_numeric(self, depth: int) -> Expr:
        r = self.rng
        if depth <= 0 or r.random() < 0.35:
            if r.random() < 0.6:
                return FieldRef(None, str(r.choice(self.num_cols)))
            if r.random() < 0.5:
                return Literal(None, int(r.integers(-50, 50)))
            return Literal(None, float(np.round(r.normal(scale=20), 2)))
        roll = r.random()
        if roll < 0.15:
            # unary math (exact semantics)
            op = str(r.choice(["abs", "floor", "ceil", "sign"]))
            return Call(None, op, (self.gen_numeric(depth - 1),))
        if roll < 0.3:
            # probability cdfs (f32-internal: compared with loose tol)
            op = str(r.choice(["normal_cdf", "cauchy_cdf",
                               "laplace_cdf"]))
            return Call(None, op, (
                Literal(None, 0.0), Literal(None, 2.5),
                self.gen_numeric(depth - 1)))
        op = str(r.choice(["plus", "minus", "multiply"]))
        return Call(None, op, (
            self.gen_numeric(depth - 1), self.gen_numeric(depth - 1)))

    def gen_bool(self, depth: int) -> Expr:
        r = self.rng
        kind = str(r.choice(
            ["cmp", "and", "or", "not", "is_null", "between", "in",
             "streq", "flag"] if depth > 0 else ["cmp", "flag"]))
        if kind == "cmp":
            op = str(r.choice(["eq", "neq", "lt", "lte", "gt", "gte"]))
            return Call(None, op, (
                self.gen_numeric(depth - 1), self.gen_numeric(depth - 1)))
        if kind == "and" or kind == "or":
            return Call(None, kind, (
                self.gen_bool(depth - 1), self.gen_bool(depth - 1)))
        if kind == "not":
            return Call(None, "not", (self.gen_bool(depth - 1),))
        if kind == "is_null":
            return Call(None, "is_null", (self.gen_numeric(depth - 1),))
        if kind == "between":
            lo = int(self.rng.integers(-40, 0))
            hi = int(self.rng.integers(0, 40))
            return Call(None, "between", (
                FieldRef(None, self.int_col), Literal(None, lo),
                Literal(None, hi)))
        if kind == "in":
            vals = [int(v) for v in self.rng.integers(-20, 20, 3)]
            return Call(None, "in", (
                FieldRef(None, self.int_col),
                *[Literal(None, v) for v in vals]))
        if kind == "streq":
            return Call(None, "eq", (
                FieldRef(None, self.str_col),
                Literal(None, f"s{int(self.rng.integers(0, 14)):02d}")))
        return FieldRef(None, self.bool_col)

    def gen_string(self, depth: int) -> Expr:
        """String-valued exprs over the dictionary column (exercises
        DictTransform composition + CSE across transforms)."""
        r = self.rng
        if depth <= 0 or r.random() < 0.4:
            return FieldRef(None, self.str_col)
        kind = str(r.choice(
            ["upper", "lower", "reverse", "replace", "lpad", "rpad",
             "substr", "trim", "ltrim", "rtrim", "soundex",
             "translate", "concat"]))
        inner = self.gen_string(depth - 1)
        if kind in ("upper", "lower", "reverse", "trim", "ltrim",
                    "rtrim", "soundex"):
            return Call(None, kind, (inner,))
        if kind == "translate":
            return Call(None, "translate", (
                inner, Literal(None, "s01"), Literal(None, "z9")))
        if kind == "concat":
            return Call(None, "concat", (
                inner, Literal(None, str(r.choice(["_t", ""])))))
        if kind == "replace":
            a = str(r.choice(list("s0123")))
            b = str(r.choice(["", "x", "yy"]))
            return Call(None, "replace", (
                inner, Literal(None, a), Literal(None, b)))
        if kind in ("lpad", "rpad"):
            return Call(None, kind, (
                inner, Literal(None, int(r.integers(1, 8))),
                Literal(None, "*")))
        return Call(None, "substr", (
            inner, Literal(None, int(r.integers(1, 4))),
            Literal(None, int(r.integers(1, 4)))))

    def gen(self, depth: int = 3) -> Expr:
        if self.rng.random() < 0.15:
            # string -> scalar bridges: length/strpos/starts_with over a
            # composed transform
            k = str(self.rng.choice(
                ["length", "strpos", "starts_with",
                 "levenshtein_distance", "regexp_like"]))
            inner = self.gen_string(2)
            if k == "length":
                return Call(None, "length", (inner,))
            if k == "strpos":
                return Call(None, "strpos", (
                    inner, Literal(None, str(self.rng.choice(
                        list("s01x*"))))))
            if k == "levenshtein_distance":
                return Call(None, "levenshtein_distance", (
                    FieldRef(None, self.str_col),
                    Literal(None, "s05")))
            if k == "regexp_like":
                return Call(None, "regexp_like", (
                    FieldRef(None, self.str_col),
                    Literal(None, str(self.rng.choice(
                        [r"^s\\d+$", "0", r"\\p{Digit}{2}"])))))
            return Call(None, "starts_with", (
                inner, Literal(None, str(self.rng.choice(
                    ["s", "s0", "*", ""])))))
        if self.rng.random() < 0.5:
            return self.gen_bool(depth)
        e = self.gen_numeric(depth)
        if self.rng.random() < 0.3:
            return Call(None, "coalesce", (e, self.gen_numeric(1)))
        if self.rng.random() < 0.3:
            return Call(None, "if", (self.gen_bool(1), e,
                                     self.gen_numeric(1)))
        return e


# ---------------------------------------------------------------- oracle

def _isna(v) -> bool:
    """NULL as the reference's evaluator reads it: None or a float NaN."""
    return v is None or (isinstance(v, float) and math.isnan(v))


def _lpad(s: str, k: int, p: str) -> str:
    return s[:k] if len(s) >= k else (p * k)[: k - len(s)] + s


def _rpad(s: str, k: int, p: str) -> str:
    return s[:k] if len(s) >= k else s + (p * k)[: k - len(s)]


_STRING_FNS = {
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "reverse": lambda s: s[::-1],
    "replace": lambda s, a, b: s.replace(a, b),
    "lpad": _lpad, "rpad": _rpad,
    "substr": lambda s, st, ln: s[st - 1: st - 1 + ln],
    "length": lambda s: len(s),
    "strpos": lambda s, sub: s.find(sub) + 1,
    "starts_with": lambda s, p: s.startswith(p),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "soundex": H.soundex,
    "translate": H.translate3,
    "concat": lambda s, suf: s + suf,
    "levenshtein_distance": H.levenshtein_distance,
    "regexp_like": H.regexp_like,
}


def _normal_cdf(m, sd, v):
    return 0.5 * math.erfc(-(v - m) / (sd * math.sqrt(2.0)))


def _cauchy_cdf(m, sd, v):
    return 0.5 + math.atan((v - m) / sd) / math.pi


def _laplace_cdf(m, sd, v):
    z = (v - m) / sd
    return 0.5 * math.exp(z) if z < 0 else 1.0 - 0.5 * math.exp(-z)


_CDFS = {"normal_cdf": _normal_cdf, "cauchy_cdf": _cauchy_cdf,
         "laplace_cdf": _laplace_cdf}

_BINARY = {
    "plus": lambda a, b: a + b,
    "minus": lambda a, b: a - b,
    "multiply": lambda a, b: a * b,
    "eq": lambda a, b: a == b, "neq": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "lte": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "gte": lambda a, b: a >= b,
}


def _unary(name: str, v):
    if name == "abs":
        return abs(v)
    if name == "sign":
        r = int(v > 0) - int(v < 0)
    else:
        r = math.floor(v) if name == "floor" else math.ceil(v)
    return float(r) if isinstance(v, float) else r


def _oracle(e: Expr, table: Dict[str, list], n: int) -> list:
    """Independent evaluator over ``table`` (column -> list, ``None`` is
    NULL): one Python value a row, ``None`` for NULL, with Presto
    default-null and Kleene AND/OR semantics."""
    if isinstance(e, FieldRef):
        return list(table[e.name])
    if isinstance(e, Literal):
        return [e.value] * n
    if not isinstance(e, Call):
        raise TypeError(e)
    name = e.name
    if name in ("and", "or"):
        args = [_oracle(a, table, n) for a in e.args]
        out = []
        for i in range(n):
            vals = [None if _isna(a[i]) else bool(a[i]) for a in args]
            if name == "and":
                out.append(False if any(v is False for v in vals)
                           else None if any(v is None for v in vals)
                           else True)
            else:
                out.append(True if any(v is True for v in vals)
                           else None if any(v is None for v in vals)
                           else False)
        return out
    if name == "not":
        return [None if _isna(v) else not bool(v)
                for v in _oracle(e.args[0], table, n)]
    if name == "is_null":
        return [_isna(v) for v in _oracle(e.args[0], table, n)]
    if name == "coalesce":
        a, b = [_oracle(x, table, n) for x in e.args]
        return [y if _isna(x) else x for x, y in zip(a, b)]
    if name == "if":
        c, t = _oracle(e.args[0], table, n), _oracle(e.args[1], table, n)
        f = (_oracle(e.args[2], table, n) if len(e.args) > 2
             else [None] * n)
        return [fv if _isna(cv) or not cv else tv
                for cv, tv, fv in zip(c, t, f)]
    if name == "between":
        v, lo, hi = [_oracle(x, table, n) for x in e.args]
        return [None if _isna(a) or _isna(b) or _isna(c)
                else bool(b <= a <= c) for a, b, c in zip(v, lo, hi)]
    if name == "in":
        vals = [a.value for a in e.args[1:]]
        return [None if _isna(x) else x in vals
                for x in _oracle(e.args[0], table, n)]
    if name in ("abs", "floor", "ceil", "sign"):
        return [None if _isna(v) else _unary(name, v)
                for v in _oracle(e.args[0], table, n)]
    if name in _CDFS:
        m, sd = e.args[0].value, e.args[1].value
        return [None if _isna(v) else float(_CDFS[name](m, sd, v))
                for v in _oracle(e.args[2], table, n)]
    if name in _STRING_FNS:
        fn = _STRING_FNS[name]
        extras = [a.value for a in e.args[1:]]
        return [None if _isna(v) else fn(str(v), *extras)
                for v in _oracle(e.args[0], table, n)]
    fn = _BINARY[name]
    args = [_oracle(a, table, n) for a in e.args]
    return [None if any(_isna(v) for v in vals) else fn(*vals)
            for vals in zip(*args)]


def draw_iteration(rng: np.random.Generator, vf: VectorFuzzer, it: int,
                   seed: int, rows: int):
    """Iteration ``it``'s schema, table (column -> list) and tree, drawn
    in the reference fuzzer's order."""
    # randomized schema each iteration (the velox fuzzer generates
    # random input types; a fixed schema misses name/width variety)
    n_num = int(rng.integers(2, 6))
    names = [f"c{j}" for j in range(n_num)]
    kinds = [str(rng.choice(["bigint", "double"]))
             for _ in range(n_num)]
    if "bigint" not in kinds:
        kinds[0] = "bigint"
    int_col = names[kinds.index("bigint")]
    sc = f"s{it % 3}"
    bc = f"b{it % 2}"
    schema = dict(zip(names, kinds))
    schema[sc] = "varchar"
    schema[bc] = "boolean"
    rows_it = int(rng.integers(max(rows // 2, 4), rows + 32))
    ef = ExpressionFuzzer(
        seed + it, num_cols=names, str_col=sc, bool_col=bc,
        int_col=int_col)
    table = vf.table(schema, rows_it)
    return schema, table, ef.gen(3)


def run_expression_fuzz(iterations: int = 100, seed: int = 0,
                        rows: int = 64, device=None) -> int:
    """Run the differential fuzz on ``device`` (default: the card);
    returns #expressions checked. Raises on the first mismatch with a
    repro dump."""
    from velox_tpu_torch.utils.syncs import to_numpy

    device = resolve_device(device)
    rng = np.random.default_rng(seed + 99)
    vf = VectorFuzzer(seed + 1)
    checked = 0
    for it in range(iterations):
        schema, table, expr = draw_iteration(rng, vf, it, seed, rows)
        rows_cur = len(next(iter(table.values())))
        batch = Batch.from_pydict(
            table, {c: KIND_TYPES[k] for c, k in schema.items()},
            device=device)
        try:
            es = ExprSet(
                [expr], batch.schema,
                {n: c.dictionary for n, c in batch.columns.items()
                 if c.dictionary is not None})
        except (TypeError, KeyError):
            continue  # untyped combination; generator can produce these
        arrays = {name: (c.values, c.valid)
                  for name, c in batch.columns.items()}
        vals, valid = es.evaluate(arrays)[0]
        vals = to_numpy(vals)
        got_vals = (np.broadcast_to(vals, (rows_cur,)) if vals.ndim == 0
                    else vals[:rows_cur])
        if valid is None:
            got_valid = np.ones(rows_cur, bool)
        else:
            valid = to_numpy(valid)
            got_valid = (np.broadcast_to(valid, (rows_cur,))
                         if valid.ndim == 0 else valid[:rows_cur])
        check_rows(expr, table, _oracle(expr, table, rows_cur), got_vals,
                   got_valid)
        checked += 1
    return checked


def check_rows(expr: Expr, table: Dict[str, list], exp: list,
               got_vals: np.ndarray, got_valid: np.ndarray) -> None:
    """Each row's engine value against the oracle's: NULL for NULL,
    booleans and integers exactly, floats within 3e-5 under a
    probability CDF and 1e-9 otherwise."""
    for i, ev in enumerate(exp):
        if _isna(ev):
            assert not got_valid[i], _repro(expr, table, i, got_vals[i], ev)
            continue
        assert got_valid[i], _repro(expr, table, i, None, ev)
        gv = got_vals[i]
        if isinstance(ev, (bool, np.bool_)):
            assert bool(gv) == bool(ev), _repro(expr, table, i, gv, ev)
        elif isinstance(ev, float) or isinstance(gv, float):
            # f32-internal probability fns compare loosely
            # (relative error survives downstream arithmetic)
            tol = 3e-5 if _has_approx(expr) else 1e-9
            assert math.isclose(
                float(gv), float(ev), rel_tol=tol,
                abs_tol=tol), _repro(expr, table, i, gv, ev)
        else:
            assert int(gv) == int(ev), _repro(expr, table, i, gv, ev)


def _has_approx(e: Expr) -> bool:
    if isinstance(e, Call) and e.name in _CDFS:
        return True
    return any(_has_approx(c) for c in e.children)


def _repro(expr: Expr, table: Dict[str, list], i: int, got,
           exp) -> str:
    row: Dict[str, Optional[object]] = {c: v[i] for c, v in table.items()}
    return (
        f"fuzz mismatch at row {i}: got={got!r} expected={exp!r}\n"
        f"expr: {expr}\nrow: {row}")

