"""ARRAY, MAP and ROW projections of the port against the JAX package.

One seeded table in three literal batches of each package (made by each
package's ``Batch.from_pydict`` from the same Python lists): arrays with
NULL rows, NULL elements and empty arrays, maps with NULL values, a ROW
column with NULL rows, nested arrays, and an outer column with NULLs for
the lambdas to capture. Each family of projections runs once through
both packages' ``run_plan``; the results must be equal element for
element (DOUBLE elements to rtol=1e-9). Where the JAX package is wrong
(a float segment sum as a difference of prefixes), the port is held
against Python instead.
"""

import math

import numpy as np
import pytest

from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.types import BIGINT as J_BIGINT, DOUBLE as J_DOUBLE
from velox_tpu.types import VARCHAR as J_VARCHAR
from velox_tpu.types.types import array as j_array, map_ as j_map
from velox_tpu.types.types import row_type as j_row
from velox_tpu.vector.batch import Batch as JaxBatch
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.types import BIGINT, DOUBLE, VARCHAR
from velox_tpu_torch.types.types import array, map_, row_type
from velox_tpu_torch.vector.batch import Batch as TorchBatch

N = 60
SPLIT = 20
WORDS = ["ash", "birch", "cedar", "elm", "fir"]


def _maybe(rng, p, v):
    return None if rng.random() < p else v


def make_rows(seed: int = 20261018, n: int = N):
    """The table as Python lists."""
    rng = np.random.default_rng(seed)

    def int_array(p_null_row=0.1, hi=12):
        return [None if rng.random() < p_null_row else
                [_maybe(rng, 0.1, int(v))
                 for v in rng.integers(0, hi, rng.integers(0, 6))]
                for _ in range(n)]

    def str_map():
        out = []
        for _ in range(n):
            if rng.random() < 0.1:
                out.append(None)
                continue
            keys = rng.choice(WORDS, rng.integers(0, 4), replace=False)
            out.append({str(k): _maybe(rng, 0.15,
                                       float(np.round(rng.normal() * 10, 2)))
                        for k in keys})
        return out

    def int_map():
        out = []
        for _ in range(n):
            keys = rng.choice(8, rng.integers(0, 4), replace=False)
            out.append(None if rng.random() < 0.1 else
                       {int(k): _maybe(rng, 0.1, int(rng.integers(-5, 50)))
                        for k in keys})
        return out

    return {
        "id": list(range(n)),
        "k": [_maybe(rng, 0.15, int(v)) for v in rng.integers(0, 8, n)],
        "xs": int_array(),
        "ys": int_array(hi=8),
        "fs": [None if rng.random() < 0.1 else
               [_maybe(rng, 0.1, float(np.round(v, 3)))
                for v in rng.normal(size=rng.integers(0, 5)) * 50]
               for _ in range(n)],
        "ss": [None if rng.random() < 0.1 else
               [_maybe(rng, 0.1, str(w))
                for w in rng.choice(WORDS, rng.integers(0, 5))]
               for _ in range(n)],
        "m": str_map(),
        "m2": str_map(),
        "mi": int_map(),
        "s": [None if rng.random() < 0.1 else ",".join(
            f"{rng.choice(WORDS)}:{rng.integers(0, 9)}"
            for _ in range(rng.integers(0, 4))) for _ in range(n)],
        "r": [None if rng.random() < 0.1 else
              {"a": _maybe(rng, 0.1, int(rng.integers(0, 100))),
               "b": _maybe(rng, 0.1, str(rng.choice(WORDS)))}
              for _ in range(n)],
        "nested": [None if rng.random() < 0.1 else
                   [None if rng.random() < 0.1 else
                    [int(v) for v in rng.integers(0, 9, rng.integers(0, 4))]
                    for _ in range(rng.integers(0, 3))]
                   for _ in range(n)],
    }


def types_of(pkg):
    if pkg == "jax":
        B, D, V, A, M, R = (J_BIGINT, J_DOUBLE, J_VARCHAR, j_array, j_map,
                            j_row)
    else:
        B, D, V, A, M, R = BIGINT, DOUBLE, VARCHAR, array, map_, row_type
    return {"id": B, "k": B, "xs": A(B), "ys": A(B), "fs": A(D), "ss": A(V),
            "m": M(V, D), "m2": M(V, D), "mi": M(B, B), "s": V,
            "r": R(["a", "b"], [B, V]), "nested": A(A(B))}


def batches_of(rows, split=SPLIT):
    """The rows as literal batches of each package: (jax, torch)."""
    out = ([], [])
    for lo in range(0, len(rows["id"]), split):
        part = {c: v[lo:lo + split] for c, v in rows.items()}
        out[0].append(JaxBatch.from_pydict(part, types_of("jax")))
        out[1].append(TorchBatch.from_pydict(part, types_of("torch"),
                                             device="cpu"))
    return out


def same(got, want, path="") -> None:
    """Nested equality: floats to rtol=1e-9 (NaN equals NaN), strings of
    either kind alike, tuples and lists alike."""
    if isinstance(want, float) or isinstance(got, float):
        assert want is not None and got is not None, (path, got, want)
        if math.isnan(want):
            assert math.isnan(got), (path, got, want)
        else:
            assert got == pytest.approx(want, rel=1e-9, abs=0), \
                (path, got, want)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), \
            (path, got, want)
        for k in want:
            same(got[k], want[k], f"{path}.{k}")
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def table():
    rows = make_rows()
    return rows, batches_of(rows)


def both(table, exprs, filter=None):
    """The projection through both packages: (port rows, JAX rows)."""
    _, (jb, tb) = table
    jp = JaxPlanBuilder().values(jb)
    tp = TorchPlanBuilder().values(tb)
    if filter is not None:
        jp, tp = jp.filter(filter), tp.filter(filter)
    want = jax_run_plan(jp.project(["id"] + exprs).build()).to_pydict()
    got = torch_run_plan(tp.project(["id"] + exprs))
    return got, want


FAMILIES = {
    # the array lanes of functions/scalar.py through bind_array_funcs
    "array_lanes": [
        "cardinality(xs) AS c", "array_sum(xs) AS s", "array_sum(fs) AS sf",
        "array_average(fs) AS av", "contains(xs, 3) AS ct",
        "element_at(xs, 2) AS e2", "element_at(xs, -1) AS el",
        "element_at(xs, k) AS ek", "array_position(xs, 3) AS ap",
        "array_min(xs) AS mn", "array_max(fs) AS mx",
        "contains(ss, 'elm') AS cs", "element_at(ss, 1) AS es",
        "cardinality(nested) AS cn",
        "element_at(ARRAY[1, 2, 3], 2) AS lit"],
    # lambdas, with captures of k (NULL in some outer rows)
    "lambdas": [
        "transform(xs, x -> x * 2) AS t2", "transform(xs, x -> x + k) AS tk",
        "transform(fs, x -> x * k) AS tf", "filter(xs, x -> x > k) AS fk",
        "filter(ss, x -> x <> 'ash') AS fs2",
        "any_match(xs, x -> x > k) AS am", "all_match(xs, x -> x < 9) AS al",
        "none_match(xs, x -> x = k) AS nm",
        "find_first(xs, x -> x > k) AS ff",
        "find_first_index(xs, x -> x >= 5) AS fi",
        "array_max_by(xs, x -> -x) AS amb",
        "array_min_by(fs, x -> x * x) AS mnb",
        "transform_with_index(xs, (x, i) -> x * i + k) AS twi",
        "zip_with(xs, ys, (a, b) -> a * 10 + b + k) AS zw",
        "array_remove(xs, 3) AS rm"],
    "maps": [
        "map_keys(m) AS mk", "map_values(m) AS mv", "element_at(m, 'elm') AS me",
        "element_at(mi, 3) AS mi3", "cardinality(m) AS mc",
        "map_filter(m, (a, b) -> b > 0.0) AS mf",
        "map_filter(mi, (a, b) -> a > k) AS mfk",
        "transform_values(m, (a, b) -> b * 2) AS tv",
        "transform_keys(mi, (a, b) -> a + 100) AS tkk",
        "map_concat(m, m2) AS mcc", "map_entries(mi) AS ment",
        "map_key_exists(m, 'fir') AS mke",
        "map_keys_overlap(mi, ARRAY[1, 2]) AS mko",
        "any_keys_match(m, x -> x = 'ash') AS akm",
        "map_values_all_match(mi, v -> v > k) AS mvm",
        "no_values_match(m, v -> v > 5.0) AS nvm",
        "map_from_entries(map_entries(mi)) AS mfe"],
    "reorder": [
        "array_sort(xs) AS so", "array_sort(ss) AS sso",
        "array_distinct(xs) AS di", "array_distinct(ss) AS sdi",
        "slice(xs, 2, 2) AS sl", "slice(xs, -2, 5) AS sln",
        "sequence(k, 6) AS sq", "repeat(k, 3) AS rp",
        "split(s, ',') AS sp", "split(s, ',', 2) AS sp2",
        "regexp_split(s, '[,:]') AS rsp",
        "regexp_extract_all(s, '[a-z]+') AS rea", "reverse(xs) AS rv"],
    "combos": [
        "concat(xs, ys) AS cc", "array_intersect(xs, ys) AS ai",
        "array_except(xs, ys) AS ae", "array_union(xs, ys) AS au",
        "arrays_overlap(xs, ys) AS ao", "zip(xs, ys, fs) AS zp",
        "map(remove_nulls(ys), xs) AS mp", "flatten(nested) AS fl",
        "ARRAY[id, k, 7] AS ac"],
    "rows": [
        "r AS rr", "r.a AS ra", "r.b AS rb", "row_constructor(id, k, xs) AS rc",
        "r.a + k AS rak"],
    "ext_arrays": [
        "array_cum_sum(xs) AS cs", "array_cum_sum(fs) AS csf",
        "array_normalize(fs, 2) AS an", "remove_nulls(xs) AS rn",
        "trim_array(xs, 1) AS tr", "array_sort_desc(xs) AS sd",
        "array_duplicates(xs) AS du", "array_has_duplicates(ss) AS hd",
        "array_top_n(xs, 2) AS tn", "typeof(xs) AS ty"],
    "ext_maps": [
        "map_normalize(m) AS mn", "map_subset(m, ARRAY['ash', 'elm']) AS ms",
        "map_intersect(mi, ARRAY[1, 3, 5]) AS mint",
        "map_except(m, ARRAY['fir']) AS mex",
        "map_values_in_range(m, -5.0, 5.0) AS mr",
        "map_remove_null_values(m) AS mrn", "map_top_n(m, 2) AS mt",
        "map_top_n_keys(mi, 2) AS mtk", "map_top_n_values(m, 1) AS mtv",
        "map_keys_by_top_n_values(mi, 2) AS mkv",
        "remap_keys(m, ARRAY['ash'], ARRAY['oak']) AS rk",
        "split_to_map(s, ',', ':') AS stm",
        "split_to_multimap(s, ',', ':') AS stmm",
        "map_zip_with(mi, mi, (kk, a, b) -> a + b) AS mzw"],
    "ext_host": [
        "array_join(xs, '-') AS aj", "array_join(ss, '|', 'N') AS ajn",
        "ngrams(xs, 2) AS ng", "combinations(ys, 2) AS cb",
        "array_frequency(xs) AS af", "multimap_from_entries(zip(xs, ys)) AS mm",
        "cosine_similarity(m, m2) AS cos",
        "array_split_into_chunks(xs, 2) AS ch"],
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_projection_family_equals_jax(table, family):
    got, want = both(table, FAMILIES[family])
    assert list(got) == list(want)
    for c in want:
        same(got[c], want[c], f"{family}.{c}")


def test_lambda_filter_and_capture_of_null_outer_rows(table):
    """A lambda in a filter, and a capture whose outer value is NULL:
    its elements are NULL (``tests/test_lambda.py``'s rule)."""
    got, want = both(table, ["xs", "transform(xs, x -> x * k) AS t",
                             "filter(xs, x -> x >= k) AS f"],
                     filter="any_match(xs, x -> x > k) OR k IS NULL")
    for c in want:
        same(got[c], want[c], c)
    rows, _ = table
    for i, t in zip(got["id"], got["t"]):
        if rows["k"][i] is None and rows["xs"][i] is not None:
            assert t == [None] * len(rows["xs"][i])


def test_shuffle_permutes_each_row(table):
    rows, (_, tb) = table
    got = torch_run_plan(TorchPlanBuilder().values(tb).project(
        ["id", "shuffle(xs) AS sh"]))
    key = (lambda v: (v is None, v if v is not None else 0))
    for i, sh in zip(got["id"], got["sh"]):
        want = rows["xs"][i]
        assert (sh is None) == (want is None)
        if want is not None:
            assert sorted(sh, key=key) == sorted(want, key=key)


def test_where_the_reference_differs_against_python(table):
    """The JAX package sums a DOUBLE array as a difference of lane-wide
    prefixes, so a NaN or a large value in one row spoils the rows after
    it, and ``element_at`` of a map reads a float value the same way.
    The port sums each row's own elements (``ops/window.py``
    ``range_sum``) and reads the hit's position. ``array_min`` of a
    VARCHAR array and a string compare inside ``find_first`` fail in the
    JAX package; the port's strings equal Python's."""
    rows, (_, tb) = table
    got = torch_run_plan(TorchPlanBuilder().values(tb).project(
        ["id", "array_min(ss) AS sm", "find_first(ss, x -> x > 'c') AS f"]))
    for i, sm, f in zip(got["id"], got["sm"], got["f"]):
        ss = rows["ss"][i]
        live = [w for w in (ss or []) if w is not None]
        assert sm == (None if ss is None or not live else min(live))
        hit = next((w for w in (ss or []) if w is not None and w > "c"),
                   None)
        assert f == hit
    data = {"id": [0, 1, 2, 3],
            "fs": [[1e20], [1.0, 2.5], [float("nan")], [0.125, 3.0]],
            "m": [{"a": 1e20}, {"a": 0.5}, {"b": float("nan")}, {"a": 2.25}]}
    types = {"id": BIGINT, "fs": array(DOUBLE), "m": map_(VARCHAR, DOUBLE)}
    b = TorchBatch.from_pydict(data, types, device="cpu")
    got = torch_run_plan(TorchPlanBuilder().values([b]).project([
        "array_sum(fs) AS s", "array_average(fs) AS a",
        "element_at(m, 'a') AS e"]))
    want_s = [math.fsum(r) for r in data["fs"]]
    same(got["s"], want_s)
    same(got["a"], [s / len(r) for s, r in zip(want_s, data["fs"])])
    same(got["e"], [1e20, 0.5, None, 2.25])
    jb = JaxBatch.from_pydict(data, {"id": J_BIGINT, "fs": j_array(J_DOUBLE),
                                     "m": j_map(J_VARCHAR, J_DOUBLE)})
    ref = jax_run_plan(JaxPlanBuilder().values([jb]).project(
        ["array_sum(fs) AS s"]).build()).to_pydict()
    assert ref["s"][1] != 3.5 and math.isnan(ref["s"][3])
