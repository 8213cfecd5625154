"""TPC-H Q1 and Q6 through both packages' ``run_plan`` on the CPU, on one
seeded lineitem: exact in the decimal configurations, ``rtol=1e-9`` (the
tolerance of tests/test_tpch.py) in the DOUBLE one. Also the expression
compiler's lane choices, and the port's import rules."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from torch_tpch_data import CONFIGS, lineitem_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.exec.operator import eval_dicts as jax_eval_dicts
from velox_tpu.exec.operator import eval_pairs as jax_eval_pairs
from velox_tpu.expr.compiler import ExprSet as JaxExprSet
from velox_tpu.io.catalog import get_table as jax_get_table
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.exec.operator import batch_ranges
from velox_tpu_torch.exec.operator import eval_dicts as torch_eval_dicts
from velox_tpu_torch.exec.operator import eval_pairs as torch_eval_pairs
from velox_tpu_torch.expr.compiler import ExprSet as TorchExprSet
from velox_tpu_torch.io.catalog import get_table as torch_get_table
from velox_tpu_torch.ops import grouped_sum
from velox_tpu_torch.tpch import tpch_plan as torch_tpch_plan

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Count calls of the two grouped-sum wrappers (on the CPU they run
    the plain versions, so the kernels' launch counters stay at 0)."""
    calls = {"grouped_sum_i32": 0, "grouped_multi_sum_i32": 0}
    for name in calls:
        fn = getattr(grouped_sum, name)

        def counting(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(grouped_sum, name, counting)
    return calls


def _assert_same(got: dict, exp: dict, floats: bool):
    assert list(got) == list(exp)
    for c in exp:
        assert len(got[c]) == len(exp[c]), c
        if floats and exp[c] and isinstance(exp[c][0], float):
            np.testing.assert_allclose(got[c], exp[c], rtol=1e-9,
                                       err_msg=c)
        else:
            assert got[c] == exp[c], c


@pytest.mark.parametrize("narrow,money", CONFIGS)
def test_q1_q6_match_jax(narrow, money, wrapper_calls):
    with lineitem_in_both(narrow, money):
        splits = len(torch_get_table("lineitem").batches)
        for q in (1, 6):
            exp = jax_run_plan(jax_tpch_plan(q).build()).to_pydict()
            got = torch_run_plan(torch_tpch_plan(q))
            _assert_same(got, exp, floats=money == "double")
            assert len(got["revenue" if q == 6 else "count_order"]) == \
                (1 if q == 6 else 4)
    if narrow and money == "cents":
        # decimal Q1: every split through B2, count(*) included
        assert wrapper_calls == {"grouped_sum_i32": 0,
                                 "grouped_multi_sum_i32": splits}
    elif narrow:
        # DOUBLE Q1: the multi-sum declines (float inputs); count(*)
        # goes through B1 once per split
        assert wrapper_calls == {"grouped_sum_i32": splits,
                                 "grouped_multi_sum_i32": 0}
    else:
        assert wrapper_calls == {"grouped_sum_i32": 0,
                                 "grouped_multi_sum_i32": 0}


def test_q6_empty_filter_emits_one_null_row():
    from velox_tpu_torch.plan import PlanBuilder

    with lineitem_in_both(True, "cents"):
        plan = (PlanBuilder()
                .table_scan("lineitem", columns=["l_extendedprice"],
                            subfilter="l_shipdate < DATE '1900-01-01'")
                .aggregate([], ["sum(l_extendedprice) AS s",
                                "count(*) AS c"]))
        assert torch_run_plan(plan) == {"s": [None], "c": [0]}


@pytest.mark.parametrize("narrow,money", CONFIGS)
def test_q1_projection_lanes_match_jax(narrow, money):
    """The compiler's lane choices (widen_decimal_arith reads the stats)
    and values of Q1's projection, split 0, in both packages."""
    with lineitem_in_both(narrow, money):
        jplan, tplan = jax_tpch_plan(1).build(), torch_tpch_plan(1).build()
        jproj, tproj = jplan.source.source, tplan.source.source
        jb = jax_get_table("lineitem").batches[0]
        tb = torch_get_table("lineitem").batches[0]
        jset = JaxExprSet(list(jproj.exprs), jproj.source.output_type,
                          jax_eval_dicts(jb),
                          {n: c.stats for n, c in jb.columns.items()
                           if c.stats is not None})
        tset = TorchExprSet(list(tproj.exprs), tproj.source.output_type,
                            torch_eval_dicts(tb), batch_ranges(tb))
        jout = jset.evaluate(jax_eval_pairs(jb))
        tout = tset.evaluate(torch_eval_pairs(tb))
        for name, (jv, _), (tv, _) in zip(jproj.names, jout, tout):
            jv = np.asarray(jv)
            assert tv.numpy().dtype == jv.dtype, name
            if money == "double":
                np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-12)
            else:
                np.testing.assert_array_equal(tv.numpy(), jv)
        if narrow and money == "cents":
            # disc_price proven to fit int32 by the stats; charge widens
            assert tout[5][0].dtype == torch.int32
            assert tout[6][0].dtype == torch.int64


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_pyarrow_pandas_or_reference():
    files = sorted((REPO / "velox_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pyarrow", "pandas",
                               "velox_tpu"), f"{f}: imports {mod}"


def test_ingest_without_device_raises_without_cuda(monkeypatch):
    from velox_tpu_torch.io.catalog import register_columns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_columns("t_nocard", {"k": np.arange(4)})
