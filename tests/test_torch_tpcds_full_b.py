"""TPC-DS beyond the spec subset, queries 13-24 of ``FULL_QUERIES`` (q16,
q17, q18, q20, q21, q22, q23, q24, q25, q26, q29, q30) against the JAX
package on the CPU at SF 0.01.

The 24 tables of ``velox_tpu_torch.io.tpcds_full`` (seed 7, NULLs in
foreign keys, measures and dimension attributes) go into both catalogs
from the same arrays; each query runs through the JAX package's
``run_plan`` once and through the port's with ``optimize_plans`` on and
off, with ``FULL_PARAMS``' constants where the spec's select nothing.
Integers, strings, dates, NULLs and row order must match exactly, DOUBLE
to rtol=1e-9."""

import pytest

from torch_tpch_data import check_full_query, full_queries_fixture
from velox_tpu_torch.tpcds import FULL_QUERIES

QUERIES = FULL_QUERIES[12:24]

tpcds_full = full_queries_fixture()


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(tpcds_full, q, monkeypatch):
    check_full_query(tpcds_full, q, monkeypatch)
