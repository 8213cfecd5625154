"""TPC-DS beyond the spec subset, queries 25-36 of ``FULL_QUERIES`` (q31,
q32, q33, q34, q35, q36, q37, q38, q39, q40, q41, q44) against the JAX
package on the CPU at SF 0.01.

The 24 tables of ``velox_tpu_torch.io.tpcds_full`` (seed 7, NULLs in
foreign keys, measures and dimension attributes) go into both catalogs
from the same arrays; each query runs through the JAX package's
``run_plan`` once and through the port's with ``optimize_plans`` on and
off, with ``FULL_PARAMS``' constants where the spec's select nothing.
Integers, strings, dates, NULLs and row order must match exactly, DOUBLE
to rtol=1e-9.

q41 selects no row at SF 0.01 in either package (``FULL_EMPTY`` says
why); the test holds the port to the empty result and fails if a row
appears."""

import pytest

from torch_tpch_data import check_full_query, full_queries_fixture
from velox_tpu_torch.tpcds import FULL_QUERIES

QUERIES = FULL_QUERIES[24:36]

tpcds_full = full_queries_fixture()


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(tpcds_full, q, monkeypatch):
    check_full_query(tpcds_full, q, monkeypatch)
