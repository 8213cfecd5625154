"""TPC-DS beyond the spec subset, queries 73-84 of ``FULL_QUERIES`` (q87,
q88, q89, q90, q91, q92, q93, q94, q95, q97, q98, q99) against the JAX
package on the CPU at SF 0.01.

The 24 tables of ``velox_tpu_torch.io.tpcds_full`` (seed 7, NULLs in
foreign keys, measures and dimension attributes) go into both catalogs
from the same arrays; each query runs through the JAX package's
``run_plan`` once and through the port's with ``optimize_plans`` on and
off, with ``FULL_PARAMS``' constants where the spec's select nothing.
Integers, strings, dates, NULLs and row order must match exactly, DOUBLE
to rtol=1e-9.

q91 selects no row at SF 0.01 in either package (``FULL_EMPTY`` says
why); the test holds the port to the empty result and fails if a row
appears."""

import pytest

from torch_tpch_data import check_full_query, full_queries_fixture
from velox_tpu_torch.tpcds import FULL_QUERIES

QUERIES = FULL_QUERIES[72:84]

tpcds_full = full_queries_fixture()


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(tpcds_full, q, monkeypatch):
    check_full_query(tpcds_full, q, monkeypatch)
