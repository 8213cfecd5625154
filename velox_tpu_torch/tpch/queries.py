"""TPC-H query plans (PlanBuilder programs): the ported subset.

Copies of ``q1`` and ``q6`` of the JAX package's ``tpch/queries.py``.
The other queries need the join and streaming-aggregation operators,
which later slices port; ``tpch_plan`` raises for them.
"""

from __future__ import annotations

from velox_tpu_torch.plan import PlanBuilder


def q1() -> PlanBuilder:
    return (
        PlanBuilder()
        .table_scan(
            "lineitem",
            columns=["l_returnflag", "l_linestatus", "l_quantity",
                     "l_extendedprice", "l_discount", "l_tax",
                     "l_shipdate"],
            subfilter="l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY")
        .project([
            "l_returnflag", "l_linestatus", "l_quantity",
            "l_extendedprice", "l_discount",
            "l_extendedprice * (1.0 - l_discount) AS disc_price",
            "l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax) AS charge",
        ])
        .aggregate(
            ["l_returnflag", "l_linestatus"],
            ["sum(l_quantity) AS sum_qty",
             "sum(l_extendedprice) AS sum_base_price",
             "sum(disc_price) AS sum_disc_price",
             "sum(charge) AS sum_charge",
             "avg(l_quantity) AS avg_qty",
             "avg(l_extendedprice) AS avg_price",
             "avg(l_discount) AS avg_disc",
             "count(*) AS count_order"])
        .order_by(["l_returnflag", "l_linestatus"])
    )


def q6() -> PlanBuilder:
    return (
        PlanBuilder()
        .table_scan(
            "lineitem",
            columns=["l_extendedprice", "l_discount", "l_quantity",
                     "l_shipdate"],
            subfilter="l_shipdate >= DATE '1994-01-01' AND "
                      "l_shipdate < DATE '1995-01-01' AND "
                      "l_discount BETWEEN 0.05 AND 0.07 AND "
                      "l_quantity < 24.0")
        .project(["l_extendedprice * l_discount AS part_rev"])
        .aggregate([], ["sum(part_rev) AS revenue"])
    )


_QUERIES = {1: q1, 6: q6}

SUPPORTED_QUERIES = sorted(_QUERIES)


def tpch_plan(n: int) -> PlanBuilder:
    """Plan for Q{n}; only the ported queries exist."""
    try:
        q = _QUERIES[n]
    except KeyError:
        raise NotImplementedError(
            f"TPC-H Q{n} is not ported to velox_tpu_torch yet")
    return q()
