"""TPC-H query plans (PlanBuilder programs): the ported subset.

Copies of ``q1``, ``q3``, ``q6``, ``q18`` and the clustered variants
``q3c`` and ``q18c`` of the JAX package's ``tpch/queries.py``. The other
queries need operators later slices port; ``tpch_plan`` raises for them.
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


def q3() -> PlanBuilder:
    customers = (
        PlanBuilder()
        .table_scan("customer", columns=["c_custkey", "c_mktsegment"],
                    subfilter="c_mktsegment = 'BUILDING'")
        .project(["c_custkey"]))
    orders = (
        PlanBuilder()
        .table_scan("orders",
                    columns=["o_orderkey", "o_custkey", "o_orderdate",
                             "o_shippriority"],
                    subfilter="o_orderdate < DATE '1995-03-15'")
        .hash_join(customers, ["o_custkey"], ["c_custkey"], "left_semi",
                   output=["o_orderkey", "o_orderdate", "o_shippriority"]))
    return (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_extendedprice", "l_discount",
                             "l_shipdate"],
                    subfilter="l_shipdate > DATE '1995-03-15'")
        .hash_join(orders, ["l_orderkey"], ["o_orderkey"], "inner",
                   output=["l_orderkey", "l_extendedprice", "l_discount",
                           "o_orderdate", "o_shippriority"])
        .project(["l_orderkey", "o_orderdate", "o_shippriority",
                  "l_extendedprice * (1.0 - l_discount) AS part_rev"])
        .aggregate(["l_orderkey", "o_orderdate", "o_shippriority"],
                   ["sum(part_rev) AS revenue"])
        .top_n(["revenue DESC", "o_orderdate"], 10)
        .project(["l_orderkey", "revenue", "o_orderdate", "o_shippriority"])
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


def q18() -> PlanBuilder:
    big_orders = (
        PlanBuilder()
        .table_scan("lineitem", columns=["l_orderkey", "l_quantity"])
        .aggregate(["l_orderkey"], ["sum(l_quantity) AS total_qty"])
        .filter("total_qty > 300.0")
        .project(["l_orderkey AS big_okey"]))
    orders = (
        PlanBuilder()
        .table_scan("orders",
                    columns=["o_orderkey", "o_custkey", "o_orderdate",
                             "o_totalprice"])
        .hash_join(big_orders, ["o_orderkey"], ["big_okey"], "left_semi")
        .hash_join(
            PlanBuilder().table_scan(
                "customer", columns=["c_custkey", "c_name"]),
            ["o_custkey"], ["c_custkey"], "inner",
            output=["o_orderkey", "o_orderdate", "o_totalprice",
                    "c_custkey", "c_name"]))
    return (
        PlanBuilder()
        .table_scan("lineitem", columns=["l_orderkey", "l_quantity"])
        .hash_join(orders, ["l_orderkey"], ["o_orderkey"], "inner",
                   output=["l_quantity", "o_orderkey", "o_orderdate",
                           "o_totalprice", "c_custkey", "c_name"])
        .aggregate(
            ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
             "o_totalprice"],
            ["sum(l_quantity) AS sum_qty"])
        .top_n(["o_totalprice DESC", "o_orderdate"], 100)
        .project(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                  "o_totalprice", "sum_qty"])
    )


# ---------------------------------------------------------------- clustered
# Variants written for the physical clustering the generator gives:
# orders/lineitem ascend on orderkey and customer on custkey, so the
# orderkey/custkey joins are merge joins and the orderkey group-bys are
# streaming aggregations (the shapes plan/optimizer.py derives by itself).


def q3c() -> PlanBuilder:
    customers = (
        PlanBuilder()
        .table_scan("customer", columns=["c_custkey", "c_mktsegment"],
                    subfilter="c_mktsegment = 'BUILDING'")
        .project(["c_custkey"]))
    orders = (
        PlanBuilder()
        .table_scan("orders",
                    columns=["o_orderkey", "o_custkey", "o_orderdate",
                             "o_shippriority"],
                    subfilter="o_orderdate < DATE '1995-03-15'")
        # build side (customer) is custkey-clustered -> merge semi join
        .merge_join(customers, ["o_custkey"], ["c_custkey"], "left_semi",
                    output=["o_orderkey", "o_orderdate", "o_shippriority"]))
    return (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_extendedprice", "l_discount",
                             "l_shipdate"],
                    subfilter="l_shipdate > DATE '1995-03-15'")
        # orders kept orderkey-ascending by the semi join -> merge join;
        # output stays lineitem(probe)-ordered, i.e. orderkey-clustered
        .merge_join(orders, ["l_orderkey"], ["o_orderkey"], "inner",
                    output=["l_orderkey", "l_extendedprice", "l_discount",
                            "o_orderdate", "o_shippriority"])
        .project(["l_orderkey", "o_orderdate", "o_shippriority",
                  "l_extendedprice * (1.0 - l_discount) AS part_rev"])
        .streaming_aggregate(
            ["l_orderkey", "o_orderdate", "o_shippriority"],
            ["sum(part_rev) AS revenue"])
        .top_n(["revenue DESC", "o_orderdate"], 10)
        .project(["l_orderkey", "revenue", "o_orderdate", "o_shippriority"])
    )


def q18c() -> PlanBuilder:
    big_orders = (
        PlanBuilder()
        .table_scan("lineitem", columns=["l_orderkey", "l_quantity"])
        .streaming_aggregate(["l_orderkey"], ["sum(l_quantity) AS total_qty"])
        .filter("total_qty > 300.0")
        .project(["l_orderkey AS big_okey"]))
    orders = (
        PlanBuilder()
        .table_scan("orders",
                    columns=["o_orderkey", "o_custkey", "o_orderdate",
                             "o_totalprice"])
        .merge_join(big_orders, ["o_orderkey"], ["big_okey"], "left_semi")
        .merge_join(
            PlanBuilder().table_scan(
                "customer", columns=["c_custkey", "c_name"]),
            ["o_custkey"], ["c_custkey"], "inner",
            output=["o_orderkey", "o_orderdate", "o_totalprice",
                    "c_custkey", "c_name"]))
    return (
        PlanBuilder()
        .table_scan("lineitem", columns=["l_orderkey", "l_quantity"])
        .merge_join(orders, ["l_orderkey"], ["o_orderkey"], "inner",
                    output=["l_quantity", "o_orderkey", "o_orderdate",
                            "o_totalprice", "c_custkey", "c_name"])
        .streaming_aggregate(
            ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
             "o_totalprice"],
            ["sum(l_quantity) AS sum_qty"])
        .top_n(["o_totalprice DESC", "o_orderdate"], 100)
        .project(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                  "o_totalprice", "sum_qty"])
    )


#: clustered-plan variants (query number -> builder)
CLUSTERED_QUERIES = {3: q3c, 18: q18c}

_QUERIES = {1: q1, 3: q3, 6: q6, 18: q18}

SUPPORTED_QUERIES = sorted(_QUERIES)


def tpch_plan(n: int, sf: float = 1.0,
              clustered: bool = False) -> PlanBuilder:
    """Plan for Q{n}; ``clustered=True`` picks the merge-join/streaming
    variant where one exists. ``sf`` is accepted for the reference's
    signature (its Q11 reads it); no ported query does."""
    if clustered and n in CLUSTERED_QUERIES:
        return CLUSTERED_QUERIES[n]()
    try:
        q = _QUERIES[n]
    except KeyError:
        raise NotImplementedError(
            f"TPC-H Q{n} is not ported to velox_tpu_torch yet")
    return q()
