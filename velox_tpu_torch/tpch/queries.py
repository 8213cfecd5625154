"""TPC-H query plans (PlanBuilder programs): all 22 queries.

Copies of the JAX package's ``tpch/queries.py``, which mirrors the
reference's TpchQueryBuilder plan shapes
(velox/exec/tests/utils/TpchQueryBuilder.cpp:145-187): filters pushed into
scans, build sides chosen small-side-right, semi joins for IN subqueries,
anti joins for NOT IN / NOT EXISTS, cross joins against single-row scalar
subqueries. Tables must be registered first
(``velox_tpu_torch.io.tpch.register_tpch_tables``).
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


def q5() -> PlanBuilder:
    nations_in_region = (
        PlanBuilder()
        .table_scan("nation",
                    columns=["n_nationkey", "n_name", "n_regionkey"])
        .hash_join(
            PlanBuilder().table_scan(
                "region", columns=["r_regionkey", "r_name"],
                subfilter="r_name = 'ASIA'").project(["r_regionkey"]),
            ["n_regionkey"], ["r_regionkey"], "left_semi",
            output=["n_nationkey", "n_name"]))
    suppliers = (
        PlanBuilder()
        .table_scan("supplier", columns=["s_suppkey", "s_nationkey"])
        .hash_join(nations_in_region, ["s_nationkey"], ["n_nationkey"],
                   "inner", output=["s_suppkey", "s_nationkey", "n_name"]))
    orders = (
        PlanBuilder()
        .table_scan(
            "orders", columns=["o_orderkey", "o_custkey", "o_orderdate"],
            subfilter="o_orderdate >= DATE '1994-01-01' AND "
                      "o_orderdate < DATE '1995-01-01'")
        .hash_join(
            PlanBuilder().table_scan(
                "customer", columns=["c_custkey", "c_nationkey"]),
            ["o_custkey"], ["c_custkey"], "inner",
            output=["o_orderkey", "c_nationkey"]))
    return (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_suppkey", "l_extendedprice",
                             "l_discount"])
        .hash_join(orders, ["l_orderkey"], ["o_orderkey"], "inner",
                   output=["l_suppkey", "l_extendedprice", "l_discount",
                           "c_nationkey"])
        .hash_join(suppliers, ["l_suppkey", "c_nationkey"],
                   ["s_suppkey", "s_nationkey"], "inner",
                   output=["l_extendedprice", "l_discount", "n_name"])
        .project(["n_name",
                  "l_extendedprice * (1.0 - l_discount) AS part_rev"])
        .aggregate(["n_name"], ["sum(part_rev) AS revenue"])
        .order_by(["revenue DESC"])
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


def q10() -> PlanBuilder:
    orders = (
        PlanBuilder()
        .table_scan(
            "orders", columns=["o_orderkey", "o_custkey", "o_orderdate"],
            subfilter="o_orderdate >= DATE '1993-10-01' AND "
                      "o_orderdate < DATE '1994-01-01'")
        .project(["o_orderkey", "o_custkey"]))
    lineitem = (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_extendedprice", "l_discount",
                             "l_returnflag"],
                    subfilter="l_returnflag = 'R'")
        .hash_join(orders, ["l_orderkey"], ["o_orderkey"], "inner",
                   output=["l_extendedprice", "l_discount", "o_custkey"]))
    customer = (
        PlanBuilder()
        .table_scan("customer",
                    columns=["c_custkey", "c_name", "c_acctbal",
                             "c_nationkey", "c_address", "c_phone",
                             "c_comment"])
        .hash_join(
            PlanBuilder().table_scan(
                "nation", columns=["n_nationkey", "n_name"]),
            ["c_nationkey"], ["n_nationkey"], "inner",
            output=["c_custkey", "c_name", "c_acctbal", "c_address",
                    "c_phone", "c_comment", "n_name"]))
    return (
        lineitem
        .hash_join(customer, ["o_custkey"], ["c_custkey"], "inner",
                   output=["l_extendedprice", "l_discount", "c_custkey",
                           "c_name", "c_acctbal", "c_address", "c_phone",
                           "c_comment", "n_name"])
        .project(["c_custkey", "c_name", "c_acctbal", "c_address",
                  "c_phone", "c_comment", "n_name",
                  "l_extendedprice * (1.0 - l_discount) AS part_rev"])
        .aggregate(
            ["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
             "c_address", "c_comment"],
            ["sum(part_rev) AS revenue"])
        .top_n(["revenue DESC"], 20)
        .project(["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
                  "c_address", "c_phone", "c_comment"])
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


def q2() -> PlanBuilder:
    eur_nations = (
        PlanBuilder()
        .table_scan("nation", columns=["n_nationkey", "n_name",
                                       "n_regionkey"])
        .hash_join(
            PlanBuilder().table_scan(
                "region", columns=["r_regionkey", "r_name"],
                subfilter="r_name = 'EUROPE'").project(["r_regionkey"]),
            ["n_regionkey"], ["r_regionkey"], "left_semi",
            output=["n_nationkey", "n_name"]))
    eur_supp = (
        PlanBuilder()
        .table_scan("supplier",
                    columns=["s_suppkey", "s_name", "s_address",
                             "s_nationkey", "s_phone", "s_acctbal",
                             "s_comment"])
        .hash_join(eur_nations, ["s_nationkey"], ["n_nationkey"], "inner",
                   output=["s_suppkey", "s_name", "s_address", "s_phone",
                           "s_acctbal", "s_comment", "n_name"]))
    ps_eur = (
        PlanBuilder()
        .table_scan("partsupp", columns=["ps_partkey", "ps_suppkey",
                                         "ps_supplycost"])
        .hash_join(eur_supp, ["ps_suppkey"], ["s_suppkey"], "inner"))
    min_cost = (
        PlanBuilder()
        .table_scan("partsupp", columns=["ps_partkey", "ps_suppkey",
                                         "ps_supplycost"])
        .hash_join(
            PlanBuilder()
            .table_scan("supplier", columns=["s_suppkey", "s_nationkey"])
            .hash_join(eur_nations, ["s_nationkey"], ["n_nationkey"],
                       "left_semi", output=["s_suppkey"]),
            ["ps_suppkey"], ["s_suppkey"], "left_semi",
            output=["ps_partkey", "ps_supplycost"])
        .aggregate(["ps_partkey"], ["min(ps_supplycost) AS min_cost"])
        .project(["ps_partkey AS mc_partkey", "min_cost"]))
    parts = (
        PlanBuilder()
        .table_scan("part", columns=["p_partkey", "p_mfgr", "p_size",
                                     "p_type"],
                    subfilter="p_size = 15 AND p_type LIKE '%BRASS'")
        .project(["p_partkey", "p_mfgr"]))
    return (
        ps_eur
        .hash_join(parts, ["ps_partkey"], ["p_partkey"], "inner")
        .hash_join(min_cost, ["ps_partkey"], ["mc_partkey"], "inner",
                   filter="ps_supplycost = min_cost",
                   output=["s_acctbal", "s_name", "n_name", "p_partkey",
                           "p_mfgr", "s_address", "s_phone", "s_comment"])
        .top_n(["s_acctbal DESC", "n_name", "s_name", "p_partkey"], 100)
    )


def q4() -> PlanBuilder:
    late = (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_commitdate",
                             "l_receiptdate"],
                    subfilter="l_commitdate < l_receiptdate")
        .project(["l_orderkey"]))
    return (
        PlanBuilder()
        .table_scan("orders",
                    columns=["o_orderkey", "o_orderdate",
                             "o_orderpriority"],
                    subfilter="o_orderdate >= DATE '1993-07-01' AND "
                              "o_orderdate < DATE '1993-10-01'")
        .hash_join(late, ["o_orderkey"], ["l_orderkey"], "left_semi",
                   output=["o_orderpriority"])
        .aggregate(["o_orderpriority"], ["count(*) AS order_count"])
        .order_by(["o_orderpriority"])
    )


def q7() -> PlanBuilder:
    n1 = (PlanBuilder().table_scan(
        "nation", columns=["n_nationkey", "n_name"],
        subfilter="n_name IN ('FRANCE', 'GERMANY')")
        .project(["n_nationkey AS s_natkey", "n_name AS supp_nation"]))
    n2 = (PlanBuilder().table_scan(
        "nation", columns=["n_nationkey", "n_name"],
        subfilter="n_name IN ('FRANCE', 'GERMANY')")
        .project(["n_nationkey AS c_natkey", "n_name AS cust_nation"]))
    supp = (
        PlanBuilder()
        .table_scan("supplier", columns=["s_suppkey", "s_nationkey"])
        .hash_join(n1, ["s_nationkey"], ["s_natkey"], "inner",
                   output=["s_suppkey", "supp_nation"]))
    cust = (
        PlanBuilder()
        .table_scan("customer", columns=["c_custkey", "c_nationkey"])
        .hash_join(n2, ["c_nationkey"], ["c_natkey"], "inner",
                   output=["c_custkey", "cust_nation"]))
    orders = (
        PlanBuilder()
        .table_scan("orders", columns=["o_orderkey", "o_custkey"])
        .hash_join(cust, ["o_custkey"], ["c_custkey"], "inner",
                   output=["o_orderkey", "cust_nation"]))
    return (
        PlanBuilder()
        .table_scan(
            "lineitem",
            columns=["l_orderkey", "l_suppkey", "l_extendedprice",
                     "l_discount", "l_shipdate"],
            subfilter="l_shipdate BETWEEN DATE '1995-01-01' AND "
                      "DATE '1996-12-31'")
        .hash_join(supp, ["l_suppkey"], ["s_suppkey"], "inner")
        .hash_join(orders, ["l_orderkey"], ["o_orderkey"], "inner",
                   output=["l_extendedprice", "l_discount", "l_shipdate",
                           "supp_nation", "cust_nation"])
        .filter("(supp_nation = 'FRANCE' AND cust_nation = 'GERMANY') OR "
                "(supp_nation = 'GERMANY' AND cust_nation = 'FRANCE')")
        .project(["supp_nation", "cust_nation",
                  "year(l_shipdate) AS l_year",
                  "l_extendedprice * (1.0 - l_discount) AS volume"])
        .aggregate(["supp_nation", "cust_nation", "l_year"],
                   ["sum(volume) AS revenue"])
        .order_by(["supp_nation", "cust_nation", "l_year"])
    )


def q8() -> PlanBuilder:
    amer_nations = (
        PlanBuilder()
        .table_scan("nation", columns=["n_nationkey", "n_regionkey"])
        .hash_join(
            PlanBuilder().table_scan(
                "region", columns=["r_regionkey", "r_name"],
                subfilter="r_name = 'AMERICA'").project(["r_regionkey"]),
            ["n_regionkey"], ["r_regionkey"], "left_semi",
            output=["n_nationkey"]))
    cust = (
        PlanBuilder()
        .table_scan("customer", columns=["c_custkey", "c_nationkey"])
        .hash_join(amer_nations, ["c_nationkey"], ["n_nationkey"],
                   "left_semi", output=["c_custkey"]))
    orders = (
        PlanBuilder()
        .table_scan(
            "orders", columns=["o_orderkey", "o_custkey", "o_orderdate"],
            subfilter="o_orderdate BETWEEN DATE '1995-01-01' AND "
                      "DATE '1996-12-31'")
        .hash_join(cust, ["o_custkey"], ["c_custkey"], "left_semi",
                   output=["o_orderkey", "o_orderdate"]))
    supp = (
        PlanBuilder()
        .table_scan("supplier", columns=["s_suppkey", "s_nationkey"])
        .hash_join(
            PlanBuilder().table_scan(
                "nation", columns=["n_nationkey", "n_name"])
            .project(["n_nationkey AS n2_key", "n_name AS nation"]),
            ["s_nationkey"], ["n2_key"], "inner",
            output=["s_suppkey", "nation"]))
    parts = (
        PlanBuilder()
        .table_scan("part", columns=["p_partkey", "p_type"],
                    subfilter="p_type = 'ECONOMY ANODIZED STEEL'")
        .project(["p_partkey"]))
    return (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_partkey", "l_suppkey",
                             "l_extendedprice", "l_discount"])
        .hash_join(parts, ["l_partkey"], ["p_partkey"], "left_semi")
        .hash_join(orders, ["l_orderkey"], ["o_orderkey"], "inner")
        .hash_join(supp, ["l_suppkey"], ["s_suppkey"], "inner",
                   output=["l_extendedprice", "l_discount", "o_orderdate",
                           "nation"])
        .project([
            "year(o_orderdate) AS o_year",
            "l_extendedprice * (1.0 - l_discount) AS volume",
            "CASE WHEN nation = 'BRAZIL' THEN "
            "l_extendedprice * (1.0 - l_discount) ELSE 0.0 END AS bvol"])
        .aggregate(["o_year"],
                   ["sum(bvol) AS brazil", "sum(volume) AS total"])
        .project(["o_year", "brazil / total AS mkt_share"])
        .order_by(["o_year"])
    )


def q9() -> PlanBuilder:
    parts = (
        PlanBuilder()
        .table_scan("part", columns=["p_partkey", "p_name"],
                    subfilter="p_name LIKE '%green%'")
        .project(["p_partkey"]))
    supp = (
        PlanBuilder()
        .table_scan("supplier", columns=["s_suppkey", "s_nationkey"])
        .hash_join(
            PlanBuilder().table_scan(
                "nation", columns=["n_nationkey", "n_name"])
            .project(["n_nationkey", "n_name AS nation"]),
            ["s_nationkey"], ["n_nationkey"], "inner",
            output=["s_suppkey", "nation"]))
    orders = (
        PlanBuilder()
        .table_scan("orders", columns=["o_orderkey", "o_orderdate"]))
    partsupp = (
        PlanBuilder()
        .table_scan("partsupp", columns=["ps_partkey", "ps_suppkey",
                                         "ps_supplycost"]))
    return (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_partkey", "l_suppkey",
                             "l_quantity", "l_extendedprice",
                             "l_discount"])
        .hash_join(parts, ["l_partkey"], ["p_partkey"], "left_semi")
        .hash_join(partsupp, ["l_partkey", "l_suppkey"],
                   ["ps_partkey", "ps_suppkey"], "inner")
        .hash_join(orders, ["l_orderkey"], ["o_orderkey"], "inner")
        .hash_join(supp, ["l_suppkey"], ["s_suppkey"], "inner",
                   output=["l_quantity", "l_extendedprice", "l_discount",
                           "ps_supplycost", "o_orderdate", "nation"])
        .project([
            "nation", "year(o_orderdate) AS o_year",
            "l_extendedprice * (1.0 - l_discount) - "
            "ps_supplycost * l_quantity AS amount"])
        .aggregate(["nation", "o_year"], ["sum(amount) AS sum_profit"])
        .order_by(["nation", "o_year DESC"])
    )


def q11(sf: float = 1.0) -> PlanBuilder:
    def base() -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan("partsupp", columns=["ps_partkey", "ps_suppkey",
                                             "ps_availqty",
                                             "ps_supplycost"])
            .hash_join(
                PlanBuilder()
                .table_scan("supplier",
                            columns=["s_suppkey", "s_nationkey"])
                .hash_join(
                    PlanBuilder().table_scan(
                        "nation", columns=["n_nationkey", "n_name"],
                        subfilter="n_name = 'GERMANY'")
                    .project(["n_nationkey"]),
                    ["s_nationkey"], ["n_nationkey"], "left_semi",
                    output=["s_suppkey"]),
                ["ps_suppkey"], ["s_suppkey"], "left_semi")
            .project(["ps_partkey",
                      "ps_supplycost * ps_availqty AS val"]))

    threshold = (
        base()
        .aggregate([], ["sum(val) AS total"])
        .project([f"total * {0.0001 / sf:.10f} AS threshold"])
        .enforce_single_row())
    return (
        base()
        .aggregate(["ps_partkey"], ["sum(val) AS value"])
        .cross_join(threshold)
        .filter("value > threshold")
        .project(["ps_partkey", "value"])
        .order_by(["value DESC"])
    )


def q12() -> PlanBuilder:
    return (
        PlanBuilder()
        .table_scan(
            "lineitem",
            columns=["l_orderkey", "l_shipmode", "l_shipdate",
                     "l_commitdate", "l_receiptdate"],
            subfilter="l_shipmode IN ('MAIL', 'SHIP') AND "
                      "l_commitdate < l_receiptdate AND "
                      "l_shipdate < l_commitdate AND "
                      "l_receiptdate >= DATE '1994-01-01' AND "
                      "l_receiptdate < DATE '1995-01-01'")
        .hash_join(
            PlanBuilder().table_scan(
                "orders", columns=["o_orderkey", "o_orderpriority"]),
            ["l_orderkey"], ["o_orderkey"], "inner",
            output=["l_shipmode", "o_orderpriority"])
        .project([
            "l_shipmode",
            "CASE WHEN o_orderpriority = '1-URGENT' OR "
            "o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END AS high",
            "CASE WHEN o_orderpriority <> '1-URGENT' AND "
            "o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END AS low"])
        .aggregate(["l_shipmode"],
                   ["sum(high) AS high_line_count",
                    "sum(low) AS low_line_count"])
        .order_by(["l_shipmode"])
    )


def q13() -> PlanBuilder:
    orders = (
        PlanBuilder()
        .table_scan("orders",
                    columns=["o_orderkey", "o_custkey", "o_comment"],
                    subfilter="o_comment NOT LIKE '%special%requests%'")
        .project(["o_orderkey", "o_custkey"]))
    return (
        PlanBuilder()
        .table_scan("customer", columns=["c_custkey"])
        .hash_join(orders, ["c_custkey"], ["o_custkey"], "left",
                   output=["c_custkey", "o_orderkey"])
        .aggregate(["c_custkey"], ["count(o_orderkey) AS c_count"])
        .aggregate(["c_count"], ["count(*) AS custdist"])
        .order_by(["custdist DESC", "c_count DESC"])
    )


def q14() -> PlanBuilder:
    return (
        PlanBuilder()
        .table_scan(
            "lineitem",
            columns=["l_partkey", "l_extendedprice", "l_discount",
                     "l_shipdate"],
            subfilter="l_shipdate >= DATE '1995-09-01' AND "
                      "l_shipdate < DATE '1995-10-01'")
        .hash_join(
            PlanBuilder().table_scan(
                "part", columns=["p_partkey", "p_type"]),
            ["l_partkey"], ["p_partkey"], "inner",
            output=["l_extendedprice", "l_discount", "p_type"])
        .project([
            "l_extendedprice * (1.0 - l_discount) AS volume",
            "CASE WHEN p_type LIKE 'PROMO%' THEN "
            "l_extendedprice * (1.0 - l_discount) ELSE 0.0 END AS promo"])
        .aggregate([], ["sum(promo) AS p", "sum(volume) AS t"])
        .project(["100.0 * p / t AS promo_revenue"])
    )


def q15() -> PlanBuilder:
    def revenue() -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan(
                "lineitem",
                columns=["l_suppkey", "l_extendedprice", "l_discount",
                         "l_shipdate"],
                subfilter="l_shipdate >= DATE '1996-01-01' AND "
                          "l_shipdate < DATE '1996-04-01'")
            .project(["l_suppkey",
                      "l_extendedprice * (1.0 - l_discount) AS rev"])
            .aggregate(["l_suppkey"], ["sum(rev) AS total_revenue"]))

    max_rev = (
        revenue()
        .aggregate([], ["max(total_revenue) AS max_rev"])
        .enforce_single_row())
    return (
        revenue()
        .cross_join(max_rev)
        .filter("total_revenue = max_rev")
        .hash_join(
            PlanBuilder().table_scan(
                "supplier", columns=["s_suppkey", "s_name", "s_address",
                                     "s_phone"]),
            ["l_suppkey"], ["s_suppkey"], "inner",
            output=["s_suppkey", "s_name", "s_address", "s_phone",
                    "total_revenue"])
        .order_by(["s_suppkey"])
    )


def q16() -> PlanBuilder:
    bad_suppliers = (
        PlanBuilder()
        .table_scan("supplier", columns=["s_suppkey", "s_comment"],
                    subfilter="s_comment LIKE '%Customer%Complaints%'")
        .project(["s_suppkey"]))
    parts = (
        PlanBuilder()
        .table_scan(
            "part", columns=["p_partkey", "p_brand", "p_type", "p_size"],
            subfilter="p_brand <> 'Brand#45' AND "
                      "p_type NOT LIKE 'MEDIUM POLISHED%' AND "
                      "p_size IN (49, 14, 23, 45, 19, 3, 36, 9)"))
    return (
        PlanBuilder()
        .table_scan("partsupp", columns=["ps_partkey", "ps_suppkey"])
        .hash_join(bad_suppliers, ["ps_suppkey"], ["s_suppkey"], "anti")
        .hash_join(parts, ["ps_partkey"], ["p_partkey"], "inner",
                   output=["p_brand", "p_type", "p_size", "ps_suppkey"])
        .aggregate(["p_brand", "p_type", "p_size"],
                   ["count(distinct ps_suppkey) AS supplier_cnt"])
        .order_by(["supplier_cnt DESC", "p_brand", "p_type", "p_size"])
    )


def q17() -> PlanBuilder:
    parts = (
        PlanBuilder()
        .table_scan("part",
                    columns=["p_partkey", "p_brand", "p_container"],
                    subfilter="p_brand = 'Brand#23' AND "
                              "p_container = 'MED BOX'")
        .project(["p_partkey"]))
    avgs = (
        PlanBuilder()
        .table_scan("lineitem", columns=["l_partkey", "l_quantity"])
        .hash_join(parts, ["l_partkey"], ["p_partkey"], "left_semi")
        .aggregate(["l_partkey"], ["avg(l_quantity) AS avg_qty"])
        .project(["l_partkey AS a_partkey", "0.2 * avg_qty AS lim"]))
    return (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_partkey", "l_quantity",
                             "l_extendedprice"])
        .hash_join(avgs, ["l_partkey"], ["a_partkey"], "inner",
                   filter="l_quantity < lim",
                   output=["l_extendedprice"])
        .aggregate([], ["sum(l_extendedprice) AS s"])
        .project(["s / 7.0 AS avg_yearly"])
    )


def q19() -> PlanBuilder:
    return (
        PlanBuilder()
        .table_scan(
            "lineitem",
            columns=["l_partkey", "l_quantity", "l_extendedprice",
                     "l_discount", "l_shipinstruct", "l_shipmode"],
            subfilter="l_shipmode IN ('AIR', 'REG AIR') AND "
                      "l_shipinstruct = 'DELIVER IN PERSON'")
        .hash_join(
            PlanBuilder().table_scan(
                "part", columns=["p_partkey", "p_brand", "p_size",
                                 "p_container"]),
            ["l_partkey"], ["p_partkey"], "inner",
            output=["l_quantity", "l_extendedprice", "l_discount",
                    "p_brand", "p_size", "p_container"])
        .filter(
            "(p_brand = 'Brand#12' AND p_container IN "
            "('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG') AND "
            "l_quantity >= 1.0 AND l_quantity <= 11.0 AND "
            "p_size BETWEEN 1 AND 5) OR "
            "(p_brand = 'Brand#23' AND p_container IN "
            "('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK') AND "
            "l_quantity >= 10.0 AND l_quantity <= 20.0 AND "
            "p_size BETWEEN 1 AND 10) OR "
            "(p_brand = 'Brand#34' AND p_container IN "
            "('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG') AND "
            "l_quantity >= 20.0 AND l_quantity <= 30.0 AND "
            "p_size BETWEEN 1 AND 15)")
        .project(["l_extendedprice * (1.0 - l_discount) AS part_rev"])
        .aggregate([], ["sum(part_rev) AS revenue"])
    )


def q20() -> PlanBuilder:
    forest_parts = (
        PlanBuilder()
        .table_scan("part", columns=["p_partkey", "p_name"],
                    subfilter="p_name LIKE 'forest%'")
        .project(["p_partkey"]))
    half_qty = (
        PlanBuilder()
        .table_scan(
            "lineitem",
            columns=["l_partkey", "l_suppkey", "l_quantity",
                     "l_shipdate"],
            subfilter="l_shipdate >= DATE '1994-01-01' AND "
                      "l_shipdate < DATE '1995-01-01'")
        .aggregate(["l_partkey", "l_suppkey"],
                   ["sum(l_quantity) AS qty"])
        .project(["l_partkey AS h_partkey", "l_suppkey AS h_suppkey",
                  "0.5 * qty AS half"]))
    qualifying = (
        PlanBuilder()
        .table_scan("partsupp",
                    columns=["ps_partkey", "ps_suppkey", "ps_availqty"])
        .hash_join(forest_parts, ["ps_partkey"], ["p_partkey"],
                   "left_semi")
        .hash_join(half_qty, ["ps_partkey", "ps_suppkey"],
                   ["h_partkey", "h_suppkey"], "inner",
                   filter="ps_availqty > half",
                   output=["ps_suppkey"]))
    return (
        PlanBuilder()
        .table_scan("supplier",
                    columns=["s_suppkey", "s_name", "s_address",
                             "s_nationkey"])
        .hash_join(qualifying, ["s_suppkey"], ["ps_suppkey"], "left_semi")
        .hash_join(
            PlanBuilder().table_scan(
                "nation", columns=["n_nationkey", "n_name"],
                subfilter="n_name = 'CANADA'").project(["n_nationkey"]),
            ["s_nationkey"], ["n_nationkey"], "left_semi",
            output=["s_name", "s_address"])
        .order_by(["s_name"])
    )


def q21() -> PlanBuilder:
    other_supp = (
        PlanBuilder()
        .table_scan("lineitem", columns=["l_orderkey", "l_suppkey"])
        .project(["l_orderkey AS l2_orderkey", "l_suppkey AS l2_suppkey"]))
    other_late = (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_suppkey", "l_commitdate",
                             "l_receiptdate"],
                    subfilter="l_receiptdate > l_commitdate")
        .project(["l_orderkey AS l3_orderkey", "l_suppkey AS l3_suppkey"]))
    f_orders = (
        PlanBuilder()
        .table_scan("orders", columns=["o_orderkey", "o_orderstatus"],
                    subfilter="o_orderstatus = 'F'")
        .project(["o_orderkey"]))
    saudi_supp = (
        PlanBuilder()
        .table_scan("supplier",
                    columns=["s_suppkey", "s_name", "s_nationkey"])
        .hash_join(
            PlanBuilder().table_scan(
                "nation", columns=["n_nationkey", "n_name"],
                subfilter="n_name = 'SAUDI ARABIA'")
            .project(["n_nationkey"]),
            ["s_nationkey"], ["n_nationkey"], "left_semi",
            output=["s_suppkey", "s_name"]))
    return (
        PlanBuilder()
        .table_scan("lineitem",
                    columns=["l_orderkey", "l_suppkey", "l_commitdate",
                             "l_receiptdate"],
                    subfilter="l_receiptdate > l_commitdate")
        .project(["l_orderkey", "l_suppkey"])
        .hash_join(f_orders, ["l_orderkey"], ["o_orderkey"], "left_semi")
        .hash_join(saudi_supp, ["l_suppkey"], ["s_suppkey"], "inner")
        .hash_join(other_supp, ["l_orderkey"], ["l2_orderkey"],
                   "left_semi", filter="l2_suppkey <> l_suppkey")
        .hash_join(other_late, ["l_orderkey"], ["l3_orderkey"],
                   "anti_simple", filter="l3_suppkey <> l_suppkey")
        .aggregate(["s_name"], ["count(*) AS numwait"])
        .top_n(["numwait DESC", "s_name"], 100)
    )


_Q22_CODES = "('13', '31', '23', '29', '30', '18', '17')"


def q22() -> PlanBuilder:
    def candidates() -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan("customer",
                        columns=["c_custkey", "c_phone", "c_acctbal"])
            .filter(f"substr(c_phone, 1, 2) IN {_Q22_CODES}"))

    avg_bal = (
        candidates()
        .filter("c_acctbal > 0.0")
        .aggregate([], ["avg(c_acctbal) AS avgbal"])
        .enforce_single_row())
    return (
        candidates()
        .cross_join(avg_bal)
        .filter("c_acctbal > avgbal")
        .hash_join(
            PlanBuilder().table_scan("orders", columns=["o_custkey"]),
            ["c_custkey"], ["o_custkey"], "anti_simple")
        .project(["substr(c_phone, 1, 2) AS cntrycode", "c_acctbal"])
        .aggregate(["cntrycode"],
                   ["count(*) AS numcust", "sum(c_acctbal) AS totacctbal"])
        .order_by(["cntrycode"])
    )


_QUERIES = {
    1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8, 9: q9,
    10: q10, 11: q11, 12: q12, 13: q13, 14: q14, 15: q15, 16: q16,
    17: q17, 18: q18, 19: q19, 20: q20, 21: q21, 22: q22,
}

SUPPORTED_QUERIES = sorted(_QUERIES)


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


def tpch_plan(n: int, sf: float = 1.0,
              clustered: bool = False) -> PlanBuilder:
    """Plan for Q{n}; ``clustered=True`` picks the merge-join/streaming
    variant where one exists. ``sf`` is the scale the tables were
    generated at: Q11's threshold reads it."""
    if clustered and n in CLUSTERED_QUERIES:
        return CLUSTERED_QUERIES[n]()
    try:
        q = _QUERIES[n]
    except KeyError:
        raise NotImplementedError(f"TPC-H Q{n} does not exist")
    return q(sf) if n == 11 else q()
