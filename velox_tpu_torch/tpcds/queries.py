"""TPC-DS query plans (reporting star-join subset).

Plan shapes mirror the reference's TPC-DS harness queries
(velox/benchmarks/tpcds; SQL text from the TPC-DS spec): q3/q42/q52/q55
are the classic date_dim x store_sales x item stars, q7 adds
customer_demographics + promotion, q19 adds customer/address/store with
a zip-mismatch predicate, q96 is a pure count star, q68-lite touches
the address dimension. Fact-table scans always probe replicated
dimension builds — exactly the broadcast-join shape the distributed
runner (parallel/pipeline.py) shards over the mesh.
"""

from __future__ import annotations

from velox_tpu_torch.plan import PlanBuilder


def _dim(table, columns, subfilter=None):
    return PlanBuilder().table_scan(table, columns=columns,
                                    subfilter=subfilter)


def q3() -> PlanBuilder:
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              "d_moy = 11")
    it = _dim("item", ["i_item_sk", "i_brand", "i_brand_id",
                       "i_manufact_id"],
              "i_manufact_id = 128")
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_ext_sales_price"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_item_sk", "ss_ext_sales_price",
                           "d_year"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["d_year", "i_brand", "i_brand_id",
                           "ss_ext_sales_price"])
        .aggregate(["d_year", "i_brand_id", "i_brand"],
                   ["sum(ss_ext_sales_price) AS sum_agg"])
        .order_by(["d_year", "sum_agg DESC", "i_brand_id"])
        .limit(100)
    )


def _brand_star(manager_id: int, moy: int, year: int,
                brand_cols=("i_brand", "i_brand_id")) -> PlanBuilder:
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_moy = {moy} AND d_year = {year}")
    it = _dim("item", ["i_item_sk", *brand_cols, "i_manager_id"],
              f"i_manager_id = {manager_id}")
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_ext_sales_price"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_item_sk", "ss_ext_sales_price",
                           "d_year"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["d_year", *brand_cols,
                           "ss_ext_sales_price"])
        .aggregate(["d_year", *brand_cols],
                   ["sum(ss_ext_sales_price) AS ext_price"])
        .order_by(["d_year", "ext_price DESC", f"{brand_cols[1]}"])
        .limit(100)
    )


def q42() -> PlanBuilder:
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              "d_moy = 11 AND d_year = 2000")
    it = _dim("item", ["i_item_sk", "i_category_id", "i_category",
                       "i_manager_id"], "i_manager_id = 1")
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_ext_sales_price"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_item_sk", "ss_ext_sales_price",
                           "d_year"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["d_year", "i_category_id", "i_category",
                           "ss_ext_sales_price"])
        .aggregate(["d_year", "i_category_id", "i_category"],
                   ["sum(ss_ext_sales_price) AS total"])
        .order_by(["total DESC", "d_year", "i_category_id",
                   "i_category"])
        .limit(100)
    )


def q52() -> PlanBuilder:
    return _brand_star(manager_id=1, moy=11, year=2000)


def q55() -> PlanBuilder:
    return _brand_star(manager_id=28, moy=11, year=1999)


def q7() -> PlanBuilder:
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_gender", "cd_marital_status",
               "cd_education_status"],
              "cd_gender = 'M' AND cd_marital_status = 'S' AND "
              "cd_education_status = 'College'")
    dt = _dim("date_dim", ["d_date_sk", "d_year"], "d_year = 2000")
    pr = _dim("promotion",
              ["p_promo_sk", "p_channel_email", "p_channel_event"],
              "p_channel_email = 'N' OR p_channel_event = 'N'")
    it = _dim("item", ["i_item_sk", "i_item_id"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_cdemo_sk", "ss_promo_sk",
                             "ss_quantity", "ss_list_price",
                             "ss_coupon_amt", "ss_sales_price"])
        .hash_join(cd, ["ss_cdemo_sk"], ["cd_demo_sk"], "left_semi")
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(pr, ["ss_promo_sk"], ["p_promo_sk"], "left_semi")
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["i_item_id", "ss_quantity", "ss_list_price",
                           "ss_coupon_amt", "ss_sales_price"])
        .aggregate(["i_item_id"],
                   ["avg(ss_quantity) AS agg1",
                    "avg(ss_list_price) AS agg2",
                    "avg(ss_coupon_amt) AS agg3",
                    "avg(ss_sales_price) AS agg4"])
        .order_by(["i_item_id"])
        .limit(100)
    )


def q19() -> PlanBuilder:
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              "d_moy = 11 AND d_year = 1999")
    it = _dim("item", ["i_item_sk", "i_brand_id", "i_brand",
                       "i_manufact_id", "i_manager_id"],
              "i_manager_id = 8")
    cu = _dim("customer", ["c_customer_sk", "c_current_addr_sk"])
    ca = _dim("customer_address", ["ca_address_sk", "ca_zip"])
    st = _dim("store", ["s_store_sk", "s_state"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_customer_sk", "ss_store_sk",
                             "ss_ext_sales_price"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["ss_customer_sk", "ss_store_sk",
                           "ss_ext_sales_price", "i_brand_id",
                           "i_brand", "i_manufact_id"])
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["ss_store_sk", "ss_ext_sales_price",
                           "i_brand_id", "i_brand", "i_manufact_id",
                           "c_current_addr_sk"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner",
                   output=["ss_store_sk", "ss_ext_sales_price",
                           "i_brand_id", "i_brand", "i_manufact_id",
                           "ca_zip"])
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["ss_ext_sales_price", "i_brand_id",
                           "i_brand", "i_manufact_id", "ca_zip",
                           "s_state"])
        .aggregate(["i_brand_id", "i_brand", "i_manufact_id"],
                   ["sum(ss_ext_sales_price) AS ext_price"])
        .order_by(["ext_price DESC", "i_brand_id"])
        .limit(100)
    )


def q96() -> PlanBuilder:
    dt = _dim("date_dim", ["d_date_sk", "d_dom"], "d_dom = 25")
    st = _dim("store", ["s_store_sk", "s_state"], "s_state = 'TX'")
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "left_semi")
        .aggregate([], ["count(*) AS cnt"])
    )


def q13() -> PlanBuilder:
    """Demographic/address OR-band averages (spec q13 shape; the
    net-profit band rides ss_ext_discount_amt — the generator's
    closest measure)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year"], "d_year = 2001")
    st = _dim("store", ["s_store_sk"])
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_marital_status",
               "cd_education_status"])
    cu = _dim("customer", ["c_customer_sk", "c_current_addr_sk"])
    ca = _dim("customer_address", ["ca_address_sk", "ca_state"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_cdemo_sk", "ss_customer_sk",
                             "ss_quantity", "ss_sales_price",
                             "ss_ext_sales_price", "ss_wholesale_cost",
                             "ss_ext_discount_amt"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "left_semi")
        .hash_join(cd, ["ss_cdemo_sk"], ["cd_demo_sk"], "inner",
                   output=["ss_customer_sk", "ss_quantity",
                           "ss_sales_price", "ss_ext_sales_price",
                           "ss_wholesale_cost", "ss_ext_discount_amt",
                           "cd_marital_status", "cd_education_status"])
        .filter("(cd_marital_status = 'M' AND "
                "cd_education_status = 'Advanced Degree' AND "
                "ss_sales_price >= 100.0 AND ss_sales_price <= 150.0)"
                " OR (cd_marital_status = 'S' AND "
                "cd_education_status = 'College' AND "
                "ss_sales_price >= 50.0 AND ss_sales_price <= 100.0)"
                " OR (cd_marital_status = 'W' AND "
                "cd_education_status = '2 yr Degree' AND "
                "ss_sales_price >= 150.0 AND ss_sales_price <= 200.0)")
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["ss_quantity", "ss_ext_sales_price",
                           "ss_wholesale_cost", "ss_ext_discount_amt",
                           "c_current_addr_sk"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner",
                   output=["ss_quantity", "ss_ext_sales_price",
                           "ss_wholesale_cost", "ss_ext_discount_amt",
                           "ca_state"])
        .filter("(ca_state IN ('TX', 'OH', 'CA') AND "
                "ss_ext_discount_amt >= 0.0 AND "
                "ss_ext_discount_amt <= 200.0)"
                " OR (ca_state IN ('NY', 'KS', 'MI') AND "
                "ss_ext_discount_amt >= 150.0 AND "
                "ss_ext_discount_amt <= 300.0)"
                " OR (ca_state IN ('AL', 'GA', 'TN') AND "
                "ss_ext_discount_amt >= 50.0 AND "
                "ss_ext_discount_amt <= 250.0)")
        .aggregate([], ["avg(ss_quantity) AS a1",
                        "avg(ss_ext_sales_price) AS a2",
                        "avg(ss_wholesale_cost) AS a3",
                        "sum(ss_wholesale_cost) AS s1"])
    )


def q27() -> PlanBuilder:
    """Rollup (i_item_id, s_state) averages over a demographic slice
    (spec q27 GROUP BY ROLLUP via the GroupId/Expand path)."""
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_gender", "cd_marital_status",
               "cd_education_status"],
              "cd_gender = 'F' AND cd_marital_status = 'S' AND "
              "cd_education_status = 'College'")
    dt = _dim("date_dim", ["d_date_sk", "d_year"], "d_year = 2002")
    st = _dim("store", ["s_store_sk", "s_state"])
    it = _dim("item", ["i_item_sk", "i_item_id"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_store_sk", "ss_cdemo_sk",
                             "ss_quantity", "ss_list_price",
                             "ss_coupon_amt", "ss_sales_price"])
        .hash_join(cd, ["ss_cdemo_sk"], ["cd_demo_sk"], "left_semi")
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["ss_item_sk", "ss_quantity",
                           "ss_list_price", "ss_coupon_amt",
                           "ss_sales_price", "s_state"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["i_item_id", "s_state", "ss_quantity",
                           "ss_list_price", "ss_coupon_amt",
                           "ss_sales_price"])
        .group_id([["i_item_id", "s_state"], ["i_item_id"], []])
        .aggregate(["i_item_id", "s_state", "group_id"],
                   ["avg(ss_quantity) AS agg1",
                    "avg(ss_list_price) AS agg2",
                    "avg(ss_coupon_amt) AS agg3",
                    "avg(ss_sales_price) AS agg4"])
        .order_by(["i_item_id", "s_state"])
        .limit(100)
    )


def q43() -> PlanBuilder:
    """Per-store day-of-week sales pivot (spec q43 shape)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_day_name"],
              "d_year = 2000")
    st = _dim("store", ["s_store_sk", "s_store_id", "s_store_name"])
    days = [("sun", "Sunday"), ("mon", "Monday"), ("tue", "Tuesday"),
            ("wed", "Wednesday"), ("thu", "Thursday"),
            ("fri", "Friday"), ("sat", "Saturday")]
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_sales_price"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_store_sk", "ss_sales_price",
                           "d_day_name"])
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["s_store_id", "s_store_name",
                           "ss_sales_price", "d_day_name"])
        .project(["s_store_id", "s_store_name"] + [
            f"if(d_day_name = '{full}', ss_sales_price, 0.0)"
            f" AS {abbr}_raw" for abbr, full in days])
        .aggregate(["s_store_id", "s_store_name"], [
            f"sum({abbr}_raw) AS {abbr}_sales" for abbr, _ in days])
        .order_by(["s_store_id"])
        .limit(100)
    )


def q48() -> PlanBuilder:
    """Total quantity under OR-band demographic/address predicates
    (spec q48 shape; discount bands stand in for net profit)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year"], "d_year = 2001")
    st = _dim("store", ["s_store_sk"])
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_marital_status",
               "cd_education_status"])
    cu = _dim("customer", ["c_customer_sk", "c_current_addr_sk"])
    ca = _dim("customer_address", ["ca_address_sk", "ca_state"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_cdemo_sk", "ss_customer_sk",
                             "ss_quantity", "ss_sales_price",
                             "ss_ext_discount_amt"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "left_semi")
        .hash_join(cd, ["ss_cdemo_sk"], ["cd_demo_sk"], "inner",
                   output=["ss_customer_sk", "ss_quantity",
                           "ss_sales_price", "ss_ext_discount_amt",
                           "cd_marital_status", "cd_education_status"])
        .filter("(cd_marital_status = 'M' AND "
                "cd_education_status = '4 yr Degree' AND "
                "ss_sales_price >= 100.0 AND ss_sales_price <= 150.0)"
                " OR (cd_marital_status = 'D' AND "
                "cd_education_status = '2 yr Degree' AND "
                "ss_sales_price >= 50.0 AND ss_sales_price <= 100.0)"
                " OR (cd_marital_status = 'S' AND "
                "cd_education_status = 'College' AND "
                "ss_sales_price >= 150.0 AND ss_sales_price <= 200.0)")
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["ss_quantity", "ss_ext_discount_amt",
                           "c_current_addr_sk"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner",
                   output=["ss_quantity", "ss_ext_discount_amt",
                           "ca_state"])
        .filter("(ca_state IN ('TX', 'NY') AND "
                "ss_ext_discount_amt >= 0.0 AND "
                "ss_ext_discount_amt <= 2000.0)"
                " OR (ca_state IN ('CA', 'OH') AND "
                "ss_ext_discount_amt >= 150.0 AND "
                "ss_ext_discount_amt <= 3000.0)"
                " OR (ca_state IN ('GA', 'IL') AND "
                "ss_ext_discount_amt >= 50.0 AND "
                "ss_ext_discount_amt <= 25000.0)")
        .aggregate([], ["sum(ss_quantity) AS total_qty"])
    )


def q53() -> PlanBuilder:
    """Quarterly manufacturer sums vs their windowed average (spec
    q53's AVG() OVER (PARTITION BY i_manufact_id) deviation filter)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_qoy"],
              "d_year = 2000")
    it = _dim("item", ["i_item_sk", "i_manufact_id"],
              "i_manufact_id >= 100 AND i_manufact_id <= 140")
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_sales_price"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_item_sk", "ss_sales_price", "d_qoy"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["i_manufact_id", "d_qoy",
                           "ss_sales_price"])
        .aggregate(["i_manufact_id", "d_qoy"],
                   ["sum(ss_sales_price) AS sum_sales"])
        .window(["i_manufact_id"], [],
                ["avg(sum_sales) AS avg_quarterly_sales"])
        .filter("avg_quarterly_sales > 0.0 AND "
                "abs(sum_sales - avg_quarterly_sales)"
                " / avg_quarterly_sales > 0.1")
        .order_by(["avg_quarterly_sales", "sum_sales",
                   "i_manufact_id"])
        .limit(100)
    )


def q65() -> PlanBuilder:
    """Underperforming (store, item) revenue pairs vs 10% of the
    store's average revenue (spec q65 self-join of aggregations)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year"], "d_year = 2000")

    def revenue():
        return (PlanBuilder()
                .table_scan("store_sales",
                            columns=["ss_sold_date_sk", "ss_item_sk",
                                     "ss_store_sk", "ss_sales_price"])
                .hash_join(_dim("date_dim", ["d_date_sk", "d_year"],
                                "d_year = 2000"),
                           ["ss_sold_date_sk"], ["d_date_sk"],
                           "left_semi")
                .aggregate(["ss_store_sk", "ss_item_sk"],
                           ["sum(ss_sales_price) AS revenue"]))

    sc = (revenue()
          .aggregate(["ss_store_sk"], ["avg(revenue) AS ave"])
          .project(["ss_store_sk AS sb_store_sk", "ave"]))
    st = _dim("store", ["s_store_sk", "s_store_name"])
    it = _dim("item", ["i_item_sk", "i_item_id",
                       "i_current_price"])
    return (
        revenue()
        .hash_join(sc, ["ss_store_sk"], ["sb_store_sk"], "inner",
                   output=["ss_store_sk", "ss_item_sk", "revenue",
                           "ave"])
        .filter("revenue <= 0.1 * ave")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["s_store_name", "ss_item_sk", "revenue"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["s_store_name", "i_item_id",
                           "i_current_price", "revenue"])
        .order_by(["s_store_name", "i_item_id"])
        .limit(100)
    )


def q1(year: int = 2000, state: str = "TN") -> PlanBuilder:
    """Customers whose store returns exceed 1.2x the store average
    (spec q1: customer_total_return CTE + correlated avg subquery,
    planned as agg self-join like the reference's decorrelation)."""
    def ctr():
        return (PlanBuilder()
                .table_scan("store_returns",
                            columns=["sr_returned_date_sk",
                                     "sr_customer_sk", "sr_store_sk",
                                     "sr_return_amt"])
                .hash_join(_dim("date_dim", ["d_date_sk", "d_year"],
                                f"d_year = {year}"),
                           ["sr_returned_date_sk"], ["d_date_sk"],
                           "left_semi")
                .aggregate(["sr_customer_sk", "sr_store_sk"],
                           ["sum(sr_return_amt) AS ctr_total_return"]))

    avg_by_store = (ctr()
                    .aggregate(["sr_store_sk"],
                               ["avg(ctr_total_return) AS ctr_avg"])
                    .project(["sr_store_sk AS avg_store_sk", "ctr_avg"]))
    st = _dim("store", ["s_store_sk", "s_state"],
              f"s_state = '{state}'")
    cu = _dim("customer", ["c_customer_sk", "c_customer_id"])
    return (
        ctr()
        .hash_join(avg_by_store, ["sr_store_sk"], ["avg_store_sk"],
                   "inner",
                   output=["sr_customer_sk", "sr_store_sk",
                           "ctr_total_return", "ctr_avg"])
        .filter("ctr_total_return > 1.2 * ctr_avg")
        .hash_join(st, ["sr_store_sk"], ["s_store_sk"], "left_semi")
        .hash_join(cu, ["sr_customer_sk"], ["c_customer_sk"], "inner",
                   output=["c_customer_id"])
        .order_by(["c_customer_id"])
        .limit(100)
    )


def q6(month_seq: int = 1200, min_count: int = 10,
       factor: float = 1.2) -> PlanBuilder:
    """States where >= min_count customers bought items priced over
    1.2x their category average in one month (spec q6; the category
    average subquery decorrelates to an item-side agg join)."""
    cat_avg = (PlanBuilder()
               .table_scan("item",
                           columns=["i_category", "i_current_price"])
               .aggregate(["i_category"],
                          ["avg(i_current_price) AS cat_avg"])
               .project(["i_category AS avg_category", "cat_avg"]))
    it = (PlanBuilder()
          .table_scan("item", columns=["i_item_sk", "i_category",
                                       "i_current_price"])
          .hash_join(cat_avg, ["i_category"], ["avg_category"], "inner",
                     output=["i_item_sk", "i_current_price", "cat_avg"])
          .filter(f"i_current_price > {factor} * cat_avg"))
    dt = _dim("date_dim", ["d_date_sk", "d_month_seq"],
              f"d_month_seq = {month_seq}")
    cu = _dim("customer", ["c_customer_sk", "c_current_addr_sk"])
    ca = _dim("customer_address", ["ca_address_sk", "ca_state"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_customer_sk"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "left_semi")
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["c_current_addr_sk"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner", output=["ca_state"])
        .aggregate(["ca_state"], ["count(*) AS cnt"])
        .filter(f"cnt >= {min_count}")
        .order_by(["cnt", "ca_state"])
        .limit(100)
    )


def _channel_ratio(fact: str, pfx: str, date_col: str, item_col: str,
                   price_col: str, categories, start: str,
                   days: int = 30) -> PlanBuilder:
    """q12/q20/q98 shape: item revenue + share of its class via a
    window sum (spec's sum(sum())over(partition by i_class))."""
    import datetime as _dt

    d0 = _dt.date.fromisoformat(start)
    d1 = d0 + _dt.timedelta(days=days)
    cats = ", ".join(f"'{c}'" for c in categories)
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{d0}' AND DATE '{d1}'")
    it = _dim("item", ["i_item_sk", "i_item_id", "i_item_desc",
                       "i_category", "i_class", "i_current_price"],
              f"i_category IN ({cats})")
    return (
        PlanBuilder()
        .table_scan(fact, columns=[date_col, item_col, price_col])
        .hash_join(dt, [date_col], ["d_date_sk"], "left_semi")
        .hash_join(it, [item_col], ["i_item_sk"], "inner",
                   output=["i_item_id", "i_item_desc", "i_category",
                           "i_class", "i_current_price", price_col])
        .aggregate(["i_item_id", "i_item_desc", "i_category",
                    "i_class", "i_current_price"],
                   [f"sum({price_col}) AS itemrevenue"])
        .window(["i_class"], [], ["sum(itemrevenue) AS class_rev"])
        .project(["i_item_id", "i_item_desc", "i_category", "i_class",
                  "i_current_price", "itemrevenue",
                  "itemrevenue * 100.0 / class_rev AS revenueratio"])
        .order_by(["i_category", "i_class", "i_item_id", "i_item_desc",
                   "revenueratio"])
        .limit(100)
    )


def q12(categories=("Sports", "Books", "Home"),
        start: str = "1999-02-22") -> PlanBuilder:
    return _channel_ratio("web_sales", "ws", "ws_sold_date_sk",
                          "ws_item_sk", "ws_ext_sales_price",
                          categories, start)


def q20(categories=("Sports", "Books", "Home"),
        start: str = "1999-02-22") -> PlanBuilder:
    return _channel_ratio("catalog_sales", "cs", "cs_sold_date_sk",
                          "cs_item_sk", "cs_ext_sales_price",
                          categories, start)


def q98(categories=("Sports", "Books", "Home"),
        start: str = "1999-02-22") -> PlanBuilder:
    return _channel_ratio("store_sales", "ss", "ss_sold_date_sk",
                          "ss_item_sk", "ss_ext_sales_price",
                          categories, start)


def q15(year: int = 2001, qoy: int = 2) -> PlanBuilder:
    """Catalog sales by buyer zip: zip-prefix OR state OR big-ticket
    predicate (spec q15)."""
    cu = _dim("customer", ["c_customer_sk", "c_current_addr_sk"])
    ca = _dim("customer_address", ["ca_address_sk", "ca_state",
                                   "ca_zip"])
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_qoy"],
              f"d_qoy = {qoy} AND d_year = {year}")
    return (
        PlanBuilder()
        .table_scan("catalog_sales",
                    columns=["cs_sold_date_sk", "cs_bill_customer_sk",
                             "cs_sales_price"])
        .hash_join(dt, ["cs_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(cu, ["cs_bill_customer_sk"], ["c_customer_sk"],
                   "inner",
                   output=["cs_sales_price", "c_current_addr_sk"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner",
                   output=["cs_sales_price", "ca_state", "ca_zip"])
        .filter("substr(ca_zip, 1, 5) IN ('85669', '86197', '88274', "
                "'83405', '86475', '85392', '85460', '80348', '81792')"
                " OR ca_state IN ('CA', 'WA', 'GA')"
                " OR cs_sales_price > 500.0")
        .aggregate(["ca_zip"], ["sum(cs_sales_price) AS total"])
        .order_by(["ca_zip"])
        .limit(100)
    )


def q26(year: int = 2000) -> PlanBuilder:
    """q7's demographic/promotion star on the catalog channel."""
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_gender", "cd_marital_status",
               "cd_education_status"],
              "cd_gender = 'M' AND cd_marital_status = 'S' AND "
              "cd_education_status = 'College'")
    dt = _dim("date_dim", ["d_date_sk", "d_year"], f"d_year = {year}")
    pr = _dim("promotion",
              ["p_promo_sk", "p_channel_email", "p_channel_event"],
              "p_channel_email = 'N' OR p_channel_event = 'N'")
    it = _dim("item", ["i_item_sk", "i_item_id"])
    return (
        PlanBuilder()
        .table_scan("catalog_sales",
                    columns=["cs_sold_date_sk", "cs_item_sk",
                             "cs_bill_cdemo_sk", "cs_promo_sk",
                             "cs_quantity", "cs_list_price",
                             "cs_coupon_amt", "cs_sales_price"])
        .hash_join(cd, ["cs_bill_cdemo_sk"], ["cd_demo_sk"],
                   "left_semi")
        .hash_join(dt, ["cs_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(pr, ["cs_promo_sk"], ["p_promo_sk"], "left_semi")
        .hash_join(it, ["cs_item_sk"], ["i_item_sk"], "inner",
                   output=["i_item_id", "cs_quantity", "cs_list_price",
                           "cs_coupon_amt", "cs_sales_price"])
        .aggregate(["i_item_id"],
                   ["avg(cs_quantity) AS agg1",
                    "avg(cs_list_price) AS agg2",
                    "avg(cs_coupon_amt) AS agg3",
                    "avg(cs_sales_price) AS agg4"])
        .order_by(["i_item_id"])
        .limit(100)
    )


def q30(year: int = 2000, state: str = "IL") -> PlanBuilder:
    """Web-return outliers per (customer, state) vs 1.2x state average
    (spec q30, decorrelated agg self-join)."""
    def ctr():
        return (PlanBuilder()
                .table_scan("web_returns",
                            columns=["wr_returned_date_sk",
                                     "wr_returning_customer_sk",
                                     "wr_returning_addr_sk",
                                     "wr_return_amt"])
                .hash_join(_dim("date_dim", ["d_date_sk", "d_year"],
                                f"d_year = {year}"),
                           ["wr_returned_date_sk"], ["d_date_sk"],
                           "left_semi")
                .hash_join(_dim("customer_address",
                                ["ca_address_sk", "ca_state"]),
                           ["wr_returning_addr_sk"], ["ca_address_sk"],
                           "inner",
                           output=["wr_returning_customer_sk",
                                   "ca_state", "wr_return_amt"])
                .aggregate(["wr_returning_customer_sk", "ca_state"],
                           ["sum(wr_return_amt) AS ctr_total_return"]))

    avg_by_state = (ctr()
                    .aggregate(["ca_state"],
                               ["avg(ctr_total_return) AS ctr_avg"])
                    .project(["ca_state AS avg_state", "ctr_avg"]))
    cu = _dim("customer", ["c_customer_sk", "c_customer_id",
                           "c_first_name", "c_last_name",
                           "c_current_addr_sk"])
    ca2 = _dim("customer_address", ["ca_address_sk", "ca_state"],
               f"ca_state = '{state}'")
    return (
        ctr()
        .hash_join(avg_by_state, ["ca_state"], ["avg_state"], "inner",
                   output=["wr_returning_customer_sk", "ca_state",
                           "ctr_total_return", "ctr_avg"])
        .filter("ctr_total_return > 1.2 * ctr_avg")
        .hash_join(cu, ["wr_returning_customer_sk"], ["c_customer_sk"],
                   "inner",
                   output=["c_customer_id", "c_first_name",
                           "c_last_name", "c_current_addr_sk",
                           "ctr_total_return"])
        .hash_join(ca2, ["c_current_addr_sk"], ["ca_address_sk"],
                   "left_semi")
        .order_by(["c_customer_id", "c_first_name", "c_last_name",
                   "ctr_total_return"])
        .limit(100)
    )


def q81(year: int = 2000, state: str = "IL") -> PlanBuilder:
    """q30 on the catalog channel (spec q81)."""
    def ctr():
        return (PlanBuilder()
                .table_scan("catalog_returns",
                            columns=["cr_returned_date_sk",
                                     "cr_returning_customer_sk",
                                     "cr_returning_addr_sk",
                                     "cr_return_amt_inc_tax"])
                .hash_join(_dim("date_dim", ["d_date_sk", "d_year"],
                                f"d_year = {year}"),
                           ["cr_returned_date_sk"], ["d_date_sk"],
                           "left_semi")
                .hash_join(_dim("customer_address",
                                ["ca_address_sk", "ca_state"]),
                           ["cr_returning_addr_sk"], ["ca_address_sk"],
                           "inner",
                           output=["cr_returning_customer_sk",
                                   "ca_state",
                                   "cr_return_amt_inc_tax"])
                .aggregate(["cr_returning_customer_sk", "ca_state"],
                           ["sum(cr_return_amt_inc_tax)"
                            " AS ctr_total_return"]))

    avg_by_state = (ctr()
                    .aggregate(["ca_state"],
                               ["avg(ctr_total_return) AS ctr_avg"])
                    .project(["ca_state AS avg_state", "ctr_avg"]))
    cu = _dim("customer", ["c_customer_sk", "c_customer_id",
                           "c_first_name", "c_last_name",
                           "c_current_addr_sk"])
    ca2 = _dim("customer_address", ["ca_address_sk", "ca_state"],
               f"ca_state = '{state}'")
    return (
        ctr()
        .hash_join(avg_by_state, ["ca_state"], ["avg_state"], "inner",
                   output=["cr_returning_customer_sk", "ca_state",
                           "ctr_total_return", "ctr_avg"])
        .filter("ctr_total_return > 1.2 * ctr_avg")
        .hash_join(cu, ["cr_returning_customer_sk"], ["c_customer_sk"],
                   "inner",
                   output=["c_customer_id", "c_first_name",
                           "c_last_name", "c_current_addr_sk",
                           "ctr_total_return"])
        .hash_join(ca2, ["c_current_addr_sk"], ["ca_address_sk"],
                   "left_semi")
        .order_by(["c_customer_id", "c_first_name", "c_last_name",
                   "ctr_total_return"])
        .limit(100)
    )


_CHANNELS3 = (
    ("store_sales", "ss_sold_date_sk", "ss_item_sk", "ss_addr_sk",
     "ss_ext_sales_price"),
    ("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
     "cs_bill_addr_sk", "cs_ext_sales_price"),
    ("web_sales", "ws_sold_date_sk", "ws_item_sk", "ws_bill_addr_sk",
     "ws_ext_sales_price"),
)


def _multichannel(group_col: str, restrict_col: str,
                  restrict_filter: str, year: int, moy: int,
                  gmt: float) -> PlanBuilder:
    """q33/q56/q60 shape: per-item sales summed across all three
    channels (UNION ALL of channel aggs, re-aggregated), the item set
    restricted by an uncorrelated item subquery."""
    def channel(fact, dcol, icol, acol, pcol):
        keys = (PlanBuilder()
                .table_scan("item",
                            columns=[restrict_col]
                            + ([c for c in ("i_category", "i_color")
                                if c in restrict_filter]))
                .filter(restrict_filter)
                .project([restrict_col]).distinct()
                .project([f"{restrict_col} AS rk"]))
        it = (PlanBuilder()
              .table_scan("item", columns=["i_item_sk", group_col,
                                           restrict_col])
              .hash_join(keys, [restrict_col], ["rk"], "left_semi"))
        dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
                  f"d_year = {year} AND d_moy = {moy}")
        ca = _dim("customer_address",
                  ["ca_address_sk", "ca_gmt_offset"],
                  f"ca_gmt_offset = {gmt}")
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol, acol, pcol])
            .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
            .hash_join(ca, [acol], ["ca_address_sk"], "left_semi")
            .hash_join(it, [icol], ["i_item_sk"], "inner",
                       output=[group_col, pcol])
            .project([group_col, f"{pcol} AS part_sales"])
            .aggregate([group_col],
                       ["sum(part_sales) AS total_sales"]))

    chans = [channel(*c) for c in _CHANNELS3]
    return (
        chans[0]
        .union_all(chans[1:])
        .aggregate([group_col], ["sum(total_sales) AS total_sales"])
        .order_by(["total_sales", group_col])
        .limit(100)
    )


def q33(category: str = "Electronics", year: int = 2001,
        moy: int = 1, gmt: float = -5.0) -> PlanBuilder:
    """Manufacturer totals across channels for one category (spec
    q33)."""
    return _multichannel("i_manufact_id", "i_manufact_id",
                         f"i_category = '{category}'", year, moy, gmt)


def q56(colors=("slate", "blanched", "burnished"), year: int = 2001,
        moy: int = 2, gmt: float = -5.0) -> PlanBuilder:
    """Item-id totals across channels for a color set (spec q56)."""
    cs = ", ".join(f"'{c}'" for c in colors)
    return _multichannel("i_item_id", "i_item_id",
                         f"i_color IN ({cs})", year, moy, gmt)


def q60(category: str = "Music", year: int = 1998,
        moy: int = 9, gmt: float = -5.0) -> PlanBuilder:
    """Item-id totals across channels for one category (spec q60)."""
    return _multichannel("i_item_id", "i_item_id",
                         f"i_category = '{category}'", year, moy, gmt)


def _margin_rollup(fact: str, dcol: str, icol: str,
                   profit_col: str, price_col: str, year: int,
                   extra_join=None) -> PlanBuilder:
    """q36/q86 shape: gross-margin ROLLUP(i_category, i_class) with
    rank() within each hierarchy level (spec's grouping()-driven
    lochierarchy maps to the GroupIdNode's group_id column)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year"], f"d_year = {year}")
    it = _dim("item", ["i_item_sk", "i_category", "i_class"])
    pb = (PlanBuilder()
          .table_scan(fact, columns=[dcol, icol, profit_col,
                                     price_col]
                      + ([extra_join[0]] if extra_join else []))
          .hash_join(dt, [dcol], ["d_date_sk"], "left_semi"))
    if extra_join:
        fk, dim = extra_join
        pb = pb.hash_join(dim, [fk], dim.node.output_type.names[:1],
                          "left_semi")
    return (
        pb
        .hash_join(it, [icol], ["i_item_sk"], "inner",
                   output=["i_category", "i_class", profit_col,
                           price_col])
        .group_id([["i_category", "i_class"], ["i_category"], []])
        .aggregate(["i_category", "i_class", "group_id"],
                   [f"sum({profit_col}) AS profit",
                    f"sum({price_col}) AS sales"])
        .project(["i_category", "i_class", "group_id AS lochierarchy",
                  "profit / sales AS gross_margin",
                  "if(group_id = 0, i_category, '~all~')"
                  " AS parent_cat"])
        .window(["lochierarchy", "parent_cat"], ["gross_margin"],
                ["rank() AS rank_within_parent"])
        .order_by(["lochierarchy DESC", "parent_cat",
                   "rank_within_parent"])
        .limit(100)
    )


def q36(year: int = 2001) -> PlanBuilder:
    st = _dim("store", ["s_store_sk"])
    return _margin_rollup("store_sales", "ss_sold_date_sk",
                          "ss_item_sk", "ss_net_profit",
                          "ss_ext_sales_price", year,
                          extra_join=("ss_store_sk", st))


def q86(year: int = 2001) -> PlanBuilder:
    return _margin_rollup("web_sales", "ws_sold_date_sk",
                          "ws_item_sk", "ws_net_profit",
                          "ws_ext_sales_price", year)


def _inventory_items(fact: str, item_col: str, price_lo: float,
                     manufact_ids, start: str, qty_lo: int = 100,
                     qty_hi: int = 500, days: int = 60
                     ) -> PlanBuilder:
    """q37/q82 shape: items in a price band with mid-range inventory in
    a 60-day window that actually sold through the channel."""
    import datetime as _dt

    d0 = _dt.date.fromisoformat(start)
    d1 = d0 + _dt.timedelta(days=days)
    mids = ", ".join(str(m) for m in manufact_ids)
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{d0}' AND DATE '{d1}'")
    inv = (PlanBuilder()
           .table_scan("inventory",
                       columns=["inv_date_sk", "inv_item_sk",
                                "inv_quantity_on_hand"],
                       subfilter=f"inv_quantity_on_hand >= {qty_lo} "
                                 f"AND inv_quantity_on_hand <= {qty_hi}")
           .hash_join(dt, ["inv_date_sk"], ["d_date_sk"], "left_semi"))
    sold = PlanBuilder().table_scan(fact, columns=[item_col])
    return (
        PlanBuilder()
        .table_scan("item",
                    columns=["i_item_sk", "i_item_id", "i_item_desc",
                             "i_current_price", "i_manufact_id"],
                    subfilter=f"i_current_price >= {price_lo} AND "
                              f"i_current_price <= {price_lo + 30} AND "
                              f"i_manufact_id IN ({mids})")
        .hash_join(inv, ["i_item_sk"], ["inv_item_sk"], "left_semi")
        .hash_join(sold, ["i_item_sk"], [item_col], "left_semi")
        .project(["i_item_id", "i_item_desc", "i_current_price"])
        .distinct()
        .order_by(["i_item_id"])
        .limit(100)
    )


def q37(price_lo: float = 68.0,
        manufact_ids=(677, 940, 694, 808),
        start: str = "2000-02-01") -> PlanBuilder:
    return _inventory_items("catalog_sales", "cs_item_sk", price_lo,
                            manufact_ids, start)


def q82(price_lo: float = 62.0,
        manufact_ids=(129, 270, 821, 423),
        start: str = "2000-05-25") -> PlanBuilder:
    return _inventory_items("store_sales", "ss_item_sk", price_lo,
                            manufact_ids, start)


def q40(split_date: str = "2000-03-11", price_lo: float = 0.99,
        price_hi: float = 1.49) -> PlanBuilder:
    """Warehouse sales before/after a date with returns netted out
    (spec q40: catalog_sales LEFT OUTER catalog_returns on
    (order, item))."""
    import datetime as _dt

    d0 = _dt.date.fromisoformat(split_date)
    lo = d0 - _dt.timedelta(days=30)
    hi = d0 + _dt.timedelta(days=30)
    cr = _dim("catalog_returns",
              ["cr_order_number", "cr_item_sk", "cr_refunded_cash"])
    wh = _dim("warehouse", ["w_warehouse_sk", "w_state"])
    it = _dim("item", ["i_item_sk", "i_item_id", "i_current_price"],
              f"i_current_price >= {price_lo} AND "
              f"i_current_price <= {price_hi}")
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{lo}' AND DATE '{hi}'")
    return (
        PlanBuilder()
        .table_scan("catalog_sales",
                    columns=["cs_sold_date_sk", "cs_order_number",
                             "cs_item_sk", "cs_warehouse_sk",
                             "cs_sales_price"])
        .hash_join(cr, ["cs_order_number", "cs_item_sk"],
                   ["cr_order_number", "cr_item_sk"], "left",
                   output=["cs_sold_date_sk", "cs_item_sk",
                           "cs_warehouse_sk", "cs_sales_price",
                           "cr_refunded_cash"])
        .hash_join(wh, ["cs_warehouse_sk"], ["w_warehouse_sk"],
                   "inner",
                   output=["cs_sold_date_sk", "cs_item_sk",
                           "cs_sales_price", "cr_refunded_cash",
                           "w_state"])
        .hash_join(it, ["cs_item_sk"], ["i_item_sk"], "inner",
                   output=["cs_sold_date_sk", "cs_sales_price",
                           "cr_refunded_cash", "w_state", "i_item_id"])
        .hash_join(dt, ["cs_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["cs_sales_price", "cr_refunded_cash",
                           "w_state", "i_item_id", "d_date"])
        .project(["w_state", "i_item_id",
                  f"if(d_date < DATE '{d0}', cs_sales_price - "
                  "coalesce(cr_refunded_cash, 0.0), 0.0)"
                  " AS before_amt",
                  f"if(d_date >= DATE '{d0}', cs_sales_price - "
                  "coalesce(cr_refunded_cash, 0.0), 0.0)"
                  " AS after_amt"])
        .aggregate(["w_state", "i_item_id"],
                   ["sum(before_amt) AS sales_before",
                    "sum(after_amt) AS sales_after"])
        .order_by(["w_state", "i_item_id"])
        .limit(100)
    )


def q50(year: int = 2001, moy: int = 8) -> PlanBuilder:
    """Return-latency buckets per store (spec q50: sales joined to
    their returns on (ticket, item, customer); date_sks are julian
    days so the day difference is the sk difference)."""
    dt2 = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
               f"d_year = {year} AND d_moy = {moy}")
    st = _dim("store", ["s_store_sk", "s_store_name", "s_company_id",
                        "s_street_number", "s_street_name",
                        "s_street_type", "s_suite_number", "s_city",
                        "s_county", "s_state", "s_zip"])
    sr = (PlanBuilder()
          .table_scan("store_returns",
                      columns=["sr_ticket_number", "sr_item_sk",
                               "sr_customer_sk",
                               "sr_returned_date_sk"])
          .hash_join(dt2, ["sr_returned_date_sk"], ["d_date_sk"],
                     "left_semi"))
    buckets = [
        ("d30", "lag <= 30"),
        ("d60", "lag > 30 AND lag <= 60"),
        ("d90", "lag > 60 AND lag <= 90"),
        ("d120", "lag > 90 AND lag <= 120"),
        ("dmore", "lag > 120"),
    ]
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_ticket_number", "ss_item_sk",
                             "ss_customer_sk", "ss_sold_date_sk",
                             "ss_store_sk"])
        .hash_join(sr, ["ss_ticket_number", "ss_item_sk",
                        "ss_customer_sk"],
                   ["sr_ticket_number", "sr_item_sk",
                    "sr_customer_sk"], "inner",
                   output=["ss_sold_date_sk", "ss_store_sk",
                           "sr_returned_date_sk"])
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["ss_sold_date_sk", "sr_returned_date_sk",
                           "s_store_name", "s_company_id",
                           "s_street_number", "s_street_name",
                           "s_street_type", "s_suite_number",
                           "s_city", "s_county", "s_state", "s_zip"])
        .project(["s_store_name", "s_company_id", "s_street_number",
                  "s_street_name", "s_street_type", "s_suite_number",
                  "s_city", "s_county", "s_state", "s_zip",
                  "sr_returned_date_sk - ss_sold_date_sk AS lag"])
        .project(["s_store_name", "s_company_id", "s_street_number",
                  "s_street_name", "s_street_type", "s_suite_number",
                  "s_city", "s_county", "s_state", "s_zip"] + [
                  f"if({cond}, 1, 0) AS {name}_raw"
                  for name, cond in buckets])
        .aggregate(["s_store_name", "s_company_id", "s_street_number",
                    "s_street_name", "s_street_type",
                    "s_suite_number", "s_city", "s_county", "s_state",
                    "s_zip"],
                   [f"sum({name}_raw) AS {name}"
                    for name, _ in buckets])
        .order_by(["s_store_name", "s_company_id", "s_street_number"])
        .limit(100)
    )


def _ship_buckets(fact, dcol, shipcol, whcol, smcol, sitecol,
                  site_table, site_key, site_name, month_seq_lo):
    """q62/q99 shape: shipping-latency buckets per (warehouse,
    ship mode, site); date_sks are julian days so the lag is the sk
    difference."""
    dt = _dim("date_dim", ["d_date_sk", "d_month_seq"],
              f"d_month_seq >= {month_seq_lo} AND "
              f"d_month_seq <= {month_seq_lo + 11}")
    wh = _dim("warehouse", ["w_warehouse_sk", "w_warehouse_name"])
    sm = _dim("ship_mode", ["sm_ship_mode_sk", "sm_type"])
    st = _dim(site_table, [site_key, site_name])
    buckets = [("d30", "lag <= 30"),
               ("d60", "lag > 30 AND lag <= 60"),
               ("d90", "lag > 60 AND lag <= 90"),
               ("d120", "lag > 90 AND lag <= 120"),
               ("dmore", "lag > 120")]
    return (
        PlanBuilder()
        .table_scan(fact, columns=[dcol, shipcol, whcol, smcol,
                                   sitecol])
        .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
        .hash_join(wh, [whcol], ["w_warehouse_sk"], "inner",
                   output=[dcol, shipcol, smcol, sitecol,
                           "w_warehouse_name"])
        .hash_join(sm, [smcol], ["sm_ship_mode_sk"], "inner",
                   output=[dcol, shipcol, sitecol, "w_warehouse_name",
                           "sm_type"])
        .hash_join(st, [sitecol], [site_key], "inner",
                   output=[dcol, shipcol, "w_warehouse_name",
                           "sm_type", site_name])
        .project(["substr(w_warehouse_name, 1, 20) AS wname",
                  "sm_type", site_name,
                  f"{shipcol} - {dcol} AS lag"])
        .project(["wname", "sm_type", site_name] + [
            f"if({cond}, 1, 0) AS {n}_raw" for n, cond in buckets])
        .aggregate(["wname", "sm_type", site_name],
                   [f"sum({n}_raw) AS {n}" for n, _ in buckets])
        .order_by(["wname", "sm_type", site_name])
        .limit(100)
    )


def q62(month_seq_lo: int = 1200) -> PlanBuilder:
    return _ship_buckets(
        "web_sales", "ws_sold_date_sk", "ws_ship_date_sk",
        "ws_warehouse_sk", "ws_ship_mode_sk", "ws_web_site_sk",
        "web_site", "web_site_sk", "web_name", month_seq_lo)


def q99(month_seq_lo: int = 1200) -> PlanBuilder:
    return _ship_buckets(
        "catalog_sales", "cs_sold_date_sk", "cs_ship_date_sk",
        "cs_warehouse_sk", "cs_ship_mode_sk", "cs_call_center_sk",
        "call_center", "cc_call_center_sk", "cc_name", month_seq_lo)


def q63(manager_ids=(1, 2, 3, 4, 5, 6, 7, 8), year: int = 2001
        ) -> PlanBuilder:
    """Monthly manager sales vs their average (q53's shape keyed on
    i_manager_id — spec q63)."""
    mids = ", ".join(str(m) for m in manager_ids)
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_year = {year}")
    it = _dim("item", ["i_item_sk", "i_manager_id"],
              f"i_manager_id IN ({mids})")
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_sales_price"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_item_sk", "ss_sales_price", "d_moy"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["i_manager_id", "d_moy", "ss_sales_price"])
        .aggregate(["i_manager_id", "d_moy"],
                   ["sum(ss_sales_price) AS sum_sales"])
        .window(["i_manager_id"], [],
                ["avg(sum_sales) AS avg_monthly_sales"])
        .filter("avg_monthly_sales > 0.0 AND "
                "abs(sum_sales - avg_monthly_sales)"
                " / avg_monthly_sales > 0.1")
        .order_by(["i_manager_id", "avg_monthly_sales", "sum_sales"])
        .limit(100)
    )


def q73(year: int = 2000, dep: int = 4, vehicle: int = 3,
        buy=("'>10000'", "'Unknown'"), cnt_lo: int = 1,
        cnt_hi: int = 5) -> PlanBuilder:
    """Tickets with 1-5 items for high-potential households (spec
    q73): per-(ticket, customer) counts with HAVING, joined back to
    customer names."""
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_dom"],
              f"d_dom >= 1 AND d_dom <= 2 AND d_year = {year}")
    st = _dim("store", ["s_store_sk"])
    hd = _dim("household_demographics",
              ["hd_demo_sk", "hd_buy_potential", "hd_dep_count",
               "hd_vehicle_count"],
              f"(hd_buy_potential = {buy[0]} OR "
              f"hd_buy_potential = {buy[1]}) AND "
              f"(hd_dep_count = {dep} OR hd_vehicle_count = {vehicle})")
    cu = _dim("customer", ["c_customer_sk", "c_last_name",
                           "c_first_name", "c_salutation",
                           "c_preferred_cust_flag"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_hdemo_sk", "ss_ticket_number",
                             "ss_customer_sk"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "left_semi")
        .hash_join(hd, ["ss_hdemo_sk"], ["hd_demo_sk"], "left_semi")
        .aggregate(["ss_ticket_number", "ss_customer_sk"],
                   ["count(*) AS cnt"])
        .filter(f"cnt >= {cnt_lo} AND cnt <= {cnt_hi}")
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["c_last_name", "c_first_name",
                           "c_salutation", "c_preferred_cust_flag",
                           "ss_ticket_number", "cnt"])
        .order_by(["cnt DESC", "c_last_name"])
        .limit(1000)
    )


def q79(year: int = 2000, dep: int = 6, vehicle: int = 2,
        employees=(200, 295)) -> PlanBuilder:
    """Monday-shopper ticket profits (spec q79)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_dow"],
              f"d_dow = 1 AND d_year = {year}")
    st = _dim("store", ["s_store_sk", "s_number_employees", "s_city"],
              f"s_number_employees >= {employees[0]} AND "
              f"s_number_employees <= {employees[1]}")
    hd = _dim("household_demographics",
              ["hd_demo_sk", "hd_dep_count", "hd_vehicle_count"],
              f"hd_dep_count = {dep} OR hd_vehicle_count > {vehicle}")
    cu = _dim("customer", ["c_customer_sk", "c_last_name",
                           "c_first_name"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_hdemo_sk", "ss_ticket_number",
                             "ss_customer_sk", "ss_addr_sk",
                             "ss_coupon_amt", "ss_net_profit"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(hd, ["ss_hdemo_sk"], ["hd_demo_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["ss_ticket_number", "ss_customer_sk",
                           "ss_addr_sk", "ss_coupon_amt",
                           "ss_net_profit", "s_city"])
        .aggregate(["ss_ticket_number", "ss_customer_sk", "ss_addr_sk",
                    "s_city"],
                   ["sum(ss_coupon_amt) AS amt",
                    "sum(ss_net_profit) AS profit"])
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["c_last_name", "c_first_name", "s_city",
                           "ss_ticket_number", "amt", "profit"])
        .order_by(["c_last_name", "c_first_name", "s_city",
                   "profit DESC", "ss_ticket_number"])
        .limit(100)
    )


def q88(dep: int = 4, vehicle: int = 2) -> PlanBuilder:
    """Store traffic in 8 half-hour bands (spec q88's eight scalar
    subqueries computed as conditional counts in ONE pass — documented
    shape deviation, identical values)."""
    hd = _dim("household_demographics",
              ["hd_demo_sk", "hd_dep_count", "hd_vehicle_count"],
              f"(hd_dep_count = {dep} AND hd_vehicle_count <= "
              f"{dep + 2}) OR (hd_dep_count = {dep - 2} AND "
              f"hd_vehicle_count <= {dep}) OR (hd_dep_count = "
              f"{vehicle} AND hd_vehicle_count <= {vehicle + 2})")
    st = _dim("store", ["s_store_sk"])
    td = _dim("time_dim", ["t_time_sk", "t_hour", "t_minute"],
              "t_hour >= 8 AND t_hour <= 12")
    bands = [(f"h{h}_{m}", f"t_hour = {h} AND "
              + ("t_minute < 30" if m == 0 else "t_minute >= 30"))
             for h in (8, 9, 10, 11) for m in (0, 30)]
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_time_sk", "ss_hdemo_sk",
                             "ss_store_sk"])
        .hash_join(hd, ["ss_hdemo_sk"], ["hd_demo_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "left_semi")
        .hash_join(td, ["ss_sold_time_sk"], ["t_time_sk"], "inner",
                   output=["t_hour", "t_minute"])
        .project([f"if({cond}, 1, 0) AS {n}_raw" for n, cond in bands])
        .aggregate([], [f"sum({n}_raw) AS {n}" for n, _ in bands])
    )


def q90(dep: int = 6, am=(8, 9), pm=(19, 20),
        chars=(5000, 5200)) -> PlanBuilder:
    """AM/PM web traffic ratio (spec q90)."""
    hd = _dim("household_demographics", ["hd_demo_sk", "hd_dep_count"],
              f"hd_dep_count = {dep}")
    wp = _dim("web_page", ["wp_web_page_sk", "wp_char_count"],
              f"wp_char_count >= {chars[0]} AND "
              f"wp_char_count <= {chars[1]}")
    td = _dim("time_dim", ["t_time_sk", "t_hour"],
              f"(t_hour >= {am[0]} AND t_hour <= {am[1]}) OR "
              f"(t_hour >= {pm[0]} AND t_hour <= {pm[1]})")
    return (
        PlanBuilder()
        .table_scan("web_sales",
                    columns=["ws_sold_time_sk", "ws_ship_hdemo_sk",
                             "ws_web_page_sk"])
        .hash_join(hd, ["ws_ship_hdemo_sk"], ["hd_demo_sk"],
                   "left_semi")
        .hash_join(wp, ["ws_web_page_sk"], ["wp_web_page_sk"],
                   "left_semi")
        .hash_join(td, ["ws_sold_time_sk"], ["t_time_sk"], "inner",
                   output=["t_hour"])
        .project([f"if(t_hour <= {am[1]}, 1, 0) AS am_raw",
                  f"if(t_hour >= {pm[0]}, 1, 0) AS pm_raw"])
        .aggregate([], ["sum(am_raw) AS amc", "sum(pm_raw) AS pmc"])
        .project(["amc", "pmc",
                  "amc * 1.0 / pmc AS am_pm_ratio"])
    )


def q93(reason: str = "reason 1") -> PlanBuilder:
    """Actual sales after returns for one return reason (spec q93;
    the WHERE's reason equi-filter makes the outer join effectively
    inner on returns)."""
    rs = _dim("reason", ["r_reason_sk", "r_reason_desc"],
              f"r_reason_desc = '{reason}'")
    sr = (PlanBuilder()
          .table_scan("store_returns",
                      columns=["sr_ticket_number", "sr_item_sk",
                               "sr_reason_sk", "sr_return_quantity"])
          .hash_join(rs, ["sr_reason_sk"], ["r_reason_sk"],
                     "left_semi"))
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_ticket_number", "ss_item_sk",
                             "ss_customer_sk", "ss_quantity",
                             "ss_sales_price"])
        .hash_join(sr, ["ss_ticket_number", "ss_item_sk"],
                   ["sr_ticket_number", "sr_item_sk"], "inner",
                   output=["ss_customer_sk", "ss_quantity",
                           "sr_return_quantity", "ss_sales_price"])
        .project(["ss_customer_sk",
                  "(ss_quantity - sr_return_quantity) * "
                  "ss_sales_price AS act_sales"])
        .aggregate(["ss_customer_sk"],
                   ["sum(act_sales) AS sumsales"])
        .order_by(["sumsales", "ss_customer_sk"])
        .limit(100)
    )


def q97(month_seq_lo: int = 1200) -> PlanBuilder:
    """Store/catalog shopper overlap via FULL OUTER join of distinct
    (customer, item) sets (spec q97)."""
    dt = _dim("date_dim", ["d_date_sk", "d_month_seq"],
              f"d_month_seq >= {month_seq_lo} AND "
              f"d_month_seq <= {month_seq_lo + 11}")

    ssci = (PlanBuilder()
            .table_scan("store_sales",
                        columns=["ss_sold_date_sk", "ss_customer_sk",
                                 "ss_item_sk"])
            .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"],
                       "left_semi")
            .project(["ss_customer_sk", "ss_item_sk"])
            .distinct())
    csci = (PlanBuilder()
            .table_scan("catalog_sales",
                        columns=["cs_sold_date_sk",
                                 "cs_bill_customer_sk", "cs_item_sk"])
            .hash_join(_dim("date_dim", ["d_date_sk", "d_month_seq"],
                            f"d_month_seq >= {month_seq_lo} AND "
                            f"d_month_seq <= {month_seq_lo + 11}"),
                       ["cs_sold_date_sk"], ["d_date_sk"],
                       "left_semi")
            .project(["cs_bill_customer_sk", "cs_item_sk"])
            .distinct())
    return (
        ssci
        .hash_join(csci, ["ss_customer_sk", "ss_item_sk"],
                   ["cs_bill_customer_sk", "cs_item_sk"], "full",
                   output=["ss_customer_sk", "ss_item_sk",
                           "cs_bill_customer_sk", "cs_item_sk"])
        .project([
            "if(is_not_null(ss_customer_sk) AND "
            "is_null(cs_bill_customer_sk), 1, 0) AS s_only",
            "if(is_null(ss_customer_sk) AND "
            "is_not_null(cs_bill_customer_sk), 1, 0) AS c_only",
            "if(is_not_null(ss_customer_sk) AND "
            "is_not_null(cs_bill_customer_sk), 1, 0) AS both_raw"])
        .aggregate([], ["sum(s_only) AS store_only",
                        "sum(c_only) AS catalog_only",
                        "sum(both_raw) AS store_and_catalog"])
    )


def q68(year: int = 2000, dep: int = 4, vehicle: int = 3,
        cities=("Midway", "Fairview")) -> PlanBuilder:
    """Per-ticket spend for early-month city shoppers whose bought
    city differs from their current city (spec q68; two address
    roles)."""
    cs = ", ".join(f"'{c}'" for c in cities)
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_dom"],
              f"d_dom >= 1 AND d_dom <= 2 AND d_year = {year}")
    st = _dim("store", ["s_store_sk", "s_city"],
              f"s_city IN ({cs})")
    hd = _dim("household_demographics",
              ["hd_demo_sk", "hd_dep_count", "hd_vehicle_count"],
              f"hd_dep_count = {dep} OR hd_vehicle_count = {vehicle}")
    ca = _dim("customer_address", ["ca_address_sk", "ca_city"])
    cu = _dim("customer", ["c_customer_sk", "c_last_name",
                           "c_first_name", "c_current_addr_sk"])
    cur = (PlanBuilder()
           .table_scan("customer_address",
                       columns=["ca_address_sk", "ca_city"])
           .project(["ca_address_sk AS cur_addr_sk",
                     "ca_city AS current_city"]))
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_hdemo_sk", "ss_addr_sk",
                             "ss_ticket_number", "ss_customer_sk",
                             "ss_ext_sales_price", "ss_ext_list_price",
                             "ss_ext_tax"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "left_semi")
        .hash_join(hd, ["ss_hdemo_sk"], ["hd_demo_sk"], "left_semi")
        .hash_join(ca, ["ss_addr_sk"], ["ca_address_sk"], "inner",
                   output=["ss_ticket_number", "ss_customer_sk",
                           "ss_ext_sales_price", "ss_ext_list_price",
                           "ss_ext_tax", "ca_city"])
        .aggregate(["ss_ticket_number", "ss_customer_sk", "ca_city"],
                   ["sum(ss_ext_sales_price) AS extended_price",
                    "sum(ss_ext_list_price) AS list_price",
                    "sum(ss_ext_tax) AS extended_tax"])
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["c_last_name", "c_first_name",
                           "c_current_addr_sk", "ca_city",
                           "ss_ticket_number", "extended_price",
                           "list_price", "extended_tax"])
        .hash_join(cur, ["c_current_addr_sk"], ["cur_addr_sk"],
                   "inner",
                   output=["c_last_name", "c_first_name", "ca_city",
                           "current_city", "ss_ticket_number",
                           "extended_price", "list_price",
                           "extended_tax"])
        .filter("current_city <> ca_city")
        .order_by(["c_last_name", "ss_ticket_number"])
        .limit(100)
    )


def q21(split_date: str = "2000-03-11") -> PlanBuilder:
    """Warehouse inventory before/after a freshness date, kept when
    the after/before ratio stays within [2/3, 3/2] (spec q21)."""
    import datetime as _dt

    d0 = _dt.date.fromisoformat(split_date)
    lo = d0 - _dt.timedelta(days=30)
    hi = d0 + _dt.timedelta(days=30)
    wh = _dim("warehouse", ["w_warehouse_sk", "w_warehouse_name"])
    it = _dim("item", ["i_item_sk", "i_item_id", "i_current_price"],
              "i_current_price >= 0.99 AND i_current_price <= 1.49")
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{lo}' AND DATE '{hi}'")
    return (
        PlanBuilder()
        .table_scan("inventory",
                    columns=["inv_date_sk", "inv_item_sk",
                             "inv_warehouse_sk",
                             "inv_quantity_on_hand"])
        .hash_join(wh, ["inv_warehouse_sk"], ["w_warehouse_sk"],
                   "inner",
                   output=["inv_date_sk", "inv_item_sk",
                           "inv_quantity_on_hand",
                           "w_warehouse_name"])
        .hash_join(it, ["inv_item_sk"], ["i_item_sk"], "inner",
                   output=["inv_date_sk", "inv_quantity_on_hand",
                           "w_warehouse_name", "i_item_id"])
        .hash_join(dt, ["inv_date_sk"], ["d_date_sk"], "inner",
                   output=["inv_quantity_on_hand", "w_warehouse_name",
                           "i_item_id", "d_date"])
        .project(["w_warehouse_name", "i_item_id",
                  f"if(d_date < DATE '{d0}', inv_quantity_on_hand, 0)"
                  " AS qty_before",
                  f"if(d_date >= DATE '{d0}', inv_quantity_on_hand, 0)"
                  " AS qty_after"])
        .aggregate(["w_warehouse_name", "i_item_id"],
                   ["sum(qty_before) AS inv_before",
                    "sum(qty_after) AS inv_after"])
        .filter("inv_before > 0 "
                "AND inv_after >= inv_before * 2 / 3 "
                "AND inv_after <= inv_before * 3 / 2")
        .order_by(["w_warehouse_name", "i_item_id"])
        .limit(100)
    )


def q22(month_seq_lo: int = 1200) -> PlanBuilder:
    """Average quantity on hand by the item ROLLUP hierarchy over a
    year of inventory snapshots (spec q22)."""
    dt = _dim("date_dim", ["d_date_sk", "d_month_seq"],
              f"d_month_seq >= {month_seq_lo} AND "
              f"d_month_seq <= {month_seq_lo + 11}")
    it = _dim("item", ["i_item_sk", "i_product_name", "i_brand",
                       "i_class", "i_category"])
    return (
        PlanBuilder()
        .table_scan("inventory",
                    columns=["inv_date_sk", "inv_item_sk",
                             "inv_quantity_on_hand"])
        .hash_join(dt, ["inv_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(it, ["inv_item_sk"], ["i_item_sk"], "inner",
                   output=["i_product_name", "i_brand", "i_class",
                           "i_category", "inv_quantity_on_hand"])
        .group_id([["i_product_name", "i_brand", "i_class",
                    "i_category"],
                   ["i_product_name", "i_brand", "i_class"],
                   ["i_product_name", "i_brand"],
                   ["i_product_name"], []])
        .aggregate(["i_product_name", "i_brand", "i_class",
                    "i_category", "group_id"],
                   ["avg(inv_quantity_on_hand) AS qoh"])
        .order_by(["qoh", "i_product_name", "i_brand", "i_class",
                   "i_category"])
        .limit(100)
    )


def _q28_bucket(qlo: int, qhi: int, lp: float, coup: float,
                whole: float, i: int) -> PlanBuilder:
    """One q28 quantity bucket: avg/count/count-distinct of list
    price under a three-way price-band disjunction."""
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_quantity", "ss_list_price",
                             "ss_coupon_amt",
                             "ss_wholesale_cost"],
                    subfilter=f"ss_quantity >= {qlo} AND "
                              f"ss_quantity <= {qhi}")
        .filter(f"(ss_list_price >= {lp} AND "
                f"ss_list_price <= {lp + 10}) OR "
                f"(ss_coupon_amt >= {coup} AND "
                f"ss_coupon_amt <= {coup + 1000}) OR "
                f"(ss_wholesale_cost >= {whole} AND "
                f"ss_wholesale_cost <= {whole + 20})")
        .aggregate([], [f"avg(ss_list_price) AS b{i}_lp",
                        f"count(ss_list_price) AS b{i}_cnt",
                        f"count(distinct ss_list_price) AS b{i}_cntd"])
    )


def q28() -> PlanBuilder:
    """Six quantity-bucket list-price profiles as one pivot row
    (spec q28: cross join of six single-row aggregations)."""
    params = [(0, 5, 8.0, 459.0, 57.0), (6, 10, 90.0, 2323.0, 31.0),
              (11, 15, 142.0, 12214.0, 79.0),
              (16, 20, 135.0, 6071.0, 38.0),
              (21, 25, 122.0, 836.0, 17.0),
              (26, 30, 154.0, 7326.0, 7.0)]
    pb = _q28_bucket(*params[0], 1)
    for i, p in enumerate(params[1:], start=2):
        pb = pb.cross_join(_q28_bucket(*p, i))
    return pb.limit(100)


def q34(year: int = 2000, dep: int = 4, vehicle: int = 3,
        counties=("Williamson County",), cnt_lo: int = 15,
        cnt_hi: int = 20) -> PlanBuilder:
    """Bulk tickets (15-20 items) around month boundaries for
    high-potential households (spec q34 — the q73 shape with a
    county filter and a dom disjunction)."""
    cs = ", ".join(f"'{c}'" for c in counties)
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_dom"],
              f"(d_dom >= 1 AND d_dom <= 3 OR "
              f"d_dom >= 25 AND d_dom <= 28) AND "
              f"(d_year = {year} OR d_year = {year + 1} OR "
              f"d_year = {year + 2})")
    st = _dim("store", ["s_store_sk", "s_county"],
              f"s_county IN ({cs})")
    hd = _dim("household_demographics",
              ["hd_demo_sk", "hd_buy_potential", "hd_dep_count",
               "hd_vehicle_count"],
              f"(hd_buy_potential = '>10000' OR "
              f"hd_buy_potential = 'Unknown') AND "
              f"(hd_vehicle_count > 0) AND "
              f"(hd_dep_count / hd_vehicle_count > 1.2)")
    cu = _dim("customer", ["c_customer_sk", "c_last_name",
                           "c_first_name", "c_salutation",
                           "c_preferred_cust_flag"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_hdemo_sk", "ss_ticket_number",
                             "ss_customer_sk"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "left_semi")
        .hash_join(hd, ["ss_hdemo_sk"], ["hd_demo_sk"], "left_semi")
        .aggregate(["ss_ticket_number", "ss_customer_sk"],
                   ["count(*) AS cnt"])
        .filter(f"cnt >= {cnt_lo} AND cnt <= {cnt_hi}")
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["c_last_name", "c_first_name",
                           "c_salutation", "c_preferred_cust_flag",
                           "ss_ticket_number", "cnt"])
        .order_by(["c_last_name", "c_first_name", "c_salutation",
                   "c_preferred_cust_flag DESC", "ss_ticket_number"])
        .limit(1000)
    )


def q46(year: int = 2000, dep: int = 4, vehicle: int = 3,
        cities=("Fairview", "Midway")) -> PlanBuilder:
    """Weekend-ticket spend where the bought city differs from the
    customer's current city (spec q46 — the q68 shape on weekend
    days with profit/coupon amounts)."""
    cs = ", ".join(f"'{c}'" for c in cities)
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_dow"],
              f"(d_dow = 6 OR d_dow = 0) AND "
              f"(d_year = {year} OR d_year = {year + 1} OR "
              f"d_year = {year + 2})")
    st = _dim("store", ["s_store_sk", "s_city"],
              f"s_city IN ({cs})")
    hd = _dim("household_demographics",
              ["hd_demo_sk", "hd_dep_count", "hd_vehicle_count"],
              f"hd_dep_count = {dep} OR hd_vehicle_count = {vehicle}")
    ca = _dim("customer_address", ["ca_address_sk", "ca_city"])
    cu = _dim("customer", ["c_customer_sk", "c_last_name",
                           "c_first_name", "c_current_addr_sk"])
    cur = (PlanBuilder()
           .table_scan("customer_address",
                       columns=["ca_address_sk", "ca_city"])
           .project(["ca_address_sk AS cur_addr_sk",
                     "ca_city AS current_city"]))
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_hdemo_sk", "ss_addr_sk",
                             "ss_ticket_number", "ss_customer_sk",
                             "ss_coupon_amt", "ss_net_profit"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "left_semi")
        .hash_join(hd, ["ss_hdemo_sk"], ["hd_demo_sk"], "left_semi")
        .hash_join(ca, ["ss_addr_sk"], ["ca_address_sk"], "inner",
                   output=["ss_ticket_number", "ss_customer_sk",
                           "ss_coupon_amt", "ss_net_profit",
                           "ca_city"])
        .aggregate(["ss_ticket_number", "ss_customer_sk", "ca_city"],
                   ["sum(ss_coupon_amt) AS amt",
                    "sum(ss_net_profit) AS profit"])
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"], "inner",
                   output=["c_last_name", "c_first_name",
                           "c_current_addr_sk", "ca_city",
                           "ss_ticket_number", "amt", "profit"])
        .hash_join(cur, ["c_current_addr_sk"], ["cur_addr_sk"],
                   "inner",
                   output=["c_last_name", "c_first_name", "ca_city",
                           "current_city", "ss_ticket_number", "amt",
                           "profit"])
        .filter("current_city <> ca_city")
        .order_by(["c_last_name", "c_first_name", "ca_city",
                   "ss_ticket_number"])
        .limit(100)
    )


def q61(year: int = 1998, moy: int = 11, gmt: float = -5.0,
        category: str = "Jewelry") -> PlanBuilder:
    """Promotional vs total sales ratio for one category and month
    (spec q61: two single-row sums cross-joined)."""

    def branch(with_promo: bool, out: str) -> PlanBuilder:
        dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
                  f"d_year = {year} AND d_moy = {moy}")
        it = _dim("item", ["i_item_sk", "i_category"],
                  f"i_category = '{category}'")
        st = _dim("store", ["s_store_sk", "s_gmt_offset"],
                  f"s_gmt_offset = {gmt}")
        ca = _dim("customer_address",
                  ["ca_address_sk", "ca_gmt_offset"],
                  f"ca_gmt_offset = {gmt}")
        cu = (PlanBuilder()
              .table_scan("customer",
                          columns=["c_customer_sk",
                                   "c_current_addr_sk"])
              .hash_join(ca, ["c_current_addr_sk"],
                         ["ca_address_sk"], "left_semi"))
        pb = (PlanBuilder()
              .table_scan("store_sales",
                          columns=["ss_sold_date_sk", "ss_item_sk",
                                   "ss_store_sk", "ss_promo_sk",
                                   "ss_customer_sk",
                                   "ss_ext_sales_price"])
              .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"],
                         "left_semi")
              .hash_join(it, ["ss_item_sk"], ["i_item_sk"],
                         "left_semi")
              .hash_join(st, ["ss_store_sk"], ["s_store_sk"],
                         "left_semi")
              .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"],
                         "left_semi"))
        if with_promo:
            pr = _dim("promotion",
                      ["p_promo_sk", "p_channel_dmail",
                       "p_channel_email", "p_channel_tv"],
                      "p_channel_dmail = 'Y' OR "
                      "p_channel_email = 'Y' OR p_channel_tv = 'Y'")
            pb = pb.hash_join(pr, ["ss_promo_sk"], ["p_promo_sk"],
                              "left_semi")
        return pb.aggregate(
            [], [f"sum(ss_ext_sales_price) AS {out}"])

    return (
        branch(True, "promotions")
        .cross_join(branch(False, "total"))
        .project(["promotions", "total",
                  "promotions / total * 100.0 AS promo_pct"])
        .limit(100)
    )


def q71(year: int = 1999, moy: int = 11,
        manager_id: int = 1) -> PlanBuilder:
    """Brand revenue by meal-time hour across the three channels
    (spec q71: union of facts joined to time_dim breakfast/dinner
    bands)."""
    it = _dim("item", ["i_item_sk", "i_brand_id", "i_brand",
                       "i_manager_id"],
              f"i_manager_id = {manager_id}")
    tt = _dim("time_dim", ["t_time_sk", "t_hour", "t_minute",
                           "t_meal_time"],
              "t_meal_time = 'breakfast' OR t_meal_time = 'dinner'")

    def channel(fact, dcol, icol, tcol, pcol) -> PlanBuilder:
        dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
                  f"d_moy = {moy} AND d_year = {year}")
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol, tcol, pcol])
            .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
            .project([f"{icol} AS item_sk", f"{tcol} AS time_sk",
                      f"{pcol} AS ext_price"])
        )

    ws = channel("web_sales", "ws_sold_date_sk", "ws_item_sk",
                 "ws_sold_time_sk", "ws_ext_sales_price")
    cs = channel("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                 "cs_sold_time_sk", "cs_ext_sales_price")
    ss = channel("store_sales", "ss_sold_date_sk", "ss_item_sk",
                 "ss_sold_time_sk", "ss_ext_sales_price")
    return (
        ws.union_all([cs, ss])
        .hash_join(it, ["item_sk"], ["i_item_sk"], "inner",
                   output=["i_brand_id", "i_brand", "time_sk",
                           "ext_price"])
        .hash_join(tt, ["time_sk"], ["t_time_sk"], "inner",
                   output=["i_brand_id", "i_brand", "t_hour",
                           "t_minute", "ext_price"])
        .aggregate(["i_brand_id", "i_brand", "t_hour", "t_minute"],
                   ["sum(ext_price) AS ext_price"])
        .order_by(["ext_price DESC", "i_brand_id", "t_hour",
                   "t_minute"])
        .limit(1000)
    )


def q76() -> PlanBuilder:
    """Sales rows with a NULL surrogate key, counted per channel /
    year / quarter / category (spec q76: UNION ALL of the three
    facts)."""
    it = _dim("item", ["i_item_sk", "i_category"])
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_qoy"])

    def channel(fact, null_col, dcol, icol, pcol, label
                ) -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan(fact, columns=[null_col, dcol, icol, pcol])
            .filter(f"is_null({null_col})")
            .project([f"'{label}' AS channel",
                      f"'{null_col}' AS col_name",
                      f"{dcol} AS date_sk", f"{icol} AS item_sk",
                      f"{pcol} AS ext_sales_price"])
        )

    ss = channel("store_sales", "ss_store_sk", "ss_sold_date_sk",
                 "ss_item_sk", "ss_ext_sales_price", "store")
    ws = channel("web_sales", "ws_ship_customer_sk",
                 "ws_sold_date_sk", "ws_item_sk",
                 "ws_ext_sales_price", "web")
    cs = channel("catalog_sales", "cs_ship_addr_sk",
                 "cs_sold_date_sk", "cs_item_sk",
                 "cs_ext_sales_price", "catalog")
    return (
        ss.union_all([ws, cs])
        .hash_join(it, ["item_sk"], ["i_item_sk"], "inner",
                   output=["channel", "col_name", "date_sk",
                           "i_category", "ext_sales_price"])
        .hash_join(dt, ["date_sk"], ["d_date_sk"], "inner",
                   output=["channel", "col_name", "d_year", "d_qoy",
                           "i_category", "ext_sales_price"])
        .aggregate(["channel", "col_name", "d_year", "d_qoy",
                    "i_category"],
                   ["count(*) AS sales_cnt",
                    "sum(ext_sales_price) AS sales_amt"])
        .order_by(["channel", "col_name", "d_year", "d_qoy",
                   "i_category"])
        .limit(100)
    )


def q84(city: str = "Edgewood",
        income_lo: int = 38128) -> PlanBuilder:
    """Customers in one city within an income band, ordered by the
    returns they appear in (spec q84; names output as separate
    columns — documented deviation from the SQL || concat)."""
    ca = _dim("customer_address", ["ca_address_sk", "ca_city"],
              f"ca_city = '{city}'")
    ib = _dim("income_band",
              ["ib_income_band_sk", "ib_lower_bound",
               "ib_upper_bound"],
              f"ib_lower_bound >= {income_lo} AND "
              f"ib_upper_bound <= {income_lo + 50000}")
    hd = (PlanBuilder()
          .table_scan("household_demographics",
                      columns=["hd_demo_sk", "hd_income_band_sk"])
          .hash_join(ib, ["hd_income_band_sk"],
                     ["ib_income_band_sk"], "left_semi"))
    cd = _dim("customer_demographics", ["cd_demo_sk"])
    sr = _dim("store_returns", ["sr_cdemo_sk"])
    return (
        PlanBuilder()
        .table_scan("customer",
                    columns=["c_customer_sk", "c_customer_id",
                             "c_current_addr_sk", "c_current_cdemo_sk",
                             "c_current_hdemo_sk", "c_first_name",
                             "c_last_name"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "left_semi")
        .hash_join(hd, ["c_current_hdemo_sk"], ["hd_demo_sk"],
                   "left_semi")
        .hash_join(cd, ["c_current_cdemo_sk"], ["cd_demo_sk"],
                   "inner",
                   output=["c_customer_id", "c_first_name",
                           "c_last_name", "cd_demo_sk"])
        .hash_join(sr, ["cd_demo_sk"], ["sr_cdemo_sk"], "left_semi")
        .order_by(["c_customer_id"])
        .limit(100)
    )


def q91(year: int = 1998, moy: int = 11, gmt: float = -7.0
        ) -> PlanBuilder:
    """Catalog-return losses by call center for a month, for
    educated/high-potential demographics (spec q91)."""
    cc = _dim("call_center",
              ["cc_call_center_sk", "cc_call_center_id", "cc_name",
               "cc_manager"])
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_year = {year} AND d_moy = {moy}")
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_marital_status",
               "cd_education_status"],
              "(cd_marital_status = 'M' AND "
              "cd_education_status = 'Unknown') OR "
              "(cd_marital_status = 'W' AND "
              "cd_education_status = 'Advanced Degree')")
    hd = _dim("household_demographics",
              ["hd_demo_sk", "hd_buy_potential"],
              "hd_buy_potential = 'Unknown' OR "
              "hd_buy_potential = '>10000'")
    ca = _dim("customer_address", ["ca_address_sk", "ca_gmt_offset"],
              f"ca_gmt_offset = {gmt}")
    cu = (PlanBuilder()
          .table_scan("customer",
                      columns=["c_customer_sk", "c_current_cdemo_sk",
                               "c_current_hdemo_sk",
                               "c_current_addr_sk"])
          .hash_join(hd, ["c_current_hdemo_sk"], ["hd_demo_sk"],
                     "left_semi")
          .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                     "left_semi"))
    return (
        PlanBuilder()
        .table_scan("catalog_returns",
                    columns=["cr_call_center_sk", "cr_returned_date_sk",
                             "cr_returning_customer_sk",
                             "cr_net_loss"])
        .hash_join(dt, ["cr_returned_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(cu, ["cr_returning_customer_sk"],
                   ["c_customer_sk"], "inner",
                   output=["cr_call_center_sk", "cr_net_loss",
                           "c_current_cdemo_sk"])
        .hash_join(cd, ["c_current_cdemo_sk"], ["cd_demo_sk"],
                   "inner",
                   output=["cr_call_center_sk", "cr_net_loss",
                           "cd_marital_status",
                           "cd_education_status"])
        .hash_join(cc, ["cr_call_center_sk"], ["cc_call_center_sk"],
                   "inner",
                   output=["cc_call_center_id", "cc_name",
                           "cc_manager", "cd_marital_status",
                           "cd_education_status", "cr_net_loss"])
        .aggregate(["cc_call_center_id", "cc_name", "cc_manager",
                    "cd_marital_status", "cd_education_status"],
                   ["sum(cr_net_loss) AS returns_loss"])
        .order_by(["returns_loss DESC", "cc_call_center_id"])
        .limit(100)
    )


def _excess_discount(fact: str, dcol: str, icol: str, amtcol: str,
                     manufact_id: int, start: str,
                     out: str) -> PlanBuilder:
    """q32/q92 shape: discount amounts above 1.3x the per-item average
    over a 90-day window (the correlated subquery becomes a broadcast
    join against a per-item aggregate of the same dated slice)."""
    import datetime as _dt

    d0 = _dt.date.fromisoformat(start)
    d1 = d0 + _dt.timedelta(days=90)

    def dated() -> PlanBuilder:
        dt_ = _dim("date_dim", ["d_date_sk", "d_date"],
                   f"d_date BETWEEN DATE '{d0}' AND DATE '{d1}'")
        return (PlanBuilder()
                .table_scan(fact, columns=[dcol, icol, amtcol])
                .hash_join(dt_, [dcol], ["d_date_sk"], "left_semi"))

    it = _dim("item", ["i_item_sk", "i_manufact_id"],
              f"i_manufact_id = {manufact_id}")
    thresh = (dated()
              .aggregate([icol], [f"avg({amtcol}) AS avg_amt"])
              .project([f"{icol} AS t_item_sk",
                        "avg_amt * 1.3 AS bar"]))
    return (
        dated()
        .hash_join(it, [icol], ["i_item_sk"], "left_semi")
        .hash_join(thresh, [icol], ["t_item_sk"], "inner",
                   output=[amtcol, "bar"])
        .filter(f"{amtcol} > bar")
        .aggregate([], [f"sum({amtcol}) AS {out}"])
        .limit(100)
    )


def q32(manufact_id: int = 977,
        start: str = "2000-01-27") -> PlanBuilder:
    return _excess_discount("catalog_sales", "cs_sold_date_sk",
                            "cs_item_sk", "cs_ext_discount_amt",
                            manufact_id, start, "excess_discount")


def q92(manufact_id: int = 350,
        start: str = "2000-01-27") -> PlanBuilder:
    return _excess_discount("web_sales", "ws_sold_date_sk",
                            "ws_item_sk", "ws_ext_discount_amt",
                            manufact_id, start, "excess_discount")


def q41(manufact_lo: int = 738) -> PlanBuilder:
    """Distinct product names of manufacturers that make at least one
    item matching the attribute disjunction (spec q41: the EXISTS
    subquery becomes a semi join on i_manufact)."""
    attr = ("(i_category = 'Women' AND "
            "(i_color = 'powder' OR i_color = 'khaki') AND "
            "(i_units = 'Ounce' OR i_units = 'Oz') AND "
            "(i_size = 'medium' OR i_size = 'extra large')) OR "
            "(i_category = 'Men' AND "
            "(i_color = 'brown' OR i_color = 'honeydew') AND "
            "(i_units = 'Bunch' OR i_units = 'Ton') AND "
            "(i_size = 'N/A' OR i_size = 'small'))")
    making = (PlanBuilder()
              .table_scan("item",
                          columns=["i_manufact", "i_category",
                                   "i_color", "i_units", "i_size"])
              .filter(attr)
              .project(["i_manufact AS m_manufact"])
              .distinct())
    return (
        PlanBuilder()
        .table_scan("item",
                    columns=["i_manufact_id", "i_manufact",
                             "i_product_name"],
                    subfilter=f"i_manufact_id >= {manufact_lo} AND "
                              f"i_manufact_id <= {manufact_lo + 40}")
        .hash_join(making, ["i_manufact"], ["m_manufact"],
                   "left_semi")
        .project(["i_product_name"])
        .distinct()
        .order_by(["i_product_name"])
        .limit(100)
    )


def q45(year: int = 2001, qoy: int = 2,
        zips=("85669", "86197", "88274", "83405", "86475",
              "85392", "85460", "80348", "81792"),
        item_sks=(2, 3, 5, 7, 11, 13, 17, 19, 23, 29)
        ) -> PlanBuilder:
    """Web sales by customer zip/city where the zip prefix is in a
    list OR the item matches a sk-derived id set (spec q45; the IN
    subquery becomes a marker left join on i_item_id)."""
    zs = ", ".join(f"'{z}'" for z in zips)
    sks = ", ".join(str(s) for s in item_sks)
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_qoy"],
              f"d_qoy = {qoy} AND d_year = {year}")
    it = _dim("item", ["i_item_sk", "i_item_id"])
    sub = (PlanBuilder()
           .table_scan("item", columns=["i_item_sk", "i_item_id"],
                       subfilter=f"i_item_sk IN ({sks})")
           .project(["i_item_id AS sub_item_id", "1 AS hot"])
           .distinct())
    ca = _dim("customer_address",
              ["ca_address_sk", "ca_city", "ca_zip"])
    cu = _dim("customer", ["c_customer_sk", "c_current_addr_sk"])
    return (
        PlanBuilder()
        .table_scan("web_sales",
                    columns=["ws_sold_date_sk", "ws_item_sk",
                             "ws_bill_customer_sk",
                             "ws_sales_price"])
        .hash_join(dt, ["ws_sold_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(cu, ["ws_bill_customer_sk"], ["c_customer_sk"],
                   "inner",
                   output=["ws_item_sk", "ws_sales_price",
                           "c_current_addr_sk"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner",
                   output=["ws_item_sk", "ws_sales_price", "ca_city",
                           "ca_zip"])
        .hash_join(it, ["ws_item_sk"], ["i_item_sk"], "inner",
                   output=["ws_sales_price", "ca_city", "ca_zip",
                           "i_item_id"])
        .hash_join(sub, ["i_item_id"], ["sub_item_id"], "left",
                   output=["ws_sales_price", "ca_city", "ca_zip",
                           "hot"])
        .filter(f"substr(ca_zip, 1, 5) IN ({zs}) "
                "OR coalesce(hot, 0) = 1")
        .aggregate(["ca_zip", "ca_city"],
                   ["sum(ws_sales_price) AS total"])
        .order_by(["ca_zip", "ca_city"])
        .limit(100)
    )


def q83(dates=("2000-06-30", "2000-09-27", "2000-11-17")
        ) -> PlanBuilder:
    """Returned quantities per item across all three return channels
    in the weeks of three seed dates (spec q83: the nested date
    subqueries become week-seq semi joins)."""
    ds = ", ".join(f"DATE '{d}'" for d in dates)
    seed = _dim("date_dim", ["d_date", "d_week_seq"],
                f"d_date IN ({ds})")
    weeks = (PlanBuilder()
             .table_scan("date_dim",
                         columns=["d_date_sk", "d_week_seq"])
             .hash_join(seed.project(["d_week_seq AS w_seq"]),
                        ["d_week_seq"], ["w_seq"], "left_semi"))

    def channel(fact, dcol, icol, qcol, out) -> PlanBuilder:
        it = _dim("item", ["i_item_sk", "i_item_id"])
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol, qcol])
            .hash_join(weeks, [dcol], ["d_date_sk"], "left_semi")
            .hash_join(it, [icol], ["i_item_sk"], "inner",
                       output=["i_item_id", qcol])
            .aggregate(["i_item_id"], [f"sum({qcol}) AS {out}"])
        )

    sr = channel("store_returns", "sr_returned_date_sk",
                 "sr_item_sk", "sr_return_quantity", "sr_qty")
    cr = (channel("catalog_returns", "cr_returned_date_sk",
                  "cr_item_sk", "cr_return_quantity", "cr_qty")
          .project(["i_item_id AS cr_item_id", "cr_qty"]))
    wr = (channel("web_returns", "wr_returned_date_sk",
                  "wr_item_sk", "wr_return_quantity", "wr_qty")
          .project(["i_item_id AS wr_item_id", "wr_qty"]))
    return (
        sr
        .hash_join(cr, ["i_item_id"], ["cr_item_id"], "inner",
                   output=["i_item_id", "sr_qty", "cr_qty"])
        .hash_join(wr, ["i_item_id"], ["wr_item_id"], "inner",
                   output=["i_item_id", "sr_qty", "cr_qty",
                           "wr_qty"])
        .project(["i_item_id", "sr_qty", "cr_qty", "wr_qty",
                  "(sr_qty + cr_qty + wr_qty) / 3.0 AS average"])
        .order_by(["i_item_id", "sr_qty"])
        .limit(100)
    )


def _channel_customers(fact: str, dcol: str, ccol: str,
                       seq_lo: int) -> PlanBuilder:
    """Distinct (last, first, date) shopper triples in one channel
    within a month-seq window (q38/q87 building block; NULL names are
    excluded — documented deviation from INTERSECT's null-equal
    semantics)."""
    dt = _dim("date_dim", ["d_date_sk", "d_date", "d_month_seq"],
              f"d_month_seq >= {seq_lo} AND "
              f"d_month_seq <= {seq_lo + 11}")
    cu = _dim("customer", ["c_customer_sk", "c_last_name",
                           "c_first_name"])
    return (
        PlanBuilder()
        .table_scan(fact, columns=[dcol, ccol])
        .hash_join(dt, [dcol], ["d_date_sk"], "inner",
                   output=[ccol, "d_date"])
        .hash_join(cu, [ccol], ["c_customer_sk"], "inner",
                   output=["c_last_name", "c_first_name", "d_date"])
        .filter("is_not_null(c_last_name) AND "
                "is_not_null(c_first_name)")
        .distinct()
    )


def q38(month_seq_lo: int = 1200) -> PlanBuilder:
    """Customers who shopped all three channels in one year
    (spec q38: INTERSECT of distinct shopper triples -> semi joins)."""
    ss = _channel_customers("store_sales", "ss_sold_date_sk",
                            "ss_customer_sk", month_seq_lo)
    cs = (_channel_customers("catalog_sales", "cs_sold_date_sk",
                             "cs_bill_customer_sk", month_seq_lo)
          .project(["c_last_name AS cs_last", "c_first_name AS cs_first",
                    "d_date AS cs_date"]))
    ws = (_channel_customers("web_sales", "ws_sold_date_sk",
                             "ws_bill_customer_sk", month_seq_lo)
          .project(["c_last_name AS ws_last", "c_first_name AS ws_first",
                    "d_date AS ws_date"]))
    return (
        ss
        .hash_join(cs, ["c_last_name", "c_first_name", "d_date"],
                   ["cs_last", "cs_first", "cs_date"], "left_semi")
        .hash_join(ws, ["c_last_name", "c_first_name", "d_date"],
                   ["ws_last", "ws_first", "ws_date"], "left_semi")
        .aggregate([], ["count(*) AS cnt"])
        .limit(100)
    )


def q87(month_seq_lo: int = 1200) -> PlanBuilder:
    """Store shoppers who used neither other channel (spec q87:
    EXCEPT -> anti joins over the same distinct triples)."""
    ss = _channel_customers("store_sales", "ss_sold_date_sk",
                            "ss_customer_sk", month_seq_lo)
    cs = (_channel_customers("catalog_sales", "cs_sold_date_sk",
                             "cs_bill_customer_sk", month_seq_lo)
          .project(["c_last_name AS cs_last", "c_first_name AS cs_first",
                    "d_date AS cs_date"]))
    ws = (_channel_customers("web_sales", "ws_sold_date_sk",
                             "ws_bill_customer_sk", month_seq_lo)
          .project(["c_last_name AS ws_last", "c_first_name AS ws_first",
                    "d_date AS ws_date"]))
    return (
        ss
        .hash_join(cs, ["c_last_name", "c_first_name", "d_date"],
                   ["cs_last", "cs_first", "cs_date"], "anti_simple")
        .hash_join(ws, ["c_last_name", "c_first_name", "d_date"],
                   ["ws_last", "ws_first", "ws_date"], "anti_simple")
        .aggregate([], ["count(*) AS cnt"])
        .limit(100)
    )


def q9(thresholds=(3672, 3392, 32784, 26032, 23982)) -> PlanBuilder:
    """Five quantity-bucket averages picked by row-count thresholds
    (spec q9: the CASE WHEN count subqueries become cross-joined
    single-row aggregates over one scan per bucket)."""
    pb = PlanBuilder().table_scan("reason", columns=["r_reason_sk"],
                                  subfilter="r_reason_sk = 1")
    projections = []
    for i, th in enumerate(thresholds, start=1):
        qlo, qhi = 20 * (i - 1) + 1, 20 * i
        bucket = (
            PlanBuilder()
            .table_scan("store_sales",
                        columns=["ss_quantity",
                                 "ss_ext_discount_amt",
                                 "ss_net_paid"],
                        subfilter=f"ss_quantity >= {qlo} AND "
                                  f"ss_quantity <= {qhi}")
            .aggregate([], [f"count(*) AS cnt{i}",
                            f"avg(ss_ext_discount_amt) AS disc{i}",
                            f"avg(ss_net_paid) AS paid{i}"]))
        pb = pb.cross_join(bucket)
        projections.append(
            f"if(cnt{i} > {th}, disc{i}, paid{i}) AS bucket{i}")
    return pb.project(projections).limit(100)


def q31(year: int = 2000) -> PlanBuilder:
    """County web-vs-store quarterly growth (spec q31: six quarterly
    sums joined on county, web growth must beat store growth)."""

    def quarter(fact, dcol, acol, price, qoy, out) -> PlanBuilder:
        dt = _dim("date_dim", ["d_date_sk", "d_year", "d_qoy"],
                  f"d_qoy = {qoy} AND d_year = {year}")
        ca = _dim("customer_address",
                  ["ca_address_sk", "ca_county"])
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, acol, price])
            .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
            .hash_join(ca, [acol], ["ca_address_sk"], "inner",
                       output=["ca_county", price])
            .filter("is_not_null(ca_county)")
            .aggregate(["ca_county"], [f"sum({price}) AS {out}"])
            .project([f"ca_county AS {out}_county", out])
        )

    ss1 = quarter("store_sales", "ss_sold_date_sk", "ss_addr_sk",
                  "ss_ext_sales_price", 1, "ss1")
    ss2 = quarter("store_sales", "ss_sold_date_sk", "ss_addr_sk",
                  "ss_ext_sales_price", 2, "ss2")
    ss3 = quarter("store_sales", "ss_sold_date_sk", "ss_addr_sk",
                  "ss_ext_sales_price", 3, "ss3")
    ws1 = quarter("web_sales", "ws_sold_date_sk",
                  "ws_bill_addr_sk", "ws_ext_sales_price", 1, "ws1")
    ws2 = quarter("web_sales", "ws_sold_date_sk",
                  "ws_bill_addr_sk", "ws_ext_sales_price", 2, "ws2")
    ws3 = quarter("web_sales", "ws_sold_date_sk",
                  "ws_bill_addr_sk", "ws_ext_sales_price", 3, "ws3")
    return (
        ss1
        .hash_join(ss2, ["ss1_county"], ["ss2_county"], "inner",
                   output=["ss1_county", "ss1", "ss2"])
        .hash_join(ss3, ["ss1_county"], ["ss3_county"], "inner",
                   output=["ss1_county", "ss1", "ss2", "ss3"])
        .hash_join(ws1, ["ss1_county"], ["ws1_county"], "inner",
                   output=["ss1_county", "ss1", "ss2", "ss3", "ws1"])
        .hash_join(ws2, ["ss1_county"], ["ws2_county"], "inner",
                   output=["ss1_county", "ss1", "ss2", "ss3", "ws1",
                           "ws2"])
        .hash_join(ws3, ["ss1_county"], ["ws3_county"], "inner",
                   output=["ss1_county", "ss1", "ss2", "ss3", "ws1",
                           "ws2", "ws3"])
        .filter("ss1 > 0 AND ss2 > 0 AND ws1 > 0 AND ws2 > 0")
        .filter("ws2 / ws1 > ss2 / ss1 AND "
                "ws3 / ws2 > ss3 / ss2")
        .project(["ss1_county AS county",
                  "ws2 / ws1 AS web_q1_q2_increase",
                  "ss2 / ss1 AS store_q1_q2_increase",
                  "ws3 / ws2 AS web_q2_q3_increase",
                  "ss3 / ss2 AS store_q2_q3_increase"])
        .order_by(["county"])
        .limit(100)
    )


def q74(year: int = 1999) -> PlanBuilder:
    """Customers whose web spend grew faster than store spend across
    two years (spec q74 / q11-lite: four yearly totals joined on
    customer)."""

    def totals(fact, dcol, ccol, price, y, out) -> PlanBuilder:
        dt = _dim("date_dim", ["d_date_sk", "d_year"],
                  f"d_year = {y}")
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, ccol, price])
            .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
            .filter(f"is_not_null({ccol})")
            .aggregate([ccol], [f"sum({price}) AS {out}"])
            .project([f"{ccol} AS {out}_c", out])
        )

    s1 = totals("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                "ss_net_paid", year, "s1")
    s2 = totals("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                "ss_net_paid", year + 1, "s2")
    w1 = totals("web_sales", "ws_sold_date_sk",
                "ws_bill_customer_sk", "ws_net_paid", year, "w1")
    w2 = totals("web_sales", "ws_sold_date_sk",
                "ws_bill_customer_sk", "ws_net_paid", year + 1, "w2")
    cu = _dim("customer", ["c_customer_sk", "c_customer_id",
                           "c_first_name", "c_last_name"])
    return (
        s1
        .hash_join(s2, ["s1_c"], ["s2_c"], "inner",
                   output=["s1_c", "s1", "s2"])
        .hash_join(w1, ["s1_c"], ["w1_c"], "inner",
                   output=["s1_c", "s1", "s2", "w1"])
        .hash_join(w2, ["s1_c"], ["w2_c"], "inner",
                   output=["s1_c", "s1", "s2", "w1", "w2"])
        .filter("s1 > 0 AND w1 > 0")
        .filter("w2 / w1 > s2 / s1")
        .hash_join(cu, ["s1_c"], ["c_customer_sk"], "inner",
                   output=["c_customer_id", "c_first_name",
                           "c_last_name"])
        .order_by(["c_customer_id"])
        .limit(100)
    )


def q39(year: int = 2000, moy: int = 1,
        cov_bar: float = 1.0) -> PlanBuilder:
    """Inventory demand variability: item/warehouse months whose
    coefficient of variation exceeds the bar in two consecutive
    months (spec q39 part 1)."""

    def month(m, sfx) -> PlanBuilder:
        dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
                  f"d_year = {year} AND d_moy = {m}")
        return (
            PlanBuilder()
            .table_scan("inventory",
                        columns=["inv_date_sk", "inv_item_sk",
                                 "inv_warehouse_sk",
                                 "inv_quantity_on_hand"])
            .hash_join(dt, ["inv_date_sk"], ["d_date_sk"],
                       "left_semi")
            .aggregate(["inv_item_sk", "inv_warehouse_sk"],
                       ["avg(inv_quantity_on_hand) AS mean",
                        "stddev_samp(inv_quantity_on_hand)"
                        " AS sdev"])
            .filter("is_not_null(sdev) AND mean > 0")
            .project([f"inv_item_sk AS item{sfx}",
                      f"inv_warehouse_sk AS wh{sfx}",
                      f"mean AS mean{sfx}",
                      f"sdev / mean AS cov{sfx}"])
            .filter(f"cov{sfx} > {cov_bar}")
        )

    m1 = month(moy, "1")
    m2 = month(moy + 1, "2")
    return (
        m1
        .hash_join(m2, ["item1", "wh1"], ["item2", "wh2"], "inner",
                   output=["wh1", "item1", "mean1", "cov1",
                           "mean2", "cov2"])
        .order_by(["wh1", "item1", "mean1", "cov1"])
        .limit(100)
    )


def _exists_family(require_web_or_catalog: str,
                   demo_cols, demo_group, year: int,
                   moy_lo: int, moy_span: int) -> PlanBuilder:
    """q10/q35/q69 skeleton: customers with store activity in a window
    AND web/catalog activity per ``require_web_or_catalog`` ("or" |
    "and" | "neither"), profiled by customer demographics. EXISTS
    subqueries become semi joins; the OR of two EXISTS becomes two
    marker left joins on deduped activity sets."""
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_year = {year} AND d_moy >= {moy_lo} AND "
              f"d_moy <= {moy_lo + moy_span}")

    def active(fact, dcol, ccol, out):
        return (PlanBuilder()
                .table_scan(fact, columns=[dcol, ccol])
                .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
                .filter(f"is_not_null({ccol})")
                .project([f"{ccol} AS {out}"])
                .distinct())

    ss = active("store_sales", "ss_sold_date_sk", "ss_customer_sk",
                "ss_c")
    ws = active("web_sales", "ws_sold_date_sk",
                "ws_bill_customer_sk", "ws_c")
    cs = active("catalog_sales", "cs_sold_date_sk",
                "cs_bill_customer_sk", "cs_c")
    cd = _dim("customer_demographics", ["cd_demo_sk"] + demo_cols)
    pb = (PlanBuilder()
          .table_scan("customer",
                      columns=["c_customer_sk", "c_current_cdemo_sk"])
          .hash_join(ss, ["c_customer_sk"], ["ss_c"], "left_semi"))
    if require_web_or_catalog == "or":
        pb = (pb.hash_join(ws.project(["ws_c", "1 AS wmark"]),
                           ["c_customer_sk"], ["ws_c"], "left",
                           output=["c_customer_sk",
                                   "c_current_cdemo_sk", "wmark"])
              .hash_join(cs.project(["cs_c", "1 AS cmark"]),
                         ["c_customer_sk"], ["cs_c"], "left",
                         output=["c_customer_sk",
                                 "c_current_cdemo_sk", "wmark",
                                 "cmark"])
              .filter("coalesce(wmark, 0) = 1 OR "
                      "coalesce(cmark, 0) = 1"))
    elif require_web_or_catalog == "and":
        pb = (pb.hash_join(ws, ["c_customer_sk"], ["ws_c"],
                           "left_semi")
              .hash_join(cs, ["c_customer_sk"], ["cs_c"],
                         "left_semi"))
    else:  # neither
        pb = (pb.hash_join(ws, ["c_customer_sk"], ["ws_c"],
                           "anti_simple")
              .hash_join(cs, ["c_customer_sk"], ["cs_c"],
                         "anti_simple"))
    return (
        pb.hash_join(cd, ["c_current_cdemo_sk"], ["cd_demo_sk"],
                     "inner", output=demo_cols)
        .aggregate(demo_group, ["count(*) AS cnt"])
        .order_by(demo_group)
        .limit(100)
    )


def q10(year: int = 2002, moy_lo: int = 1) -> PlanBuilder:
    """Demographic counts of store shoppers also active on web OR
    catalog (spec q10)."""
    cols = ["cd_gender", "cd_marital_status", "cd_education_status",
            "cd_purchase_estimate", "cd_credit_rating"]
    return _exists_family("or", cols, cols, year, moy_lo, 3)


def q35(year: int = 2002) -> PlanBuilder:
    """Demographic counts of store shoppers also active on web OR
    catalog, by gender/marital/dependents (spec q35 behavioral
    subset: the address join is dropped — documented deviation)."""
    cols = ["cd_gender", "cd_marital_status", "cd_dep_count"]
    return _exists_family("or", cols, cols, year, 1, 3)


def q69(year: int = 2001, moy_lo: int = 4) -> PlanBuilder:
    """Demographics of store shoppers with NO web or catalog activity
    (spec q69)."""
    cols = ["cd_gender", "cd_marital_status", "cd_education_status",
            "cd_purchase_estimate", "cd_credit_rating"]
    return _exists_family("neither", cols, cols, year, moy_lo, 2)


def _order_counts(fact: str, dcol: str, addr_col: str, ship_col: str,
                  order_col: str, price_col: str, profit_col: str,
                  returns_fact: str, returns_order: str,
                  start: str, days: int, state: str) -> PlanBuilder:
    """q16/q94 skeleton: orders shipped from one state in a window
    with at least one other shipment leg (multi-warehouse EXISTS via a
    per-order leg-count subquery) and NO return; count distinct orders
    + money sums."""
    import datetime as _dt

    d0 = _dt.date.fromisoformat(start)
    d1 = d0 + _dt.timedelta(days=days)
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{d0}' AND DATE '{d1}'")
    ca = _dim("customer_address", ["ca_address_sk", "ca_state"],
              f"ca_state = '{state}'")
    # orders with >= 2 distinct ship legs (the EXISTS-other-warehouse
    # subquery: wh1 <> wh2 over the same order)
    multi = (PlanBuilder()
             .table_scan(fact, columns=[order_col, ship_col])
             .filter(f"is_not_null({ship_col})")
             .aggregate([order_col],
                        [f"count(distinct {ship_col}) AS legs"])
             .filter("legs >= 2")
             .project([f"{order_col} AS m_order"]))
    ret = (PlanBuilder()
           .table_scan(returns_fact, columns=[returns_order])
           .project([f"{returns_order} AS r_order"])
           .distinct())
    return (
        PlanBuilder()
        .table_scan(fact, columns=[dcol, addr_col, order_col,
                                   price_col, profit_col])
        .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
        .hash_join(ca, [addr_col], ["ca_address_sk"], "left_semi")
        .hash_join(multi, [order_col], ["m_order"], "left_semi")
        .hash_join(ret, [order_col], ["r_order"], "anti_simple")
        .aggregate([], [f"count(distinct {order_col}) AS order_count",
                        f"sum({price_col}) AS total_shipping_cost",
                        f"sum({profit_col}) AS total_net_profit"])
        .limit(100)
    )


def q16(start: str = "2002-02-01", state: str = "GA") -> PlanBuilder:
    """Catalog orders from one state, multi-warehouse, never returned
    (spec q16; the call-center county filter is dropped at small SF —
    documented deviation)."""
    return _order_counts(
        "catalog_sales", "cs_ship_date_sk", "cs_ship_addr_sk",
        "cs_warehouse_sk", "cs_order_number", "cs_ext_ship_cost",
        "cs_net_profit", "catalog_returns", "cr_order_number",
        start, 60, state)


def q94(start: str = "1999-02-01", state: str = "IL") -> PlanBuilder:
    """Web orders from one state, multi-site, never returned
    (spec q94)."""
    return _order_counts(
        "web_sales", "ws_ship_date_sk", "ws_ship_addr_sk",
        "ws_web_site_sk", "ws_order_number", "ws_ext_ship_cost",
        "ws_net_profit", "web_returns", "wr_order_number",
        start, 60, state)


def q95(start: str = "1999-02-01", state: str = "IL") -> PlanBuilder:
    """Web orders from one state, multi-site, WITH a return
    (spec q95: q94's anti join flipped to semi)."""
    import datetime as _dt

    d0 = _dt.date.fromisoformat(start)
    d1 = d0 + _dt.timedelta(days=60)
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{d0}' AND DATE '{d1}'")
    ca = _dim("customer_address", ["ca_address_sk", "ca_state"],
              f"ca_state = '{state}'")
    multi = (PlanBuilder()
             .table_scan("web_sales",
                         columns=["ws_order_number", "ws_web_site_sk"])
             .filter("is_not_null(ws_web_site_sk)")
             .aggregate(["ws_order_number"],
                        ["count(distinct ws_web_site_sk) AS legs"])
             .filter("legs >= 2")
             .project(["ws_order_number AS m_order"]))
    ret = (PlanBuilder()
           .table_scan("web_returns", columns=["wr_order_number"])
           .project(["wr_order_number AS r_order"])
           .distinct())
    return (
        PlanBuilder()
        .table_scan("web_sales",
                    columns=["ws_ship_date_sk", "ws_ship_addr_sk",
                             "ws_order_number", "ws_ext_ship_cost",
                             "ws_net_profit"])
        .hash_join(dt, ["ws_ship_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(ca, ["ws_ship_addr_sk"], ["ca_address_sk"],
                   "left_semi")
        .hash_join(multi, ["ws_order_number"], ["m_order"],
                   "left_semi")
        .hash_join(ret, ["ws_order_number"], ["r_order"],
                   "left_semi")
        .aggregate([], ["count(distinct ws_order_number)"
                        " AS order_count",
                        "sum(ws_ext_ship_cost)"
                        " AS total_shipping_cost",
                        "sum(ws_net_profit) AS total_net_profit"])
        .limit(100)
    )


def _sold_returned_rebought(measure_ss: str, measure_sr: str,
                            measure_cs: str, q1y: int,
                            aggs) -> PlanBuilder:
    """q17/q25/q29 skeleton: items sold in quarter 1, returned by the
    customer in quarters 1-3, re-bought via catalog — a 3-fact chain
    joined on (customer, item) with per-channel date windows."""
    d1 = _dim("date_dim", ["d_date_sk", "d_year", "d_qoy"],
              f"d_qoy = 1 AND d_year = {q1y}")
    d2 = (PlanBuilder().table_scan(
        "date_dim", columns=["d_date_sk", "d_year", "d_qoy"],
        subfilter=f"d_qoy >= 1 AND d_qoy <= 3 AND d_year = {q1y}")
        .project(["d_date_sk AS d2_sk"]))
    d3 = (PlanBuilder().table_scan(
        "date_dim", columns=["d_date_sk", "d_year"],
        subfilter=f"d_year >= {q1y} AND d_year <= {q1y + 2}")
        .project(["d_date_sk AS d3_sk"]))
    st = _dim("store", ["s_store_sk", "s_state"])
    it = _dim("item", ["i_item_sk", "i_item_id", "i_item_desc"])
    sr = (PlanBuilder()
          .table_scan("store_returns",
                      columns=["sr_returned_date_sk", "sr_customer_sk",
                               "sr_item_sk", "sr_ticket_number",
                               measure_sr])
          .hash_join(d2, ["sr_returned_date_sk"], ["d2_sk"],
                     "left_semi"))
    cs = (PlanBuilder()
          .table_scan("catalog_sales",
                      columns=["cs_sold_date_sk",
                               "cs_bill_customer_sk", "cs_item_sk",
                               measure_cs])
          .hash_join(d3, ["cs_sold_date_sk"], ["d3_sk"],
                     "left_semi"))
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_customer_sk",
                             "ss_item_sk", "ss_ticket_number",
                             "ss_store_sk", measure_ss])
        .hash_join(d1, ["ss_sold_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(sr, ["ss_customer_sk", "ss_item_sk",
                        "ss_ticket_number"],
                   ["sr_customer_sk", "sr_item_sk",
                    "sr_ticket_number"], "inner",
                   output=["ss_item_sk", "ss_store_sk",
                           "ss_customer_sk", measure_ss, measure_sr])
        .hash_join(cs, ["ss_customer_sk", "ss_item_sk"],
                   ["cs_bill_customer_sk", "cs_item_sk"], "inner",
                   output=["ss_item_sk", "ss_store_sk", measure_ss,
                           measure_sr, measure_cs])
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["ss_item_sk", "s_state", measure_ss,
                           measure_sr, measure_cs])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["i_item_id", "i_item_desc", "s_state",
                           measure_ss, measure_sr, measure_cs])
        .aggregate(["i_item_id", "i_item_desc", "s_state"], aggs)
        .order_by(["i_item_id", "i_item_desc", "s_state"])
        .limit(100)
    )


def q17(year: int = 2001) -> PlanBuilder:
    """Quantity statistics of sold/returned/re-bought items
    (spec q17)."""
    return _sold_returned_rebought(
        "ss_quantity", "sr_return_quantity", "cs_quantity", year,
        ["count(ss_quantity) AS store_sales_quantitycount",
         "avg(ss_quantity) AS store_sales_quantityave",
         "stddev_samp(ss_quantity) AS store_sales_quantitystdev",
         "count(sr_return_quantity) AS store_returns_quantitycount",
         "avg(sr_return_quantity) AS store_returns_quantityave",
         "count(cs_quantity) AS catalog_sales_quantitycount",
         "avg(cs_quantity) AS catalog_sales_quantityave"])


def q25(year: int = 2000) -> PlanBuilder:
    """Net-profit sums of sold/returned/re-bought items (spec q25)."""
    return _sold_returned_rebought(
        "ss_net_profit", "sr_net_loss", "cs_net_profit", year,
        ["sum(ss_net_profit) AS store_sales_profit",
         "sum(sr_net_loss) AS store_returns_loss",
         "sum(cs_net_profit) AS catalog_sales_profit"])


def q29(year: int = 1999) -> PlanBuilder:
    """Quantity sums of sold/returned/re-bought items (spec q29)."""
    return _sold_returned_rebought(
        "ss_quantity", "sr_return_quantity", "cs_quantity", year,
        ["sum(ss_quantity) AS store_sales_quantity",
         "sum(sr_return_quantity) AS store_returns_quantity",
         "sum(cs_quantity) AS catalog_sales_quantity"])


def q85(year: int = 2000) -> PlanBuilder:
    """Web returns profiled by reason with demographic band matching
    (spec q85 behavioral subset: one cd join on the returning
    customer demographics + reason rollup; the paired-demographics
    sanity bands are kept as value filters)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year"],
              f"d_year = {year}")
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_marital_status",
               "cd_education_status"])
    r = _dim("reason", ["r_reason_sk", "r_reason_desc"])
    wp = _dim("web_page", ["wp_web_page_sk"])
    return (
        PlanBuilder()
        .table_scan("web_returns",
                    columns=["wr_returned_date_sk", "wr_item_sk",
                             "wr_order_number", "wr_reason_sk",
                             "wr_refunded_cdemo_sk", "wr_fee",
                             "wr_refunded_cash", "wr_web_page_sk"])
        .hash_join(dt, ["wr_returned_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(wp, ["wr_web_page_sk"], ["wp_web_page_sk"],
                   "left_semi")
        .hash_join(cd, ["wr_refunded_cdemo_sk"], ["cd_demo_sk"],
                   "inner",
                   output=["wr_reason_sk", "wr_fee",
                           "wr_refunded_cash", "cd_marital_status",
                           "cd_education_status"])
        .hash_join(r, ["wr_reason_sk"], ["r_reason_sk"], "inner",
                   output=["r_reason_desc", "wr_fee",
                           "wr_refunded_cash"])
        .aggregate(["r_reason_desc"],
                   ["avg(wr_fee) AS avg_fee",
                    "avg(wr_refunded_cash) AS avg_refund"])
        .order_by(["r_reason_desc"])
        .limit(100)
    )


def q89(year: int = 1999) -> PlanBuilder:
    """Monthly class sales vs the class's yearly average: rows more
    than 10% off the mean, via an AVG window over the monthly sums
    (spec q89)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_year = {year}")
    it = _dim("item", ["i_item_sk", "i_category", "i_class",
                       "i_brand"])
    st = _dim("store", ["s_store_sk", "s_store_name",
                        "s_company_name"])
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_store_sk", "ss_sales_price"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_item_sk", "ss_store_sk",
                           "ss_sales_price", "d_moy"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["i_category", "i_class", "i_brand",
                           "ss_store_sk", "ss_sales_price", "d_moy"])
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["i_category", "i_class", "i_brand",
                           "s_store_name", "s_company_name",
                           "ss_sales_price", "d_moy"])
        .aggregate(["i_category", "i_class", "i_brand",
                    "s_store_name", "s_company_name", "d_moy"],
                   ["sum(ss_sales_price) AS sum_sales"])
        .window(["i_category", "i_brand", "s_store_name",
                 "s_company_name"], [],
                ["avg(sum_sales) AS avg_monthly_sales"])
        .filter("avg_monthly_sales <> 0.0 AND "
                "abs(sum_sales - avg_monthly_sales) "
                "/ avg_monthly_sales > 0.1")
        .project(["i_category", "i_class", "i_brand", "s_store_name",
                  "s_company_name", "d_moy", "sum_sales",
                  "avg_monthly_sales",
                  "sum_sales - avg_monthly_sales AS deviation"])
        .order_by(["deviation", "s_store_name", "d_moy"])
        .limit(100)
    )


def _v1_window(fact_group, year: int) -> PlanBuilder:
    """q47/q57 monthly series: rank + lag + lead over per-entity
    monthly sums, filtered to rows deviating from the yearly mean."""
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_year = {year}")
    it = _dim("item", ["i_item_sk", "i_category", "i_brand"])
    ent_dim, ent_fk, ent_cols = fact_group
    return (
        PlanBuilder()
        .table_scan(ent_dim["fact"],
                    columns=[ent_dim["dcol"], ent_dim["icol"],
                             ent_fk, ent_dim["price"]])
        .hash_join(dt, [ent_dim["dcol"]], ["d_date_sk"], "inner",
                   output=[ent_dim["icol"], ent_fk,
                           ent_dim["price"], "d_year", "d_moy"])
        .hash_join(it, [ent_dim["icol"]], ["i_item_sk"], "inner",
                   output=["i_category", "i_brand", ent_fk,
                           ent_dim["price"], "d_year", "d_moy"])
        .hash_join(ent_cols, [ent_fk],
                   [ent_cols.node.output_type.names[0]], "inner",
                   output=["i_category", "i_brand",
                           *ent_cols.node.output_type.names[1:],
                           ent_dim["price"], "d_year", "d_moy"])
        .aggregate(["i_category", "i_brand",
                    *ent_cols.node.output_type.names[1:], "d_year",
                    "d_moy"],
                   [f"sum({ent_dim['price']}) AS sum_sales"])
        .window(["i_category", "i_brand",
                 *ent_cols.node.output_type.names[1:], "d_year"], [],
                ["avg(sum_sales) AS avg_monthly_sales"])
        .window(["i_category", "i_brand",
                 *ent_cols.node.output_type.names[1:]],
                ["d_year", "d_moy"],
                ["lag(sum_sales) AS psum", "lead(sum_sales) AS nsum"])
        .filter("avg_monthly_sales > 0.0 AND "
                "abs(sum_sales - avg_monthly_sales) "
                "/ avg_monthly_sales > 0.1")
        .project(["i_category", "i_brand", "d_year", "d_moy",
                  "sum_sales", "avg_monthly_sales", "psum", "nsum",
                  "sum_sales - avg_monthly_sales AS deviation"])
        .order_by(["deviation", "d_moy"])
        .limit(100)
    )


def q47(year: int = 1999) -> PlanBuilder:
    """Store monthly brand sales deviating from the yearly mean, with
    prev/next month context (spec q47 behavioral subset: the spec's
    rank-adjacent self joins become lag/lead windows)."""
    st = (PlanBuilder().table_scan(
        "store", columns=["s_store_sk", "s_store_name",
                          "s_company_name"]))
    return _v1_window((
        {"fact": "store_sales", "dcol": "ss_sold_date_sk",
         "icol": "ss_item_sk", "price": "ss_sales_price"},
        "ss_store_sk", st), year)


def q57(year: int = 1999) -> PlanBuilder:
    """Catalog monthly brand sales deviating from the yearly mean,
    with prev/next month context (spec q57, same rewrite as q47)."""
    cc = (PlanBuilder().table_scan(
        "call_center", columns=["cc_call_center_sk", "cc_name"]))
    return _v1_window((
        {"fact": "catalog_sales", "dcol": "cs_sold_date_sk",
         "icol": "cs_item_sk", "price": "cs_sales_price"},
        "cs_call_center_sk", cc), year)


def q44(store_sk: int = 1, null_col: str = "ss_addr_sk"
        ) -> PlanBuilder:
    """Best and worst performing items by average net profit at one
    store (spec q44: asc/desc rank windows over per-item averages;
    the spec's null-column average filter keeps the sample
    comparable)."""
    it1 = (PlanBuilder().table_scan(
        "item", columns=["i_item_sk", "i_product_name"]))
    base = (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_store_sk", "ss_item_sk",
                             "ss_net_profit", null_col])
        .filter(f"ss_store_sk = {store_sk}")
        .aggregate(["ss_item_sk"],
                   ["avg(ss_net_profit) AS rank_col"])
        .filter("is_not_null(rank_col)")
        .window([], ["rank_col DESC"], ["rank() AS rnk_best"])
        .window([], ["rank_col"], ["rank() AS rnk_worst"])
        .filter("rnk_best <= 10 OR rnk_worst <= 10"))
    return (
        base
        .hash_join(it1, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["rnk_best", "rnk_worst", "rank_col",
                           "i_product_name"])
        .order_by(["rnk_best", "rnk_worst"])
        .limit(100)
    )


def _weekly_pivot(facts, year: int, id_dim=None) -> PlanBuilder:
    """q2/q59 building block: weekly sums pivoted by day name."""
    dt = _dim("date_dim",
              ["d_date_sk", "d_week_seq", "d_day_name", "d_year"])
    srcs = []
    for fact, dcol, pcol in facts:
        srcs.append(PlanBuilder()
                    .table_scan(fact, columns=[dcol, pcol]
                                + ([id_dim[1]] if id_dim else []))
                    .project([f"{dcol} AS date_sk",
                              f"{pcol} AS price"]
                             + ([f"{id_dim[1]} AS ent_sk"]
                                if id_dim else [])))
    pb = srcs[0]
    if len(srcs) > 1:
        pb = pb.union_all(srcs[1:])
    pb = pb.hash_join(dt, ["date_sk"], ["d_date_sk"], "inner",
                      output=(["ent_sk"] if id_dim else [])
                      + ["price", "d_week_seq", "d_day_name",
                         "d_year"])
    days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
            "Friday", "Saturday"]
    pb = pb.project(
        (["ent_sk"] if id_dim else [])
        + ["d_week_seq", "d_year"]
        + [f"if(d_day_name = '{d}', price, 0.0) AS p{i}"
           for i, d in enumerate(days)])
    keys = ((["ent_sk"] if id_dim else [])
            + ["d_week_seq", "d_year"])
    return pb.aggregate(
        keys, [f"sum(p{i}) AS {d.lower()[:3]}_sales"
               for i, d in enumerate(days)])


def q2(year: int = 2001) -> PlanBuilder:
    """Web+catalog weekly day-of-week sales, this year vs next year
    same week (spec q2: week_seq self join at +53 weeks)."""
    days = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]
    y1 = (_weekly_pivot(
        [("web_sales", "ws_sold_date_sk", "ws_ext_sales_price"),
         ("catalog_sales", "cs_sold_date_sk", "cs_ext_sales_price")],
        year)
        .filter(f"d_year = {year}"))
    y2 = (_weekly_pivot(
        [("web_sales", "ws_sold_date_sk", "ws_ext_sales_price"),
         ("catalog_sales", "cs_sold_date_sk", "cs_ext_sales_price")],
        year)
        .filter(f"d_year = {year + 1}")
        .project(["d_week_seq AS wk2"]
                 + [f"{d}_sales AS {d}2" for d in days]))
    return (
        y1.project(["d_week_seq"]
                   + [f"{d}_sales" for d in days])
        .hash_join(y2, ["d_week_seq"], ["wk2"], "inner",
                   output=["d_week_seq"]
                   + [f"{d}_sales" for d in days]
                   + [f"{d}2" for d in days])
        .order_by(["d_week_seq"])
        .limit(1000)
    )


def q59(year_seq_lo: int = 1195) -> PlanBuilder:
    """Store weekly day-of-week sales, weeks n vs n+52, per store
    (spec q59)."""
    days = ["sun", "mon", "tue", "wed", "thu", "fri", "sat"]
    st = _dim("store", ["s_store_sk", "s_store_id", "s_store_name"])
    base = _weekly_pivot(
        [("store_sales", "ss_sold_date_sk", "ss_sales_price")],
        0, id_dim=("store", "ss_store_sk"))
    w1 = (base
          .filter(f"d_week_seq >= {year_seq_lo} AND "
                  f"d_week_seq <= {year_seq_lo + 51}")
          .hash_join(st, ["ent_sk"], ["s_store_sk"], "inner",
                     output=["s_store_id", "s_store_name",
                             "d_week_seq"]
                     + [f"{d}_sales" for d in days]))
    base2 = _weekly_pivot(
        [("store_sales", "ss_sold_date_sk", "ss_sales_price")],
        0, id_dim=("store", "ss_store_sk"))
    w2 = (base2
          .filter(f"d_week_seq >= {year_seq_lo + 52} AND "
                  f"d_week_seq <= {year_seq_lo + 103}")
          .hash_join(st, ["ent_sk"], ["s_store_sk"], "inner",
                     output=["s_store_id", "d_week_seq"]
                     + [f"{d}_sales" for d in days])
          .project(["s_store_id AS sid2",
                    "d_week_seq - 52 AS wk2"]
                   + [f"{d}_sales AS {d}2" for d in days]))
    return (
        w1.hash_join(w2, ["s_store_id", "d_week_seq"],
                     ["sid2", "wk2"], "inner",
                     output=["s_store_name", "s_store_id",
                             "d_week_seq"]
                     + [f"{d}_sales" for d in days]
                     + [f"{d}2" for d in days])
        .order_by(["s_store_name", "s_store_id", "d_week_seq"])
        .limit(100)
    )


def q8(zip_prefixes=None, min_pref: int = 10) -> PlanBuilder:
    """Store net profit for stores whose 2-digit zip prefix matches a
    zip with enough preferred customers (spec q8 behavioral subset:
    the literal 400-zip list becomes the preferred-customer zip set
    itself — the INTERSECT arm that carries the semantics)."""
    ca = _dim("customer_address", ["ca_address_sk", "ca_zip"])
    cu = _dim("customer", ["c_customer_sk", "c_current_addr_sk",
                           "c_preferred_cust_flag"],
              "c_preferred_cust_flag = 'Y'")
    pref_zips = (
        PlanBuilder()
        .table_scan("customer_address",
                    columns=["ca_address_sk", "ca_zip"])
        .hash_join(cu, ["ca_address_sk"], ["c_current_addr_sk"],
                   "left_semi")
        .filter("is_not_null(ca_zip)")
        .project(["substr(ca_zip, 1, 5) AS zip5"])
        .aggregate(["zip5"], ["count(*) AS cnt"])
        .filter(f"cnt > {min_pref}")
        .project(["substr(zip5, 1, 2) AS zip2"])
        .distinct())
    st = (PlanBuilder()
          .table_scan("store", columns=["s_store_sk", "s_store_name",
                                        "s_zip"])
          .filter("is_not_null(s_zip)")
          .project(["s_store_sk", "s_store_name",
                    "substr(s_zip, 1, 2) AS s_zip2"])
          .hash_join(pref_zips, ["s_zip2"], ["zip2"], "left_semi"))
    dt = _dim("date_dim", ["d_date_sk", "d_qoy", "d_year"],
              "d_qoy = 2")
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_net_profit"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["s_store_name", "ss_net_profit"])
        .aggregate(["s_store_name"],
                   ["sum(ss_net_profit) AS net_profit"])
        .order_by(["s_store_name"])
        .limit(100)
    )


def q18(year: int = 1998, gender: str = "F",
        education: str = "Unknown",
        birth_months=(1, 6, 8, 9, 12, 2)) -> PlanBuilder:
    """Catalog purchase averages by item across a geography ROLLUP
    for a demographic slice (spec q18; the numeric casts stay in the
    engine's decimal lanes)."""
    ms = ", ".join(str(m) for m in birth_months)
    dt = _dim("date_dim", ["d_date_sk", "d_year"],
              f"d_year = {year}")
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_gender", "cd_education_status",
               "cd_dep_count"],
              f"cd_gender = '{gender}' AND "
              f"cd_education_status = '{education}'")
    cu = _dim("customer",
              ["c_customer_sk", "c_current_addr_sk",
               "c_birth_month", "c_birth_year"],
              f"c_birth_month IN ({ms})")
    ca = _dim("customer_address",
              ["ca_address_sk", "ca_country", "ca_state",
               "ca_county"])
    it = _dim("item", ["i_item_sk", "i_item_id"])
    return (
        PlanBuilder()
        .table_scan("catalog_sales",
                    columns=["cs_sold_date_sk", "cs_item_sk",
                             "cs_bill_customer_sk",
                             "cs_bill_cdemo_sk", "cs_quantity",
                             "cs_list_price", "cs_coupon_amt",
                             "cs_sales_price", "cs_net_profit"])
        .hash_join(dt, ["cs_sold_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(cd, ["cs_bill_cdemo_sk"], ["cd_demo_sk"],
                   "left_semi")
        .hash_join(cu, ["cs_bill_customer_sk"], ["c_customer_sk"],
                   "inner",
                   output=["cs_item_sk", "cs_quantity",
                           "cs_list_price", "cs_coupon_amt",
                           "cs_sales_price", "cs_net_profit",
                           "c_current_addr_sk", "c_birth_year"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner",
                   output=["cs_item_sk", "cs_quantity",
                           "cs_list_price", "cs_coupon_amt",
                           "cs_sales_price", "cs_net_profit",
                           "c_birth_year", "ca_country", "ca_state",
                           "ca_county"])
        .hash_join(it, ["cs_item_sk"], ["i_item_sk"], "inner",
                   output=["i_item_id", "ca_country", "ca_state",
                           "ca_county", "cs_quantity",
                           "cs_list_price", "cs_coupon_amt",
                           "cs_sales_price", "cs_net_profit",
                           "c_birth_year"])
        .group_id([["i_item_id", "ca_country", "ca_state",
                    "ca_county"],
                   ["i_item_id", "ca_country", "ca_state"],
                   ["i_item_id", "ca_country"], ["i_item_id"], []])
        .aggregate(["i_item_id", "ca_country", "ca_state",
                    "ca_county", "group_id"],
                   ["avg(cs_quantity) AS agg1",
                    "avg(cs_list_price) AS agg2",
                    "avg(cs_coupon_amt) AS agg3",
                    "avg(cs_sales_price) AS agg4",
                    "avg(cs_net_profit) AS agg5",
                    "avg(c_birth_year) AS agg6"])
        .order_by(["ca_country", "ca_state", "ca_county",
                   "i_item_id"])
        .limit(100)
    )


def q49(year: int = 2001, moy: int = 12) -> PlanBuilder:
    """Worst return ratios per channel: quantity and currency return
    ratios ranked, rows in either top-10 kept (spec q49)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_year = {year} AND d_moy = {moy}")

    def channel(label, fact, dcol, icol, ocol, qcol, pcol,
                rfact, ricol, rocol, rqcol, ramtcol) -> PlanBuilder:
        r = (PlanBuilder()
             .table_scan(rfact, columns=[ricol, rocol, rqcol,
                                         ramtcol])
             .filter(f"coalesce({ramtcol}, 0.0) > 0.0")
             .project([f"{ricol} AS r_item", f"{rocol} AS r_order",
                       f"{rqcol} AS r_qty", f"{ramtcol} AS r_amt"]))
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol, ocol, qcol, pcol])
            .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
            .filter(f"coalesce({pcol}, 0.0) > 0.0")
            .hash_join(r, [icol, ocol], ["r_item", "r_order"],
                       "left",
                       output=[icol, qcol, pcol, "r_qty", "r_amt"])
            .aggregate([icol],
                       [f"sum({qcol}) AS sold_qty",
                        "sum(coalesce(r_qty, 0)) AS ret_qty",
                        f"sum({pcol}) AS sold_amt",
                        "sum(coalesce(r_amt, 0.0)) AS ret_amt"])
            .filter("sold_qty > 0 AND sold_amt > 0.0")
            .project([f"'{label}' AS channel", f"{icol} AS item",
                      "ret_qty * 1.0 / sold_qty AS return_ratio",
                      "ret_amt / sold_amt AS currency_ratio"])
            .window([], ["return_ratio"],
                    ["rank() AS return_rank"])
            .window([], ["currency_ratio"],
                    ["rank() AS currency_rank"])
            .filter("return_rank <= 10 OR currency_rank <= 10"))

    web = channel("web", "web_sales", "ws_sold_date_sk",
                  "ws_item_sk", "ws_order_number", "ws_quantity",
                  "ws_net_paid", "web_returns", "wr_item_sk",
                  "wr_order_number", "wr_return_quantity",
                  "wr_return_amt")
    cat = channel("catalog", "catalog_sales", "cs_sold_date_sk",
                  "cs_item_sk", "cs_order_number", "cs_quantity",
                  "cs_net_paid", "catalog_returns", "cr_item_sk",
                  "cr_order_number", "cr_return_quantity",
                  "cr_return_amount")
    sto = channel("store", "store_sales", "ss_sold_date_sk",
                  "ss_item_sk", "ss_ticket_number", "ss_quantity",
                  "ss_net_paid", "store_returns", "sr_item_sk",
                  "sr_ticket_number", "sr_return_quantity",
                  "sr_return_amt")
    return (web.union_all([cat, sto])
            .order_by(["channel", "return_rank", "currency_rank",
                       "item"])
            .limit(100))


def q66(year: int = 2001,
        ship_modes=("DHL", "BARIAN"),
        time_lo: int = 30838) -> PlanBuilder:
    """Warehouse monthly sales/net by ship mode and time band
    (spec q66: 12 pivoted month sums per measure, web + catalog)."""
    sm = ", ".join(f"'{m}'" for m in ship_modes)
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_year = {year}")
    smd = _dim("ship_mode", ["sm_ship_mode_sk", "sm_carrier"],
               f"sm_carrier IN ({sm})")
    td = _dim("time_dim", ["t_time_sk", "t_time"],
              f"t_time >= {time_lo} AND t_time <= {time_lo + 28800}")
    wh = _dim("warehouse",
              ["w_warehouse_sk", "w_warehouse_name",
               "w_warehouse_sq_ft", "w_city", "w_county", "w_state",
               "w_country"])

    def channel(fact, dcol, tcol, mcol, wcol, price, net
                ) -> PlanBuilder:
        return (
            PlanBuilder()
            .table_scan(fact,
                        columns=[dcol, tcol, mcol, wcol, price, net])
            .hash_join(smd, [mcol], ["sm_ship_mode_sk"], "left_semi")
            .hash_join(td, [tcol], ["t_time_sk"], "left_semi")
            .hash_join(dt, [dcol], ["d_date_sk"], "inner",
                       output=[wcol, price, net, "d_moy"])
            .project([f"{wcol} AS wh_sk", f"{price} AS price",
                      f"{net} AS net", "d_moy"]))

    ws = channel("web_sales", "ws_sold_date_sk", "ws_sold_time_sk",
                 "ws_ship_mode_sk", "ws_warehouse_sk",
                 "ws_ext_sales_price", "ws_net_paid")
    cs = channel("catalog_sales", "cs_sold_date_sk",
                 "cs_sold_time_sk", "cs_ship_mode_sk",
                 "cs_warehouse_sk", "cs_sales_price",
                 "cs_net_paid_inc_tax")
    months = [f"if(d_moy = {m}, price, 0.0) AS s{m}"
              for m in range(1, 13)]
    nets = [f"if(d_moy = {m}, net, 0.0) AS n{m}"
            for m in range(1, 13)]
    return (
        ws.union_all([cs])
        .project(["wh_sk"] + months + nets)
        .aggregate(["wh_sk"],
                   [f"sum(s{m}) AS sales{m}" for m in range(1, 13)]
                   + [f"sum(n{m}) AS net{m}" for m in range(1, 13)])
        .hash_join(wh, ["wh_sk"], ["w_warehouse_sk"], "inner",
                   output=["w_warehouse_name", "w_warehouse_sq_ft",
                           "w_city", "w_county", "w_state",
                           "w_country"]
                   + [f"sales{m}" for m in range(1, 13)]
                   + [f"net{m}" for m in range(1, 13)])
        .order_by(["w_warehouse_name"])
        .limit(100)
    )


def q70(year: int = 1999) -> PlanBuilder:
    """State/county profit ROLLUP limited to the top-5 profit states,
    with rank within each hierarchy level (spec q70)."""
    dt = _dim("date_dim", ["d_date_sk", "d_year"],
              f"d_year = {year}")
    st = _dim("store", ["s_store_sk", "s_state", "s_county"])
    top_states = (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_net_profit"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["s_state", "ss_net_profit"])
        .aggregate(["s_state"], ["sum(ss_net_profit) AS sp"])
        .window([], ["sp DESC"], ["rank() AS srank"])
        .filter("srank <= 5")
        .project(["s_state AS top_state"]))
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_store_sk",
                             "ss_net_profit"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"],
                   "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["s_state", "s_county", "ss_net_profit"])
        .hash_join(top_states, ["s_state"], ["top_state"],
                   "left_semi")
        .group_id([["s_state", "s_county"], ["s_state"], []])
        .aggregate(["s_state", "s_county", "group_id"],
                   ["sum(ss_net_profit) AS total_sum"])
        .project(["total_sum", "s_state", "s_county",
                  "group_id AS lochierarchy",
                  "if(group_id = 0, s_state, '~all~')"
                  " AS parent_state"])
        .window(["lochierarchy", "parent_state"],
                ["total_sum DESC"], ["rank() AS rank_within_parent"])
        .order_by(["lochierarchy DESC", "parent_state",
                   "rank_within_parent"])
        .limit(100)
    )


_QUERIES = {1: q1, 2: q2, 3: q3, 5: None, 6: q6, 7: q7, 8: q8,
            9: q9, 10: q10, 12: q12, 13: q13, 15: q15, 16: q16,
            17: q17, 18: q18, 19: q19, 20: q20, 21: q21, 22: q22,
            25: q25, 26: q26, 27: q27, 28: q28, 29: q29, 30: q30,
            31: q31, 32: q32, 33: q33, 34: q34, 35: q35, 36: q36,
            37: q37, 38: q38, 39: q39, 40: q40, 41: q41, 42: q42,
            43: q43, 44: q44, 45: q45, 46: q46, 47: q47, 48: q48,
            49: q49, 50: q50, 52: q52, 53: q53, 55: q55, 56: q56,
            57: q57, 59: q59, 60: q60, 61: q61, 62: q62, 63: q63,
            65: q65, 66: q66, 68: q68, 69: q69, 70: q70, 71: q71,
            73: q73, 74: q74, 76: q76, 79: q79, 81: q81, 82: q82,
            83: q83, 84: q84, 85: q85, 86: q86, 87: q87, 88: q88,
            89: q89, 90: q90, 91: q91, 92: q92, 93: q93, 94: q94,
            95: q95, 96: q96, 97: q97, 98: q98, 99: q99}
_QUERIES = {k: v for k, v in _QUERIES.items() if v is not None}

from velox_tpu_torch.tpcds.queries_hard import HARD_QUERIES as _HARD  # noqa: E402

_QUERIES.update(_HARD)
SUPPORTED_QUERIES = sorted(_QUERIES)

#: the queries whose eight tables the spec-shaped generator makes
#: (``velox_tpu_torch.io.tpcds``, numpy oracles in ``tpcds/oracle.py``)
SPEC_QUERIES = [3, 7, 13, 19, 27, 28, 42, 43, 48, 52, 53, 55, 63, 65, 96]

#: the other 84, over the 24 tables of ``velox_tpu_torch.io.tpcds_full``
FULL_QUERIES = [q for q in SUPPORTED_QUERIES if q not in SPEC_QUERIES]

#: ``tpcds_plan(n, **FULL_PARAMS[n])`` where the spec's constants select
#: nothing at SF 0.01 of ``tpcds_full`` (seed 7); chosen only so that the
#: query selects rows, and given to both packages alike
FULL_PARAMS = {
    # the 2001/2002 boundary week holds no web or catalog sale in 2001
    2: {"year": 2000},
    # 500 addresses over 200 zips: no zip holds 10 preferred customers
    8: {"min_pref": 1},
    # 28,804 store lines over 1,827 days: no item sells 5 times a day,
    # and the best store customers bought nothing by catalog or web in
    # the month
    23: {"freq": 2, "pct": 0.5},
    # the plan's own switch for tiny SF (no store zip is a customer's),
    # and a market whose stores sold 'sky' items that came back
    24: {"zip_match": False, "market_id": 2},
    # manufacturer 977 makes none of the 300 items
    32: {"manufact_id": 7},
    # none of 677, 940, 694, 808 makes an item priced $68-98
    37: {"manufact_ids": (230, 279, 410, 463)},
    # the plan's own switch for tiny SF: no customer shares a store's
    # county and state
    54: {"geo_filter": False},
    # no item sells in all three channels in the week of 2000-01-03, nor
    # within 10% in the week of 2002-02-04
    58: {"day": "2002-02-04", "tol": 1.0},
    # week 1195 falls in 1922; 5166 is the first week of 1999
    59: {"year_seq_lo": 5166},
    # no item of the six colors priced $64-74 has such cross sales
    64: {"price_lo": 0.0, "price_hi": 100.0},
    # none of 129, 270, 821, 423 makes an item priced $62-92
    82: {"manufact_ids": (37, 96, 230, 279)},
    # manufacturer 350 makes no item discounted past 1.3x its average
    92: {"manufact_id": 7},
    # no multi-site web order shipped to IL in the window went unreturned
    94: {"state": "GA"},
}

#: the queries of ``FULL_QUERIES`` that select no row at SF 0.01 even so
#: (no constant of theirs helps): a customer buying in all three channels
#: in two years running (q4), an item of the attribute disjunction (q41,
#: about 1 in 8,000 items), an item returned in all three channels in
#: three weeks (q83), a customer whose demographics a store return
#: carries (q84: 2,880 returns over 1,920,800 demographics), a month of
#: catalog returns by the demographic slice (q91)
FULL_EMPTY = [4, 41, 83, 84, 91]


def tpcds_plan(n: int, **params) -> PlanBuilder:
    """Plan for TPC-DS query ``n``; ``params`` override the spec's
    substitution constants (useful at tiny scale factors where the
    defaults select empty slices)."""
    try:
        fn = _QUERIES[n]
    except KeyError:
        raise NotImplementedError(f"TPC-DS q{n} not implemented yet")
    return fn(**params)
