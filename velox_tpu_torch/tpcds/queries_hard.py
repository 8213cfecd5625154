"""TPC-DS hard-query tier: multi-channel CTE giants.

The 16 queries the first 83 left open — year-over-year customer CTEs
(q4/q11/q74-family), channel profit-and-loss rollups (q5/q77/q80),
cross-channel INTERSECT item sets (q14/q23), cumulative-window crosses
(q51), wide rollup ranks (q67), and the two-year store/catalog monster
(q64). Plan shapes mirror the reference's TPC-DS harness
(velox/tpcds/gen; SQL text from the TPC-DS spec). CTE legs are built
once as PlanBuilder sub-plans and composed by joins/unions — the same
broadcast-join shapes the distributed runner shards over the mesh.
"""

from __future__ import annotations

from velox_tpu_torch.plan import PlanBuilder


def _dim(table, columns, subfilter=None):
    return PlanBuilder().table_scan(table, columns=columns,
                                    subfilter=subfilter)


# ------------------------------------------------------------------
# q11 / q4: year-over-year per-customer channel totals
# ------------------------------------------------------------------

_CHAN_COLS = {
    "store_sales": ("ss_sold_date_sk", "ss_customer_sk", "ss_ext"),
    "catalog_sales": ("cs_sold_date_sk", "cs_bill_customer_sk", "cs_ext"),
    "web_sales": ("ws_sold_date_sk", "ws_bill_customer_sk", "ws_ext"),
}


def _year_total(fact: str, measure_cols, measure: str, year: int,
                out: str) -> PlanBuilder:
    """One year_total CTE leg: per-customer sum of ``measure`` over one
    year of ``fact`` (spec q4/q11 year_total)."""
    dcol, ccol, _ = _CHAN_COLS[fact]
    dt = _dim("date_dim", ["d_date_sk", "d_year"], f"d_year = {year}")
    return (
        PlanBuilder()
        .table_scan(fact, columns=[dcol, ccol, *measure_cols])
        .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
        .filter(f"is_not_null({ccol})")
        .project([ccol, f"{measure} AS m"])
        .aggregate([ccol], [f"sum(m) AS {out}"])
        .project([f"{ccol} AS {out}_c", out])
    )


def q11(year: int = 2001) -> PlanBuilder:
    """Customers whose web spend grew faster than store spend across
    two consecutive years (spec q11: 4 year_total legs over
    list-price-minus-discount, joined on customer)."""

    def leg(fact, pfx, y, out):
        return _year_total(
            fact, [f"{pfx}_ext_list_price", f"{pfx}_ext_discount_amt"],
            f"{pfx}_ext_list_price - {pfx}_ext_discount_amt", y, out)

    s1 = leg("store_sales", "ss", year, "s1")
    s2 = leg("store_sales", "ss", year + 1, "s2")
    w1 = leg("web_sales", "ws", year, "w1")
    w2 = leg("web_sales", "ws", year + 1, "w2")
    cu = _dim("customer", ["c_customer_sk", "c_customer_id",
                           "c_first_name", "c_last_name",
                           "c_preferred_cust_flag"])
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
                           "c_last_name", "c_preferred_cust_flag"])
        .order_by(["c_customer_id", "c_first_name", "c_last_name",
                   "c_preferred_cust_flag"])
        .limit(100)
    )


def q4(year: int = 2001) -> PlanBuilder:
    """Customers whose catalog growth beat both store and web growth
    (spec q4: 6 year_total legs over the half-profit measure)."""

    def leg(fact, pfx, y, out):
        return _year_total(
            fact,
            [f"{pfx}_ext_list_price", f"{pfx}_ext_wholesale_cost",
             f"{pfx}_ext_discount_amt", f"{pfx}_ext_sales_price"],
            f"(({pfx}_ext_list_price - {pfx}_ext_wholesale_cost"
            f" - {pfx}_ext_discount_amt) + {pfx}_ext_sales_price) / 2.0",
            y, out)

    s1 = leg("store_sales", "ss", year, "s1")
    s2 = leg("store_sales", "ss", year + 1, "s2")
    c1 = leg("catalog_sales", "cs", year, "c1")
    c2 = leg("catalog_sales", "cs", year + 1, "c2")
    w1 = leg("web_sales", "ws", year, "w1")
    w2 = leg("web_sales", "ws", year + 1, "w2")
    cu = _dim("customer", ["c_customer_sk", "c_customer_id",
                           "c_first_name", "c_last_name",
                           "c_email_address"])
    return (
        s1
        .hash_join(s2, ["s1_c"], ["s2_c"], "inner",
                   output=["s1_c", "s1", "s2"])
        .hash_join(c1, ["s1_c"], ["c1_c"], "inner",
                   output=["s1_c", "s1", "s2", "c1"])
        .hash_join(c2, ["s1_c"], ["c2_c"], "inner",
                   output=["s1_c", "s1", "s2", "c1", "c2"])
        .hash_join(w1, ["s1_c"], ["w1_c"], "inner",
                   output=["s1_c", "s1", "s2", "c1", "c2", "w1"])
        .hash_join(w2, ["s1_c"], ["w2_c"], "inner",
                   output=["s1_c", "s1", "s2", "c1", "c2", "w1",
                           "w2"])
        .filter("s1 > 0 AND c1 > 0 AND w1 > 0")
        .filter("c2 / c1 > s2 / s1 AND c2 / c1 > w2 / w1")
        .hash_join(cu, ["s1_c"], ["c_customer_sk"], "inner",
                   output=["c_customer_id", "c_first_name",
                           "c_last_name", "c_email_address"])
        .order_by(["c_customer_id", "c_first_name", "c_last_name",
                   "c_email_address"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q58: per-item revenue within 10% across all three channels in one week
# ------------------------------------------------------------------

def _week_dates(day: str) -> PlanBuilder:
    """date_sk set of the week containing ``day`` (spec q58's nested
    d_week_seq subquery)."""
    wk = (PlanBuilder()
          .table_scan("date_dim", columns=["d_date", "d_week_seq"])
          .filter(f"d_date = DATE '{day}'")
          .project(["d_week_seq AS wk_seq"]))
    return (PlanBuilder()
            .table_scan("date_dim",
                        columns=["d_date_sk", "d_week_seq"])
            .hash_join(wk, ["d_week_seq"], ["wk_seq"], "left_semi")
            .project(["d_date_sk AS wd_sk"]))


def q58(day: str = "2000-01-03", tol: float = 0.1) -> PlanBuilder:
    """Items whose store/catalog/web revenues in one week are mutually
    within ``tol`` (spec q58: 10%; wider at tiny SF where three-channel
    overlap in one week is a handful of items)."""
    def leg(fact, dcol, icol, price, out):
        it = _dim("item", ["i_item_sk", "i_item_id"])
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol, price])
            .hash_join(_week_dates(day), [dcol], ["wd_sk"],
                       "left_semi")
            .hash_join(it, [icol], ["i_item_sk"], "inner",
                       output=["i_item_id", price])
            .aggregate(["i_item_id"], [f"sum({price}) AS {out}"])
            .project([f"i_item_id AS {out}_id", out])
        )

    ss = leg("store_sales", "ss_sold_date_sk", "ss_item_sk",
             "ss_ext_sales_price", "ss_item_rev")
    cs = leg("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
             "cs_ext_sales_price", "cs_item_rev")
    ws = leg("web_sales", "ws_sold_date_sk", "ws_item_sk",
             "ws_ext_sales_price", "ws_item_rev")
    return (
        ss
        .hash_join(cs, ["ss_item_rev_id"], ["cs_item_rev_id"],
                   "inner",
                   output=["ss_item_rev_id", "ss_item_rev",
                           "cs_item_rev"])
        .hash_join(ws, ["ss_item_rev_id"], ["ws_item_rev_id"],
                   "inner",
                   output=["ss_item_rev_id", "ss_item_rev",
                           "cs_item_rev", "ws_item_rev"])
        .filter(" AND ".join(
            f"{a}_item_rev >= {1 - tol} * {b}_item_rev AND "
            f"{a}_item_rev <= {1 + tol} * {b}_item_rev"
            for a, b in (("ss", "cs"), ("cs", "ss"), ("ss", "ws"),
                         ("ws", "ss"), ("cs", "ws"), ("ws", "cs"))))
        .project(["ss_item_rev_id AS item_id", "ss_item_rev",
                  "ss_item_rev / ((ss_item_rev + cs_item_rev +"
                  " ws_item_rev) / 3.0) * 100.0 AS ss_dev",
                  "cs_item_rev",
                  "cs_item_rev / ((ss_item_rev + cs_item_rev +"
                  " ws_item_rev) / 3.0) * 100.0 AS cs_dev",
                  "ws_item_rev",
                  "ws_item_rev / ((ss_item_rev + cs_item_rev +"
                  " ws_item_rev) / 3.0) * 100.0 AS ws_dev",
                  "(ss_item_rev + cs_item_rev + ws_item_rev) / 3.0"
                  " AS average"])
        .order_by(["item_id", "ss_item_rev"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q75: net sales (sales minus returns) year-over-year by item ids
# ------------------------------------------------------------------

def q75(year: int = 2001, category: str = "Books") -> PlanBuilder:
    """Brand/class/category/manufact cells whose current-year net unit
    sales dropped below 90% of the prior year's, across all three
    channels (spec q75)."""

    def detail(fact, pfx, rfact, rpfx, okey, rokey,
               ramt=None) -> PlanBuilder:
        ramt = ramt or f"{rpfx}_return_amt"
        it = _dim("item",
                  ["i_item_sk", "i_brand_id", "i_class_id",
                   "i_category_id", "i_manufact_id", "i_category"],
                  f"i_category = '{category}'")
        dt = _dim("date_dim", ["d_date_sk", "d_year"])
        ret = (PlanBuilder()
               .table_scan(rfact,
                           columns=[rokey, f"{rpfx}_item_sk",
                                    f"{rpfx}_return_quantity", ramt])
               .project([f"{rokey} AS r_ord",
                         f"{rpfx}_item_sk AS r_item",
                         f"{rpfx}_return_quantity AS r_qty",
                         f"{ramt} AS r_amt"]))
        return (
            PlanBuilder()
            .table_scan(fact,
                        columns=[f"{pfx}_sold_date_sk",
                                 f"{pfx}_item_sk", okey,
                                 f"{pfx}_quantity",
                                 f"{pfx}_ext_sales_price"])
            .hash_join(it, [f"{pfx}_item_sk"], ["i_item_sk"],
                       "inner",
                       output=[f"{pfx}_sold_date_sk", okey,
                               f"{pfx}_item_sk", f"{pfx}_quantity",
                               f"{pfx}_ext_sales_price",
                               "i_brand_id", "i_class_id",
                               "i_category_id", "i_manufact_id"])
            .hash_join(dt, [f"{pfx}_sold_date_sk"], ["d_date_sk"],
                       "inner",
                       output=["d_year", okey, f"{pfx}_item_sk",
                               f"{pfx}_quantity",
                               f"{pfx}_ext_sales_price",
                               "i_brand_id", "i_class_id",
                               "i_category_id", "i_manufact_id"])
            .hash_join(ret, [okey, f"{pfx}_item_sk"],
                       ["r_ord", "r_item"], "left",
                       output=["d_year", "i_brand_id", "i_class_id",
                               "i_category_id", "i_manufact_id",
                               f"{pfx}_quantity",
                               f"{pfx}_ext_sales_price", "r_qty",
                               "r_amt"])
            .project(["d_year", "i_brand_id", "i_class_id",
                      "i_category_id", "i_manufact_id",
                      f"{pfx}_quantity - coalesce(r_qty, 0)"
                      " AS sales_cnt",
                      f"{pfx}_ext_sales_price -"
                      " coalesce(r_amt, 0.0) AS sales_amt"])
        )

    legs = [
        detail("catalog_sales", "cs", "catalog_returns", "cr",
               "cs_order_number", "cr_order_number",
               ramt="cr_return_amount"),
        detail("store_sales", "ss", "store_returns", "sr",
               "ss_ticket_number", "sr_ticket_number"),
        detail("web_sales", "ws", "web_returns", "wr",
               "ws_order_number", "wr_order_number"),
    ]
    # spec uses UNION (distinct) across the three channel details
    all_sales = (
        legs[0].union_all(legs[1:])
        .distinct()
        .aggregate(["d_year", "i_brand_id", "i_class_id",
                    "i_category_id", "i_manufact_id"],
                   ["sum(sales_cnt) AS sales_cnt",
                    "sum(sales_amt) AS sales_amt"])
    )
    curr = (all_sales
            .filter(f"d_year = {year + 1}")
            .project(["i_brand_id AS cb", "i_class_id AS cc",
                      "i_category_id AS cg", "i_manufact_id AS cm",
                      "sales_cnt AS curr_cnt",
                      "sales_amt AS curr_amt"]))

    def build_prev():
        legs2 = [
            detail("catalog_sales", "cs", "catalog_returns", "cr",
                   "cs_order_number", "cr_order_number",
                   ramt="cr_return_amount"),
            detail("store_sales", "ss", "store_returns", "sr",
                   "ss_ticket_number", "sr_ticket_number"),
            detail("web_sales", "ws", "web_returns", "wr",
                   "ws_order_number", "wr_order_number"),
        ]
        return (legs2[0].union_all(legs2[1:])
                .distinct()
                .aggregate(["d_year", "i_brand_id", "i_class_id",
                            "i_category_id", "i_manufact_id"],
                           ["sum(sales_cnt) AS sales_cnt",
                            "sum(sales_amt) AS sales_amt"])
                .filter(f"d_year = {year}")
                .project(["i_brand_id AS pb", "i_class_id AS pc",
                          "i_category_id AS pg",
                          "i_manufact_id AS pm",
                          "sales_cnt AS prev_cnt",
                          "sales_amt AS prev_amt"]))

    return (
        curr
        .hash_join(build_prev(), ["cb", "cc", "cg", "cm"],
                   ["pb", "pc", "pg", "pm"], "inner",
                   output=["cb", "cc", "cg", "cm", "prev_cnt",
                           "curr_cnt", "prev_amt", "curr_amt"])
        .filter("cast(curr_cnt AS DOUBLE) / cast(prev_cnt AS DOUBLE)"
                " < 0.9")
        .project([f"{year} AS prev_year", f"{year + 1} AS year_",
                  "cb AS i_brand_id", "cc AS i_class_id",
                  "cg AS i_category_id", "cm AS i_manufact_id",
                  "prev_cnt AS prev_yr_cnt", "curr_cnt AS curr_yr_cnt",
                  "curr_cnt - prev_cnt AS sales_cnt_diff",
                  "curr_amt - prev_amt AS sales_amt_diff"])
        .order_by(["sales_cnt_diff", "sales_amt_diff"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q5 / q77 / q80: channel profit-and-loss reports with ROLLUP
# ------------------------------------------------------------------

def _days_after(day: str, n: int) -> str:
    import datetime as _dt

    d = _dt.date.fromisoformat(day) + _dt.timedelta(days=n)
    return d.isoformat()


def _rollup_report(legs) -> PlanBuilder:
    """UNION ALL the channel legs (channel, id, sales, returns,
    profit), then GROUP BY ROLLUP(channel, id) (spec q5/q77/q80
    final select)."""
    return (
        legs[0].union_all(legs[1:])
        .group_id([["channel", "id"], ["channel"], []])
        .aggregate(["channel", "id", "group_id"],
                   ["sum(sales) AS sales", "sum(returns_) AS returns_",
                    "sum(profit) AS profit"])
        .project(["channel", "id", "sales", "returns_", "profit"])
        .order_by(["channel", "id"])
        .limit(100)
    )


def q5(day: str = "2000-08-23") -> PlanBuilder:
    """Channel P&L over 14 days: per-store / per-catalog-page /
    per-web-site sales, returns and profit with a channel ROLLUP
    (spec q5)."""
    d0, d1 = day, _days_after(day, 14)
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{d0}' AND DATE '{d1}'")

    def sales_returns(sales_tab, s_cols, s_proj, ret_tab, r_cols,
                      r_proj, dim, dim_keys, dim_id, label):
        sales = (PlanBuilder().table_scan(sales_tab, columns=s_cols)
                 .project(s_proj))
        rets = (PlanBuilder().table_scan(ret_tab, columns=r_cols)
                .project(r_proj))
        return (
            sales.union_all([rets])
            .hash_join(dt, ["date_sk"], ["d_date_sk"], "left_semi")
            .hash_join(dim, ["ent_sk"], [dim_keys], "inner",
                       output=[dim_id, "sales_price", "profit",
                               "return_amt", "net_loss"])
            .aggregate([dim_id],
                       ["sum(sales_price) AS sales",
                        "sum(return_amt) AS returns_",
                        "sum(profit) AS profit_raw",
                        "sum(net_loss) AS profit_loss"])
            .project([f"'{label} channel' AS channel",
                      f"concat('{label}', {dim_id}) AS id",
                      "sales", "returns_",
                      "profit_raw - profit_loss AS profit"])
        )

    st = _dim("store", ["s_store_sk", "s_store_id"])
    ssr = sales_returns(
        "store_sales",
        ["ss_store_sk", "ss_sold_date_sk", "ss_ext_sales_price",
         "ss_net_profit"],
        ["ss_store_sk AS ent_sk", "ss_sold_date_sk AS date_sk",
         "ss_ext_sales_price AS sales_price",
         "ss_net_profit AS profit", "0.0 AS return_amt",
         "0.0 AS net_loss"],
        "store_returns",
        ["sr_store_sk", "sr_returned_date_sk", "sr_return_amt",
         "sr_net_loss"],
        ["sr_store_sk AS ent_sk", "sr_returned_date_sk AS date_sk",
         "0.0 AS sales_price", "0.0 AS profit",
         "sr_return_amt AS return_amt", "sr_net_loss AS net_loss"],
        st, "s_store_sk", "s_store_id", "store")

    cp = _dim("catalog_page", ["cp_catalog_page_sk",
                               "cp_catalog_page_id"])
    csr = sales_returns(
        "catalog_sales",
        ["cs_catalog_page_sk", "cs_sold_date_sk",
         "cs_ext_sales_price", "cs_net_profit"],
        ["cs_catalog_page_sk AS ent_sk", "cs_sold_date_sk AS date_sk",
         "cs_ext_sales_price AS sales_price",
         "cs_net_profit AS profit", "0.0 AS return_amt",
         "0.0 AS net_loss"],
        "catalog_returns",
        ["cr_catalog_page_sk", "cr_returned_date_sk",
         "cr_return_amount", "cr_net_loss"],
        ["cr_catalog_page_sk AS ent_sk",
         "cr_returned_date_sk AS date_sk", "0.0 AS sales_price",
         "0.0 AS profit", "cr_return_amount AS return_amt",
         "cr_net_loss AS net_loss"],
        cp, "cp_catalog_page_sk", "cp_catalog_page_id",
        "catalog_page")

    # web returns find their site through the originating sale
    # (spec q5 wsr: web_returns LEFT OUTER JOIN web_sales on
    # item+order; an inner join here — null sites drop at the dim
    # join either way)
    ws_site = (PlanBuilder()
               .table_scan("web_sales",
                           columns=["ws_item_sk", "ws_order_number",
                                    "ws_web_site_sk"])
               .project(["ws_item_sk AS wsl_item",
                         "ws_order_number AS wsl_ord",
                         "ws_web_site_sk AS wsl_site"]))
    web_sales = (PlanBuilder()
                 .table_scan("web_sales",
                             columns=["ws_web_site_sk",
                                      "ws_sold_date_sk",
                                      "ws_ext_sales_price",
                                      "ws_net_profit"])
                 .project(["ws_web_site_sk AS ent_sk",
                           "ws_sold_date_sk AS date_sk",
                           "ws_ext_sales_price AS sales_price",
                           "ws_net_profit AS profit",
                           "0.0 AS return_amt", "0.0 AS net_loss"]))
    web_rets = (PlanBuilder()
                .table_scan("web_returns",
                            columns=["wr_item_sk", "wr_order_number",
                                     "wr_returned_date_sk",
                                     "wr_return_amt", "wr_net_loss"])
                .hash_join(ws_site,
                           ["wr_item_sk", "wr_order_number"],
                           ["wsl_item", "wsl_ord"], "inner",
                           output=["wsl_site", "wr_returned_date_sk",
                                   "wr_return_amt", "wr_net_loss"])
                .project(["wsl_site AS ent_sk",
                          "wr_returned_date_sk AS date_sk",
                          "0.0 AS sales_price", "0.0 AS profit",
                          "wr_return_amt AS return_amt",
                          "wr_net_loss AS net_loss"]))
    wsite = _dim("web_site", ["web_site_sk", "web_site_id"])
    wsr = (
        web_sales.union_all([web_rets])
        .hash_join(dt, ["date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(wsite, ["ent_sk"], ["web_site_sk"], "inner",
                   output=["web_site_id", "sales_price", "profit",
                           "return_amt", "net_loss"])
        .aggregate(["web_site_id"],
                   ["sum(sales_price) AS sales",
                    "sum(return_amt) AS returns_",
                    "sum(profit) AS profit_raw",
                    "sum(net_loss) AS profit_loss"])
        .project(["'web channel' AS channel",
                  "concat('web_site', web_site_id) AS id",
                  "sales", "returns_",
                  "profit_raw - profit_loss AS profit"])
    )
    return _rollup_report([ssr, csr, wsr])


def q77(day: str = "2000-08-23") -> PlanBuilder:
    """Channel P&L over 30 days: store / call-center / web-page level
    sales vs returns, ROLLUP by channel (spec q77)."""
    d0, d1 = day, _days_after(day, 30)
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{d0}' AND DATE '{d1}'")

    def agg(fact, cols, dcol, key, sums, outs):
        return (
            PlanBuilder().table_scan(fact, columns=cols)
            .hash_join(dt, [dcol], ["d_date_sk"], "left_semi")
            .filter(f"is_not_null({key})")
            .aggregate([key],
                       [f"sum({c}) AS {o}" for c, o in
                        zip(sums, outs)])
        )

    st = _dim("store", ["s_store_sk"])
    ss = (PlanBuilder()
          .table_scan("store_sales",
                      columns=["ss_store_sk", "ss_sold_date_sk",
                               "ss_ext_sales_price",
                               "ss_net_profit"])
          .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"],
                     "left_semi")
          .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                     output=["s_store_sk", "ss_ext_sales_price",
                             "ss_net_profit"])
          .aggregate(["s_store_sk"],
                     ["sum(ss_ext_sales_price) AS sales",
                      "sum(ss_net_profit) AS profit"]))
    sr = (PlanBuilder()
          .table_scan("store_returns",
                      columns=["sr_store_sk", "sr_returned_date_sk",
                               "sr_return_amt", "sr_net_loss"])
          .hash_join(dt, ["sr_returned_date_sk"], ["d_date_sk"],
                     "left_semi")
          .hash_join(st, ["sr_store_sk"], ["s_store_sk"], "inner",
                     output=["s_store_sk", "sr_return_amt",
                             "sr_net_loss"])
          .aggregate(["s_store_sk"],
                     ["sum(sr_return_amt) AS returns_",
                      "sum(sr_net_loss) AS profit_loss"])
          .project(["s_store_sk AS sr_store_sk", "returns_",
                    "profit_loss"]))
    store_leg = (
        ss.hash_join(sr, ["s_store_sk"], ["sr_store_sk"], "left",
                     output=["s_store_sk", "sales", "profit",
                             "returns_", "profit_loss"])
        .project(["'store channel' AS channel", "s_store_sk AS id",
                  "sales", "coalesce(returns_, 0.0) AS returns_",
                  "profit - coalesce(profit_loss, 0.0) AS profit"]))

    cs = agg("catalog_sales",
             ["cs_call_center_sk", "cs_sold_date_sk",
              "cs_ext_sales_price", "cs_net_profit"],
             "cs_sold_date_sk", "cs_call_center_sk",
             ["cs_ext_sales_price", "cs_net_profit"],
             ["sales", "profit"])
    cr = (PlanBuilder()
          .table_scan("catalog_returns",
                      columns=["cr_returned_date_sk",
                               "cr_return_amount", "cr_net_loss"])
          .hash_join(dt, ["cr_returned_date_sk"], ["d_date_sk"],
                     "left_semi")
          .aggregate([], ["sum(cr_return_amount) AS returns_",
                          "sum(cr_net_loss) AS profit_loss"]))
    # spec q77: catalog sales and returns meet in a CROSS join (cr is
    # a one-row total, not keyed by call center)
    catalog_leg = (
        cs.cross_join(cr)
        .project(["'catalog channel' AS channel",
                  "cs_call_center_sk AS id", "sales", "returns_",
                  "profit - profit_loss AS profit"]))

    wp = _dim("web_page", ["wp_web_page_sk"])
    ws = (PlanBuilder()
          .table_scan("web_sales",
                      columns=["ws_web_page_sk", "ws_sold_date_sk",
                               "ws_ext_sales_price",
                               "ws_net_profit"])
          .hash_join(dt, ["ws_sold_date_sk"], ["d_date_sk"],
                     "left_semi")
          .hash_join(wp, ["ws_web_page_sk"], ["wp_web_page_sk"],
                     "inner",
                     output=["wp_web_page_sk", "ws_ext_sales_price",
                             "ws_net_profit"])
          .aggregate(["wp_web_page_sk"],
                     ["sum(ws_ext_sales_price) AS sales",
                      "sum(ws_net_profit) AS profit"]))
    wr = (PlanBuilder()
          .table_scan("web_returns",
                      columns=["wr_web_page_sk",
                               "wr_returned_date_sk",
                               "wr_return_amt", "wr_net_loss"])
          .hash_join(dt, ["wr_returned_date_sk"], ["d_date_sk"],
                     "left_semi")
          .hash_join(wp, ["wr_web_page_sk"], ["wp_web_page_sk"],
                     "inner",
                     output=["wp_web_page_sk", "wr_return_amt",
                             "wr_net_loss"])
          .aggregate(["wp_web_page_sk"],
                     ["sum(wr_return_amt) AS returns_",
                      "sum(wr_net_loss) AS profit_loss"])
          .project(["wp_web_page_sk AS wr_page_sk", "returns_",
                    "profit_loss"]))
    web_leg = (
        ws.hash_join(wr, ["wp_web_page_sk"], ["wr_page_sk"], "left",
                     output=["wp_web_page_sk", "sales", "profit",
                             "returns_", "profit_loss"])
        .project(["'web channel' AS channel",
                  "wp_web_page_sk AS id", "sales",
                  "coalesce(returns_, 0.0) AS returns_",
                  "profit - coalesce(profit_loss, 0.0) AS profit"]))

    return _rollup_report([store_leg, catalog_leg, web_leg])


def q80(day: str = "2000-08-23", price: float = 50.0) -> PlanBuilder:
    """Channel P&L over 30 days restricted to pricey non-TV-promoted
    items, sales LEFT JOIN returns at line granularity, channel ROLLUP
    (spec q80)."""
    d0, d1 = day, _days_after(day, 30)
    dt = _dim("date_dim", ["d_date_sk", "d_date"],
              f"d_date BETWEEN DATE '{d0}' AND DATE '{d1}'")
    it = _dim("item", ["i_item_sk", "i_current_price"],
              f"i_current_price > {price}")
    pr = _dim("promotion", ["p_promo_sk", "p_channel_tv"],
              "p_channel_tv = 'N'")

    def leg(fact, pfx, ikey, okey, pkey, rfact, rpfx, rokey, ramt,
            dim, dim_key, dim_id, label, entcol):
        rets = (PlanBuilder()
                .table_scan(rfact,
                            columns=[f"{rpfx}_item_sk", rokey, ramt,
                                     f"{rpfx}_net_loss"])
                .project([f"{rpfx}_item_sk AS r_item",
                          f"{rokey} AS r_ord", f"{ramt} AS r_amt",
                          f"{rpfx}_net_loss AS r_loss"]))
        return (
            PlanBuilder()
            .table_scan(fact,
                        columns=[f"{pfx}_sold_date_sk", ikey, okey,
                                 pkey, entcol,
                                 f"{pfx}_ext_sales_price",
                                 f"{pfx}_net_profit"])
            .hash_join(dt, [f"{pfx}_sold_date_sk"], ["d_date_sk"],
                       "left_semi")
            .hash_join(it, [ikey], ["i_item_sk"], "left_semi")
            .hash_join(pr, [pkey], ["p_promo_sk"], "left_semi")
            .hash_join(rets, [ikey, okey], ["r_item", "r_ord"],
                       "left",
                       output=[entcol, f"{pfx}_ext_sales_price",
                               f"{pfx}_net_profit", "r_amt",
                               "r_loss"])
            .hash_join(dim, [entcol], [dim_key], "inner",
                       output=[dim_id, f"{pfx}_ext_sales_price",
                               f"{pfx}_net_profit", "r_amt",
                               "r_loss"])
            .aggregate([dim_id],
                       [f"sum({pfx}_ext_sales_price) AS sales",
                        "sum(coalesce(r_amt, 0.0)) AS returns_",
                        f"sum({pfx}_net_profit -"
                        " coalesce(r_loss, 0.0)) AS profit"])
            .project([f"'{label} channel' AS channel",
                      f"concat('{label}', {dim_id}) AS id", "sales",
                      "returns_", "profit"])
        )

    ssr = leg("store_sales", "ss", "ss_item_sk", "ss_ticket_number",
              "ss_promo_sk", "store_returns", "sr",
              "sr_ticket_number", "sr_return_amt",
              _dim("store", ["s_store_sk", "s_store_id"]),
              "s_store_sk", "s_store_id", "store", "ss_store_sk")
    csr = leg("catalog_sales", "cs", "cs_item_sk", "cs_order_number",
              "cs_promo_sk", "catalog_returns", "cr",
              "cr_order_number", "cr_return_amount",
              _dim("catalog_page",
                   ["cp_catalog_page_sk", "cp_catalog_page_id"]),
              "cp_catalog_page_sk", "cp_catalog_page_id",
              "catalog_page", "cs_catalog_page_sk")
    wsr = leg("web_sales", "ws", "ws_item_sk", "ws_order_number",
              "ws_promo_sk", "web_returns", "wr", "wr_order_number",
              "wr_return_amt",
              _dim("web_site", ["web_site_sk", "web_site_id"]),
              "web_site_sk", "web_site_id", "web_site",
              "ws_web_site_sk")
    return _rollup_report([ssr, csr, wsr])


# ------------------------------------------------------------------
# q51: cumulative web-vs-store revenue cross
# ------------------------------------------------------------------

def q51(month_seq_lo: int = 1200) -> PlanBuilder:
    """Item/date points where cumulative web sales overtake cumulative
    store sales (spec q51: two windowed CTEs FULL OUTER joined on
    (item, date), then running max of each side)."""
    def v1(fact, dcol, icol, price, sfx):
        dt = _dim("date_dim", ["d_date_sk", "d_date", "d_month_seq"],
                  f"d_month_seq >= {month_seq_lo} AND "
                  f"d_month_seq <= {month_seq_lo + 11}")
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol, price])
            .filter(f"is_not_null({icol})")
            .hash_join(dt, [dcol], ["d_date_sk"], "inner",
                       output=[icol, "d_date", price])
            .aggregate([icol, "d_date"],
                       [f"sum({price}) AS sales{sfx}"])
            .window([icol], ["d_date"],
                    [f"sum(sales{sfx}) AS cume{sfx} rows between"
                     " unbounded preceding and current row"])
            .project([f"{icol} AS item{sfx}", f"d_date AS date{sfx}",
                      f"cume{sfx}"])
        )

    web = v1("web_sales", "ws_sold_date_sk", "ws_item_sk",
             "ws_sales_price", "_w")
    store = v1("store_sales", "ss_sold_date_sk", "ss_item_sk",
               "ss_sales_price", "_s")
    return (
        web
        .hash_join(store, ["item_w", "date_w"],
                   ["item_s", "date_s"], "full",
                   output=["item_w", "date_w", "cume_w", "item_s",
                           "date_s", "cume_s"])
        .project(["coalesce(item_w, item_s) AS item_sk",
                  "coalesce(date_w, date_s) AS d_date",
                  "cume_w AS web_sales", "cume_s AS store_sales"])
        .window(["item_sk"], ["d_date"],
                ["max(web_sales) AS web_cumulative rows between"
                 " unbounded preceding and current row",
                 "max(store_sales) AS store_cumulative rows between"
                 " unbounded preceding and current row"])
        .filter("web_cumulative > store_cumulative")
        .project(["item_sk", "d_date", "web_sales", "store_sales",
                  "web_cumulative", "store_cumulative"])
        .order_by(["item_sk", "d_date"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q67: 8-level rollup ranked within category
# ------------------------------------------------------------------

def q67(month_seq_lo: int = 1200) -> PlanBuilder:
    """Top-100 sales cells per category over an 8-column ROLLUP
    (spec q67)."""
    dt = _dim("date_dim",
              ["d_date_sk", "d_year", "d_qoy", "d_moy",
               "d_month_seq"],
              f"d_month_seq >= {month_seq_lo} AND "
              f"d_month_seq <= {month_seq_lo + 11}")
    st = _dim("store", ["s_store_sk", "s_store_id"])
    it = _dim("item", ["i_item_sk", "i_category", "i_class",
                       "i_brand", "i_product_name"])
    cols = ["i_category", "i_class", "i_brand", "i_product_name",
            "d_year", "d_qoy", "d_moy", "s_store_id"]
    sets = [cols[:i] for i in range(len(cols), -1, -1)]
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk",
                             "ss_store_sk", "ss_sales_price",
                             "ss_quantity"])
        .hash_join(dt, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_item_sk", "ss_store_sk",
                           "ss_sales_price", "ss_quantity",
                           "d_year", "d_qoy", "d_moy"])
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["ss_item_sk", "ss_sales_price",
                           "ss_quantity", "d_year", "d_qoy",
                           "d_moy", "s_store_id"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["ss_sales_price", "ss_quantity",
                           "d_year", "d_qoy", "d_moy", "s_store_id",
                           "i_category", "i_class", "i_brand",
                           "i_product_name"])
        .project([*cols,
                  "coalesce(ss_sales_price * ss_quantity, 0.0)"
                  " AS amt"])
        .group_id(sets)
        .aggregate([*cols, "group_id"], ["sum(amt) AS sumsales"])
        .window(["i_category"], ["sumsales DESC"],
                ["rank() AS rk"])
        .filter("rk <= 100")
        .project([*cols, "sumsales", "rk"])
        .order_by(["i_category", "i_class", "i_brand",
                   "i_product_name", "d_year", "d_qoy", "d_moy",
                   "s_store_id", "sumsales", "rk"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q54: revenue segments of cross-channel maternity shoppers
# ------------------------------------------------------------------

def q54(year: int = 1998, moy: int = 12,
        category: str = "Women", iclass: str = "maternity",
        geo_filter: bool = True) -> PlanBuilder:
    """$50 revenue-segment histogram of store revenue from customers
    who bought the target category via catalog/web in one month
    (spec q54).

    ``geo_filter=False`` drops the spec's store-county/state address
    clause: at tiny SF both stores sit in one county with ~0 customer
    addresses, so the spec-exact query is structurally empty — tests
    run both forms (exact vs oracle, relaxed for non-vacuity)."""
    it = _dim("item", ["i_item_sk", "i_category", "i_class"],
              f"i_category = '{category}' AND i_class = '{iclass}'")
    dt = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
              f"d_year = {year} AND d_moy = {moy}")
    cs = (PlanBuilder()
          .table_scan("catalog_sales",
                      columns=["cs_sold_date_sk",
                               "cs_bill_customer_sk", "cs_item_sk"])
          .project(["cs_sold_date_sk AS sold_date_sk",
                    "cs_bill_customer_sk AS customer_sk",
                    "cs_item_sk AS item_sk"]))
    ws = (PlanBuilder()
          .table_scan("web_sales",
                      columns=["ws_sold_date_sk",
                               "ws_bill_customer_sk", "ws_item_sk"])
          .project(["ws_sold_date_sk AS sold_date_sk",
                    "ws_bill_customer_sk AS customer_sk",
                    "ws_item_sk AS item_sk"]))
    cu = _dim("customer", ["c_customer_sk", "c_current_addr_sk"])
    my_customers = (
        cs.union_all([ws])
        .hash_join(dt, ["sold_date_sk"], ["d_date_sk"], "left_semi")
        .hash_join(it, ["item_sk"], ["i_item_sk"], "left_semi")
        .hash_join(cu, ["customer_sk"], ["c_customer_sk"], "inner",
                   output=["c_customer_sk", "c_current_addr_sk"])
        .distinct()
    )
    # month_seq window (seq+1 .. seq+3) via a one-row cross join —
    # the spec's scalar subqueries
    seq = (PlanBuilder()
           .table_scan("date_dim", columns=["d_date_sk", "d_year",
                                            "d_moy", "d_month_seq"])
           .filter(f"d_year = {year} AND d_moy = {moy}")
           .project(["d_month_seq"]).distinct()
           .enforce_single_row()
           .project(["d_month_seq AS seq0"]))
    dt3 = (PlanBuilder()
           .table_scan("date_dim", columns=["d_date_sk",
                                            "d_month_seq"])
           .cross_join(seq)
           .filter("d_month_seq >= seq0 + 1 AND "
                   "d_month_seq <= seq0 + 3")
           .project(["d_date_sk AS w_date_sk"]))
    ca = _dim("customer_address",
              ["ca_address_sk", "ca_county", "ca_state"])
    st = _dim("store", ["s_store_sk", "s_county", "s_state"])
    county_state = (st.project(["s_county", "s_state"]).distinct()
                    .project(["s_county AS okc", "s_state AS oks"]))
    revenue = (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_customer_sk",
                             "ss_ext_sales_price"])
        .hash_join(dt3, ["ss_sold_date_sk"], ["w_date_sk"],
                   "left_semi")
        .hash_join(my_customers, ["ss_customer_sk"],
                   ["c_customer_sk"], "inner",
                   output=["ss_customer_sk", "ss_ext_sales_price",
                           "c_current_addr_sk"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner",
                   output=["ss_customer_sk", "ss_ext_sales_price",
                           "ca_county", "ca_state"])
    )
    if geo_filter:
        revenue = revenue.hash_join(
            county_state, ["ca_county", "ca_state"], ["okc", "oks"],
            "left_semi")
    revenue = revenue.aggregate(
        ["ss_customer_sk"], ["sum(ss_ext_sales_price) AS revenue"])
    return (
        revenue
        .project(["cast(revenue / 50.0 AS INTEGER) AS segment"])
        .aggregate(["segment"], ["count() AS num_customers"])
        .project(["segment", "num_customers",
                  "segment * 50 AS segment_base"])
        .order_by(["segment", "num_customers"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q72: inventory shortfall promo/no-promo counts
# ------------------------------------------------------------------

def q72(year: int = 1999, buy_potential: str = ">10000",
        marital: str = "D") -> PlanBuilder:
    """Catalog lines whose same-week inventory ran short, shipped >5
    days late, bucketed by promotion presence (spec q72). The spec's
    d1.d_week_seq = d2.d_week_seq cross-filter becomes a (item, week)
    equi-join against week-keyed inventory."""
    d1 = _dim("date_dim", ["d_date_sk", "d_date", "d_week_seq",
                           "d_year"], f"d_year = {year}")
    d2 = _dim("date_dim", ["d_date_sk", "d_week_seq"])
    d3 = _dim("date_dim", ["d_date_sk", "d_date"])
    hd = _dim("household_demographics",
              ["hd_demo_sk", "hd_buy_potential"],
              f"hd_buy_potential = '{buy_potential}'")
    cd = _dim("customer_demographics",
              ["cd_demo_sk", "cd_marital_status"],
              f"cd_marital_status = '{marital}'")
    it = _dim("item", ["i_item_sk", "i_item_desc"])
    wh = _dim("warehouse", ["w_warehouse_sk", "w_warehouse_name"])
    inv = (PlanBuilder()
           .table_scan("inventory",
                       columns=["inv_date_sk", "inv_item_sk",
                                "inv_warehouse_sk",
                                "inv_quantity_on_hand"])
           .hash_join(d2, ["inv_date_sk"], ["d_date_sk"], "inner",
                      output=["inv_item_sk", "inv_warehouse_sk",
                              "inv_quantity_on_hand", "d_week_seq"])
           .project(["inv_item_sk", "inv_warehouse_sk",
                     "inv_quantity_on_hand",
                     "d_week_seq AS inv_week"]))
    pr = (PlanBuilder()
          .table_scan("promotion", columns=["p_promo_sk"])
          .project(["p_promo_sk AS pp_sk"]))
    ret = (PlanBuilder()
           .table_scan("catalog_returns",
                       columns=["cr_item_sk", "cr_order_number"])
           .project(["cr_item_sk AS r_item",
                     "cr_order_number AS r_ord"]))
    return (
        PlanBuilder()
        .table_scan("catalog_sales",
                    columns=["cs_sold_date_sk", "cs_ship_date_sk",
                             "cs_bill_cdemo_sk", "cs_bill_hdemo_sk",
                             "cs_item_sk", "cs_promo_sk",
                             "cs_order_number", "cs_quantity"])
        .hash_join(hd, ["cs_bill_hdemo_sk"], ["hd_demo_sk"],
                   "left_semi")
        .hash_join(cd, ["cs_bill_cdemo_sk"], ["cd_demo_sk"],
                   "left_semi")
        .hash_join(d1, ["cs_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["cs_ship_date_sk", "cs_item_sk",
                           "cs_promo_sk", "cs_order_number",
                           "cs_quantity", "d_date", "d_week_seq"])
        .hash_join(d3.project(["d_date_sk AS ship_sk",
                               "d_date AS ship_date"]),
                   ["cs_ship_date_sk"], ["ship_sk"], "inner",
                   output=["cs_item_sk", "cs_promo_sk",
                           "cs_order_number", "cs_quantity",
                           "d_date", "d_week_seq", "ship_date"])
        .filter("ship_date > d_date + 5")
        .hash_join(inv, ["cs_item_sk", "d_week_seq"],
                   ["inv_item_sk", "inv_week"], "inner",
                   output=["cs_item_sk", "cs_promo_sk",
                           "cs_order_number", "cs_quantity",
                           "d_week_seq", "inv_warehouse_sk",
                           "inv_quantity_on_hand"])
        .filter("inv_quantity_on_hand < cs_quantity")
        .hash_join(wh, ["inv_warehouse_sk"], ["w_warehouse_sk"],
                   "inner",
                   output=["cs_item_sk", "cs_promo_sk",
                           "cs_order_number", "cs_quantity",
                           "d_week_seq", "w_warehouse_name"])
        .hash_join(it, ["cs_item_sk"], ["i_item_sk"], "inner",
                   output=["cs_item_sk", "cs_promo_sk",
                           "cs_order_number", "d_week_seq",
                           "w_warehouse_name", "i_item_desc"])
        .hash_join(pr, ["cs_promo_sk"], ["pp_sk"], "left",
                   output=["cs_item_sk", "cs_order_number",
                           "d_week_seq", "w_warehouse_name",
                           "i_item_desc", "pp_sk"])
        .hash_join(ret, ["cs_item_sk", "cs_order_number"],
                   ["r_item", "r_ord"], "left",
                   output=["d_week_seq", "w_warehouse_name",
                           "i_item_desc", "pp_sk"])
        .aggregate(["i_item_desc", "w_warehouse_name", "d_week_seq"],
                   ["sum(if(is_null(pp_sk), 1, 0)) AS no_promo",
                    "sum(if(is_not_null(pp_sk), 1, 0)) AS promo",
                    "count() AS total_cnt"])
        .order_by(["total_cnt DESC", "i_item_desc",
                   "w_warehouse_name", "d_week_seq"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q78: store sales vs other-channel sales per (year, item, customer)
# ------------------------------------------------------------------

def q78(year: int = 2000) -> PlanBuilder:
    """Store-channel quantities/costs per (item, customer) vs the
    combined web+catalog channels, unreturned lines only (spec q78:
    three CTEs with returns ANTI-joined out, LEFT joined on
    (year, item, customer))."""
    dt = _dim("date_dim", ["d_date_sk", "d_year"], f"d_year = {year}")

    def leg(fact, pfx, okey, ret, rpfx, rokey, ccol, sfx):
        rt = (PlanBuilder()
              .table_scan(ret, columns=[f"{rpfx}_item_sk", rokey])
              .project([f"{rpfx}_item_sk AS r_item",
                        f"{rokey} AS r_ord"]))
        return (
            PlanBuilder()
            .table_scan(fact,
                        columns=[f"{pfx}_sold_date_sk", f"{pfx}_item_sk",
                                 ccol, okey, f"{pfx}_quantity",
                                 f"{pfx}_wholesale_cost",
                                 f"{pfx}_sales_price"])
            .hash_join(rt, [okey, f"{pfx}_item_sk"],
                       ["r_ord", "r_item"], "anti_simple")
            .hash_join(dt, [f"{pfx}_sold_date_sk"], ["d_date_sk"],
                       "left_semi")
            .filter(f"is_not_null({ccol})")
            .aggregate([f"{pfx}_item_sk", ccol],
                       [f"sum({pfx}_quantity) AS qty{sfx}",
                        f"sum({pfx}_wholesale_cost) AS wc{sfx}",
                        f"sum({pfx}_sales_price) AS sp{sfx}"])
            .project([f"{pfx}_item_sk AS item{sfx}",
                      f"{ccol} AS cust{sfx}",
                      f"qty{sfx}", f"wc{sfx}", f"sp{sfx}"])
        )

    ss = leg("store_sales", "ss", "ss_ticket_number",
             "store_returns", "sr", "sr_ticket_number",
             "ss_customer_sk", "_s")
    ws = leg("web_sales", "ws", "ws_order_number",
             "web_returns", "wr", "wr_order_number",
             "ws_bill_customer_sk", "_w")
    cs = leg("catalog_sales", "cs", "cs_order_number",
             "catalog_returns", "cr", "cr_order_number",
             "cs_bill_customer_sk", "_c")
    return (
        ss
        .hash_join(ws, ["item_s", "cust_s"], ["item_w", "cust_w"],
                   "left",
                   output=["item_s", "cust_s", "qty_s", "wc_s",
                           "sp_s", "qty_w", "wc_w", "sp_w"])
        .hash_join(cs, ["item_s", "cust_s"], ["item_c", "cust_c"],
                   "left",
                   output=["item_s", "cust_s", "qty_s", "wc_s",
                           "sp_s", "qty_w", "wc_w", "sp_w", "qty_c",
                           "wc_c", "sp_c"])
        .filter("coalesce(qty_w, 0.0) > 0.0 OR"
                " coalesce(qty_c, 0.0) > 0.0")
        .project([
            f"{year} AS ss_sold_year", "item_s AS ss_item_sk",
            "cust_s AS ss_customer_sk",
            "round(qty_s / (coalesce(qty_w, 0.0)"
            " + coalesce(qty_c, 0.0)), 2) AS ratio",
            "qty_s AS store_qty", "wc_s AS store_wholesale_cost",
            "sp_s AS store_sales_price",
            "coalesce(qty_w, 0.0) + coalesce(qty_c, 0.0)"
            " AS other_chan_qty",
            "coalesce(wc_w, 0.0) + coalesce(wc_c, 0.0)"
            " AS other_chan_wholesale_cost",
            "coalesce(sp_w, 0.0) + coalesce(sp_c, 0.0)"
            " AS other_chan_sales_price"])
        .order_by(["ss_sold_year", "ss_item_sk", "ss_customer_sk",
                   "store_qty DESC", "store_wholesale_cost DESC",
                   "store_sales_price DESC", "other_chan_qty",
                   "other_chan_wholesale_cost",
                   "other_chan_sales_price", "ratio"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q23: catalog+web sales of frequent store items by best store customers
# ------------------------------------------------------------------

def q23(year: int = 2000, moy: int = 2, freq: int = 4,
        pct: float = 0.95) -> PlanBuilder:
    """Total catalog+web sales in one month restricted to items bought
    >``freq`` times a day in store over 4 years and to customers whose
    store spend exceeds ``pct`` of the best store customer (spec q23
    iteration 1: frequent_ss_items / max_store_sales /
    best_ss_customer CTEs)."""
    years = f"d_year >= {year} AND d_year <= {year + 3}"
    dt4 = _dim("date_dim", ["d_date_sk", "d_date", "d_year"], years)
    it = _dim("item", ["i_item_sk", "i_item_desc"])

    frequent = (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_item_sk"])
        .hash_join(dt4, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=["ss_item_sk", "d_date"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["ss_item_sk", "i_item_desc", "d_date"])
        .project(["substr(i_item_desc, 1, 30) AS itemdesc",
                  "ss_item_sk", "d_date"])
        .aggregate(["itemdesc", "ss_item_sk", "d_date"],
                   ["count() AS cnt"])
        .filter(f"cnt > {freq}")
        .project(["ss_item_sk AS freq_item"])
        .distinct()
    )

    per_cust4 = (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_sold_date_sk", "ss_customer_sk",
                             "ss_quantity", "ss_sales_price"])
        .filter("is_not_null(ss_customer_sk)")
        .hash_join(dt4, ["ss_sold_date_sk"], ["d_date_sk"],
                   "left_semi")
        .project(["ss_customer_sk",
                  "ss_quantity * ss_sales_price AS csales"])
        .aggregate(["ss_customer_sk"], ["sum(csales) AS csales"])
    )
    max_sales = (per_cust4
                 .aggregate([], ["max(csales) AS tpcds_cmax"])
                 .enforce_single_row())

    best = (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_customer_sk", "ss_quantity",
                             "ss_sales_price"])
        .filter("is_not_null(ss_customer_sk)")
        .project(["ss_customer_sk",
                  "ss_quantity * ss_sales_price AS ssales"])
        .aggregate(["ss_customer_sk"], ["sum(ssales) AS ssales"])
        .cross_join(max_sales)
        .filter(f"ssales > {pct} * tpcds_cmax")
        .project(["ss_customer_sk AS best_cust"])
    )

    dt1 = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
               f"d_year = {year} AND d_moy = {moy}")

    def sales_leg(fact, dcol, icol, ccol, qty, price):
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol, ccol, qty, price])
            .hash_join(dt1, [dcol], ["d_date_sk"], "left_semi")
            .hash_join(frequent, [icol], ["freq_item"], "left_semi")
            .hash_join(best, [ccol], ["best_cust"], "left_semi")
            .project([f"{qty} * {price} AS sales"])
        )

    cs = sales_leg("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                   "cs_bill_customer_sk", "cs_quantity",
                   "cs_list_price")
    ws = sales_leg("web_sales", "ws_sold_date_sk", "ws_item_sk",
                   "ws_bill_customer_sk", "ws_quantity",
                   "ws_list_price")
    return (cs.union_all([ws])
            .aggregate([], ["sum(sales) AS total_sales"])
            .limit(100))


# ------------------------------------------------------------------
# q14: cross-channel item INTERSECT with above-average sales rollup
# ------------------------------------------------------------------

def q14(year: int = 1999, moy: int = 11) -> PlanBuilder:
    """Channel/brand/class/category ROLLUP of sales in one month over
    items sold in ALL three channels during [year, year+2], keeping only
    cells above the cross-channel average unit sale (spec q14
    iteration 1: cross_items INTERSECT + avg_sales scalar CTE)."""
    years = f"d_year >= {year} AND d_year <= {year + 2}"
    dt3 = _dim("date_dim", ["d_date_sk", "d_year"], years)
    it_ids = _dim("item", ["i_item_sk", "i_brand_id", "i_class_id",
                           "i_category_id"])

    def triples(fact, dcol, icol, sfx):
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol])
            .hash_join(dt3, [dcol], ["d_date_sk"], "left_semi")
            .hash_join(it_ids, [icol], ["i_item_sk"], "inner",
                       output=["i_brand_id", "i_class_id",
                               "i_category_id"])
            .distinct()
            .project([f"i_brand_id AS b{sfx}",
                      f"i_class_id AS c{sfx}",
                      f"i_category_id AS g{sfx}"])
        )

    ss_t = triples("store_sales", "ss_sold_date_sk", "ss_item_sk",
                   "_s")
    cs_t = triples("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                   "_c")
    ws_t = triples("web_sales", "ws_sold_date_sk", "ws_item_sk",
                   "_w")
    cross_triples = (
        ss_t
        .hash_join(cs_t, ["b_s", "c_s", "g_s"],
                   ["b_c", "c_c", "g_c"], "left_semi")
        .hash_join(ws_t, ["b_s", "c_s", "g_s"],
                   ["b_w", "c_w", "g_w"], "left_semi")
    )
    cross_items = (
        _dim("item", ["i_item_sk", "i_brand_id", "i_class_id",
                      "i_category_id"])
        .hash_join(cross_triples,
                   ["i_brand_id", "i_class_id", "i_category_id"],
                   ["b_s", "c_s", "g_s"], "left_semi")
        .project(["i_item_sk AS x_item"])
    )

    def unit_sales(fact, dcol, qty, price):
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, qty, price])
            .hash_join(dt3, [dcol], ["d_date_sk"], "left_semi")
            .project([f"{qty} * {price} AS unit"])
        )

    avg_sales = (
        unit_sales("store_sales", "ss_sold_date_sk", "ss_quantity",
                   "ss_list_price")
        .union_all([
            unit_sales("catalog_sales", "cs_sold_date_sk",
                       "cs_quantity", "cs_list_price"),
            unit_sales("web_sales", "ws_sold_date_sk", "ws_quantity",
                       "ws_list_price")])
        .aggregate([], ["avg(unit) AS average_sales"])
        .enforce_single_row()
    )

    dt1 = _dim("date_dim", ["d_date_sk", "d_year", "d_moy"],
               f"d_year = {year + 2} AND d_moy = {moy}")

    def channel_leg(fact, dcol, icol, qty, price, label):
        return (
            PlanBuilder()
            .table_scan(fact, columns=[dcol, icol, qty, price])
            .hash_join(dt1, [dcol], ["d_date_sk"], "left_semi")
            .hash_join(cross_items, [icol], ["x_item"], "left_semi")
            .hash_join(it_ids, [icol], ["i_item_sk"], "inner",
                       output=["i_brand_id", "i_class_id",
                               "i_category_id", qty, price])
            .project(["i_brand_id", "i_class_id", "i_category_id",
                      f"{qty} * {price} AS amt"])
            .aggregate(["i_brand_id", "i_class_id", "i_category_id"],
                       ["sum(amt) AS sales",
                        "count() AS number_sales"])
            .cross_join(avg_sales)
            .filter("sales > average_sales")
            .project([f"'{label}' AS channel", "i_brand_id",
                      "i_class_id", "i_category_id", "sales",
                      "number_sales"])
        )

    store = channel_leg("store_sales", "ss_sold_date_sk",
                        "ss_item_sk", "ss_quantity", "ss_list_price",
                        "store")
    catalog = channel_leg("catalog_sales", "cs_sold_date_sk",
                          "cs_item_sk", "cs_quantity",
                          "cs_list_price", "catalog")
    web = channel_leg("web_sales", "ws_sold_date_sk", "ws_item_sk",
                      "ws_quantity", "ws_list_price", "web")
    cols = ["channel", "i_brand_id", "i_class_id", "i_category_id"]
    sets = [cols[:i] for i in range(len(cols), -1, -1)]
    return (
        store.union_all([catalog, web])
        .group_id(sets)
        .aggregate([*cols, "group_id"],
                   ["sum(sales) AS sum_sales",
                    "sum(number_sales) AS sum_number_sales"])
        .project([*cols, "sum_sales", "sum_number_sales"])
        .order_by(cols)
        .limit(100)
    )


# ------------------------------------------------------------------
# q24: returned store purchases by customers born abroad, per color
# ------------------------------------------------------------------

def q24(color: str = "sky", market_id: int = 8, frac: float = 0.05,
        zip_match: bool = True) -> PlanBuilder:
    """Per-customer net paid on returned store purchases of one color,
    kept when above ``frac`` of the mean across all colors (spec q24's
    ssales CTE + scalar-avg HAVING).

    ``zip_match=False`` drops the spec's s_zip = ca_zip clause: at tiny
    SF no customer address shares the (single) store zip, so the
    spec-exact query is structurally empty — tests run both forms."""
    sr = (PlanBuilder()
          .table_scan("store_returns",
                      columns=["sr_ticket_number", "sr_item_sk"])
          .project(["sr_ticket_number AS r_ticket",
                    "sr_item_sk AS r_item"]))
    st = _dim("store",
              ["s_store_sk", "s_store_name", "s_state", "s_zip",
               "s_market_id"], f"s_market_id = {market_id}")
    it = _dim("item", ["i_item_sk", "i_color", "i_current_price",
                       "i_manager_id", "i_units", "i_size"])
    cu = _dim("customer",
              ["c_customer_sk", "c_last_name", "c_first_name",
               "c_birth_country", "c_current_addr_sk"])
    ca = _dim("customer_address",
              ["ca_address_sk", "ca_state", "ca_zip", "ca_country"])
    ssales = (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_ticket_number", "ss_item_sk",
                             "ss_customer_sk", "ss_store_sk",
                             "ss_net_paid"])
        .hash_join(sr, ["ss_ticket_number", "ss_item_sk"],
                   ["r_ticket", "r_item"], "left_semi")
        .hash_join(st, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=["ss_item_sk", "ss_customer_sk",
                           "ss_net_paid", "s_store_name", "s_state",
                           "s_zip"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["ss_customer_sk", "ss_net_paid",
                           "s_store_name", "s_state", "s_zip",
                           "i_color", "i_current_price",
                           "i_manager_id", "i_units", "i_size"])
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"],
                   "inner",
                   output=["ss_net_paid", "s_store_name", "s_state",
                           "s_zip", "i_color", "i_current_price",
                           "i_manager_id", "i_units", "i_size",
                           "c_last_name", "c_first_name",
                           "c_birth_country", "c_current_addr_sk"])
        .hash_join(ca, ["c_current_addr_sk"], ["ca_address_sk"],
                   "inner",
                   output=["ss_net_paid", "s_store_name", "s_state",
                           "s_zip", "i_color", "i_current_price",
                           "i_manager_id", "i_units", "i_size",
                           "c_last_name", "c_first_name",
                           "c_birth_country", "ca_state", "ca_zip",
                           "ca_country"])
        .filter("c_birth_country != upper(ca_country)")
    )
    if zip_match:
        ssales = ssales.filter("s_zip = ca_zip")
    ssales = ssales.aggregate(
        ["c_last_name", "c_first_name", "s_store_name", "ca_state",
         "s_state", "i_color", "i_current_price", "i_manager_id",
         "i_units", "i_size"],
        ["sum(ss_net_paid) AS netpaid"])

    avg_paid = (ssales.fork()
                .aggregate([], ["avg(netpaid) AS avg_netpaid"])
                .enforce_single_row())
    return (
        ssales
        .filter(f"i_color = '{color}'")
        .aggregate(["c_last_name", "c_first_name", "s_store_name"],
                   ["sum(netpaid) AS paid"])
        .cross_join(avg_paid)
        .filter(f"paid > {frac} * avg_netpaid")
        .project(["c_last_name", "c_first_name", "s_store_name",
                  "paid"])
        .order_by(["c_last_name", "c_first_name", "s_store_name"])
        .limit(100)
    )


# ------------------------------------------------------------------
# q64: two-year store/catalog cross-sales monster
# ------------------------------------------------------------------

_Q64_GROUP = [
    "product_name", "item_sk", "store_name", "store_zip",
    "b_street_number", "b_street_name", "b_city", "b_zip",
    "c_street_number", "c_street_name", "c_city", "c_zip",
    "syear", "fsyear", "s2year",
]


def _q64_cross_sales(colors, price_lo, price_hi) -> PlanBuilder:
    """The cross_sales CTE of spec q64: returned store purchases of
    profitable catalog items, annotated with both customer addresses,
    demographics-mismatch filter, income bands and promotions."""
    cr_amt = ("cr_refunded_cash + cr_reversed_charge"
              " + cr_store_credit")
    cs_ui = (
        PlanBuilder()
        .table_scan("catalog_sales",
                    columns=["cs_item_sk", "cs_order_number",
                             "cs_ext_list_price"])
        .hash_join(
            PlanBuilder().table_scan(
                "catalog_returns",
                columns=["cr_item_sk", "cr_order_number",
                         "cr_refunded_cash", "cr_reversed_charge",
                         "cr_store_credit"]),
            ["cs_item_sk", "cs_order_number"],
            ["cr_item_sk", "cr_order_number"], "inner",
            output=["cs_item_sk", "cs_ext_list_price",
                    "cr_refunded_cash", "cr_reversed_charge",
                    "cr_store_credit"])
        .aggregate(["cs_item_sk"],
                   ["sum(cs_ext_list_price) AS sale",
                    f"sum({cr_amt}) AS refund"])
        .filter("sale > 2.0 * refund")
        .project(["cs_item_sk AS ui_item"])
    )
    color_list = ", ".join(f"'{c}'" for c in colors)
    it = _dim("item",
              ["i_item_sk", "i_product_name", "i_color",
               "i_current_price"],
              f"i_color IN ({color_list}) AND "
              f"i_current_price >= {price_lo} AND "
              f"i_current_price <= {price_hi}")
    sr = (PlanBuilder()
          .table_scan("store_returns",
                      columns=["sr_ticket_number", "sr_item_sk"])
          .project(["sr_ticket_number AS r_ticket",
                    "sr_item_sk AS r_item"]))
    d1 = _dim("date_dim", ["d_date_sk", "d_year"])
    d2 = (_dim("date_dim", ["d_date_sk", "d_year"])
          .project(["d_date_sk AS d2_sk", "d_year AS fsyear"]))
    d3 = (_dim("date_dim", ["d_date_sk", "d_year"])
          .project(["d_date_sk AS d3_sk", "d_year AS s2year"]))
    stdim = _dim("store", ["s_store_sk", "s_store_name", "s_zip"])
    cu = _dim("customer",
              ["c_customer_sk", "c_current_cdemo_sk",
               "c_current_hdemo_sk", "c_current_addr_sk",
               "c_first_sales_date_sk", "c_first_shipto_date_sk"])
    cd1 = (_dim("customer_demographics",
                ["cd_demo_sk", "cd_marital_status"])
           .project(["cd_demo_sk AS cd1_sk",
                     "cd_marital_status AS ms1"]))
    cd2 = (_dim("customer_demographics",
                ["cd_demo_sk", "cd_marital_status"])
           .project(["cd_demo_sk AS cd2_sk",
                     "cd_marital_status AS ms2"]))
    hd1 = (_dim("household_demographics",
                ["hd_demo_sk", "hd_income_band_sk"])
           .project(["hd_demo_sk AS hd1_sk",
                     "hd_income_band_sk AS ib1_ref"]))
    hd2 = (_dim("household_demographics",
                ["hd_demo_sk", "hd_income_band_sk"])
           .project(["hd_demo_sk AS hd2_sk",
                     "hd_income_band_sk AS ib2_ref"]))
    ib1 = (_dim("income_band", ["ib_income_band_sk"])
           .project(["ib_income_band_sk AS ib1_sk"]))
    ib2 = (_dim("income_band", ["ib_income_band_sk"])
           .project(["ib_income_band_sk AS ib2_sk"]))
    ad1 = (_dim("customer_address",
                ["ca_address_sk", "ca_street_number",
                 "ca_street_name", "ca_city", "ca_zip"])
           .project(["ca_address_sk AS ad1_sk",
                     "ca_street_number AS b_street_number",
                     "ca_street_name AS b_street_name",
                     "ca_city AS b_city", "ca_zip AS b_zip"]))
    ad2 = (_dim("customer_address",
                ["ca_address_sk", "ca_street_number",
                 "ca_street_name", "ca_city", "ca_zip"])
           .project(["ca_address_sk AS ad2_sk",
                     "ca_street_number AS c_street_number",
                     "ca_street_name AS c_street_name",
                     "ca_city AS c_city", "ca_zip AS c_zip"]))
    pr = (PlanBuilder().table_scan("promotion",
                                   columns=["p_promo_sk"])
          .project(["p_promo_sk AS pp_sk"]))

    keep = ["ss_item_sk", "ss_wholesale_cost", "ss_list_price",
            "ss_coupon_amt"]
    return (
        PlanBuilder()
        .table_scan("store_sales",
                    columns=["ss_item_sk", "ss_ticket_number",
                             "ss_sold_date_sk", "ss_customer_sk",
                             "ss_cdemo_sk", "ss_hdemo_sk",
                             "ss_addr_sk", "ss_store_sk",
                             "ss_promo_sk", "ss_wholesale_cost",
                             "ss_list_price", "ss_coupon_amt"])
        .hash_join(sr, ["ss_ticket_number", "ss_item_sk"],
                   ["r_ticket", "r_item"], "left_semi")
        .hash_join(cs_ui, ["ss_item_sk"], ["ui_item"], "left_semi")
        .hash_join(pr, ["ss_promo_sk"], ["pp_sk"], "left_semi")
        .hash_join(d1, ["ss_sold_date_sk"], ["d_date_sk"], "inner",
                   output=[*keep, "ss_customer_sk", "ss_cdemo_sk",
                           "ss_hdemo_sk", "ss_addr_sk",
                           "ss_store_sk", "d_year"])
        .project([*keep, "ss_customer_sk", "ss_cdemo_sk",
                  "ss_hdemo_sk", "ss_addr_sk", "ss_store_sk",
                  "d_year AS syear"])
        .hash_join(stdim, ["ss_store_sk"], ["s_store_sk"], "inner",
                   output=[*keep, "ss_customer_sk", "ss_cdemo_sk",
                           "ss_hdemo_sk", "ss_addr_sk", "syear",
                           "s_store_name", "s_zip"])
        .hash_join(ad1, ["ss_addr_sk"], ["ad1_sk"], "inner",
                   output=[*keep, "ss_customer_sk", "ss_cdemo_sk",
                           "ss_hdemo_sk", "syear", "s_store_name",
                           "s_zip", "b_street_number",
                           "b_street_name", "b_city", "b_zip"])
        .hash_join(hd1, ["ss_hdemo_sk"], ["hd1_sk"], "inner",
                   output=[*keep, "ss_customer_sk", "ss_cdemo_sk",
                           "syear", "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip", "ib1_ref"])
        .hash_join(ib1, ["ib1_ref"], ["ib1_sk"], "left_semi")
        .hash_join(cd1, ["ss_cdemo_sk"], ["cd1_sk"], "inner",
                   output=[*keep, "ss_customer_sk", "syear",
                           "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip", "ms1"])
        .hash_join(cu, ["ss_customer_sk"], ["c_customer_sk"],
                   "inner",
                   output=[*keep, "syear", "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip", "ms1",
                           "c_current_cdemo_sk",
                           "c_current_hdemo_sk", "c_current_addr_sk",
                           "c_first_sales_date_sk",
                           "c_first_shipto_date_sk"])
        .hash_join(cd2, ["c_current_cdemo_sk"], ["cd2_sk"], "inner",
                   output=[*keep, "syear", "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip", "ms1",
                           "c_current_hdemo_sk", "c_current_addr_sk",
                           "c_first_sales_date_sk",
                           "c_first_shipto_date_sk", "ms2"])
        .filter("ms1 != ms2")
        .hash_join(hd2, ["c_current_hdemo_sk"], ["hd2_sk"], "inner",
                   output=[*keep, "syear", "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip", "c_current_addr_sk",
                           "c_first_sales_date_sk",
                           "c_first_shipto_date_sk", "ib2_ref"])
        .hash_join(ib2, ["ib2_ref"], ["ib2_sk"], "left_semi")
        .hash_join(ad2, ["c_current_addr_sk"], ["ad2_sk"], "inner",
                   output=[*keep, "syear", "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip",
                           "c_first_sales_date_sk",
                           "c_first_shipto_date_sk",
                           "c_street_number", "c_street_name",
                           "c_city", "c_zip"])
        .hash_join(d2, ["c_first_sales_date_sk"], ["d2_sk"], "inner",
                   output=[*keep, "syear", "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip",
                           "c_first_shipto_date_sk",
                           "c_street_number", "c_street_name",
                           "c_city", "c_zip", "fsyear"])
        .hash_join(d3, ["c_first_shipto_date_sk"], ["d3_sk"],
                   "inner",
                   output=[*keep, "syear", "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip", "c_street_number",
                           "c_street_name", "c_city", "c_zip",
                           "fsyear", "s2year"])
        .hash_join(it, ["ss_item_sk"], ["i_item_sk"], "inner",
                   output=["ss_wholesale_cost", "ss_list_price",
                           "ss_coupon_amt", "ss_item_sk", "syear",
                           "s_store_name", "s_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip", "c_street_number",
                           "c_street_name", "c_city", "c_zip",
                           "fsyear", "s2year", "i_product_name"])
        .project(["i_product_name AS product_name",
                  "ss_item_sk AS item_sk",
                  "s_store_name AS store_name",
                  "s_zip AS store_zip", "b_street_number",
                  "b_street_name", "b_city", "b_zip",
                  "c_street_number", "c_street_name", "c_city",
                  "c_zip", "syear", "fsyear", "s2year",
                  "ss_wholesale_cost", "ss_list_price",
                  "ss_coupon_amt"])
        .aggregate(_Q64_GROUP,
                   ["count() AS cnt",
                    "sum(ss_wholesale_cost) AS s1",
                    "sum(ss_list_price) AS s2",
                    "sum(ss_coupon_amt) AS s3"])
    )


def q64(year: int = 1999,
        colors=("purple", "burlywood", "indian", "spring", "floral",
                "medium"),
        price_lo: float = 64.0, price_hi: float = 74.0
        ) -> PlanBuilder:
    """Items returned in-store and profitable on catalog, compared
    across two consecutive first-sale years at the same store (spec
    q64: the cross_sales CTE self-joined on item/store)."""
    cs = _q64_cross_sales(colors, price_lo, price_hi)
    cs2 = (cs.fork()
           .filter(f"syear = {year + 1}")
           .project(["item_sk AS item_sk2",
                     "store_name AS store_name2",
                     "store_zip AS store_zip2", "syear AS syear2",
                     "cnt AS cnt2", "s1 AS s12", "s2 AS s22",
                     "s3 AS s32"]))
    cs1 = (cs.filter(f"syear = {year}")
           .project([*_Q64_GROUP, "cnt", "s1", "s2", "s3"]))
    return (
        cs1
        .hash_join(cs2, ["item_sk", "store_name", "store_zip"],
                   ["item_sk2", "store_name2", "store_zip2"],
                   "inner",
                   output=["product_name", "store_name", "store_zip",
                           "b_street_number", "b_street_name",
                           "b_city", "b_zip", "c_street_number",
                           "c_street_name", "c_city", "c_zip",
                           "syear", "cnt", "s1", "s2", "s3",
                           "syear2", "cnt2", "s12", "s22", "s32"])
        .filter("cnt2 <= cnt")
        .project(["product_name", "store_name", "store_zip",
                  "b_street_number", "b_street_name", "b_city",
                  "b_zip", "c_street_number", "c_street_name",
                  "c_city", "c_zip", "syear", "cnt",
                  "s1 AS s11", "s2 AS s21", "s3 AS s31",
                  "s12", "s22", "s32", "syear2", "cnt2"])
        .order_by(["product_name", "store_name", "cnt2", "s11",
                   "s12"])
        .limit(100)
    )


HARD_QUERIES = {4: q4, 5: q5, 11: q11, 14: q14, 23: q23, 24: q24,
                51: q51, 54: q54, 58: q58, 64: q64, 67: q67, 72: q72,
                75: q75, 77: q77, 78: q78, 80: q80}
