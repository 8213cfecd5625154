"""TPC-DS data generation: all 24 tables, seeded, with NULLs, without
pyarrow.

The JAX package reads the 24 tables from dsdgen (``io/dsdgen.py``), which
needs the reference's sources; this module makes tables of the same
schemas (``SCHEMAS``, the port's copy of the JAX package's ``_SCHEMAS``:
names, order and type codes) from ``np.random.default_rng(seed)`` alone,
so both packages can be fed the same arrays.

* Fixed dimensions are built as the specification builds them, with no
  draws: ``date_dim`` (73,049 days from 1900-01-02, ``d_date_sk`` the
  Julian day number, every calendar column derived from the date, so
  ``d_month_seq = (year - 1900) * 12 + month - 1``), ``time_dim``
  (86,400 seconds), ``customer_demographics`` (the 1,920,800-row product
  of its eight domains), ``household_demographics`` (7,200),
  ``income_band`` (20), ``ship_mode`` (20) and ``reason`` (35).
* Scaled dimensions have the specification's SF1 rows (item 18,000,
  customer 100,000, customer_address 50,000, store 12, promotion 300,
  warehouse 5, web_site 30, web_page 60, call_center 6, catalog_page
  11,718) and shrink linearly below SF1 down to a floor (``_DIMS``).
  Each column a query filters or groups on draws from a value list that
  holds every literal the 99 plans compare it with (``DOMAINS``); the
  few-row tables place the literals their plans need in rows of their
  own (``_PLACED``: store cities, county, state and market, a web
  page's character count).
* Fact tables: store_sales 2,880,404, catalog_sales 1,441,548 and
  web_sales 719,384 rows at SF1, linear in SF, sold 1998-01-02 ..
  2003-01-02. Lines come in tickets and orders of 1-20 lines that share
  the date, time, customer and demographics (and the store or call
  center) and hold distinct items. Money is int64 cents inside
  DECIMAL(7, 2), with the specification's identities: ``ext_sales_price
  = quantity * sales_price``, ``ext_discount_amt = quantity *
  (list_price - sales_price)``, ``net_paid = ext_sales_price -
  coupon_amt``, ``net_profit = net_paid - ext_wholesale_cost`` and the
  ``net_paid_inc_*`` sums. A fifth of the catalog orders re-buy the
  item of a store return (its customer, on or after the return date).
  ``inventory`` holds one row per warehouse, week (261 weeks from
  1998-01-01) and item of the current item versions (the odd
  ``i_item_sk``): 11,745,000 rows at SF1. Each returns table holds one
  row for a tenth of its sales lines (``row_counts``), with the line's
  item, ticket or order number, customer and demographics, returned on
  or after its sale.
* NULLs: in the fact tables every column but the primary key
  (``*_item_sk`` with the ticket or order number; inventory's three
  keys) is NULL at ``FACT_NULL_RATE`` (4%) per row, independently; a
  returns row keeps the NULLs of the columns it copies from its sale. In
  the scaled dimensions every column but the surrogate key and the
  ``*_id`` business key is NULL at ``DIM_NULL_RATE`` (2%). The fixed
  dimensions hold no NULL but where the specification has none to give
  (``t_meal_time`` outside meal hours, ``c_login``, the open end of a
  record's validity).

Strings come out as int32 codes (-1 is NULL) into one sorted value list
per column (column names are unique across the tables), dates as
``datetime64[D]``, money as int64 cents; ``nulls`` maps each table to a
bool mask by non-string column, True where the value is NULL (the value
there is 0). ``register_full`` registers money as the JAX package's
``dsdgen_tables`` view: float64 of the cents times 0.01.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Columns = Dict[str, np.ndarray]

# compact schema codes: k=int64 key, i=int32, s=varchar, d=date,
# (m, p)=DECIMAL(p, 2) money; the port's copy of the JAX package's
# ``io/dsdgen.py`` schemas (velox's TpcdsGen getTableSchema)
_K, _I, _S, _D = "k", "i", "s", "d"


def _m(p: int = 7):
    return ("m", p)


SCHEMAS: Dict[str, list] = {
    "call_center": [
        ("cc_call_center_sk", _K), ("cc_call_center_id", _S),
        ("cc_rec_start_date", _D), ("cc_rec_end_date", _D),
        ("cc_closed_date_sk", _I), ("cc_open_date_sk", _I),
        ("cc_name", _S), ("cc_class", _S), ("cc_employees", _I),
        ("cc_sq_ft", _I), ("cc_hours", _S), ("cc_manager", _S),
        ("cc_mkt_id", _I), ("cc_mkt_class", _S), ("cc_mkt_desc", _S),
        ("cc_market_manager", _S), ("cc_division", _I),
        ("cc_division_name", _S), ("cc_company", _I),
        ("cc_company_name", _S), ("cc_street_number", _S),
        ("cc_street_name", _S), ("cc_street_type", _S),
        ("cc_suite_number", _S), ("cc_city", _S), ("cc_county", _S),
        ("cc_state", _S), ("cc_zip", _S), ("cc_country", _S),
        ("cc_gmt_offset", _m(5)), ("cc_tax_percentage", _m(5)),
    ],
    "catalog_page": [
        ("cp_catalog_page_sk", _K), ("cp_catalog_page_id", _S),
        ("cp_start_date_sk", _I), ("cp_end_date_sk", _I),
        ("cp_department", _S), ("cp_catalog_number", _I),
        ("cp_catalog_page_number", _I), ("cp_description", _S),
        ("cp_type", _S),
    ],
    "catalog_returns": [
        ("cr_returned_date_sk", _K), ("cr_returned_time_sk", _K),
        ("cr_item_sk", _K), ("cr_refunded_customer_sk", _K),
        ("cr_refunded_cdemo_sk", _K), ("cr_refunded_hdemo_sk", _K),
        ("cr_refunded_addr_sk", _K), ("cr_returning_customer_sk", _K),
        ("cr_returning_cdemo_sk", _K), ("cr_returning_hdemo_sk", _K),
        ("cr_returning_addr_sk", _K), ("cr_call_center_sk", _K),
        ("cr_catalog_page_sk", _K), ("cr_ship_mode_sk", _K),
        ("cr_warehouse_sk", _K), ("cr_reason_sk", _K),
        ("cr_order_number", _K), ("cr_return_quantity", _I),
        ("cr_return_amount", _m()), ("cr_return_tax", _m()),
        ("cr_return_amt_inc_tax", _m()), ("cr_fee", _m()),
        ("cr_return_ship_cost", _m()), ("cr_refunded_cash", _m()),
        ("cr_reversed_charge", _m()), ("cr_store_credit", _m()),
        ("cr_net_loss", _m()),
    ],
    "catalog_sales": [
        ("cs_sold_date_sk", _K), ("cs_sold_time_sk", _K),
        ("cs_ship_date_sk", _K), ("cs_bill_customer_sk", _K),
        ("cs_bill_cdemo_sk", _K), ("cs_bill_hdemo_sk", _K),
        ("cs_bill_addr_sk", _K), ("cs_ship_customer_sk", _K),
        ("cs_ship_cdemo_sk", _K), ("cs_ship_hdemo_sk", _K),
        ("cs_ship_addr_sk", _K), ("cs_call_center_sk", _K),
        ("cs_catalog_page_sk", _K), ("cs_ship_mode_sk", _K),
        ("cs_warehouse_sk", _K), ("cs_item_sk", _K),
        ("cs_promo_sk", _K), ("cs_order_number", _K),
        ("cs_quantity", _I), ("cs_wholesale_cost", _m()),
        ("cs_list_price", _m()), ("cs_sales_price", _m()),
        ("cs_ext_discount_amt", _m()), ("cs_ext_sales_price", _m()),
        ("cs_ext_wholesale_cost", _m()), ("cs_ext_list_price", _m()),
        ("cs_ext_tax", _m()), ("cs_coupon_amt", _m()),
        ("cs_ext_ship_cost", _m()), ("cs_net_paid", _m()),
        ("cs_net_paid_inc_tax", _m()), ("cs_net_paid_inc_ship", _m()),
        ("cs_net_paid_inc_ship_tax", _m()), ("cs_net_profit", _m()),
    ],
    "customer": [
        ("c_customer_sk", _K), ("c_customer_id", _S),
        ("c_current_cdemo_sk", _K), ("c_current_hdemo_sk", _K),
        ("c_current_addr_sk", _K), ("c_first_shipto_date_sk", _K),
        ("c_first_sales_date_sk", _K), ("c_salutation", _S),
        ("c_first_name", _S), ("c_last_name", _S),
        ("c_preferred_cust_flag", _S), ("c_birth_day", _I),
        ("c_birth_month", _I), ("c_birth_year", _I),
        ("c_birth_country", _S), ("c_login", _S),
        ("c_email_address", _S), ("c_last_review_date_sk", _K),
    ],
    "customer_address": [
        ("ca_address_sk", _K), ("ca_address_id", _S),
        ("ca_street_number", _S), ("ca_street_name", _S),
        ("ca_street_type", _S), ("ca_suite_number", _S),
        ("ca_city", _S), ("ca_county", _S), ("ca_state", _S),
        ("ca_zip", _S), ("ca_country", _S), ("ca_gmt_offset", _m(5)),
        ("ca_location_type", _S),
    ],
    "customer_demographics": [
        ("cd_demo_sk", _K), ("cd_gender", _S),
        ("cd_marital_status", _S), ("cd_education_status", _S),
        ("cd_purchase_estimate", _I), ("cd_credit_rating", _S),
        ("cd_dep_count", _I), ("cd_dep_employed_count", _I),
        ("cd_dep_college_count", _I),
    ],
    "date_dim": [
        ("d_date_sk", _K), ("d_date_id", _S), ("d_date", _D),
        ("d_month_seq", _I), ("d_week_seq", _I), ("d_quarter_seq", _I),
        ("d_year", _I), ("d_dow", _I), ("d_moy", _I), ("d_dom", _I),
        ("d_qoy", _I), ("d_fy_year", _I), ("d_fy_quarter_seq", _I),
        ("d_fy_week_seq", _I), ("d_day_name", _S),
        ("d_quarter_name", _S), ("d_holiday", _S), ("d_weekend", _S),
        ("d_following_holiday", _S), ("d_first_dom", _I),
        ("d_last_dom", _I), ("d_same_day_ly", _I),
        ("d_same_day_lq", _I), ("d_current_day", _S),
        ("d_current_week", _S), ("d_current_month", _S),
        ("d_current_quarter", _S), ("d_current_year", _S),
    ],
    "household_demographics": [
        ("hd_demo_sk", _K), ("hd_income_band_sk", _K),
        ("hd_buy_potential", _S), ("hd_dep_count", _I),
        ("hd_vehicle_count", _I),
    ],
    "income_band": [
        ("ib_income_band_sk", _K), ("ib_lower_bound", _I),
        ("ib_upper_bound", _I),
    ],
    "inventory": [
        ("inv_date_sk", _K), ("inv_item_sk", _K),
        ("inv_warehouse_sk", _K), ("inv_quantity_on_hand", _I),
    ],
    "item": [
        ("i_item_sk", _K), ("i_item_id", _S), ("i_rec_start_date", _D),
        ("i_rec_end_date", _D), ("i_item_desc", _S),
        ("i_current_price", _m()), ("i_wholesale_cost", _m()),
        ("i_brand_id", _I), ("i_brand", _S), ("i_class_id", _I),
        ("i_class", _S), ("i_category_id", _I), ("i_category", _S),
        ("i_manufact_id", _I), ("i_manufact", _S), ("i_size", _S),
        ("i_formulation", _S), ("i_color", _S), ("i_units", _S),
        ("i_container", _S), ("i_manager_id", _I),
        ("i_product_name", _S),
    ],
    "promotion": [
        ("p_promo_sk", _K), ("p_promo_id", _S),
        ("p_start_date_sk", _K), ("p_end_date_sk", _K),
        ("p_item_sk", _K), ("p_cost", _m(15)),
        ("p_response_targe", _I), ("p_promo_name", _S),
        ("p_channel_dmail", _S), ("p_channel_email", _S),
        ("p_channel_catalog", _S), ("p_channel_tv", _S),
        ("p_channel_radio", _S), ("p_channel_press", _S),
        ("p_channel_event", _S), ("p_channel_demo", _S),
        ("p_channel_details", _S), ("p_purpose", _S),
        ("p_discount_active", _S),
    ],
    "reason": [
        ("r_reason_sk", _K), ("r_reason_id", _S), ("r_reason_desc", _S),
    ],
    "ship_mode": [
        ("sm_ship_mode_sk", _K), ("sm_ship_mode_id", _S),
        ("sm_type", _S), ("sm_code", _S), ("sm_carrier", _S),
        ("sm_contract", _S),
    ],
    "store": [
        ("s_store_sk", _K), ("s_store_id", _S),
        ("s_rec_start_date", _D), ("s_rec_end_date", _D),
        ("s_closed_date_sk", _K), ("s_store_name", _S),
        ("s_number_employees", _I), ("s_floor_space", _I),
        ("s_hours", _S), ("s_manager", _S), ("s_market_id", _I),
        ("s_geography_class", _S), ("s_market_desc", _S),
        ("s_market_manager", _S), ("s_division_id", _I),
        ("s_division_name", _S), ("s_company_id", _I),
        ("s_company_name", _S), ("s_street_number", _S),
        ("s_street_name", _S), ("s_street_type", _S),
        ("s_suite_number", _S), ("s_city", _S), ("s_county", _S),
        ("s_state", _S), ("s_zip", _S), ("s_country", _S),
        ("s_gmt_offset", _m(5)), ("s_tax_precentage", _m(5)),
    ],
    "store_returns": [
        ("sr_returned_date_sk", _K), ("sr_return_time_sk", _K),
        ("sr_item_sk", _K), ("sr_customer_sk", _K),
        ("sr_cdemo_sk", _K), ("sr_hdemo_sk", _K), ("sr_addr_sk", _K),
        ("sr_store_sk", _K), ("sr_reason_sk", _K),
        ("sr_ticket_number", _K), ("sr_return_quantity", _I),
        ("sr_return_amt", _m()), ("sr_return_tax", _m()),
        ("sr_return_amt_inc_tax", _m()), ("sr_fee", _m()),
        ("sr_return_ship_cost", _m()), ("sr_refunded_cash", _m()),
        ("sr_reversed_charge", _m()), ("sr_store_credit", _m()),
        ("sr_net_loss", _m()),
    ],
    "store_sales": [
        ("ss_sold_date_sk", _K), ("ss_sold_time_sk", _K),
        ("ss_item_sk", _K), ("ss_customer_sk", _K),
        ("ss_cdemo_sk", _K), ("ss_hdemo_sk", _K), ("ss_addr_sk", _K),
        ("ss_store_sk", _K), ("ss_promo_sk", _K),
        ("ss_ticket_number", _K), ("ss_quantity", _I),
        ("ss_wholesale_cost", _m()), ("ss_list_price", _m()),
        ("ss_sales_price", _m()), ("ss_ext_discount_amt", _m()),
        ("ss_ext_sales_price", _m()), ("ss_ext_wholesale_cost", _m()),
        ("ss_ext_list_price", _m()), ("ss_ext_tax", _m()),
        ("ss_coupon_amt", _m()), ("ss_net_paid", _m()),
        ("ss_net_paid_inc_tax", _m()), ("ss_net_profit", _m()),
    ],
    "time_dim": [
        ("t_time_sk", _K), ("t_time_id", _S), ("t_time", _I),
        ("t_hour", _I), ("t_minute", _I), ("t_second", _I),
        ("t_am_pm", _S), ("t_shift", _S), ("t_sub_shift", _S),
        ("t_meal_time", _S),
    ],
    "warehouse": [
        ("w_warehouse_sk", _K), ("w_warehouse_id", _S),
        ("w_warehouse_name", _S), ("w_warehouse_sq_ft", _I),
        ("w_street_number", _S), ("w_street_name", _S),
        ("w_street_type", _S), ("w_suite_number", _S), ("w_city", _S),
        ("w_county", _S), ("w_state", _S), ("w_zip", _S),
        ("w_country", _S), ("w_gmt_offset", _m(5)),
    ],
    "web_page": [
        ("wp_web_page_sk", _K), ("wp_web_page_id", _S),
        ("wp_rec_start_date", _D), ("wp_rec_end_date", _D),
        ("wp_creation_date_sk", _K), ("wp_access_date_sk", _K),
        ("wp_autogen_flag", _S), ("wp_customer_sk", _K),
        ("wp_url", _S), ("wp_type", _S), ("wp_char_count", _I),
        ("wp_link_count", _I), ("wp_image_count", _I),
        ("wp_max_ad_count", _I),
    ],
    "web_returns": [
        ("wr_returned_date_sk", _K), ("wr_returned_time_sk", _K),
        ("wr_item_sk", _K), ("wr_refunded_customer_sk", _K),
        ("wr_refunded_cdemo_sk", _K), ("wr_refunded_hdemo_sk", _K),
        ("wr_refunded_addr_sk", _K), ("wr_returning_customer_sk", _K),
        ("wr_returning_cdemo_sk", _K), ("wr_returning_hdemo_sk", _K),
        ("wr_returning_addr_sk", _K), ("wr_web_page_sk", _K),
        ("wr_reason_sk", _K), ("wr_order_number", _K),
        ("wr_return_quantity", _I), ("wr_return_amt", _m()),
        ("wr_return_tax", _m()), ("wr_return_amt_inc_tax", _m()),
        ("wr_fee", _m()), ("wr_return_ship_cost", _m()),
        ("wr_refunded_cash", _m()), ("wr_reversed_charge", _m()),
        ("wr_account_credit", _m()), ("wr_net_loss", _m()),
    ],
    "web_sales": [
        ("ws_sold_date_sk", _K), ("ws_sold_time_sk", _K),
        ("ws_ship_date_sk", _K), ("ws_item_sk", _K),
        ("ws_bill_customer_sk", _K), ("ws_bill_cdemo_sk", _K),
        ("ws_bill_hdemo_sk", _K), ("ws_bill_addr_sk", _K),
        ("ws_ship_customer_sk", _K), ("ws_ship_cdemo_sk", _K),
        ("ws_ship_hdemo_sk", _K), ("ws_ship_addr_sk", _K),
        ("ws_web_page_sk", _K), ("ws_web_site_sk", _K),
        ("ws_ship_mode_sk", _K), ("ws_warehouse_sk", _K),
        ("ws_promo_sk", _K), ("ws_order_number", _K),
        ("ws_quantity", _I), ("ws_wholesale_cost", _m()),
        ("ws_list_price", _m()), ("ws_sales_price", _m()),
        ("ws_ext_discount_amt", _m()), ("ws_ext_sales_price", _m()),
        ("ws_ext_wholesale_cost", _m()), ("ws_ext_list_price", _m()),
        ("ws_ext_tax", _m()), ("ws_coupon_amt", _m()),
        ("ws_ext_ship_cost", _m()), ("ws_net_paid", _m()),
        ("ws_net_paid_inc_tax", _m()), ("ws_net_paid_inc_ship", _m()),
        ("ws_net_paid_inc_ship_tax", _m()), ("ws_net_profit", _m()),
    ],
    "web_site": [
        ("web_site_sk", _K), ("web_site_id", _S),
        ("web_rec_start_date", _D), ("web_rec_end_date", _D),
        ("web_name", _S), ("web_open_date_sk", _K),
        ("web_close_date_sk", _K), ("web_class", _S),
        ("web_manager", _S), ("web_mkt_id", _I), ("web_mkt_class", _S),
        ("web_mkt_desc", _S), ("web_market_manager", _S),
        ("web_company_id", _I), ("web_company_name", _S),
        ("web_street_number", _S), ("web_street_name", _S),
        ("web_street_type", _S), ("web_suite_number", _S),
        ("web_city", _S), ("web_county", _S), ("web_state", _S),
        ("web_zip", _S), ("web_country", _S), ("web_gmt_offset", _m(5)),
        ("web_tax_percentage", _m(5)),
    ],
}

TABLES = tuple(SCHEMAS)

#: NULL share of each nullable fact-table column
FACT_NULL_RATE = 0.04
#: NULL share of each nullable scaled-dimension column
DIM_NULL_RATE = 0.02

#: sales rows at SF1 (linear in SF)
_SALES = {"store_sales": 2_880_404, "catalog_sales": 1_441_548,
          "web_sales": 719_384}
#: scaled dimensions: (rows at SF1, floor below SF1)
_DIMS = {"item": (18_000, 300), "customer": (100_000, 500),
         "customer_address": (50_000, 250), "store": (12, 6),
         "promotion": (300, 30), "warehouse": (5, 5),
         "web_site": (30, 6), "web_page": (60, 12),
         "call_center": (6, 2), "catalog_page": (11_718, 200)}
_FIXED = {"date_dim": 73_049, "time_dim": 86_400,
          "customer_demographics": 1_920_800,
          "household_demographics": 7_200, "income_band": 20,
          "ship_mode": 20, "reason": 35}
#: inventory: weekly snapshots over the sales years
_WEEKS = 261
_RETURNS = {"store_returns": "store_sales",
            "catalog_returns": "catalog_sales",
            "web_returns": "web_sales"}

_EPOCH_JDN = 2_440_588                  # Julian day of 1970-01-01
_FIRST_DAY = np.datetime64("1900-01-02")
_SOLD_LO = np.datetime64("1998-01-02")
_SOLD_HI = np.datetime64("2003-01-02")
_INV_START = np.datetime64("1998-01-01")


def _jdn(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype(np.int64) + _EPOCH_JDN


def _date(jdn: np.ndarray) -> np.ndarray:
    return (np.asarray(jdn, np.int64) - _EPOCH_JDN).astype("datetime64[D]")


def row_counts(sf: float) -> Dict[str, int]:
    """Rows of each table at scale factor ``sf``."""
    out = dict(_FIXED)
    for t, (base, floor) in _DIMS.items():
        out[t] = max(int(base * min(sf, 1.0)), floor)
    for t, base in _SALES.items():
        out[t] = max(int(base * sf), 2_000)
    for r, s in _RETURNS.items():
        out[r] = out[s] // 10
    out["inventory"] = (-(-out["item"] // 2)) * out["warehouse"] * _WEEKS
    return {t: out[t] for t in TABLES}


# ---------------------------------------------------------- value lists

_SYLLABLES = ["ought", "able", "pri", "ese", "anti", "cally", "ation",
              "eing", "bar", "n st"]
_CATEGORIES = {
    "Books": ["arts", "business", "computers", "cooking",
              "entertainments", "fiction", "history", "home repair",
              "mystery", "parenting", "reference", "romance", "science",
              "self-help", "sports", "travel"],
    "Children": ["infants", "newborn", "school-uniforms", "toddlers"],
    "Electronics": ["audio", "automotive", "cameras", "disk drives",
                    "dvd/vcr players", "karoke", "memory", "monitors",
                    "musical", "personal", "portable", "scanners",
                    "stereo", "televisions", "wireless"],
    "Home": ["accent", "bathroom", "bedding", "blinds/shades",
             "curtains/drapes", "decor", "flatware", "furniture",
             "glassware", "kids", "lighting", "mattresses", "paint",
             "rugs", "tables", "wallpaper"],
    "Jewelry": ["birdal", "bracelets", "consignment", "costume", "custom",
                "diamonds", "earings", "estate", "gold", "jewelry boxes",
                "loose stones", "mens watch", "pendants", "rings",
                "semi-precious", "womens watch"],
    "Men": ["accessories", "pants", "shirts", "sports-apparel"],
    "Music": ["classical", "country", "pop", "rock"],
    "Shoes": ["athletic", "kids", "mens", "womens"],
    "Sports": ["archery", "athletic shoes", "baseball", "basketball",
               "camping", "fishing", "fitness", "football", "golf",
               "guns", "hockey", "optics", "outdoor", "pools", "sailing",
               "tennis"],
    "Women": ["dresses", "fragrances", "maternity", "swimwear"],
}
_COLORS = ["slate", "blanched", "burnished", "powder", "khaki", "brown",
           "honeydew", "purple", "burlywood", "indian", "spring",
           "floral", "medium", "sky", "almond", "antique", "aquamarine",
           "azure", "beige", "bisque", "black", "blue", "blush",
           "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
           "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger",
           "drab", "firebrick", "forest", "frosted", "gainsboro", "ghost",
           "goldenrod", "green", "grey", "hot", "lace", "lavender",
           "lawn", "lemon", "light", "lime", "linen", "magenta",
           "maroon", "metallic", "midnight", "mint", "misty", "moccasin",
           "navajo", "navy", "olive", "orange", "orchid", "pale",
           "papaya", "peach", "peru", "pink", "plum", "puff", "red",
           "rose", "rosy", "royal", "saddle", "salmon", "sandy",
           "seashell", "sienna", "smoke", "snow", "steel", "tan",
           "thistle", "tomato", "turquoise", "violet", "wheat", "white",
           "yellow"]
_UNITS = ["Ounce", "Oz", "Bunch", "Ton", "Unknown", "Each", "Dozen",
          "Case", "Pallet", "Gross", "Carton", "Box", "Bundle", "Lb",
          "Pound", "Tsp", "Tbl", "Cup", "Dram", "Gram", "N/A"]
_SIZES = ["medium", "extra large", "N/A", "small", "petite", "large",
          "economy"]
_CITIES = ["Midway", "Fairview", "Edgewood", "Oak Grove", "Five Points",
           "Pleasant Hill", "Centerville", "Oakland", "Riverside",
           "Mount Pleasant", "Union", "Greenwood", "Salem",
           "Springfield", "Georgetown", "Liberty", "Franklin",
           "Clinton", "Marion", "Glendale", "Bethel", "Shiloh",
           "Jamestown", "Highland Park", "Summit", "Lakeside",
           "Woodland", "Antioch", "Mountain View", "Sulphur Springs",
           "Pleasant Valley", "Wildwood", "Concord", "Harmony",
           "Hopewell", "Newport", "Enterprise", "Greenville",
           "Unionville", "Lebanon"]
_COUNTIES = ["Williamson County", "Ziebach County", "Walker County",
             "Franklin Parish", "Barrow County", "Luce County",
             "Richland County", "Daviess County", "Fairfield County",
             "Bronx County", "Jefferson County", "Orange County",
             "Huron County", "Kittitas County", "Mobile County",
             "Raleigh County", "Perry County", "Salem County",
             "Dauphin County", "Levy County"]
_STATES = ["TN", "IL", "GA", "CA", "WA", "TX", "NY", "AL", "OH", "KS",
           "MI", "KY", "VA", "NC", "IN", "MO", "IA", "NE", "WI", "MN",
           "SD", "ND", "MS", "LA", "AR", "OK", "CO", "PA", "FL", "SC"]
#: q15's and q45's zips first, then filler
_ZIPS = (["85669", "86197", "88274", "83405", "86475", "85392", "85460",
          "80348", "81792"]
         + [f"{(31_415 + 7_919 * k) % 90_000 + 10_000:05d}"
            for k in range(191)])
_STREETS = ["Main", "Oak", "Park", "Elm", "Maple", "Cedar", "Pine",
            "Lake", "Hill", "Washington", "Lincoln", "Jackson", "Church",
            "Spring", "Ridge", "Sunset", "Railroad", "Mill", "River",
            "Forest", "View", "First", "Second", "Third", "Fourth",
            "Fifth", "Sixth", "Seventh", "Eighth", "Ninth", "Tenth",
            "Walnut", "Willow", "Chestnut", "Highland", "Jefferson",
            "Adams", "Madison", "Wilson", "Smith"]
_STREET_TYPES = ["Street", "ST", "Avenue", "Ave", "Boulevard", "Blvd",
                 "Road", "RD", "Drive", "Dr.", "Circle", "Cir.", "Court",
                 "Ct.", "Lane", "Ln", "Parkway", "Pkwy", "Way", "Wy"]
_SUITES = ([f"Suite {10 * k}" for k in range(1, 50)]
           + [f"Suite {c}" for c in "ABCDEFGHIJKLMNOPQRSTUVWXY"])
_GMT = [-500, -600, -700, -800, -900, -1000]      # cents
_GMT_P = [0.35, 0.3, 0.15, 0.1, 0.05, 0.05]
_FIRST = ["James", "John", "Robert", "Michael", "William", "David",
          "Richard", "Charles", "Joseph", "Thomas", "Mary", "Patricia",
          "Linda", "Barbara", "Elizabeth", "Jennifer", "Maria", "Susan",
          "Margaret", "Dorothy", "Lisa", "Nancy", "Karen", "Betty",
          "Helen", "Sandra", "Donna", "Carol", "Ruth", "Sharon",
          "Michelle", "Laura", "Sarah", "Kimberly", "Deborah", "Jessica",
          "Shirley", "Cynthia", "Angela", "Melissa", "Brenda", "Amy",
          "Anna", "Rebecca", "Virginia", "Kathleen", "Pamela", "Martha",
          "Debra", "Amanda", "Daniel", "Paul", "Mark", "Donald",
          "George", "Kenneth", "Steven", "Edward", "Brian", "Ronald",
          "Anthony", "Kevin", "Jason", "Matthew", "Gary", "Timothy",
          "Jose", "Larry", "Jeffrey", "Frank", "Scott", "Eric",
          "Stephen", "Andrew", "Raymond", "Gregory", "Joshua", "Jerry",
          "Dennis", "Walter"]
_LAST = ["Smith", "Johnson", "Williams", "Jones", "Brown", "Davis",
         "Miller", "Wilson", "Moore", "Taylor", "Anderson", "Thomas",
         "Jackson", "White", "Harris", "Martin", "Thompson", "Garcia",
         "Martinez", "Robinson", "Clark", "Rodriguez", "Lewis", "Lee",
         "Walker", "Hall", "Allen", "Young", "Hernandez", "King",
         "Wright", "Lopez", "Hill", "Scott", "Green", "Adams", "Baker",
         "Gonzalez", "Nelson", "Carter", "Mitchell", "Perez", "Roberts",
         "Turner", "Phillips", "Campbell", "Parker", "Evans", "Edwards",
         "Collins", "Stewart", "Sanchez", "Morris", "Rogers", "Reed",
         "Cook", "Morgan", "Bell", "Murphy", "Bailey"]
_SALUTATIONS = ["Mr.", "Mrs.", "Ms.", "Miss", "Sir", "Dr."]
_COUNTRIES = ["UNITED STATES", "CANADA", "MEXICO", "BRAZIL", "CHILE",
              "GERMANY", "FRANCE", "ITALY", "SPAIN", "PORTUGAL",
              "IRELAND", "NORWAY", "SWEDEN", "FINLAND", "POLAND",
              "GREECE", "TURKEY", "EGYPT", "KENYA", "NIGERIA", "INDIA",
              "CHINA", "JAPAN", "KOREA", "VIET NAM", "THAILAND",
              "AUSTRALIA", "NEW ZEALAND", "PERU", "ARGENTINA"]
_WORDS = ["able", "about", "across", "actual", "after", "again",
          "almost", "along", "also", "always", "among", "annual",
          "another", "around", "available", "back", "basic", "become",
          "before", "better", "between", "big", "both", "bright",
          "broad", "careful", "central", "certain", "clear", "close",
          "common", "complete", "current", "dark", "deep", "different",
          "direct", "early", "easy", "economic", "entire", "equal",
          "even", "every", "exact", "extra", "fair", "familiar", "far",
          "few", "final", "fine", "firm", "following", "foreign",
          "free", "full", "general", "good", "great", "green", "happy",
          "hard", "high", "human", "important", "large", "late",
          "little", "local", "long", "low", "main", "major", "modern",
          "much", "national", "natural", "new", "normal", "old", "only",
          "open", "other", "particular", "personal", "political",
          "popular", "possible", "present", "private", "public",
          "quiet", "rapid", "real", "recent", "red", "right", "same",
          "serious", "short", "similar", "simple", "single", "small",
          "social", "special", "strong", "sure", "total", "true",
          "usual", "various", "very", "whole", "wide", "young"]
_BUY = [">10000", "Unknown", "5001-10000", "1001-5000", "501-1000",
        "0-500"]
_MARITAL = ["M", "S", "D", "W", "U"]
_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
              "4 yr Degree", "Advanced Degree", "Unknown"]
_CREDIT = ["Good", "High Risk", "Low Risk", "Unknown"]
_CARRIERS = ["DHL", "BARIAN", "UPS", "FEDEX", "AIRBORNE", "USPS", "TBS",
             "ZHOU", "ZOUROS", "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL",
             "BOXBUNDLES", "GREAT EASTERN", "DIAMOND", "RUPEKSA",
             "GERMA", "HARMSTORF", "PRIVATECARRIER"]
_SM_TYPES = ["REGULAR", "EXPRESS", "NEXT DAY", "OVERNIGHT", "TWO DAY",
             "LIBRARY"]
_SM_CODES = ["AIR", "SURFACE", "SEA", "BIKE", "HAND CARRY", "MESSENGER",
             "COURIER"]
_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday"]
_CC_NAMES = ["NY Metro", "Mid Atlantic", "North Midwest",
             "Pacific Northwest", "California", "Hawaii/Alaska"]
_WP_TYPES = ["ad", "bio", "dynamic", "feedback", "general", "order",
             "protected", "welcome"]

#: each filtered or grouped column's value list (the literals the plans
#: compare it with first)
DOMAINS: Dict[str, List[str]] = {
    "ca_city": _CITIES, "s_city": _CITIES, "w_city": _CITIES,
    "cc_city": _CITIES, "web_city": _CITIES,
    "ca_county": _COUNTIES, "s_county": _COUNTIES, "w_county": _COUNTIES,
    "cc_county": _COUNTIES, "web_county": _COUNTIES,
    "ca_state": _STATES, "s_state": _STATES, "w_state": _STATES,
    "cc_state": _STATES, "web_state": _STATES,
    "ca_zip": _ZIPS, "s_zip": _ZIPS, "w_zip": _ZIPS, "cc_zip": _ZIPS,
    "web_zip": _ZIPS,
    "i_category": list(_CATEGORIES),
    "i_class": sorted({c for cs in _CATEGORIES.values() for c in cs}),
    "i_color": _COLORS, "i_units": _UNITS, "i_size": _SIZES,
    "cd_gender": ["M", "F"], "cd_marital_status": _MARITAL,
    "cd_education_status": _EDUCATION, "cd_credit_rating": _CREDIT,
    "hd_buy_potential": _BUY, "sm_carrier": _CARRIERS,
    "sm_type": _SM_TYPES, "sm_code": _SM_CODES,
    "t_meal_time": ["breakfast", "lunch", "dinner"],
    "r_reason_desc": [f"reason {k}" for k in range(1, 36)],
    "d_day_name": _DAY_NAMES,
    "c_preferred_cust_flag": ["Y", "N"], "c_birth_country": _COUNTRIES,
    "c_salutation": _SALUTATIONS, "c_first_name": _FIRST,
    "c_last_name": _LAST,
    **{f"p_channel_{c}": ["Y", "N"]
       for c in ("dmail", "email", "catalog", "tv", "radio", "press",
                 "event", "demo")},
}
#: literals a small table places in one row at least (beyond its list)
_PLACED = {"s_city": ["Midway", "Fairview"],
           "s_county": ["Williamson County"], "s_state": ["TN"],
           "s_market_id": [8], "wp_char_count": [5100]}


# ---------------------------------------------------------- helpers

def _coded(values: Sequence[str], picks: np.ndarray
           ) -> Tuple[np.ndarray, List[str]]:
    """int32 codes into the sorted distinct values of ``values`` that
    ``picks`` (indices into ``values``, -1 for NULL) use."""
    values = np.asarray(list(values), dtype=object)
    picks = np.asarray(picks, dtype=np.int64)
    live = picks >= 0
    used = np.zeros(len(values), dtype=bool)
    used[picks[live]] = True
    uniq, inverse = np.unique(values[used].astype(str), return_inverse=True)
    rank = np.full(len(values), -1, dtype=np.int64)
    rank[np.nonzero(used)[0]] = inverse
    codes = np.where(live, rank[np.where(live, picks, 0)], -1)
    return codes.astype(np.int32), [str(v) for v in uniq]


def _syllables(n: np.ndarray) -> List[str]:
    """The specification's word for a number: one syllable a digit."""
    return ["".join(_SYLLABLES[int(d)] for d in str(int(v))) for v in n]


class _Builder:
    """One table's columns as they are drawn: numbers, dates, and
    strings as indices into a value list (-1 NULL)."""

    def __init__(self, name: str, n: int, rng: np.random.Generator):
        self.name, self.n, self.rng = name, n, rng
        self.cols: Dict[str, np.ndarray] = {}
        self.strings: Dict[str, List[str]] = {}
        self.nulls: Dict[str, np.ndarray] = {}
        #: columns copied from another table's rows, with their NULLs
        self.copied: set = set()

    def pick(self, col: str, values: Sequence, p=None,
             idx: Optional[np.ndarray] = None) -> None:
        """A string column drawn from ``values`` (or given by ``idx``),
        the column's ``_PLACED`` literals put in rows of their own."""
        values = list(values)
        if idx is None:
            idx = self.rng.choice(len(values), self.n, p=p)
        idx = np.asarray(idx, dtype=np.int64)
        self._place(col, idx, [values.index(v) for v in
                               _PLACED.get(col, [])])
        self.cols[col], self.strings[col] = idx, values

    def text(self, col: str, values: Sequence[str]) -> None:
        """A string column given row by row."""
        self.cols[col] = np.arange(self.n, dtype=np.int64)
        self.strings[col] = list(values)

    def num(self, col: str, values: np.ndarray) -> None:
        values = np.asarray(values)
        self._place(col, values, _PLACED.get(col, []))
        self.cols[col] = values

    def _place(self, col: str, arr: np.ndarray, literals) -> None:
        if literals and self.n >= len(literals):
            rows = self.rng.choice(self.n, len(literals), replace=False)
            arr[rows] = literals

    def null(self, col: str, mask: np.ndarray) -> None:
        mask = np.asarray(mask, dtype=bool)
        if col in self.nulls:
            mask = mask | self.nulls[col]
        self.nulls[col] = mask

    def finish(self, keep: Sequence[str], rate: float
               ) -> Tuple[Columns, Dict[str, List[str]],
                          Dict[str, np.ndarray]]:
        """The table in ``SCHEMAS`` order: every column not in ``keep``
        NULL at ``rate`` (on top of NULLs already set), numbers zeroed
        and string codes -1 where NULL."""
        schema = SCHEMAS[self.name]
        missing = [c for c, _ in schema if c not in self.cols]
        if missing:
            raise AssertionError(f"{self.name}: no values for {missing}")
        cols: Columns = {}
        dicts: Dict[str, List[str]] = {}
        nulls: Dict[str, np.ndarray] = {}
        for c, code in schema:
            mask = self.nulls.get(c, np.zeros(self.n, dtype=bool))
            if rate and c not in keep:
                mask = mask | (self.rng.random(self.n) < rate)
            v = self.cols[c]
            if code == "s":
                cols[c], dicts[c] = _coded(self.strings[c],
                                           np.where(mask, -1, v))
                continue
            if code == "d":
                v = np.where(mask, np.datetime64("1970-01-01"),
                             v.astype("datetime64[D]"))
            else:
                dtype = np.int32 if code == "i" else np.int64
                v = np.where(mask, 0, v).astype(dtype)
            cols[c] = v
            if mask.any():
                nulls[c] = mask
        return cols, dicts, nulls


def _dates_between(rng, n: int, lo: np.datetime64, hi: np.datetime64
                   ) -> np.ndarray:
    """Julian day numbers drawn uniformly in [lo, hi]."""
    return rng.integers(_jdn(np.array([lo]))[0],
                        _jdn(np.array([hi]))[0] + 1, n)


def _address(b: _Builder, pfx: str, rng) -> None:
    """The street address columns every located table carries."""
    n = b.n
    b.pick(f"{pfx}_street_number",
           [str(k) for k in range(1, 1000)])
    b.pick(f"{pfx}_street_name", _STREETS)
    b.pick(f"{pfx}_street_type", _STREET_TYPES)
    b.pick(f"{pfx}_suite_number", _SUITES)
    p_city = np.full(len(_CITIES), 1.0)
    p_city[:3] = [8, 8, 4]
    b.pick(f"{pfx}_city", _CITIES, p=p_city / p_city.sum())
    p_county = np.full(len(_COUNTIES), 1.0)
    p_county[0] = 6
    b.pick(f"{pfx}_county", _COUNTIES, p=p_county / p_county.sum())
    b.pick(f"{pfx}_state", _STATES)
    b.pick(f"{pfx}_zip", _ZIPS)
    b.pick(f"{pfx}_country", ["United States"],
           idx=np.zeros(n, dtype=np.int64))
    b.num(f"{pfx}_gmt_offset", rng.choice(_GMT, n, p=_GMT_P))


def _ids(prefix: str, n: int) -> List[str]:
    return [f"AAAAAAAA{prefix}{k:07d}" for k in range(1, n + 1)]


def _sentences(rng, n: int, lo: int, hi: int) -> List[str]:
    words = np.asarray(_WORDS, dtype=object)
    lens = rng.integers(lo, hi + 1, n)
    flat = words[rng.integers(0, len(words), int(lens.sum()))]
    ends = np.cumsum(lens)
    return [" ".join(flat[e - k:e]) for e, k in zip(ends, lens)]


def _rec_dates(b: _Builder, pfx: str, rng) -> None:
    """A record's validity: start between 1997 and 2001; the open end
    of the newest version NULL (half the rows)."""
    start = _dates_between(rng, b.n, np.datetime64("1997-03-13"),
                           np.datetime64("2001-10-26"))
    b.num(f"{pfx}_rec_start_date", _date(start))
    b.num(f"{pfx}_rec_end_date", _date(start + rng.integers(365, 1460,
                                                            b.n)))
    b.null(f"{pfx}_rec_end_date", rng.random(b.n) < 0.5)


# ---------------------------------------------------------- fixed dims

def _date_dim(rng) -> _Builder:
    n = _FIXED["date_dim"]
    b = _Builder("date_dim", n, rng)
    days = _FIRST_DAY + np.arange(n)
    sk = _jdn(days)
    months = days.astype("datetime64[M]")
    year = months.astype(np.int64) // 12 + 1970
    moy = months.astype(np.int64) % 12 + 1
    dom = (days - months.astype("datetime64[D]")).astype(np.int64) + 1
    dow = (sk + 1) % 7                       # 0 = Sunday
    qoy = (moy - 1) // 3 + 1
    week_seq = (sk - 2_415_020) // 7 + 1     # weeks from Sunday 1899-12-31
    quarter_seq = (year - 1900) * 4 + qoy
    b.num("d_date_sk", sk)
    b.text("d_date_id", [f"AAAAAAAA{k:08d}" for k in sk])
    b.num("d_date", days)
    b.num("d_month_seq", (year - 1900) * 12 + moy - 1)
    b.num("d_week_seq", week_seq)
    b.num("d_quarter_seq", quarter_seq)
    b.num("d_year", year)
    b.num("d_dow", dow)
    b.num("d_moy", moy)
    b.num("d_dom", dom)
    b.num("d_qoy", qoy)
    b.num("d_fy_year", year)
    b.num("d_fy_quarter_seq", quarter_seq)
    b.num("d_fy_week_seq", week_seq)
    b.pick("d_day_name", _DAY_NAMES, idx=dow)
    quarters = [f"{y}Q{q}" for y in range(1900, 2101) for q in range(1, 5)]
    b.pick("d_quarter_name", quarters, idx=(year - 1900) * 4 + qoy - 1)
    holiday = (((moy == 1) & (dom == 1)) | ((moy == 7) & (dom == 4))
               | ((moy == 12) & (dom == 25)))
    yn = ["N", "Y"]
    b.pick("d_holiday", yn, idx=holiday.astype(np.int64))
    b.pick("d_weekend", yn, idx=((dow == 0) | (dow == 6)).astype(np.int64))
    b.pick("d_following_holiday", yn,
           idx=np.concatenate([[0], holiday[:-1]]).astype(np.int64))
    first = _jdn(months.astype("datetime64[D]"))
    last = _jdn((months + 1).astype("datetime64[D]")) - 1
    b.num("d_first_dom", first)
    b.num("d_last_dom", last)

    def shifted(k):
        m = months - k
        length = ((m + 1).astype("datetime64[D]")
                  - m.astype("datetime64[D]")).astype(np.int64)
        return _jdn(m.astype("datetime64[D]")) + np.minimum(dom, length) - 1

    b.num("d_same_day_ly", shifted(12))
    b.num("d_same_day_lq", shifted(3))
    for c in ("day", "week", "month", "quarter", "year"):
        b.pick(f"d_current_{c}", yn, idx=np.zeros(n, dtype=np.int64))
    return b


def _time_dim(rng) -> _Builder:
    n = _FIXED["time_dim"]
    b = _Builder("time_dim", n, rng)
    t = np.arange(n, dtype=np.int64)
    hour = t // 3600
    b.num("t_time_sk", t)
    b.text("t_time_id", [f"AAAAAAAA{k:08d}" for k in t])
    b.num("t_time", t)
    b.num("t_hour", hour)
    b.num("t_minute", t // 60 % 60)
    b.num("t_second", t % 60)
    b.pick("t_am_pm", ["AM", "PM"], idx=(hour >= 12).astype(np.int64))
    b.pick("t_shift", ["first", "second", "third"], idx=hour // 8)
    b.pick("t_sub_shift", ["night", "morning", "afternoon", "evening"],
           idx=hour // 6)
    meal = np.full(n, -1, dtype=np.int64)
    meal[(hour >= 6) & (hour <= 9)] = 0
    meal[(hour >= 11) & (hour <= 13)] = 1
    meal[(hour >= 17) & (hour <= 20)] = 2
    b.pick("t_meal_time", ["breakfast", "lunch", "dinner"], idx=meal)
    b.null("t_meal_time", meal < 0)
    return b


def _customer_demographics(rng) -> _Builder:
    n = _FIXED["customer_demographics"]
    b = _Builder("customer_demographics", n, rng)
    k = np.arange(n, dtype=np.int64)
    b.num("cd_demo_sk", k + 1)
    b.pick("cd_gender", ["M", "F"], idx=k % 2)
    b.pick("cd_marital_status", _MARITAL, idx=k // 2 % 5)
    b.pick("cd_education_status", _EDUCATION, idx=k // 10 % 7)
    b.num("cd_purchase_estimate", (k // 70 % 20 + 1) * 500)
    b.pick("cd_credit_rating", _CREDIT, idx=k // 1_400 % 4)
    b.num("cd_dep_count", k // 5_600 % 7)
    b.num("cd_dep_employed_count", k // 39_200 % 7)
    b.num("cd_dep_college_count", k // 274_400 % 7)
    return b


def _household_demographics(rng) -> _Builder:
    n = _FIXED["household_demographics"]
    b = _Builder("household_demographics", n, rng)
    k = np.arange(n, dtype=np.int64)
    b.num("hd_demo_sk", k + 1)
    b.num("hd_income_band_sk", k % 20 + 1)
    b.pick("hd_buy_potential", _BUY, idx=k // 20 % 6)
    b.num("hd_dep_count", k // 120 % 10)
    b.num("hd_vehicle_count", k // 1_200 % 6 - 1)
    return b


def _income_band(rng) -> _Builder:
    b = _Builder("income_band", 20, rng)
    k = np.arange(20, dtype=np.int64)
    b.num("ib_income_band_sk", k + 1)
    b.num("ib_lower_bound", k * 10_000 + (k > 0))
    b.num("ib_upper_bound", (k + 1) * 10_000)
    return b


def _ship_mode(rng) -> _Builder:
    b = _Builder("ship_mode", 20, rng)
    k = np.arange(20, dtype=np.int64)
    b.num("sm_ship_mode_sk", k + 1)
    b.text("sm_ship_mode_id", _ids("SM", 20))
    b.pick("sm_type", _SM_TYPES, idx=k % len(_SM_TYPES))
    b.pick("sm_code", _SM_CODES, idx=k % len(_SM_CODES))
    b.pick("sm_carrier", _CARRIERS, idx=k)
    b.text("sm_contract", [f"contract{int(v):05d}"
                           for v in rng.integers(0, 100_000, 20)])
    return b


def _reason(rng) -> _Builder:
    b = _Builder("reason", 35, rng)
    k = np.arange(35, dtype=np.int64)
    b.num("r_reason_sk", k + 1)
    b.text("r_reason_id", _ids("R", 35))
    b.pick("r_reason_desc", DOMAINS["r_reason_desc"], idx=k)
    return b


# ---------------------------------------------------------- scaled dims

def _item(rng, n: int) -> _Builder:
    b = _Builder("item", n, rng)
    sk = np.arange(1, n + 1, dtype=np.int64)
    b.num("i_item_sk", sk)
    # two versions of each item (the odd row the older): one id each pair
    b.text("i_item_id", [f"AAAAAAAA{(k + 1) // 2:08d}" for k in sk])
    old = sk % 2 == 1
    b.num("i_rec_start_date",
          np.where(old, np.datetime64("1997-10-27"),
                   np.datetime64("2000-10-27")).astype("datetime64[D]"))
    b.num("i_rec_end_date",
          np.full(n, np.datetime64("2000-10-26"), dtype="datetime64[D]"))
    b.null("i_rec_end_date", ~old)
    b.text("i_item_desc", _sentences(rng, n, 6, 14))
    # log-uniform over $0.09 .. $99.99: cheap items are many, as in the
    # specification's price bands (q21's and q40's $0.99 .. $1.49 holds
    # about 6% of the items)
    price = np.exp(rng.uniform(np.log(9), np.log(9_999), n)).astype(np.int64)
    b.num("i_current_price", price)
    b.num("i_wholesale_cost", price * rng.integers(30, 91, n) // 100)
    cats = list(_CATEGORIES)
    cat = rng.integers(0, len(cats), n)
    cls = np.array([rng.integers(0, len(_CATEGORIES[cats[c]]))
                    for c in cat], dtype=np.int64)
    brand = rng.integers(1, 11, n)
    brand_id = (cat + 1) * 1_000_000 + (cls + 1) * 1_000 + brand
    b.num("i_brand_id", brand_id)
    b.text("i_brand", [f"{_SYLLABLES[c]}{_SYLLABLES[k % 10]}"
                       f"{_SYLLABLES[k // 10]} #{br}"
                       for c, k, br in zip(cat, cls, brand)])
    b.num("i_class_id", cls + 1)
    classes = DOMAINS["i_class"]
    b.pick("i_class", classes,
           idx=np.array([classes.index(_CATEGORIES[cats[c]][k])
                         for c, k in zip(cat, cls)], dtype=np.int64))
    b.num("i_category_id", cat + 1)
    b.pick("i_category", cats, idx=cat)
    manufact = rng.integers(1, 1001, n)
    b.num("i_manufact_id", manufact)
    b.text("i_manufact", _syllables(manufact))
    b.pick("i_size", _SIZES)
    b.text("i_formulation", [f"{int(v):010d}{w}" for v, w in zip(
        rng.integers(0, 10**10, n), rng.choice(_COLORS, n))])
    b.pick("i_color", _COLORS)
    b.pick("i_units", _UNITS)
    b.pick("i_container", ["Unknown"], idx=np.zeros(n, dtype=np.int64))
    b.num("i_manager_id", rng.integers(1, 101, n))
    b.text("i_product_name", _syllables(sk))
    return b


def _customer_address(rng, n: int) -> _Builder:
    b = _Builder("customer_address", n, rng)
    b.num("ca_address_sk", np.arange(1, n + 1, dtype=np.int64))
    b.text("ca_address_id", _ids("CA", n))
    _address(b, "ca", rng)
    b.pick("ca_location_type", ["apartment", "condo", "single family"])
    return b


def _customer(rng, n: int, n_addr: int) -> _Builder:
    b = _Builder("customer", n, rng)
    b.num("c_customer_sk", np.arange(1, n + 1, dtype=np.int64))
    b.text("c_customer_id", _ids("C", n))
    b.num("c_current_cdemo_sk",
          rng.integers(1, _FIXED["customer_demographics"] + 1, n))
    b.num("c_current_hdemo_sk",
          rng.integers(1, _FIXED["household_demographics"] + 1, n))
    b.num("c_current_addr_sk", rng.integers(1, n_addr + 1, n))
    first_sale = _dates_between(rng, n, _SOLD_LO, _SOLD_HI)
    b.num("c_first_sales_date_sk", first_sale)
    b.num("c_first_shipto_date_sk", first_sale + rng.integers(0, 31, n))
    b.pick("c_salutation", _SALUTATIONS)
    first = rng.integers(0, len(_FIRST), n)
    last = rng.integers(0, len(_LAST), n)
    b.pick("c_first_name", _FIRST, idx=first)
    b.pick("c_last_name", _LAST, idx=last)
    b.pick("c_preferred_cust_flag", ["Y", "N"])
    b.num("c_birth_day", rng.integers(1, 29, n))
    b.num("c_birth_month", rng.integers(1, 13, n))
    b.num("c_birth_year", rng.integers(1924, 1993, n))
    b.pick("c_birth_country", _COUNTRIES)
    b.pick("c_login", [""], idx=np.zeros(n, dtype=np.int64))
    b.null("c_login", np.ones(n, dtype=bool))
    domains = ["example.com", "mail.net", "post.org", "inbox.info"]
    b.text("c_email_address", [
        f"{_FIRST[f]}.{_LAST[s]}@{domains[d]}" for f, s, d in
        zip(first, last, rng.integers(0, len(domains), n))])
    b.num("c_last_review_date_sk",
          _dates_between(rng, n, _SOLD_LO, _SOLD_HI))
    return b


def _store(rng, n: int) -> _Builder:
    b = _Builder("store", n, rng)
    sk = np.arange(1, n + 1, dtype=np.int64)
    b.num("s_store_sk", sk)
    b.text("s_store_id", _ids("S", n))
    _rec_dates(b, "s", rng)
    b.num("s_closed_date_sk", _dates_between(rng, n, _SOLD_LO, _SOLD_HI))
    b.null("s_closed_date_sk", rng.random(n) < 0.7)
    b.text("s_store_name", _syllables(sk))
    b.num("s_number_employees", rng.integers(200, 301, n))
    b.num("s_floor_space", rng.integers(5_000_000, 10_000_001, n))
    b.pick("s_hours", ["8AM-4PM", "8AM-12AM", "8AM-8AM"])
    b.pick("s_manager", [f"{f} {s}" for f in _FIRST[:20]
                         for s in _LAST[:20]])
    b.num("s_market_id", rng.integers(1, 11, n))
    b.pick("s_geography_class", ["Unknown"],
           idx=np.zeros(n, dtype=np.int64))
    b.text("s_market_desc", _sentences(rng, n, 8, 16))
    b.pick("s_market_manager", [f"{f} {s}" for f in _FIRST[20:40]
                                for s in _LAST[20:40]])
    b.num("s_division_id", np.ones(n, dtype=np.int64))
    b.pick("s_division_name", ["Unknown"], idx=np.zeros(n, dtype=np.int64))
    b.num("s_company_id", np.ones(n, dtype=np.int64))
    b.pick("s_company_name", ["Unknown"], idx=np.zeros(n, dtype=np.int64))
    _address(b, "s", rng)
    b.num("s_tax_precentage", rng.integers(0, 12, n))
    return b


def _promotion(rng, n: int, n_item: int) -> _Builder:
    b = _Builder("promotion", n, rng)
    sk = np.arange(1, n + 1, dtype=np.int64)
    b.num("p_promo_sk", sk)
    b.text("p_promo_id", _ids("P", n))
    start = _dates_between(rng, n, _SOLD_LO, _SOLD_HI)
    b.num("p_start_date_sk", start)
    b.num("p_end_date_sk", start + rng.integers(1, 61, n))
    b.num("p_item_sk", rng.integers(1, n_item + 1, n))
    b.num("p_cost", rng.integers(100, 100_001, n))
    b.num("p_response_targe", np.ones(n, dtype=np.int64))
    b.text("p_promo_name", _syllables(sk))
    for c, p_yes in (("dmail", 0.5), ("email", 0.1), ("catalog", 0.1),
                     ("tv", 0.5), ("radio", 0.1), ("press", 0.1),
                     ("event", 0.1), ("demo", 0.1)):
        b.pick(f"p_channel_{c}", ["Y", "N"], p=[p_yes, 1 - p_yes])
    b.text("p_channel_details", _sentences(rng, n, 4, 10))
    b.pick("p_purpose", ["Unknown"], idx=np.zeros(n, dtype=np.int64))
    b.pick("p_discount_active", ["N"], idx=np.zeros(n, dtype=np.int64))
    return b


def _warehouse(rng, n: int) -> _Builder:
    b = _Builder("warehouse", n, rng)
    b.num("w_warehouse_sk", np.arange(1, n + 1, dtype=np.int64))
    b.text("w_warehouse_id", _ids("W", n))
    b.text("w_warehouse_name", [s[:30] for s in _sentences(rng, n, 3, 6)])
    b.num("w_warehouse_sq_ft", rng.integers(50_000, 1_000_001, n))
    _address(b, "w", rng)
    return b


def _web_site(rng, n: int) -> _Builder:
    b = _Builder("web_site", n, rng)
    sk = np.arange(1, n + 1, dtype=np.int64)
    b.num("web_site_sk", sk)
    b.text("web_site_id", _ids("WS", n))
    _rec_dates(b, "web", rng)
    b.pick("web_name", [f"site_{k}" for k in range(n)],
           idx=np.arange(n, dtype=np.int64))
    b.num("web_open_date_sk", _dates_between(
        rng, n, np.datetime64("1997-01-01"), _SOLD_LO))
    b.num("web_close_date_sk", _dates_between(rng, n, _SOLD_LO, _SOLD_HI))
    b.null("web_close_date_sk", rng.random(n) < 0.7)
    b.pick("web_class", ["Unknown"], idx=np.zeros(n, dtype=np.int64))
    b.pick("web_manager", [f"{f} {s}" for f in _FIRST[40:60]
                           for s in _LAST[40:60]])
    b.num("web_mkt_id", rng.integers(1, 7, n))
    b.text("web_mkt_class", _sentences(rng, n, 3, 6))
    b.text("web_mkt_desc", _sentences(rng, n, 8, 16))
    b.pick("web_market_manager", [f"{f} {s}" for f in _FIRST[60:]
                                  for s in _LAST[:20]])
    company = rng.integers(1, 7, n)
    b.num("web_company_id", company)
    b.text("web_company_name", _syllables(company))
    _address(b, "web", rng)
    b.num("web_tax_percentage", rng.integers(0, 13, n))
    return b


def _web_page(rng, n: int, n_cust: int) -> _Builder:
    b = _Builder("web_page", n, rng)
    b.num("wp_web_page_sk", np.arange(1, n + 1, dtype=np.int64))
    b.text("wp_web_page_id", _ids("WP", n))
    _rec_dates(b, "wp", rng)
    created = _dates_between(rng, n, np.datetime64("1997-01-01"),
                             _SOLD_LO)
    b.num("wp_creation_date_sk", created)
    b.num("wp_access_date_sk", created + rng.integers(0, 100, n))
    b.pick("wp_autogen_flag", ["Y", "N"])
    b.num("wp_customer_sk", rng.integers(1, n_cust + 1, n))
    b.null("wp_customer_sk", rng.random(n) < 0.7)
    b.pick("wp_url", ["http://www.foo.com"], idx=np.zeros(n, np.int64))
    b.pick("wp_type", _WP_TYPES)
    b.num("wp_char_count", rng.integers(303, 8_524, n))
    b.num("wp_link_count", rng.integers(2, 26, n))
    b.num("wp_image_count", rng.integers(1, 8, n))
    b.num("wp_max_ad_count", rng.integers(0, 5, n))
    return b


def _call_center(rng, n: int) -> _Builder:
    b = _Builder("call_center", n, rng)
    b.num("cc_call_center_sk", np.arange(1, n + 1, dtype=np.int64))
    b.text("cc_call_center_id", _ids("CC", n))
    _rec_dates(b, "cc", rng)
    b.num("cc_closed_date_sk", _dates_between(rng, n, _SOLD_LO, _SOLD_HI))
    b.null("cc_closed_date_sk", rng.random(n) < 0.7)
    b.num("cc_open_date_sk", _dates_between(
        rng, n, np.datetime64("1997-01-01"), _SOLD_LO))
    b.pick("cc_name", _CC_NAMES, idx=np.arange(n) % len(_CC_NAMES))
    b.pick("cc_class", ["small", "medium", "large"])
    b.num("cc_employees", rng.integers(1, 70_001, n))
    b.num("cc_sq_ft", rng.integers(100, 700_001, n))
    b.pick("cc_hours", ["8AM-4PM", "8AM-12AM", "8AM-8AM"])
    b.pick("cc_manager", [f"{f} {s}" for f in _FIRST[:20]
                          for s in _LAST[20:40]])
    b.num("cc_mkt_id", rng.integers(1, 7, n))
    b.text("cc_mkt_class", _sentences(rng, n, 3, 6))
    b.text("cc_mkt_desc", _sentences(rng, n, 8, 16))
    b.pick("cc_market_manager", [f"{f} {s}" for f in _FIRST[20:40]
                                 for s in _LAST[40:60]])
    division = rng.integers(1, 7, n)
    b.num("cc_division", division)
    b.text("cc_division_name", _syllables(division))
    company = rng.integers(1, 7, n)
    b.num("cc_company", company)
    b.text("cc_company_name", _syllables(company))
    _address(b, "cc", rng)
    b.num("cc_tax_percentage", rng.integers(0, 13, n))
    return b


def _catalog_page(rng, n: int) -> _Builder:
    b = _Builder("catalog_page", n, rng)
    k = np.arange(n, dtype=np.int64)
    b.num("cp_catalog_page_sk", k + 1)
    b.text("cp_catalog_page_id", _ids("CP", n))
    catalog = k // 108
    b.num("cp_start_date_sk", _jdn(np.array([_SOLD_LO]))[0] + catalog * 30)
    b.num("cp_end_date_sk", _jdn(np.array([_SOLD_LO]))[0]
          + catalog * 30 + 89)
    b.pick("cp_department", ["DEPARTMENT"], idx=np.zeros(n, np.int64))
    b.num("cp_catalog_number", catalog + 1)
    b.num("cp_catalog_page_number", k % 108 + 1)
    b.text("cp_description", _sentences(rng, n, 6, 14))
    b.pick("cp_type", ["bi-annual", "quarterly", "monthly"],
           idx=catalog % 3)
    return b


# ---------------------------------------------------------- facts

def _lines(rng, n: int, n_item: int):
    """Group ``n`` lines into tickets or orders of 1-20 lines: per line
    its group (0-based, in order) and its position, and per line an item
    distinct within its group (a per-group start and a step coprime with
    the item count)."""
    sizes = rng.integers(1, 21, n // 10 + 16)
    while sizes.sum() < n:
        sizes = np.concatenate([sizes, rng.integers(1, 21, n // 10 + 16)])
    ends = np.cumsum(sizes)
    groups = int(np.searchsorted(ends, n)) + 1
    sizes = sizes[:groups].copy()
    sizes[-1] -= int(ends[groups - 1] - n)
    group = np.repeat(np.arange(groups, dtype=np.int64), sizes)
    pos = np.arange(n, dtype=np.int64) - np.repeat(
        np.cumsum(sizes) - sizes, sizes)
    steps = np.array([p for p in (1, 7, 11, 13, 17, 19, 23, 29, 31, 37)
                      if np.gcd(p, n_item) == 1], dtype=np.int64)
    start = rng.integers(0, n_item, groups)
    step = steps[rng.integers(0, len(steps), groups)]
    return group, pos, start, step, groups


def _pricing(rng, n: int, qty: np.ndarray) -> Dict[str, np.ndarray]:
    """A line's money in cents, by the specification's identities."""
    wholesale = rng.integers(100, 10_001, n)
    list_price = wholesale * (100 + rng.integers(0, 201, n)) // 100
    sales = list_price * (100 - rng.integers(0, 101, n)) // 100
    ext_sales = qty * sales
    ext_list = qty * list_price
    tax = ext_sales * rng.integers(0, 10, n) // 100
    coupon = np.where(rng.random(n) < 0.2,
                      ext_sales * rng.integers(0, 101, n) // 100, 0)
    ship = ext_list * rng.integers(0, 51, n) // 100
    net_paid = ext_sales - coupon
    return {"wholesale_cost": wholesale, "list_price": list_price,
            "sales_price": sales,
            "ext_discount_amt": qty * (list_price - sales),
            "ext_sales_price": ext_sales,
            "ext_wholesale_cost": qty * wholesale,
            "ext_list_price": ext_list, "ext_tax": tax,
            "coupon_amt": coupon, "ext_ship_cost": ship,
            "net_paid": net_paid, "net_paid_inc_tax": net_paid + tax,
            "net_paid_inc_ship": net_paid + ship,
            "net_paid_inc_ship_tax": net_paid + ship + tax,
            "net_profit": net_paid - qty * wholesale}


def _sold_dates(rng, groups: int) -> np.ndarray:
    return np.sort(_dates_between(rng, groups, _SOLD_LO, _SOLD_HI))


def _store_sales(rng, n: int, dims: Dict[str, int]) -> _Builder:
    b = _Builder("store_sales", n, rng)
    ticket, pos, start, step, groups = _lines(rng, n, dims["item"])
    sold = _sold_dates(rng, groups)
    per = {
        "ss_sold_date_sk": sold,
        "ss_sold_time_sk": rng.integers(8 * 3600, 22 * 3600, groups),
        "ss_customer_sk": rng.integers(1, dims["customer"] + 1, groups),
        "ss_cdemo_sk": rng.integers(
            1, _FIXED["customer_demographics"] + 1, groups),
        "ss_hdemo_sk": rng.integers(
            1, _FIXED["household_demographics"] + 1, groups),
        "ss_addr_sk": rng.integers(1, dims["customer_address"] + 1,
                                   groups),
        "ss_store_sk": rng.integers(1, dims["store"] + 1, groups),
    }
    for c, v in per.items():
        b.num(c, v[ticket])
    b.num("ss_item_sk", (start[ticket] + pos * step[ticket])
          % dims["item"] + 1)
    b.num("ss_promo_sk", rng.integers(1, dims["promotion"] + 1, n))
    b.num("ss_ticket_number", ticket + 1)
    qty = rng.integers(1, 101, n)
    b.num("ss_quantity", qty)
    money = _pricing(rng, n, qty)
    for c in ("wholesale_cost", "list_price", "sales_price",
              "ext_discount_amt", "ext_sales_price", "ext_wholesale_cost",
              "ext_list_price", "ext_tax", "coupon_amt", "net_paid",
              "net_paid_inc_tax", "net_profit"):
        b.num(f"ss_{c}", money[c])
    return b


def _order_sales(rng, name: str, pfx: str, n: int, dims: Dict[str, int],
                 rebuy: Optional[Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]] = None
                 ) -> _Builder:
    """catalog_sales or web_sales: orders of 1-20 lines. ``rebuy``: store
    returns' (customer, item, returned date) arrays, from which a fifth
    of the orders are drawn (the returning customer buys the item again,
    on or after the return)."""
    b = _Builder(name, n, rng)
    order, pos, start, step, groups = _lines(rng, n, dims["item"])
    sold = _dates_between(rng, groups, _SOLD_LO, _SOLD_HI)
    bill = rng.integers(1, dims["customer"] + 1, groups)
    if rebuy is not None and len(rebuy[0]):
        cust, item, returned = rebuy
        which = np.nonzero(rng.random(groups) < 0.2)[0]
        src = rng.integers(0, len(cust), len(which))
        bill[which] = cust[src]
        start[which] = item[src] - 1
        sold[which] = np.minimum(returned[src] + rng.integers(0, 61,
                                                             len(which)),
                                 _jdn(np.array([_SOLD_HI]))[0])
    # orders numbered in date order
    by_date = np.argsort(sold, kind="stable")
    rank = np.empty(groups, dtype=np.int64)
    rank[by_date] = np.arange(groups)
    sold, bill = sold[by_date], bill[by_date]
    start, step = start[by_date], step[by_date]
    order = np.sort(rank[order])
    pos = np.arange(n, dtype=np.int64) - np.searchsorted(order, order)
    same_ship = rng.random(groups) < 0.7

    def other(k, hi):
        return np.where(same_ship, k, rng.integers(1, hi + 1, groups))

    n_cd = _FIXED["customer_demographics"]
    n_hd = _FIXED["household_demographics"]
    cdemo = rng.integers(1, n_cd + 1, groups)
    hdemo = rng.integers(1, n_hd + 1, groups)
    addr = rng.integers(1, dims["customer_address"] + 1, groups)
    per = {
        f"{pfx}_sold_date_sk": sold,
        f"{pfx}_sold_time_sk": rng.integers(0, 86_400, groups),
        f"{pfx}_bill_customer_sk": bill,
        f"{pfx}_bill_cdemo_sk": cdemo, f"{pfx}_bill_hdemo_sk": hdemo,
        f"{pfx}_bill_addr_sk": addr,
        f"{pfx}_ship_customer_sk": other(bill, dims["customer"]),
        f"{pfx}_ship_cdemo_sk": other(cdemo, n_cd),
        f"{pfx}_ship_hdemo_sk": other(hdemo, n_hd),
        f"{pfx}_ship_addr_sk": other(addr, dims["customer_address"]),
    }
    if pfx == "cs":
        per["cs_call_center_sk"] = rng.integers(
            1, dims["call_center"] + 1, groups)
    for c, v in per.items():
        b.num(c, v[order])
    b.num(f"{pfx}_ship_date_sk", sold[order] + rng.integers(1, 151, n))
    b.num(f"{pfx}_item_sk", (start[order] + pos * step[order])
          % dims["item"] + 1)
    if pfx == "cs":
        b.num("cs_catalog_page_sk",
              rng.integers(1, dims["catalog_page"] + 1, n))
    else:
        b.num("ws_web_page_sk", rng.integers(1, dims["web_page"] + 1, n))
        b.num("ws_web_site_sk", rng.integers(1, dims["web_site"] + 1, n))
    b.num(f"{pfx}_ship_mode_sk",
          rng.integers(1, _FIXED["ship_mode"] + 1, n))
    b.num(f"{pfx}_warehouse_sk", rng.integers(1, dims["warehouse"] + 1, n))
    b.num(f"{pfx}_promo_sk", rng.integers(1, dims["promotion"] + 1, n))
    b.num(f"{pfx}_order_number", order + 1)
    qty = rng.integers(1, 101, n)
    b.num(f"{pfx}_quantity", qty)
    money = _pricing(rng, n, qty)
    for c, v in money.items():
        b.num(f"{pfx}_{c}", v)
    return b


def _returns(rng, name: str, sale: _Builder, n: int,
             copies: Dict[str, str], own: Dict[str, Tuple[int, int]],
             money: Dict[str, str], date_col: str, sold_col: str
             ) -> _Builder:
    """A tenth of ``sale``'s lines returned: ``copies`` maps a returns
    column to the sales column it copies (with its NULLs), ``own`` a
    column to its [lo, hi] draw, ``money`` the amount columns to the
    role they play."""
    b = _Builder(name, n, rng)
    b.copied = set(copies)
    rows = np.sort(rng.choice(sale.n, n, replace=False))
    for c, s in copies.items():
        b.num(c, sale.cols[s][rows].copy())
        if s in sale.nulls:
            b.null(c, sale.nulls[s][rows])
    for c, (lo, hi) in own.items():
        b.num(c, rng.integers(lo, hi + 1, n))
    sold = sale.cols[sold_col][rows]
    b.num(date_col, sold + rng.integers(0, 91, n))
    qty_col = [c for c in SCHEMAS[name] if c[0].endswith("return_quantity")]
    pfx = sale.name.split("_")[0][0] + "s"
    bought = sale.cols[f"{pfx}_quantity"][rows]
    price = sale.cols[f"{pfx}_sales_price"][rows]
    list_price = sale.cols[f"{pfx}_list_price"][rows]
    rq = rng.integers(1, bought + 1)
    b.num(qty_col[0][0], rq)
    amt = rq * price
    tax = amt * rng.integers(0, 10, n) // 100
    fee = rng.integers(50, 10_001, n)
    ship = rq * list_price * rng.integers(0, 51, n) // 100
    cash = amt * rng.integers(0, 101, n) // 100
    charge = (amt - cash) * rng.integers(0, 101, n) // 100
    credit = amt - cash - charge
    values = {"amt": amt, "tax": tax, "amt_inc_tax": amt + tax,
              "fee": fee, "ship": ship, "cash": cash, "charge": charge,
              "credit": credit, "loss": tax + fee + ship}
    for c, role in money.items():
        b.num(c, values[role])
    return b


def _inventory(rng, dims: Dict[str, int]) -> _Builder:
    items = np.arange(1, dims["item"] + 1, 2, dtype=np.int64)
    wh = np.arange(1, dims["warehouse"] + 1, dtype=np.int64)
    weeks = _jdn(np.array([_INV_START]))[0] + 7 * np.arange(_WEEKS)
    n = len(items) * len(wh) * _WEEKS
    b = _Builder("inventory", n, rng)
    b.num("inv_date_sk", np.repeat(weeks, len(items) * len(wh)))
    b.num("inv_item_sk", np.tile(np.repeat(items, len(wh)), _WEEKS))
    b.num("inv_warehouse_sk", np.tile(wh, len(items) * _WEEKS))
    b.num("inv_quantity_on_hand", rng.integers(0, 1_001, n))
    return b


_MONEY_RETURN = {"return_amt": "amt", "return_amount": "amt",
                 "return_tax": "tax", "return_amt_inc_tax": "amt_inc_tax",
                 "fee": "fee", "return_ship_cost": "ship",
                 "refunded_cash": "cash", "reversed_charge": "charge",
                 "store_credit": "credit", "account_credit": "credit",
                 "net_loss": "loss"}


def _money_roles(name: str, pfx: str) -> Dict[str, str]:
    return {c: _MONEY_RETURN[c[len(pfx) + 1:]]
            for c, code in SCHEMAS[name] if isinstance(code, tuple)}


# ---------------------------------------------------------- entry

def generate_full(sf: float = 0.01, seed: int = 7
                  ) -> Tuple[Dict[str, Columns], Dict[str, List[str]],
                             Dict[str, Dict[str, np.ndarray]]]:
    """The 24 tables at scale ``sf``: ``(tables, dictionaries, nulls)``
    (see the module docstring). Each table draws from its own stream,
    ``np.random.default_rng([seed, k])``, k its place in ``TABLES``."""
    counts = row_counts(sf)
    dims = {t: counts[t] for t in _DIMS}

    def rng(table):
        return np.random.default_rng([seed, TABLES.index(table)])

    keys = {
        "store_sales": ("ss_item_sk", "ss_ticket_number"),
        "catalog_sales": ("cs_item_sk", "cs_order_number"),
        "web_sales": ("ws_item_sk", "ws_order_number"),
        "store_returns": ("sr_item_sk", "sr_ticket_number"),
        "catalog_returns": ("cr_item_sk", "cr_order_number"),
        "web_returns": ("wr_item_sk", "wr_order_number"),
        "inventory": ("inv_date_sk", "inv_item_sk", "inv_warehouse_sk"),
    }
    built: Dict[str, Tuple[_Builder, float]] = {}
    for t, make in (("date_dim", _date_dim), ("time_dim", _time_dim),
                    ("customer_demographics", _customer_demographics),
                    ("household_demographics", _household_demographics),
                    ("income_band", _income_band),
                    ("ship_mode", _ship_mode), ("reason", _reason)):
        built[t] = (make(rng(t)), 0.0)
    built["item"] = (_item(rng("item"), dims["item"]), DIM_NULL_RATE)
    built["customer_address"] = (_customer_address(
        rng("customer_address"), dims["customer_address"]), DIM_NULL_RATE)
    built["customer"] = (_customer(rng("customer"), dims["customer"],
                                   dims["customer_address"]), DIM_NULL_RATE)
    built["store"] = (_store(rng("store"), dims["store"]), DIM_NULL_RATE)
    built["promotion"] = (_promotion(rng("promotion"), dims["promotion"],
                                     dims["item"]), DIM_NULL_RATE)
    built["warehouse"] = (_warehouse(rng("warehouse"), dims["warehouse"]),
                          DIM_NULL_RATE)
    built["web_site"] = (_web_site(rng("web_site"), dims["web_site"]),
                         DIM_NULL_RATE)
    built["web_page"] = (_web_page(rng("web_page"), dims["web_page"],
                                   dims["customer"]), DIM_NULL_RATE)
    built["call_center"] = (_call_center(rng("call_center"),
                                         dims["call_center"]), DIM_NULL_RATE)
    built["catalog_page"] = (_catalog_page(rng("catalog_page"),
                                           dims["catalog_page"]),
                             DIM_NULL_RATE)

    # fact NULLs are set before the returns copy them
    def facts(b: _Builder) -> _Builder:
        r = b.rng
        for c, _ in SCHEMAS[b.name]:
            if c not in keys[b.name] and c not in b.copied:
                b.null(c, r.random(b.n) < FACT_NULL_RATE)
        return b

    ss = facts(_store_sales(rng("store_sales"), counts["store_sales"],
                            dims))
    sr = _returns(
        rng("store_returns"), "store_returns", ss, counts["store_returns"],
        {"sr_item_sk": "ss_item_sk", "sr_customer_sk": "ss_customer_sk",
         "sr_cdemo_sk": "ss_cdemo_sk", "sr_hdemo_sk": "ss_hdemo_sk",
         "sr_addr_sk": "ss_addr_sk", "sr_store_sk": "ss_store_sk",
         "sr_ticket_number": "ss_ticket_number"},
        {"sr_return_time_sk": (8 * 3600, 22 * 3600 - 1),
         "sr_reason_sk": (1, _FIXED["reason"])},
        _money_roles("store_returns", "sr"), "sr_returned_date_sk",
        "ss_sold_date_sk")
    facts(sr)
    # re-buys come from returns with a customer, made in the sales years
    known = ~(sr.nulls["sr_customer_sk"] | sr.nulls["sr_returned_date_sk"])
    known &= sr.cols["sr_returned_date_sk"] <= _jdn(np.array([_SOLD_HI]))[0]
    cs = facts(_order_sales(
        rng("catalog_sales"), "catalog_sales", "cs",
        counts["catalog_sales"], dims,
        (sr.cols["sr_customer_sk"][known], sr.cols["sr_item_sk"][known],
         sr.cols["sr_returned_date_sk"][known])))
    ws = facts(_order_sales(rng("web_sales"), "web_sales", "ws",
                            counts["web_sales"], dims))
    order_copies = {
        "item_sk": "item_sk", "order_number": "order_number",
        "refunded_customer_sk": "bill_customer_sk",
        "refunded_cdemo_sk": "bill_cdemo_sk",
        "refunded_hdemo_sk": "bill_hdemo_sk",
        "refunded_addr_sk": "bill_addr_sk",
        "returning_customer_sk": "ship_customer_sk",
        "returning_cdemo_sk": "ship_cdemo_sk",
        "returning_hdemo_sk": "ship_hdemo_sk",
        "returning_addr_sk": "ship_addr_sk",
    }
    cr = _returns(
        rng("catalog_returns"), "catalog_returns", cs,
        counts["catalog_returns"],
        {**{f"cr_{k}": f"cs_{v}" for k, v in order_copies.items()},
         "cr_call_center_sk": "cs_call_center_sk",
         "cr_catalog_page_sk": "cs_catalog_page_sk",
         "cr_ship_mode_sk": "cs_ship_mode_sk",
         "cr_warehouse_sk": "cs_warehouse_sk"},
        {"cr_returned_time_sk": (0, 86_399),
         "cr_reason_sk": (1, _FIXED["reason"])},
        _money_roles("catalog_returns", "cr"), "cr_returned_date_sk",
        "cs_ship_date_sk")
    wr = _returns(
        rng("web_returns"), "web_returns", ws, counts["web_returns"],
        {**{f"wr_{k}": f"ws_{v}" for k, v in order_copies.items()},
         "wr_web_page_sk": "ws_web_page_sk"},
        {"wr_returned_time_sk": (0, 86_399),
         "wr_reason_sk": (1, _FIXED["reason"])},
        _money_roles("web_returns", "wr"), "wr_returned_date_sk",
        "ws_ship_date_sk")
    for b in (cr, wr):
        facts(b)
    inv = facts(_inventory(rng("inventory"), dims))
    for b in (ss, sr, cs, cr, ws, wr, inv):
        built[b.name] = (b, 0.0)

    tables: Dict[str, Columns] = {}
    dictionaries: Dict[str, List[str]] = {}
    nulls: Dict[str, Dict[str, np.ndarray]] = {}
    for t in TABLES:
        b, rate = built[t]
        keep = [SCHEMAS[t][0][0]] + [c for c, _ in SCHEMAS[t]
                                     if c.endswith("_id")]
        tables[t], dicts, nulls[t] = b.finish(keep, rate)
        for c, v in dicts.items():
            if c in dictionaries:
                raise AssertionError(f"column {c} in two tables")
            dictionaries[c] = v
    return tables, dictionaries, nulls


def float_view(table: str, columns: Columns) -> Columns:
    """``columns`` with money (the DECIMAL(p, 2) columns) as the JAX
    package's ``dsdgen_tables`` view: float64 of the cents times 0.01."""
    out = dict(columns)
    for c, code in SCHEMAS[table]:
        if isinstance(code, tuple):
            out[c] = columns[c].astype(np.float64) * 0.01
    return out


def register_full(sf: float = 0.01, batch_rows: int = 1 << 20,
                  seed: int = 7, prefix: str = "",
                  tables: Optional[Sequence[str]] = None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[Dict[str, Columns], Dict[str, List[str]],
                             Dict[str, Dict[str, np.ndarray]]]:
    """Generate the 24 tables and register ``tables`` (default: all) as
    ``prefix + name`` in splits of at most ``batch_rows`` rows on
    ``device`` (None: the CUDA card), money as ``float_view``, NULLs as
    masks. Returns ``(tables, dictionaries, nulls)`` as registered (money
    in float64) for the callers."""
    from velox_tpu_torch import resolve_device
    from velox_tpu_torch.io.catalog import register_columns

    device = resolve_device(device)     # no card: raise before generating
    data, dictionaries, nulls = generate_full(sf, seed)
    out = {}
    for name in (tables or TABLES):
        cols = float_view(name, data[name])
        register_columns(prefix + name, cols,
                         {c: dictionaries[c] for c in cols
                          if c in dictionaries}, batch_rows, None, device,
                         nulls=nulls[name])
        out[name] = cols
    return out, dictionaries, nulls
