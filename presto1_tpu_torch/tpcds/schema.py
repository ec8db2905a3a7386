"""TPC-DS schema: all 24 tables (reference: plugin/trino-tpcds
``TpcdsMetadata`` + the tpcds library's table definitions).

Column lists and types follow the TPC-DS v2 specification; money columns
are decimal(7,2), gmt offsets decimal(5,2), surrogate keys bigint, flags
1-char varchar.
"""

from __future__ import annotations

from ..types import BIGINT, DATE, DOUBLE, DecimalType, INTEGER, VARCHAR

MONEY = DecimalType(7, 2)
GMT = DecimalType(5, 2)
PCT = DecimalType(5, 2)

_I = INTEGER
_B = BIGINT
_V = VARCHAR
_D = DATE


def _cols(*pairs):
    return [(name, t) for name, t in pairs]


TABLES = {
    "date_dim": _cols(
        ("d_date_sk", _B), ("d_date_id", _V), ("d_date", _D),
        ("d_month_seq", _I), ("d_week_seq", _I), ("d_quarter_seq", _I),
        ("d_year", _I), ("d_dow", _I), ("d_moy", _I), ("d_dom", _I),
        ("d_qoy", _I), ("d_fy_year", _I), ("d_fy_quarter_seq", _I),
        ("d_fy_week_seq", _I), ("d_day_name", _V), ("d_quarter_name", _V),
        ("d_holiday", _V), ("d_weekend", _V), ("d_following_holiday", _V),
        ("d_first_dom", _I), ("d_last_dom", _I), ("d_same_day_ly", _I),
        ("d_same_day_lq", _I), ("d_current_day", _V), ("d_current_week", _V),
        ("d_current_month", _V), ("d_current_quarter", _V),
        ("d_current_year", _V)),
    "time_dim": _cols(
        ("t_time_sk", _B), ("t_time_id", _V), ("t_time", _I),
        ("t_hour", _I), ("t_minute", _I), ("t_second", _I),
        ("t_am_pm", _V), ("t_shift", _V), ("t_sub_shift", _V),
        ("t_meal_time", _V)),
    "item": _cols(
        ("i_item_sk", _B), ("i_item_id", _V), ("i_rec_start_date", _D),
        ("i_rec_end_date", _D), ("i_item_desc", _V),
        ("i_current_price", MONEY), ("i_wholesale_cost", MONEY),
        ("i_brand_id", _I), ("i_brand", _V), ("i_class_id", _I),
        ("i_class", _V), ("i_category_id", _I), ("i_category", _V),
        ("i_manufact_id", _I), ("i_manufact", _V), ("i_size", _V),
        ("i_formulation", _V), ("i_color", _V), ("i_units", _V),
        ("i_container", _V), ("i_manager_id", _I), ("i_product_name", _V)),
    "customer": _cols(
        ("c_customer_sk", _B), ("c_customer_id", _V),
        ("c_current_cdemo_sk", _B), ("c_current_hdemo_sk", _B),
        ("c_current_addr_sk", _B), ("c_first_shipto_date_sk", _B),
        ("c_first_sales_date_sk", _B), ("c_salutation", _V),
        ("c_first_name", _V), ("c_last_name", _V),
        ("c_preferred_cust_flag", _V), ("c_birth_day", _I),
        ("c_birth_month", _I), ("c_birth_year", _I),
        ("c_birth_country", _V), ("c_login", _V), ("c_email_address", _V),
        ("c_last_review_date_sk", _B)),
    "customer_address": _cols(
        ("ca_address_sk", _B), ("ca_address_id", _V),
        ("ca_street_number", _V), ("ca_street_name", _V),
        ("ca_street_type", _V), ("ca_suite_number", _V), ("ca_city", _V),
        ("ca_county", _V), ("ca_state", _V), ("ca_zip", _V),
        ("ca_country", _V), ("ca_gmt_offset", GMT),
        ("ca_location_type", _V)),
    "customer_demographics": _cols(
        ("cd_demo_sk", _B), ("cd_gender", _V), ("cd_marital_status", _V),
        ("cd_education_status", _V), ("cd_purchase_estimate", _I),
        ("cd_credit_rating", _V), ("cd_dep_count", _I),
        ("cd_dep_employed_count", _I), ("cd_dep_college_count", _I)),
    "household_demographics": _cols(
        ("hd_demo_sk", _B), ("hd_income_band_sk", _B),
        ("hd_buy_potential", _V), ("hd_dep_count", _I),
        ("hd_vehicle_count", _I)),
    "income_band": _cols(
        ("ib_income_band_sk", _B), ("ib_lower_bound", _I),
        ("ib_upper_bound", _I)),
    "store": _cols(
        ("s_store_sk", _B), ("s_store_id", _V), ("s_rec_start_date", _D),
        ("s_rec_end_date", _D), ("s_closed_date_sk", _B),
        ("s_store_name", _V), ("s_number_employees", _I),
        ("s_floor_space", _I), ("s_hours", _V), ("s_manager", _V),
        ("s_market_id", _I), ("s_geography_class", _V),
        ("s_market_desc", _V), ("s_market_manager", _V),
        ("s_division_id", _I), ("s_division_name", _V),
        ("s_company_id", _I), ("s_company_name", _V),
        ("s_street_number", _V), ("s_street_name", _V),
        ("s_street_type", _V), ("s_suite_number", _V), ("s_city", _V),
        ("s_county", _V), ("s_state", _V), ("s_zip", _V), ("s_country", _V),
        ("s_gmt_offset", GMT), ("s_tax_precentage", PCT)),
    "promotion": _cols(
        ("p_promo_sk", _B), ("p_promo_id", _V), ("p_start_date_sk", _B),
        ("p_end_date_sk", _B), ("p_item_sk", _B), ("p_cost", MONEY),
        ("p_response_target", _I), ("p_promo_name", _V),
        ("p_channel_dmail", _V), ("p_channel_email", _V),
        ("p_channel_catalog", _V), ("p_channel_tv", _V),
        ("p_channel_radio", _V), ("p_channel_press", _V),
        ("p_channel_event", _V), ("p_channel_demo", _V),
        ("p_channel_details", _V), ("p_purpose", _V),
        ("p_discount_active", _V)),
    "warehouse": _cols(
        ("w_warehouse_sk", _B), ("w_warehouse_id", _V),
        ("w_warehouse_name", _V), ("w_warehouse_sq_ft", _I),
        ("w_street_number", _V), ("w_street_name", _V),
        ("w_street_type", _V), ("w_suite_number", _V), ("w_city", _V),
        ("w_county", _V), ("w_state", _V), ("w_zip", _V), ("w_country", _V),
        ("w_gmt_offset", GMT)),
    "ship_mode": _cols(
        ("sm_ship_mode_sk", _B), ("sm_ship_mode_id", _V), ("sm_type", _V),
        ("sm_code", _V), ("sm_carrier", _V), ("sm_contract", _V)),
    "reason": _cols(
        ("r_reason_sk", _B), ("r_reason_id", _V), ("r_reason_desc", _V)),
    "call_center": _cols(
        ("cc_call_center_sk", _B), ("cc_call_center_id", _V),
        ("cc_rec_start_date", _D), ("cc_rec_end_date", _D),
        ("cc_closed_date_sk", _B), ("cc_open_date_sk", _B), ("cc_name", _V),
        ("cc_class", _V), ("cc_employees", _I), ("cc_sq_ft", _I),
        ("cc_hours", _V), ("cc_manager", _V), ("cc_mkt_id", _I),
        ("cc_mkt_class", _V), ("cc_mkt_desc", _V),
        ("cc_market_manager", _V), ("cc_division", _I),
        ("cc_division_name", _V), ("cc_company", _I),
        ("cc_company_name", _V), ("cc_street_number", _V),
        ("cc_street_name", _V), ("cc_street_type", _V),
        ("cc_suite_number", _V), ("cc_city", _V), ("cc_county", _V),
        ("cc_state", _V), ("cc_zip", _V), ("cc_country", _V),
        ("cc_gmt_offset", GMT), ("cc_tax_percentage", PCT)),
    "catalog_page": _cols(
        ("cp_catalog_page_sk", _B), ("cp_catalog_page_id", _V),
        ("cp_start_date_sk", _B), ("cp_end_date_sk", _B),
        ("cp_department", _V), ("cp_catalog_number", _I),
        ("cp_catalog_page_number", _I), ("cp_description", _V),
        ("cp_type", _V)),
    "web_site": _cols(
        ("web_site_sk", _B), ("web_site_id", _V),
        ("web_rec_start_date", _D), ("web_rec_end_date", _D),
        ("web_name", _V), ("web_open_date_sk", _B),
        ("web_close_date_sk", _B), ("web_class", _V), ("web_manager", _V),
        ("web_mkt_id", _I), ("web_mkt_class", _V), ("web_mkt_desc", _V),
        ("web_market_manager", _V), ("web_company_id", _I),
        ("web_company_name", _V), ("web_street_number", _V),
        ("web_street_name", _V), ("web_street_type", _V),
        ("web_suite_number", _V), ("web_city", _V), ("web_county", _V),
        ("web_state", _V), ("web_zip", _V), ("web_country", _V),
        ("web_gmt_offset", GMT), ("web_tax_percentage", PCT)),
    "web_page": _cols(
        ("wp_web_page_sk", _B), ("wp_web_page_id", _V),
        ("wp_rec_start_date", _D), ("wp_rec_end_date", _D),
        ("wp_creation_date_sk", _B), ("wp_access_date_sk", _B),
        ("wp_autogen_flag", _V), ("wp_customer_sk", _B), ("wp_url", _V),
        ("wp_type", _V), ("wp_char_count", _I), ("wp_link_count", _I),
        ("wp_image_count", _I), ("wp_max_ad_count", _I)),
    "store_sales": _cols(
        ("ss_sold_date_sk", _B), ("ss_sold_time_sk", _B),
        ("ss_item_sk", _B), ("ss_customer_sk", _B), ("ss_cdemo_sk", _B),
        ("ss_hdemo_sk", _B), ("ss_addr_sk", _B), ("ss_store_sk", _B),
        ("ss_promo_sk", _B), ("ss_ticket_number", _B), ("ss_quantity", _I),
        ("ss_wholesale_cost", MONEY), ("ss_list_price", MONEY),
        ("ss_sales_price", MONEY), ("ss_ext_discount_amt", MONEY),
        ("ss_ext_sales_price", MONEY), ("ss_ext_wholesale_cost", MONEY),
        ("ss_ext_list_price", MONEY), ("ss_ext_tax", MONEY),
        ("ss_coupon_amt", MONEY), ("ss_net_paid", MONEY),
        ("ss_net_paid_inc_tax", MONEY), ("ss_net_profit", MONEY)),
    "store_returns": _cols(
        ("sr_returned_date_sk", _B), ("sr_return_time_sk", _B),
        ("sr_item_sk", _B), ("sr_customer_sk", _B), ("sr_cdemo_sk", _B),
        ("sr_hdemo_sk", _B), ("sr_addr_sk", _B), ("sr_store_sk", _B),
        ("sr_reason_sk", _B), ("sr_ticket_number", _B),
        ("sr_return_quantity", _I), ("sr_return_amt", MONEY),
        ("sr_return_tax", MONEY), ("sr_return_amt_inc_tax", MONEY),
        ("sr_fee", MONEY), ("sr_return_ship_cost", MONEY),
        ("sr_refunded_cash", MONEY), ("sr_reversed_charge", MONEY),
        ("sr_store_credit", MONEY), ("sr_net_loss", MONEY)),
    "catalog_sales": _cols(
        ("cs_sold_date_sk", _B), ("cs_sold_time_sk", _B),
        ("cs_ship_date_sk", _B), ("cs_bill_customer_sk", _B),
        ("cs_bill_cdemo_sk", _B), ("cs_bill_hdemo_sk", _B),
        ("cs_bill_addr_sk", _B), ("cs_ship_customer_sk", _B),
        ("cs_ship_cdemo_sk", _B), ("cs_ship_hdemo_sk", _B),
        ("cs_ship_addr_sk", _B), ("cs_call_center_sk", _B),
        ("cs_catalog_page_sk", _B), ("cs_ship_mode_sk", _B),
        ("cs_warehouse_sk", _B), ("cs_item_sk", _B), ("cs_promo_sk", _B),
        ("cs_order_number", _B), ("cs_quantity", _I),
        ("cs_wholesale_cost", MONEY), ("cs_list_price", MONEY),
        ("cs_sales_price", MONEY), ("cs_ext_discount_amt", MONEY),
        ("cs_ext_sales_price", MONEY), ("cs_ext_wholesale_cost", MONEY),
        ("cs_ext_list_price", MONEY), ("cs_ext_tax", MONEY),
        ("cs_coupon_amt", MONEY), ("cs_ext_ship_cost", MONEY),
        ("cs_net_paid", MONEY), ("cs_net_paid_inc_tax", MONEY),
        ("cs_net_paid_inc_ship", MONEY),
        ("cs_net_paid_inc_ship_tax", MONEY), ("cs_net_profit", MONEY)),
    "catalog_returns": _cols(
        ("cr_returned_date_sk", _B), ("cr_returned_time_sk", _B),
        ("cr_item_sk", _B), ("cr_refunded_customer_sk", _B),
        ("cr_refunded_cdemo_sk", _B), ("cr_refunded_hdemo_sk", _B),
        ("cr_refunded_addr_sk", _B), ("cr_returning_customer_sk", _B),
        ("cr_returning_cdemo_sk", _B), ("cr_returning_hdemo_sk", _B),
        ("cr_returning_addr_sk", _B), ("cr_call_center_sk", _B),
        ("cr_catalog_page_sk", _B), ("cr_ship_mode_sk", _B),
        ("cr_warehouse_sk", _B), ("cr_reason_sk", _B),
        ("cr_order_number", _B), ("cr_return_quantity", _I),
        ("cr_return_amount", MONEY), ("cr_return_tax", MONEY),
        ("cr_return_amt_inc_tax", MONEY), ("cr_fee", MONEY),
        ("cr_return_ship_cost", MONEY), ("cr_refunded_cash", MONEY),
        ("cr_reversed_charge", MONEY), ("cr_store_credit", MONEY),
        ("cr_net_loss", MONEY)),
    "web_sales": _cols(
        ("ws_sold_date_sk", _B), ("ws_sold_time_sk", _B),
        ("ws_ship_date_sk", _B), ("ws_item_sk", _B),
        ("ws_bill_customer_sk", _B), ("ws_bill_cdemo_sk", _B),
        ("ws_bill_hdemo_sk", _B), ("ws_bill_addr_sk", _B),
        ("ws_ship_customer_sk", _B), ("ws_ship_cdemo_sk", _B),
        ("ws_ship_hdemo_sk", _B), ("ws_ship_addr_sk", _B),
        ("ws_web_page_sk", _B), ("ws_web_site_sk", _B),
        ("ws_ship_mode_sk", _B), ("ws_warehouse_sk", _B),
        ("ws_promo_sk", _B), ("ws_order_number", _B), ("ws_quantity", _I),
        ("ws_wholesale_cost", MONEY), ("ws_list_price", MONEY),
        ("ws_sales_price", MONEY), ("ws_ext_discount_amt", MONEY),
        ("ws_ext_sales_price", MONEY), ("ws_ext_wholesale_cost", MONEY),
        ("ws_ext_list_price", MONEY), ("ws_ext_tax", MONEY),
        ("ws_coupon_amt", MONEY), ("ws_ext_ship_cost", MONEY),
        ("ws_net_paid", MONEY), ("ws_net_paid_inc_tax", MONEY),
        ("ws_net_paid_inc_ship", MONEY),
        ("ws_net_paid_inc_ship_tax", MONEY), ("ws_net_profit", MONEY)),
    "web_returns": _cols(
        ("wr_returned_date_sk", _B), ("wr_returned_time_sk", _B),
        ("wr_item_sk", _B), ("wr_refunded_customer_sk", _B),
        ("wr_refunded_cdemo_sk", _B), ("wr_refunded_hdemo_sk", _B),
        ("wr_refunded_addr_sk", _B), ("wr_returning_customer_sk", _B),
        ("wr_returning_cdemo_sk", _B), ("wr_returning_hdemo_sk", _B),
        ("wr_returning_addr_sk", _B), ("wr_web_page_sk", _B),
        ("wr_reason_sk", _B), ("wr_order_number", _B),
        ("wr_return_quantity", _I), ("wr_return_amt", MONEY),
        ("wr_return_tax", MONEY), ("wr_return_amt_inc_tax", MONEY),
        ("wr_fee", MONEY), ("wr_return_ship_cost", MONEY),
        ("wr_refunded_cash", MONEY), ("wr_reversed_charge", MONEY),
        ("wr_account_credit", MONEY), ("wr_net_loss", MONEY)),
    "inventory": _cols(
        ("inv_date_sk", _B), ("inv_item_sk", _B),
        ("inv_warehouse_sk", _B), ("inv_quantity_on_hand", _I)),
    "dbgen_version": _cols(
        ("dv_version", _V), ("dv_create_date", _D),
        ("dv_create_time", _V), ("dv_cmdline_args", _V)),
}

# spec row counts at SF1; "fixed" tables do not scale
SF1_ROWS = {
    "call_center": 6, "catalog_page": 11718, "catalog_returns": 144067,
    "catalog_sales": 1441548, "customer": 100000,
    "customer_address": 50000, "customer_demographics": 1920800,
    "date_dim": 73049, "household_demographics": 7200, "income_band": 20,
    "inventory": 11745000, "item": 18000, "promotion": 300, "reason": 35,
    "ship_mode": 20, "store": 12, "store_returns": 287514,
    "store_sales": 2880404, "time_dim": 86400, "warehouse": 5,
    "web_page": 60, "web_returns": 71763, "web_sales": 719384,
    "web_site": 30, "dbgen_version": 1,
}
FIXED = {"date_dim", "time_dim", "income_band", "ship_mode",
         "dbgen_version"}


# primary keys per the TPC-DS v2 spec table definitions (dimension
# surrogate keys; fact composite keys) — consumed as optimizer
# uniqueness hints exactly like the tpch connector statistics
PRIMARY_KEYS = {
    "date_dim": [("d_date_sk",)],
    "time_dim": [("t_time_sk",)],
    "item": [("i_item_sk",)],
    "customer": [("c_customer_sk",)],
    "customer_address": [("ca_address_sk",)],
    "customer_demographics": [("cd_demo_sk",)],
    "household_demographics": [("hd_demo_sk",)],
    "income_band": [("ib_income_band_sk",)],
    "store": [("s_store_sk",)],
    "call_center": [("cc_call_center_sk",)],
    "catalog_page": [("cp_catalog_page_sk",)],
    "web_site": [("web_site_sk",)],
    "web_page": [("wp_web_page_sk",)],
    "warehouse": [("w_warehouse_sk",)],
    "promotion": [("p_promo_sk",)],
    "reason": [("r_reason_sk",)],
    "ship_mode": [("sm_ship_mode_sk",)],
    "store_sales": [("ss_item_sk", "ss_ticket_number")],
    "store_returns": [("sr_item_sk", "sr_ticket_number")],
    "catalog_sales": [("cs_item_sk", "cs_order_number")],
    "catalog_returns": [("cr_item_sk", "cr_order_number")],
    "web_sales": [("ws_item_sk", "ws_order_number")],
    "web_returns": [("wr_item_sk", "wr_order_number")],
    "inventory": [("inv_date_sk", "inv_item_sk", "inv_warehouse_sk")],
}
