"""TPC-DS query corpus (adapted).

Shapes follow the official queries (star joins over date_dim/item/
demographics, grouped aggregation, ranking windows); parameters are
adjusted to the generated data's value ranges, and predicates that need
cross-column varchar comparison (e.g. q19's zip-prefix inequality) are
simplified — each adaptation is noted inline.  Correctness is validated
against a pandas oracle over the identical generated data
(tests/test_tpcds.py).
"""

QUERIES = {
    # q3: brand revenue for a manufacturer in November
    3: """
select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) sum_agg
from store_sales
join date_dim on ss_sold_date_sk = d_date_sk
join item on ss_item_sk = i_item_sk
where i_manufact_id = 5 and d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, i_brand_id
limit 100
""",
    # q7: average sales metrics for a demographic slice
    7: """
select i_item_id, avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales
join customer_demographics on ss_cdemo_sk = cd_demo_sk
join date_dim on ss_sold_date_sk = d_date_sk
join item on ss_item_sk = i_item_sk
join promotion on ss_promo_sk = p_promo_sk
where cd_gender = 'M' and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 1998
group by i_item_id order by i_item_id limit 100
""",
    # q19: brand revenue by manager/month (zip-prefix inequality dropped)
    19: """
select i_brand_id, i_brand, i_manufact_id, i_manufact,
       sum(ss_ext_sales_price) ext_price
from date_dim
join store_sales on d_date_sk = ss_sold_date_sk
join item on ss_item_sk = i_item_sk
join customer on ss_customer_sk = c_customer_sk
join customer_address on c_current_addr_sk = ca_address_sk
join store on ss_store_sk = s_store_sk
where i_manager_id = 2 and d_moy = 11 and d_year = 1999
group by i_brand_id, i_brand, i_manufact_id, i_manufact
order by ext_price desc, i_brand_id limit 100
""",
    # q42: category revenue for a month
    42: """
select d_year, i_category_id, i_category, sum(ss_ext_sales_price) s
from date_dim
join store_sales on d_date_sk = ss_sold_date_sk
join item on ss_item_sk = i_item_sk
where i_manager_id = 1 and d_moy = 11 and d_year = 1998
group by d_year, i_category_id, i_category
order by s desc, d_year, i_category_id, i_category limit 100
""",
    # q52: brand revenue for a month
    52: """
select d_year, i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim
join store_sales on d_date_sk = ss_sold_date_sk
join item on ss_item_sk = i_item_sk
where i_manager_id = 1 and d_moy = 11 and d_year = 1998
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, brand_id limit 100
""",
    # q55: brand revenue for a manager/month
    55: """
select i_brand_id brand_id, i_brand brand,
       sum(ss_ext_sales_price) ext_price
from date_dim
join store_sales on d_date_sk = ss_sold_date_sk
join item on ss_item_sk = i_item_sk
where i_manager_id = 3 and d_moy = 12 and d_year = 1998
group by i_brand_id, i_brand
order by ext_price desc, brand_id limit 100
""",
    # q96: store-sales count in a time window for a household profile
    # (store-name equality replaced by a key predicate; names are synthetic)
    96: """
select count(*) cnt
from store_sales
join household_demographics on ss_hdemo_sk = hd_demo_sk
join time_dim on ss_sold_time_sk = t_time_sk
join store on ss_store_sk = s_store_sk
where t_hour = 20 and t_minute >= 30 and hd_dep_count = 5
  and s_store_sk <= 6
""",
    # q98: class revenue ratio via a partitioned window
    98: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) itemrevenue,
       sum(ss_ext_sales_price) * 100.0000 /
         sum(sum(ss_ext_sales_price)) over (partition by i_class) revenueratio
from store_sales
join item on ss_item_sk = i_item_sk
join date_dim on ss_sold_date_sk = d_date_sk
where i_category in ('Sports', 'Books', 'Home')
  and d_date between date '1999-02-22' and date '1999-03-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    # q26: catalog-sales demographics averages
    26: """
select i_item_id, avg(cs_quantity) agg1, avg(cs_list_price) agg2,
       avg(cs_coupon_amt) agg3, avg(cs_sales_price) agg4
from catalog_sales
join customer_demographics on cs_bill_cdemo_sk = cd_demo_sk
join date_dim on cs_sold_date_sk = d_date_sk
join item on cs_item_sk = i_item_sk
join promotion on cs_promo_sk = p_promo_sk
where cd_gender = 'F' and cd_marital_status = 'W'
  and cd_education_status = 'Primary'
  and (p_channel_email = 'N' or p_channel_event = 'N')
  and d_year = 2000
group by i_item_id order by i_item_id limit 100
""",
    # q12: web-sales class revenue ratio (window)
    12: """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ws_ext_sales_price) itemrevenue,
       sum(ws_ext_sales_price) * 100.0000 /
         sum(sum(ws_ext_sales_price)) over (partition by i_class) revenueratio
from web_sales
join item on ws_item_sk = i_item_sk
join date_dim on ws_sold_date_sk = d_date_sk
where i_category in ('Men', 'Music', 'Women')
  and d_date between date '2000-01-25' and date '2000-02-24'
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
limit 100
""",
    # q6: states whose customers bought items priced 20% above their
    # category average (correlated scalar subquery; the original's
    # month-sk indirection replaced by a direct d_year/d_moy predicate)
    6: """
select ca_state state, count(*) cnt
from customer_address
join customer on ca_address_sk = c_current_addr_sk
join store_sales on c_customer_sk = ss_customer_sk
join date_dim on ss_sold_date_sk = d_date_sk
join item on ss_item_sk = i_item_sk
where d_year = 1999 and d_moy = 2
  and i_current_price > 1.2 * (select avg(j.i_current_price) from item j
                               where j.i_category = item.i_category)
group by ca_state
having count(*) >= 3
order by cnt, state limit 100
""",
    # q13: disjunctive demographic/address bands over one scan
    13: """
select avg(ss_quantity) a1, avg(ss_ext_sales_price) a2,
       avg(ss_ext_wholesale_cost) a3, sum(ss_ext_wholesale_cost) a4
from store_sales
join store on s_store_sk = ss_store_sk
join customer_demographics on cd_demo_sk = ss_cdemo_sk
join household_demographics on ss_hdemo_sk = hd_demo_sk
join customer_address on ss_addr_sk = ca_address_sk
join date_dim on ss_sold_date_sk = d_date_sk
where d_year = 1998
  and ((cd_marital_status = 'M' and cd_education_status = 'College'
        and ss_sales_price between 50.00 and 150.00 and hd_dep_count = 3)
    or (cd_marital_status = 'S' and cd_education_status = 'Secondary'
        and ss_sales_price between 10.00 and 100.00 and hd_dep_count = 1))
  and ((ca_state in ('TX', 'OH', 'MI') and ss_net_profit between 0 and 100)
    or (ca_state in ('CA', 'WA', 'GA') and ss_net_profit between 50 and 150)
    or (ca_state in ('NY', 'FL', 'AL') and ss_net_profit between 0 and 200))
""",
    # q15: catalog revenue by zip for selected zips/states or big tickets
    15: """
select ca_zip, sum(cs_sales_price) s
from catalog_sales
join customer on cs_bill_customer_sk = c_customer_sk
join customer_address on c_current_addr_sk = ca_address_sk
join date_dim on cs_sold_date_sk = d_date_sk
where (substr(ca_zip, 1, 5) in ('85669', '86197', '88274', '83405', '86475')
    or ca_state in ('CA', 'WA', 'GA') or cs_sales_price > 500)
  and d_qoy = 2 and d_year = 2000
group by ca_zip order by ca_zip limit 100
""",
    # q25: store sale -> store return -> catalog re-purchase chain
    # (three date_dim aliases; month windows widened for the small SF)
    25: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) store_sales_profit,
       sum(sr_net_loss) store_returns_loss,
       sum(cs_net_profit) catalog_sales_profit
from store_sales
join store_returns on ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk and ss_ticket_number = sr_ticket_number
join catalog_sales on sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
join date_dim d1 on d1.d_date_sk = ss_sold_date_sk
join date_dim d2 on d2.d_date_sk = sr_returned_date_sk
join date_dim d3 on d3.d_date_sk = cs_sold_date_sk
join store on s_store_sk = ss_store_sk
join item on i_item_sk = ss_item_sk
where d1.d_year = 1999
  and d2.d_moy between 1 and 12 and d2.d_year between 1999 and 2000
  and d3.d_moy between 1 and 12 and d3.d_year between 1999 and 2000
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name limit 100
""",
    # q27: demographic averages with ROLLUP subtotals
    27: """
select i_item_id, s_state,
       avg(ss_quantity) agg1, avg(ss_list_price) agg2,
       avg(ss_coupon_amt) agg3, avg(ss_sales_price) agg4
from store_sales
join customer_demographics on ss_cdemo_sk = cd_demo_sk
join date_dim on ss_sold_date_sk = d_date_sk
join store on ss_store_sk = s_store_sk
join item on ss_item_sk = i_item_sk
where cd_gender = 'F' and cd_marital_status = 'W'
  and cd_education_status = 'Primary' and d_year = 1998
  and i_manager_id = 5
group by rollup(i_item_id, s_state)
order by i_item_id, s_state
""",
    # q37: catalog items in a price band with on-hand inventory
    37: """
select i_item_id, i_item_desc, i_current_price
from item
join inventory on inv_item_sk = i_item_sk
join date_dim on d_date_sk = inv_date_sk
join catalog_sales on cs_item_sk = i_item_sk
where i_current_price between 20 and 50
  and inv_quantity_on_hand between 100 and 500
  and d_date between date '2000-02-01' and date '2000-04-01'
group by i_item_id, i_item_desc, i_current_price
order by i_item_id limit 100
""",
    # q43: weekly sales pivot per store (CASE-without-ELSE aggregation)
    43: """
select s_store_name, s_store_id,
       sum(case when d_day_name = 'Sunday' then ss_sales_price end) sun_sales,
       sum(case when d_day_name = 'Monday' then ss_sales_price end) mon_sales,
       sum(case when d_day_name = 'Tuesday' then ss_sales_price end) tue_sales,
       sum(case when d_day_name = 'Wednesday' then ss_sales_price end) wed_sales,
       sum(case when d_day_name = 'Thursday' then ss_sales_price end) thu_sales,
       sum(case when d_day_name = 'Friday' then ss_sales_price end) fri_sales,
       sum(case when d_day_name = 'Saturday' then ss_sales_price end) sat_sales
from date_dim
join store_sales on d_date_sk = ss_sold_date_sk
join store on s_store_sk = ss_store_sk
where d_year = 1998
group by s_store_name, s_store_id
order by s_store_name, s_store_id limit 100
""",
    # q65: items selling at <=10% of their store's average item revenue
    # (nested derived tables; the inner aggregate appears twice)
    65: """
select s_store_name, i_item_desc, sc.revenue
from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) revenue
      from store_sales join date_dim on d_date_sk = ss_sold_date_sk
      where d_year = 1999 group by ss_store_sk, ss_item_sk) sc
join (select ss_store_sk sk, avg(revenue) ave
      from (select ss_store_sk, ss_item_sk, sum(ss_sales_price) revenue
            from store_sales join date_dim on d_date_sk = ss_sold_date_sk
            where d_year = 1999 group by ss_store_sk, ss_item_sk) sb
      group by ss_store_sk) sbavg on sbavg.sk = sc.ss_store_sk
join store on s_store_sk = sc.ss_store_sk
join item on i_item_sk = sc.ss_item_sk
where sc.revenue <= 0.1 * sbavg.ave
order by s_store_name, i_item_desc limit 100
""",
    # q73: ticket sizes for a household profile (derived-table join;
    # ticket number added to ORDER BY for a deterministic cut)
    73: """
select c_last_name, c_first_name, c_salutation, c_preferred_cust_flag,
       ss_ticket_number, cnt
from (select ss_ticket_number, ss_customer_sk, count(*) cnt
      from store_sales
      join date_dim on ss_sold_date_sk = d_date_sk
      join store on ss_store_sk = s_store_sk
      join household_demographics on ss_hdemo_sk = hd_demo_sk
      where hd_dep_count = 5 and s_store_sk <= 6 and d_year = 1999
      group by ss_ticket_number, ss_customer_sk) dj
join customer on ss_customer_sk = c_customer_sk
where cnt between 1 and 5
order by cnt desc, c_last_name, ss_ticket_number limit 100
""",
    # q93: net sales after returns per customer (LEFT JOIN + CASE over
    # the null-extended side; the original's reason filter dropped)
    93: """
select ss_customer_sk, sum(act_sales) sumsales
from (select ss_item_sk, ss_ticket_number, ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity) * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from store_sales
      left join store_returns on sr_item_sk = ss_item_sk
        and sr_ticket_number = ss_ticket_number) t
group by ss_customer_sk
order by sumsales, ss_customer_sk limit 100
""",
    # q89: monthly class sales vs yearly average (window over partition)
    89: """
select i_category, i_class, i_brand, s_store_name, s_company_name,
       d_moy, sum(ss_sales_price) sum_sales,
       avg(sum(ss_sales_price)) over (partition by i_category, i_brand,
                                      s_store_name, s_company_name)
         avg_monthly_sales
from item
join store_sales on ss_item_sk = i_item_sk
join date_dim on ss_sold_date_sk = d_date_sk
join store on ss_store_sk = s_store_sk
where d_year = 1999 and i_category in ('Books', 'Electronics', 'Sports')
group by i_category, i_class, i_brand, s_store_name, s_company_name, d_moy
order by sum_sales, s_store_name limit 100
""",
}
