"""CSV table loaders without pandas: a copy of `nngp_tpu/data/loaders.py`.

Each loader returns ``(table, col_types[, primary_key])`` with the column
subsets and type tags of the original. Where the original returns a pandas
DataFrame, a loader here returns a `Table` (`nngp_tpu_torch.data.table`:
ordered column name -> 1-D numpy array), read by `read_csv`, which types
every column as `pd.read_csv` does. The rest of the port's data layer
(`featurize/schema.py`, `TableStats.from_dataframe`, `data/clean.py`,
`data/sampler.py`) takes `Table`s. `tests/test_torch_loaders.py` holds
every loader to the original: the same columns, dtypes and values.
"""

import os
from typing import Optional

from nngp_tpu_torch.data.table import Table, read_csv

__all__ = ["Table", "LOADERS", "SCHEMAS", "load_table", "NUM", "CAT"]

NUM = "numerical"
CAT = "categorical"


def _read(data_path, filename, col_names, nrows, header=0, delimiter=";",
          usecols=None) -> Table:
    return read_csv(os.path.join(data_path, filename), col_names,
                    header=header, delimiter=delimiter, usecols=usecols,
                    nrows=nrows)


# --- single-table datasets ---
def load_forest(data_path, filename="forest.csv", nrows=None):
    """First 10 Covertype columns as A..J."""
    cols = list("ABCDEFGHIJ")
    return _read(data_path, filename, cols, nrows, header=None,
                 delimiter=",", usecols=list(range(10))), [NUM] * 10


def load_higgs(data_path, filename="HIGGS.csv", nrows=None):
    """HIGGS columns 22..28 as A..G."""
    cols = list("ABCDEFG")
    return _read(data_path, filename, cols, nrows, header=None,
                 delimiter=",", usecols=[22, 23, 24, 25, 26, 27, 28]), \
        [NUM] * 7


def load_sales(data_path, filename="train.csv", nrows=None):
    cols = ["store", "item", "sales", "promote"]
    return _read(data_path, filename, cols, nrows, delimiter=",",
                 usecols=[2, 3, 4, 5]), [CAT, CAT, NUM, CAT]


def load_yelp_reviews(data_path, filename="review_tmp.csv", nrows=None):
    cols = ["review_id", "user_id", "business_id", "stars", "useful", "funny",
            "cool"]
    return _read(data_path, filename, cols, nrows), \
        [CAT, CAT, CAT, NUM, NUM, NUM, NUM]


def load_yelp_users(data_path, filename="user_tmp.csv", nrows=None):
    cols = ["user_id", "review_count", "useful", "funny", "cool", "fans",
            "average_stars", "compliment_hot", "compliment_more",
            "compliment_profile", "compliment_cute", "compliment_list",
            "compliment_note", "compliment_plain", "compliment_cool",
            "compliment_funny", "compliment_writer", "compliment_photos"]
    return _read(data_path, filename, cols, nrows), [CAT] + [NUM] * 17


# --- multi-table schemas: (table, col_types, primary_key) ---
def load_tpch_lineitem(data_path, filename="lineitem.csv", nrows=None):
    cols = ["order_key", "part_key", "supp_key", "line_number", "quantity",
            "extended_price", "discount", "tax"]
    return _read(data_path, filename, cols, nrows), [NUM] * 8, ""


def load_tpch_part(data_path, filename="part.csv", nrows=None):
    cols = ["part_key", "size", "retail_price"]
    return _read(data_path, filename, cols, nrows), [NUM] * 3, "part_key"


def load_tpch_orders(data_path, filename="orders.csv", nrows=None):
    cols = ["order_key", "order_status", "total_price", "ship_priority"]
    return _read(data_path, filename, cols, nrows), [NUM] * 4, "order_key"


def load_tpch_supplier(data_path, filename="supplier.csv", nrows=None):
    cols = ["supp_key", "nationkey", "acctbal"]
    return _read(data_path, filename, cols, nrows), [NUM] * 3, "supp_key"


def load_tpcds_store_sales(data_path, filename="store_sales.csv", nrows=None):
    cols = ["item_sk", "customer_sk", "store_sk", "promo_sk", "quantity",
            "wholesale_cost", "list_price", "sales_price", "ext_discount_amt",
            "ext_sales_price", "ext_wholesale_cost", "ext_list_price",
            "ext_tax", "ext_coupon_amt", "net_paid", "net_paid_inc_tax",
            "net_profit"]
    return _read(data_path, filename, cols, nrows), [NUM] * 17, ""


def load_tpcds_store(data_path, filename="store.csv", nrows=None):
    cols = ["store_sk", "number_employees", "floor_space", "market_id",
            "devision_id", "company_id", "tax_percentage"]
    return _read(data_path, filename, cols, nrows), [NUM] * 7, "store_sk"


def load_tpcds_item(data_path, filename="item.csv", nrows=None):
    cols = ["item_sk", "current_price", "wholesale_cost", "brand_id",
            "class_id", "category_id", "manufact_id"]
    return _read(data_path, filename, cols, nrows), [NUM] * 7, "item_sk"


def load_tpcds_customer(data_path, filename="customer.csv", nrows=None):
    cols = ["customer_sk", "birth_day", "birth_month", "birth_year"]
    return _read(data_path, filename, cols, nrows), [NUM] * 4, "customer_sk"


def load_tpcds_promotion(data_path, filename="promotion.csv", nrows=None):
    # 4 col_types for 4 names, as the original (which notes the
    # reference's 6 as a latent bug)
    cols = ["promo_sk", "item_sk", "cost", "response_target"]
    return _read(data_path, filename, cols, nrows), [NUM] * 4, "promo_sk"


def load_imdb_title(data_path, filename="title.csv", nrows=None):
    cols = ["movie_id", "kind_id", "product_year", "imdb_id"]
    return _read(data_path, filename, cols, nrows), [NUM] * 4, "movie_id"


def load_imdb_cast_info(data_path, filename="cast_info.csv", nrows=None):
    cols = ["person_id", "movie_id", "person_role_id"]
    return _read(data_path, filename, cols, nrows), [NUM] * 3, ""


def load_imdb_movie_info(data_path, filename="movie_info.csv", nrows=None):
    cols = ["movie_info_id", "movie_id", "info_type_id"]
    return _read(data_path, filename, cols, nrows), [NUM] * 3, "movie_info_id"


def load_imdb_movie_companies(data_path, filename="movie_companies.csv",
                              nrows=None):
    cols = ["movie_id", "company_id", "company_type_id"]
    return _read(data_path, filename, cols, nrows), [NUM] * 3, ""


def load_imdb_movie_info_idx(data_path, filename="movie_info_idx.csv",
                             nrows=None):
    cols = ["movie_info_idx_id", "movie_id", "info_type_id"]
    return _read(data_path, filename, cols, nrows), [NUM] * 3, \
        "movie_info_idx_id"


def load_imdb_movie_info_idx2(data_path, filename="movie_info_idx.csv",
                              nrows=None):
    """2-name read of movie_info_idx. As in the original, a THREE-column
    movie_info_idx.csv read with 2 names takes its column 0 as pandas'
    index: the two names label fields 1 and 2. The imdb_simple schema
    expects a 2-column file; use the full `imdb` schema for 3-column
    dumps."""
    cols = ["movie_info_idx_id", "movie_id"]
    return _read(data_path, filename, cols, nrows), [NUM] * 2, \
        "movie_info_idx_id"


def load_imdb_movie_keyword(data_path, filename="movie_keyword.csv",
                            nrows=None):
    cols = ["movie_id", "keyword_id"]
    return _read(data_path, filename, cols, nrows), [NUM] * 2, ""


def load_yelp_business_raw(data_path, filename="business.csv", nrows=None):
    cols = ["business_id", "latitude", "longitude", "business_stars",
            "business_review_count"]
    return _read(data_path, filename, cols, nrows), [NUM] * 5, "business_id"


def load_yelp_reviews_raw(data_path, filename="review.csv", nrows=None):
    cols = ["review_id", "user_id", "business_id", "review_stars",
            "review_useful", "review_funny", "review_cool"]
    return _read(data_path, filename, cols, nrows), [NUM] * 7, "review_id"


def load_yelp_users_raw(data_path, filename="user.csv", nrows=None):
    cols = ["user_id", "user_review_count", "user_useful", "user_funny",
            "user_cool", "fans", "average_stars", "compliment_hot",
            "compliment_more", "compliment_profile", "compliment_cute",
            "compliment_list", "compliment_note", "compliment_plain",
            "compliment_cool", "compliment_funny", "compliment_writer",
            "compliment_photos"]
    return _read(data_path, filename, cols, nrows), [NUM] * 18, "user_id"


LOADERS = {
    "forest": load_forest,
    "higgs": load_higgs,
    "sales": load_sales,
    "yelp-review": load_yelp_reviews,
    "yelp-user": load_yelp_users,
}

# schema_name -> (list of loader fns, table names); the table order is the
# feature layout
SCHEMAS = {
    "yelp": (
        [load_yelp_business_raw, load_yelp_reviews_raw, load_yelp_users_raw],
        ["business", "review", "user"],
    ),
    "tpcds": (
        [load_tpcds_store_sales, load_tpcds_store, load_tpcds_item,
         load_tpcds_customer, load_tpcds_promotion],
        ["store_sales", "store", "item", "customer", "promotion"],
    ),
    "tpch": (
        [load_tpch_lineitem, load_tpch_part, load_tpch_orders,
         load_tpch_supplier],
        ["lineitem", "part", "orders", "supplier"],
    ),
    "imdb_simple": (
        [load_imdb_title, load_imdb_cast_info, load_imdb_movie_info,
         load_imdb_movie_companies, load_imdb_movie_info_idx2,
         load_imdb_movie_keyword],
        ["title", "cast_info", "movie_info", "movie_companies",
         "movie_info_idx", "movie_keyword"],
    ),
    "imdb": (
        [load_imdb_title, load_imdb_cast_info, load_imdb_movie_info,
         load_imdb_movie_companies, load_imdb_movie_info_idx,
         load_imdb_movie_keyword],
        ["title", "cast_info", "movie_info", "movie_companies",
         "movie_info_idx", "movie_keyword"],
    ),
}


def load_table(relation: str, data_path: str, nrows: Optional[int] = None):
    if relation not in LOADERS:
        raise ValueError(f"Unsupported dataset {relation!r}; have "
                         f"{list(LOADERS)}")
    return LOADERS[relation](data_path, nrows=nrows)


def load_schema(schema_name: str, data_path: str,
                nrows: Optional[int] = None):
    """The schema's (tables, col_types_list, primary_keys, table_names),
    every table read by its loader."""
    if schema_name not in SCHEMAS:
        raise ValueError(f"Unsupported schema {schema_name!r}; have "
                         f"{list(SCHEMAS)}")
    loaders, table_names = SCHEMAS[schema_name]
    tables, col_types_list, pks = [], [], []
    for fn in loaders:
        table, col_types, pk = fn(data_path, nrows=nrows)
        tables.append(table)
        col_types_list.append(col_types)
        pks.append(pk)
    return tables, col_types_list, pks, list(table_names)
