from nngp_tpu_torch.featurize.stats import Address, ColumnStats, TableStats
from nngp_tpu_torch.featurize.parser import QueryInfo, parse_single_table_line
from nngp_tpu_torch.featurize.encoder import SingleTableEncoder

__all__ = [
    "Address",
    "ColumnStats",
    "TableStats",
    "QueryInfo",
    "parse_single_table_line",
    "SingleTableEncoder",
]
