"""Query-line grammars (host-side string parsing).

A copy of `nngp_tpu/featurize/parser.py`.
Its code differs only in its imports: the port imports nothing of the
JAX package. `tests/test_torch_featurize.py` holds the copy to the
original.

Grammar parity with the reference (these exact formats are the on-disk
workload interchange; the committed fixtures use them):

  single table   `col,upper,lower#col,c1,c2,...@card`
                 (`reference/QuerySampler.py:157-170`)
  binary join    `t1_preds@t2_preds@joins@card`, join `col,op#...`
                 (`reference/JoinQuerySampler.py:275-285`)
  multi join     `t1,t2,...@preds_1@...@preds_k@joins@card`,
                 join `t1_name,t2_name,col#...`
                 (`reference/JoinQuerySampler.py:624-644`)
  serving (no card) multi-join line without the trailing card
                 (`reference/neuroestimator/estimator/encoder.py:229-250`,
                  grammar documented at `neuroestimator/README.md:36-48`)

Parsing returns plain python structures; the vectorized encoders in
`nngp_tpu/featurize/encoder.py` turn batches of them into dense matrices.
"""

import collections
from typing import List, Tuple

from nngp_tpu_torch.featurize.stats import CATEGORICAL, TableStats

QueryInfo = collections.namedtuple(
    "QueryInfo",
    ["num_table", "num_joins", "num_predicates", "is_equal_join", "is_multi_key"],
)
JoinInfo = collections.namedtuple(
    "JoinInfo", ["t1_id", "t2_id", "col_name", "col_type"]
)

# A parsed predicate: (col_idx, upper, lower) for numerical,
# (col_idx, [codes]) for categorical — same tuples as the reference.
Predicate = tuple


def parse_predicates(pred_str: str, stats: TableStats) -> List[Predicate]:
    """`col,upper,lower#col,c1,c2,...` -> predicate list; empty string -> []."""
    pred_str = pred_str.strip()
    if not pred_str:
        return []
    preds = []
    for predicate in pred_str.split("#"):
        parts = predicate.split(",")
        name = parts[0].strip()
        col_idx = stats.col_idx(name)
        if stats.columns[col_idx].kind == CATEGORICAL:
            preds.append((col_idx, [int(p.strip()) for p in parts[1:]]))
        else:
            preds.append((col_idx, float(parts[1].strip()), float(parts[2].strip())))
    return preds


def parse_single_table_line(line: str, stats: TableStats) -> Tuple[List[Predicate], int]:
    """`preds@card` (`reference/QuerySampler.py:157-170`)."""
    body, card = line.split("@")
    return parse_predicates(body.strip(), stats), int(card.strip())


def load_single_table_queries(query_path: str, stats: TableStats):
    """Read every file in a query directory (sorted, as the reference does at
    `reference/QuerySampler.py:172-186`). Returns
    (all_pred_lists, all_cards, all_query_infos)."""
    import os

    all_queries, all_cards, all_infos = [], [], []
    for fname in sorted(os.listdir(query_path)):
        with open(os.path.join(query_path, fname)) as f:
            for line in f:
                if not line.strip():
                    continue
                preds, card = parse_single_table_line(line, stats)
                all_queries.append(preds)
                all_cards.append(card)
                all_infos.append(QueryInfo(
                    num_table=1, num_joins=0, num_predicates=len(preds),
                    is_equal_join=False, is_multi_key=False,
                ))
    return all_queries, all_cards, all_infos
