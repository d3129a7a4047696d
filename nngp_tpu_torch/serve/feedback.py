"""Aux-query feedback merge (offline half of the PostgreSQL loop).

A copy of `nngp_tpu/serve/feedback.py` (standard library only), carried in
this package because importing any `nngp_tpu.serve` module loads jax (the
package's `__init__` imports the JAX Estimator).

Parity surface of the reference's `neuroestimator/merge_subquery_card.py`:
joins the PostgreSQL-side `card.csv` (semicolon rows
`query;nngp_card;nngp_std;pg_card;mix_card;true_card`, header skipped, rows
with nngp_card <= 0 dropped, `:8-26`) with the sub-query text file, computes
per-query q_error = max(pred/true, true/pred) and
coef_var = nngp_std / log2(nngp_card) (`:56-58`), and emits
`join_query_aux.txt` lines `query@true_card@q_error@coef_var` consumed by
`MultiJoinEncoder.load_queries(use_aux=True)`.
"""

import collections
import math
from typing import List, Optional

PredInfo = collections.namedtuple(
    "PredInfo", ["query_str", "nngp_card", "nngp_std", "pg_card", "true_card"]
)


def load_card_csv(card_csv_path: str) -> List[PredInfo]:
    out = []
    with open(card_csv_path) as f:
        next(f)  # header
        for row in f:
            parts = row.split(";")
            nngp_card = float(parts[1])
            if nngp_card <= 0:
                continue
            out.append(PredInfo(
                query_str=parts[0], nngp_card=nngp_card,
                nngp_std=float(parts[2]), pg_card=float(parts[3]),
                true_card=float(parts[5])))
    return out


def load_subquery_lines(subquery_file: str) -> List[str]:
    with open(subquery_file) as f:
        return f.readlines()


def merge_query_res(all_pred_info: List[PredInfo], all_rows: List[str],
                    out_path: Optional[str] = None) -> List[str]:
    """Returns the aux lines; writes them to out_path if given."""
    n = min(len(all_pred_info), len(all_rows))
    all_pred_info, all_rows = all_pred_info[:n], all_rows[:n]
    lines = []
    for idx, (row, info) in enumerate(zip(all_rows, all_pred_info), start=1):
        if row.startswith("#"):
            continue
        parts = row.split("@")
        true_card = int(float(parts[-1]))
        csv_true_card = int(float(info.true_card))
        if not (true_card == csv_true_card or csv_true_card <= 0):
            raise ValueError(
                f"Inconsistent true card at line {idx}: "
                f"{true_card} vs {csv_true_card}")
        # Guards the reference lacks (`merge_subquery_card.py:57-58`
        # crashes): log2(nngp_card)=0 when the model predicts card 1, and
        # PG-side true cards can be 0 — treat both ratios as infinitely
        # uncertain/wrong (kept by any threshold) instead of aborting the
        # whole feedback build.
        log_card = math.log(info.nngp_card, 2.0)
        coef_var = info.nngp_std / log_card if log_card > 0 else math.inf
        q_error = (max(info.nngp_card / true_card, true_card / info.nngp_card)
                   if true_card > 0 else math.inf)
        merged = parts[:-1] + [str(int(true_card)), str(q_error), str(coef_var)]
        lines.append("@".join(merged))
    if out_path:
        with open(out_path, "w") as f:
            for line in lines:
                f.write(line + "\n")
    return lines


def build_aux_file(card_csv_path: str, subquery_file: str, out_path: str):
    return merge_query_res(load_card_csv(card_csv_path),
                           load_subquery_lines(subquery_file), out_path)
