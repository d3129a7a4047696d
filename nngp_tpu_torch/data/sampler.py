"""Offline labeled-query generation (ground-truth COUNT(*) labeling).

A copy of `nngp_tpu/data/sampler.py` on the port's pandas-free `Table`
(`nngp_tpu_torch.data.table`). Every random draw, dedup and frontier pop
happens in the original's order, so the same tables and seed give the same
query lines, byte for byte (`tests/test_torch_sampler.py`). The pandas
calls of the original are rebuilt on numpy:
  - the tree count's per-key messages (`groupby(dropna=False).sum()` +
    `reindex`) are `np.unique` + `np.bincount` + `searchsorted`, with NaN
    one more key value that matches itself, as pandas groups it;
  - the merge path for edge sets that are not a tree joins row-index
    arrays on keys factorized together (NaN again matching NaN, as
    `pd.merge` does); a cycle-closing edge filters with `==`.

The labeler runs on the host. This module imports no torch, so the one OS
process per arity that `parallel_sample` / `parallel_sampler` fork never
touch a CUDA context their parent may hold.

Parity surfaces:
  SingleTableSampler <-> GeneralQuerySampler sampling half
      (`reference/QuerySampler.py:59-138`): data-centric or uniform
      range predicates, IN-set categorical predicates, dedup, card >= 1,
      `pred@card` lines, one OS process per predicate arity.
  BinaryJoinSampler  <-> BinaryJoinQuerySampler (`JoinQuerySampler.py:
      185-367`): join ops {<,>,=,<=,>=,<>} numerical / {=,<>} categorical.
  MultiJoinSampler   <-> MultiJoinQuerySampler (`JoinQuerySampler.py:
      370-602`): acyclic join trees by frontier expansion, per-table
      predicates avoiding join keys, `tables@preds...@joins@card` lines.
A ClickHouse path equivalent to `query_true_card_by_clickhouse`
(`JoinQuerySampler.py:505-565`) is provided behind an optional import.
"""

import os
import random
from multiprocessing import Process
from typing import Dict, Optional, Sequence

import numpy as np

from nngp_tpu_torch.data.table import Table
from nngp_tpu_torch.featurize.join import (      # one join-op vocabulary
    CATEGORICAL_JOIN_OPS,
    NUMERICAL_JOIN_OPS,
)
from nngp_tpu_torch.featurize.stats import CATEGORICAL, TableStats


def _mask_for_predicates(df: Table, stats: TableStats, pred_list) -> np.ndarray:
    mask = np.ones(len(df), dtype=bool)
    for pred in pred_list:
        col = stats.columns[pred[0]]
        vals = df[col.name]
        if col.kind == CATEGORICAL:
            mask &= np.isin(vals, np.asarray(pred[1]))
        else:
            mask &= (vals <= pred[1]) & (vals >= pred[2])
    return mask


def true_card_single(df: Table, stats: TableStats, pred_list) -> int:
    """COUNT(*) under conjunctive predicates (replaces `df.query`,
    `reference/QuerySampler.py:111-112`)."""
    return int(_mask_for_predicates(df, stats, pred_list).sum())


def _count_pairs_op(a: np.ndarray, b: np.ndarray, op: str) -> int:
    """Count pairs (x in a, y in b) with x OP y in O(n log n)."""
    b_sorted = np.sort(b)
    n = len(b_sorted)
    if op == "<":
        return int((n - np.searchsorted(b_sorted, a, side="right")).sum())
    if op == "<=":
        return int((n - np.searchsorted(b_sorted, a, side="left")).sum())
    if op == ">":
        return int(np.searchsorted(b_sorted, a, side="left").sum())
    if op == ">=":
        return int(np.searchsorted(b_sorted, a, side="right").sum())
    if op == "=":
        lo = np.searchsorted(b_sorted, a, side="left")
        hi = np.searchsorted(b_sorted, a, side="right")
        return int((hi - lo).sum())
    if op == "<>":
        lo = np.searchsorted(b_sorted, a, side="left")
        hi = np.searchsorted(b_sorted, a, side="right")
        return int((n - (hi - lo)).sum())
    raise ValueError(f"unsupported join op {op!r}")


def _message(vals: np.ndarray, weights: np.ndarray,
             pvals: np.ndarray) -> np.ndarray:
    """The per-row factor a parent's keys `pvals` receive from a child
    whose rows carry keys `vals` and `weights`: the weight sum of the
    child rows with an equal key (NaN equal to NaN), 0 where none."""
    keys, inv = np.unique(vals, return_inverse=True)   # NaNs: one last key
    if not len(keys):
        return np.zeros(len(pvals))
    sums = np.bincount(inv.ravel(), weights=weights, minlength=len(keys))
    pos = np.minimum(np.searchsorted(keys, pvals), len(keys) - 1)
    hit = keys[pos]
    match = (hit == pvals) | (np.isnan(hit) & np.isnan(pvals))
    return np.where(match, sums[pos], 0.0)


def tree_join_count(filtered: Dict[int, Table], join_infos) -> Optional[int]:
    """Exact COUNT(*) of an acyclic equi-join WITHOUT materializing it.

    Upward message passing on the join tree (the counting semiring):
    each table's rows carry integer weights (initially 1); a child sends
    its parent the per-key sum of its row weights on the shared column,
    and the parent multiplies each of its rows by the message at that
    row's key. The root's weight sum is the join cardinality. Cost is
    O(sum_t n_t log n_t), where successive merges
    (`reference/JoinQuerySampler.py:484-503`) cost O(join output size),
    which explodes under Zipf-skewed FK<->FK joins.

    Returns None when the edge set is not a spanning tree of the filtered
    tables (cycle-closing edge or disconnected): callers fall back to the
    merge path. Exactness guard: weights are accumulated in float64; a
    result below 2^53 is exact (a contributing intermediate can only be
    smaller than the final count), and larger results are recomputed with
    arbitrary-precision Python ints.
    """
    # union-find tree check + adjacency
    uf = {t: t for t in filtered}

    def find(x):
        while uf[x] != x:
            uf[x] = uf[uf[x]]
            x = uf[x]
        return x

    adj: Dict[int, list] = {t: [] for t in filtered}
    for ji in join_infos:
        ra, rb = find(ji.t1_id), find(ji.t2_id)
        if ra == rb:
            return None  # cycle edge: equality filter needs the merge path
        uf[ra] = rb
        adj[ji.t1_id].append((ji.t2_id, ji.col_name))
        adj[ji.t2_id].append((ji.t1_id, ji.col_name))
    if len({find(t) for t in filtered}) != 1:
        return None  # disconnected: let the merge path raise

    # parent pointers + children-before-parents order (iterative DFS)
    root = next(iter(filtered))
    order, stack, seen = [], [root], {root}
    parent_edge: Dict[int, tuple] = {}
    while stack:
        t = stack.pop()
        order.append(t)
        for nb, col in adj[t]:
            if nb not in seen:
                seen.add(nb)
                parent_edge[nb] = (t, col)
                stack.append(nb)

    def _pass(as_object: bool):
        weights = {
            t: np.ones(len(df), dtype=object if as_object else np.float64)
            for t, df in filtered.items()
        }
        for t in reversed(order):
            if t == root:
                continue
            par, col = parent_edge[t]
            # one key dtype on both sides: int64/float64 mixes (fillna
            # turns NaN-bearing int columns into floats) must still match
            # on equal values, exactly as pd.merge does
            vals = np.asarray(filtered[t][col]).astype(np.float64)
            pvals = np.asarray(filtered[par][col]).astype(np.float64)
            # pd.merge MATCHES NaN keys with NaN keys, so NaN must behave
            # as one more key value on both sides
            if as_object:
                acc: Dict = {}
                for v, w in zip(vals.tolist(), weights[t].tolist()):
                    if v != v:
                        v = "__nan__"  # self-matching NaN sentinel
                    acc[v] = acc.get(v, 0) + w
                mult = np.array(
                    [acc.get(v if v == v else "__nan__", 0)
                     for v in pvals.tolist()], dtype=object)
            else:
                mult = _message(vals, weights[t], pvals)
            weights[par] = weights[par] * mult
        return weights[root].sum()

    total = float(_pass(as_object=False))
    if total < float(2 ** 53):
        return int(round(total))
    return int(_pass(as_object=True))


def _key_codes(left: Sequence[np.ndarray], right: Sequence[np.ndarray]):
    """One int code per distinct key tuple over both sides, NaN a key
    value equal to itself (`pd.merge`'s matching), as (left, right)."""
    n_left = len(left[0])
    per_col = []
    for a, b in zip(left, right):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in "biuf" and b.dtype.kind in "biuf":
            both = np.concatenate([a.astype(np.float64),
                                   b.astype(np.float64)])
            per_col.append(np.unique(both, return_inverse=True)[1].ravel())
        else:
            index: Dict = {}
            per_col.append(np.array(
                [index.setdefault("__nan__" if v != v else v, len(index))
                 for v in np.concatenate([a.astype(object),
                                          b.astype(object)]).tolist()],
                np.int64))
    codes = (per_col[0] if len(per_col) == 1 else
             np.unique(np.stack(per_col, axis=1), axis=0,
                       return_inverse=True)[1].ravel())
    return codes[:n_left], codes[n_left:]


def _join_pairs(left: Sequence[np.ndarray], right: Sequence[np.ndarray]):
    """Row pairs (i, j) of an inner equi-join of `left` and `right` key
    columns: the rows `pd.merge(how='inner')` would pair."""
    lc, rc = _key_codes(left, right)
    order = np.argsort(rc, kind="stable")
    rs = rc[order]
    lo = np.searchsorted(rs, lc, side="left")
    counts = np.searchsorted(rs, lc, side="right") - lo
    li = np.repeat(np.arange(len(lc)), counts)
    offsets = np.arange(len(li)) - np.repeat(np.cumsum(counts) - counts,
                                             counts)
    return li, order[np.repeat(lo, counts) + offsets]


def _merge_count(raw: Dict[int, Table], join_infos) -> int:
    """COUNT(*) by successive inner joins in connectivity order, over row
    indices: the original's merge path for edge sets that are not a tree."""
    remaining = list(join_infos)
    acc: Optional[Dict[int, np.ndarray]] = None   # table -> joined rows
    while remaining:
        progressed = False
        for ji in list(remaining):
            t1, t2, col = ji.t1_id, ji.t2_id, ji.col_name
            if acc is None:
                i, j = _join_pairs([raw[t1][col]], [raw[t2][col]])
                acc = {t1: i, t2: j}
            elif t1 in acc and t2 in acc:
                keep = raw[t1][col][acc[t1]] == raw[t2][col][acc[t2]]
                acc = {t: rows[keep] for t, rows in acc.items()}
            elif t1 in acc or t2 in acc:
                new = t2 if t1 in acc else t1
                old = t1 if t1 in acc else t2
                i, j = _join_pairs([raw[old][col][acc[old]]],
                                   [raw[new][col]])
                acc = {t: rows[i] for t, rows in acc.items()}
                acc[new] = j
            else:
                continue
            remaining.remove(ji)
            progressed = True
            if len(next(iter(acc.values()))) == 0:
                return 0
        if not progressed:
            raise ValueError("disconnected join graph in query")
    return len(next(iter(acc.values())))


class SingleTableSampler:
    """Samples labeled range/IN queries over one table."""

    def __init__(self, df: Table, stats: TableStats, seed: int = 1):
        self.df = df.fillna(-1)
        self.stats = stats
        self.rng = random.Random(seed)
        self._sorted_cols = {
            c.name: np.sort(self.df[c.name]) for c in stats.columns
        }

    def sample_numeric_col_predicate(self, col_idx, data_centric=False):
        col = self.stats.columns[col_idx]
        vals = self._sorted_cols[col.name]
        if data_centric:
            v1 = vals[self.rng.randrange(0, len(vals))]
            v2 = vals[self.rng.randrange(0, len(vals))]
        else:
            v1 = self.rng.uniform(col.min, col.max)
            v2 = self.rng.uniform(col.min, col.max)
        upper, lower = (v1, v2) if v1 >= v2 else (v2, v1)
        return col.name, upper, lower

    def sample_categorical_col_predicate(self, col_idx, data_centric=False,
                                         cat_size=1):
        col = self.stats.columns[col_idx]
        cat_size = min(cat_size, col.num_cat)
        if data_centric:
            vals = self.df[col.name]
            picks = [vals[i] for i in
                     self.rng.sample(range(len(vals)), cat_size)]
            picks = list(dict.fromkeys(picks))
        else:
            picks = self.rng.sample(list(col.categories), cat_size)
        codes = [col.code_of(c) for c in picks]
        return col.name, codes

    def sample_query(self, d, data_centric=False, cat_size=1,
                     col_pool: Optional[Sequence[int]] = None):
        """Returns (pred_list, pred_str)."""
        pool = list(col_pool) if col_pool is not None else list(range(self.stats.num_cols))
        assert 0 < d <= len(pool), "Error attribute number to sample!"
        col_indices = sorted(self.rng.sample(pool, k=d))
        pred_list, pred_str = [], []
        for ci in col_indices:
            if self.stats.columns[ci].kind == CATEGORICAL:
                name, codes = self.sample_categorical_col_predicate(
                    ci, data_centric, cat_size)
                pred_list.append((ci, codes))
                pred_str.append(",".join([name] + [str(c) for c in codes]))
            else:
                name, upper, lower = self.sample_numeric_col_predicate(
                    ci, data_centric)
                pred_list.append((ci, upper, lower))
                pred_str.append(",".join([name, str(upper), str(lower)]))
        return pred_list, "#".join(pred_str)

    def sample_batch_query(self, d, mini_batch, cat_size=10, save_path=None,
                           data_centric=False):
        """`pred@card` lines; dedup; card >= 1
        (`reference/QuerySampler.py:114-133`)."""
        lines, seen = [], set()
        while len(lines) < mini_batch:
            pred_list, pred_str = self.sample_query(d, data_centric, cat_size)
            if pred_str in seen:
                continue
            seen.add(pred_str)
            card = true_card_single(self.df, self.stats, pred_list)
            if card < 1:
                continue
            lines.append(f"{pred_str}@{card}")
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            with open(os.path.join(save_path, f"query_{d}.txt"), "a") as f:
                f.write("\n".join(lines) + "\n")
        return lines

    def parallel_sample(self, mini_batch, cat_size=50, save_path="./queryset",
                        data_centric=False):
        """One OS process per arity (`QuerySampler.py:135-138`)."""
        procs = []
        for d in range(1, self.stats.num_cols + 1):
            p = Process(target=self.sample_batch_query,
                        args=(d, mini_batch, cat_size, save_path, data_centric))
            p.start()
            procs.append(p)
        return procs


class MultiJoinSampler:
    """Acyclic multi-way equi-join query sampling + native ground truth."""

    def __init__(self, dfs: Sequence[Table], stats: Sequence[TableStats],
                 seed: int = 1):
        from nngp_tpu_torch.featurize.join import MultiJoinEncoder
        self.dfs = [df.fillna(-1) for df in dfs]
        self.stats = list(stats)
        self.encoder = MultiJoinEncoder(stats)
        self.rng = random.Random(seed)
        # distinct per-table streams: identical seeds would make every
        # table draw the same predicate positions/quantiles in lockstep
        self.samplers = [SingleTableSampler(df, st, seed=seed + t_id)
                         for t_id, (df, st) in enumerate(
                             zip(self.dfs, self.stats))]
        self.num_tables = len(stats)

    def sample_tables_and_joins(self, num_tables):
        """Frontier expansion over the join graph
        (`reference/JoinQuerySampler.py:419-443`)."""
        enc = self.encoder
        table_ids, join_infos = [], []
        start = self.rng.choice(range(self.num_tables))
        table_ids.append(start)
        frontier = set()
        for nb in enc.join_adj[start]:
            frontier.add((start, nb) if start < nb else (nb, start))
        while len(table_ids) < num_tables and frontier:
            t1, t2 = frontier.pop()
            if t1 in table_ids and t2 in table_ids:
                continue
            cur = t1 if t2 in table_ids else t2
            table_ids.append(cur)
            join_infos.append(
                self.rng.choice(enc.table_pair_to_join_infos[(t1, t2)]))
            for nxt in enc.join_adj[cur]:
                if nxt in table_ids:
                    continue
                frontier.add((cur, nxt) if cur < nxt else (nxt, cur))
        return sorted(table_ids), join_infos

    def sample_join_query(self, num_tables, data_centric=False, cat_size=10):
        enc = self.encoder
        if num_tables == 1:
            table_ids, join_infos = [self.rng.choice(range(self.num_tables))], []
        else:
            table_ids, join_infos = self.sample_tables_and_joins(num_tables)
        join_cols = {ji.col_name for ji in join_infos}
        all_pred_list, pred_str_list = [], []
        for t_id in table_ids:
            st = self.stats[t_id]
            # avoid predicates on any join-key column (`:473-475`)
            pool = [i for i, c in enumerate(st.columns)
                    if c.name not in join_cols
                    and c.name not in enc.all_join_col_names]
            d = self.rng.choice(range(len(pool) + 1))
            if d == 0:
                all_pred_list.append([])
                pred_str_list.append("")
                continue
            pred_list, pred_str = self.samplers[t_id].sample_query(
                d, data_centric, cat_size, col_pool=pool)
            all_pred_list.append(pred_list)
            pred_str_list.append(pred_str)
        join_str = "#".join(
            ",".join([enc.tid_to_table_name[ji.t1_id],
                      enc.tid_to_table_name[ji.t2_id], ji.col_name])
            for ji in join_infos)
        return table_ids, all_pred_list, join_infos, pred_str_list, join_str

    def query_true_card(self, table_ids, all_pred_list, join_infos) -> int:
        """COUNT(*) of the equi-join (replaces sqldf at
        `reference/JoinQuerySampler.py:484-503`)."""
        # only the join keys of the surviving rows are read below
        keys = {ji.col_name for ji in join_infos}
        raw: Dict[int, Table] = {}
        card = 1
        for t_id, preds in zip(table_ids, all_pred_list):
            df = self.dfs[t_id]
            mask = _mask_for_predicates(df, self.stats[t_id], preds)
            if not mask.any():
                return 0  # early stop (`:494-496`)
            card *= int(mask.sum())
            raw[t_id] = Table({c: df[c][mask] for c in df.columns
                               if c in keys})
        if not join_infos:
            return card
        # tree-shaped edge sets (everything the frontier sampler emits)
        # count by message passing, never materializing the join
        count = tree_join_count(raw, join_infos)
        if count is not None:
            return count
        return _merge_count(raw, join_infos)

    def sample_batch_query(self, save_path, num_tables, mini_batch,
                           data_centric=False, cat_size=10):
        """`tables@preds...@joins@card` lines
        (`reference/JoinQuerySampler.py:567-594`)."""
        enc = self.encoder
        os.makedirs(save_path, exist_ok=True)
        lines, seen = [], set()
        while len(lines) < mini_batch:
            (table_ids, all_pred_list, join_infos,
             pred_str_list, join_str) = self.sample_join_query(
                num_tables, data_centric, cat_size)
            names = ",".join(enc.tid_to_table_name[t] for t in table_ids)
            query_str = names + "@" + "@".join(pred_str_list) + "@" + join_str
            if query_str in seen:
                continue
            seen.add(query_str)
            card = self.query_true_card(table_ids, all_pred_list, join_infos)
            if card < 1:
                continue
            lines.append(f"{query_str}@{card}")
        with open(os.path.join(save_path,
                               f"join_query_{num_tables}.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
        return lines

    def parallel_sampler(self, mini_batch, save_path="./queryset",
                         data_centric=False, cat_size=10):
        procs = []
        for num_tables in range(1, self.num_tables + 1):
            p = Process(target=self.sample_batch_query,
                        args=(save_path, num_tables, mini_batch,
                              data_centric, cat_size))
            p.start()
            procs.append(p)
        return procs


class BinaryJoinSampler:
    """Two-table join sampling with the full op set
    (`reference/JoinQuerySampler.py:185-367`)."""

    def __init__(self, df1: Table, stats1: TableStats, df2: Table,
                 stats2: TableStats, seed: int = 1):
        from nngp_tpu_torch.featurize.join import BinaryJoinEncoder
        self.df1, self.df2 = df1.fillna(-1), df2.fillna(-1)
        self.stats1, self.stats2 = stats1, stats2
        self.encoder = BinaryJoinEncoder(stats1, stats2)
        self.rng = random.Random(seed)
        self.s1 = SingleTableSampler(self.df1, stats1, seed=seed)
        self.s2 = SingleTableSampler(self.df2, stats2, seed=seed + 1)

    def sample_join_query(self, num_joins, data_centric=False, cat_size=10):
        enc = self.encoder
        assert 1 <= num_joins <= enc.total_num_joins, "Error number of joins!"
        idxs = self.rng.sample(range(enc.total_num_joins), k=num_joins)
        join_conditions = []
        for i in idxs:
            ops = (CATEGORICAL_JOIN_OPS if enc.join_col_types[i] == CATEGORICAL
                   else NUMERICAL_JOIN_OPS)
            join_conditions.append((enc.join_col_names[i], self.rng.choice(ops)))
        join_cols = {c for c, _ in join_conditions}

        def table_preds(sampler, stats):
            pool = [i for i, c in enumerate(stats.columns)
                    if c.name not in join_cols]
            d = self.rng.choice(range(len(pool) + 1))
            if d == 0:
                return [], ""
            return sampler.sample_query(d, data_centric, cat_size, col_pool=pool)

        t1_preds, t1_str = table_preds(self.s1, self.stats1)
        t2_preds, t2_str = table_preds(self.s2, self.stats2)
        join_str = "#".join(",".join(jc) for jc in join_conditions)
        return t1_preds, t2_preds, join_conditions, t1_str, t2_str, join_str

    def query_true_card(self, t1_preds, t2_preds, join_conditions) -> int:
        m1 = _mask_for_predicates(self.df1, self.stats1, t1_preds)
        m2 = _mask_for_predicates(self.df2, self.stats2, t2_preds)
        d1, d2 = self.df1.take(m1), self.df2.take(m2)
        if len(d1) == 0 or len(d2) == 0:
            return 0
        if len(join_conditions) == 1:
            col, op = join_conditions[0]
            return _count_pairs_op(d1[col], d2[col], op)
        # multiple conditions: join on the '=' subset, verify the rest
        eq_cols = [c for c, op in join_conditions if op == "="]
        rest = [(c, op) for c, op in join_conditions if op != "="]
        if eq_cols:
            li, rj = _join_pairs([d1[c] for c in eq_cols],
                                 [d2[c] for c in eq_cols])
            mask = np.ones(len(li), dtype=bool)
            for c, op in rest:
                mask &= _compare(d1[c][li], d2[c][rj], op)
            return int(mask.sum())
        # no equality: blocked outer-product evaluation
        total = 0
        av = {c: d1[c] for c, _ in rest}
        bv = {c: d2[c] for c, _ in rest}
        n1 = len(d1)
        block = max(1, 10_000_000 // max(len(d2), 1))
        for s in range(0, n1, block):
            mask = None
            for c, op in rest:
                m = _compare(av[c][s:s + block, None], bv[c][None, :], op)
                mask = m if mask is None else (mask & m)
            total += int(mask.sum())
        return total

    def sample_batch_query(self, num_joins, mini_batch, cat_size=10,
                           save_path="./queryset", data_centric=True):
        os.makedirs(save_path, exist_ok=True)
        lines, seen = [], set()
        while len(lines) < mini_batch:
            (t1_preds, t2_preds, join_conditions,
             t1_str, t2_str, join_str) = self.sample_join_query(
                num_joins, data_centric, cat_size)
            query_str = f"{t1_str}@{t2_str}@{join_str}"
            if query_str in seen:
                continue
            seen.add(query_str)
            card = self.query_true_card(t1_preds, t2_preds, join_conditions)
            if card < 1:
                continue
            lines.append(f"{query_str}@{card}")
        with open(os.path.join(save_path,
                               f"join_query_{num_joins}.txt"), "a") as f:
            f.write("\n".join(lines) + "\n")
        return lines


def _compare(a, b, op):
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "=":
        return a == b
    if op == "<>":
        return a != b
    raise ValueError(f"unsupported op {op!r}")


def query_true_card_by_clickhouse(query_str: str, host="localhost",
                                  port="9000", database="imdb") -> int:
    """ClickHouse ground truth (`reference/JoinQuerySampler.py:505-565`).
    Optional: requires the clickhouse_driver package and a running server."""
    try:
        import clickhouse_driver
    except ImportError as e:
        raise RuntimeError(
            "clickhouse_driver is not installed in this environment") from e
    parts = query_str.split("@")
    table_names = parts[0].split(",")
    preds_list = [p.split("#") for p in parts[1:-1]]
    join_conditions = [j.split(",") for j in parts[-1].split("#")]
    conds = []
    for tname, preds in zip(table_names, preds_list):
        for pred in preds:
            f = pred.split(",")
            if len(f) != 3:
                continue
            conds.append(f"{tname}.{f[0]} <= {f[1]}")
            conds.append(f"{tname}.{f[0]} >= {f[2]}")
    for jc in join_conditions:
        if len(jc) != 3:
            continue
        conds.append(f"{jc[0]}.{jc[2]}={jc[1]}.{jc[2]}")
    sql = "SELECT COUNT(*) FROM " + ",".join(table_names)
    if conds:
        sql += " WHERE " + " AND ".join(conds)
    client = clickhouse_driver.Client(host=host, port=port, database=database)
    return client.execute(sql)[0][0]
