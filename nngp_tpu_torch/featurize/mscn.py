"""One-hot set encodings for MSCN / TreeLSTM baselines. Copy of
`nngp_tpu/featurize/mscn.py` (numpy only), importing the port's own
`featurize.stats` and `featurize.join`;
`tests/test_torch_baseline_trainers.py` holds it to the original bit for
bit.

  MSCNSingleEncoder: per query a set of 2*num_preds rows
      [col one-hot | op one-hot(<=, >=) | scaled value].
  MSCNJoinEncoder: per-table rows in a shared column space
      (t1 cols | t2 cols | 3 op slots); join rows
      [join-col one-hot | op one-hot over 6 ops].
  MSCNMultiEncoder: table one-hot rows, pred rows in the global column
      space, equi-join rows over the (t1,t2,col) triple vocabulary + 6 op
      slots; TreeLSTM plan chains via a BFS join order and `PlanNode`.

Set batches are zero-padded to the max set size; masks are also returned
for the corrected mean (the MSCN models pool over the padding by default).
"""

import random
from typing import List, Optional, Sequence

import numpy as np

from nngp_tpu_torch.featurize.stats import NUMERICAL, TableStats

JOIN_OPS = ["<", ">", "=", "<=", ">=", "<>"]


def one_hot_predicate_encoding(stats: TableStats, pred_list):
    """(cols_x, ops_x): 2 rows per range predicate (upper row op slot 0,
    lower row op slot 1, value in slot 2) — numerical only
    (`reference/JoinQuerySampler.py:157-177`)."""
    n = len(pred_list)
    cols_x = np.zeros((2 * n, stats.num_cols))
    ops_x = np.zeros((2 * n, 3))
    for i, pred in enumerate(pred_list):
        col_idx = pred[0]
        col = stats.columns[col_idx]
        if col.kind != NUMERICAL:
            raise NotImplementedError(
                "one-hot predicate encoding supports numerical columns only "
                "(reference parity: JoinQuerySampler.py:175-176)")
        upper = (pred[1] - col.min) / col.denominator * 1000
        lower = (pred[2] - col.min) / col.denominator * 1000
        cols_x[2 * i, col_idx] = 1
        ops_x[2 * i, 0] = 1
        ops_x[2 * i, 2] = upper
        cols_x[2 * i + 1, col_idx] = 1
        ops_x[2 * i + 1, 1] = 1
        ops_x[2 * i + 1, 2] = lower
    return cols_x, ops_x


def pad_sets(sets: Sequence[np.ndarray], min_rows: int = 1, feat=None):
    """Zero-pad a list of (rows_i, feat) arrays -> (batch, max_rows, feat)
    plus a boolean mask (batch, max_rows). Pass `feat` explicitly when the
    whole batch can be empty sets (e.g. join-less queries) — inferring it
    would collapse the feature dimension to 1."""
    if feat is None:
        feat = max((s.shape[1] for s in sets if s.size), default=1)
    max_rows = max(max((s.shape[0] for s in sets), default=0), min_rows)
    out = np.zeros((len(sets), max_rows, feat))
    mask = np.zeros((len(sets), max_rows), dtype=bool)
    for i, s in enumerate(sets):
        if s.size:
            out[i, :s.shape[0], :] = s
            mask[i, :s.shape[0]] = True
    return out, mask


class MSCNSingleEncoder:
    def __init__(self, stats: TableStats):
        self.stats = stats

    def encode_query(self, pred_list) -> np.ndarray:
        cols_x, ops_x = one_hot_predicate_encoding(self.stats, pred_list)
        return np.hstack([cols_x, ops_x])

    def encode_batch(self, pred_lists):
        return pad_sets([self.encode_query(p) for p in pred_lists])


class MSCNJoinEncoder:
    def __init__(self, table1: TableStats, table2: TableStats):
        from nngp_tpu_torch.featurize.join import detect_join_columns
        self.table1, self.table2 = table1, table2
        joinable = detect_join_columns(table1, table2)
        self.join_col_names = [n for n, _ in joinable]
        self.total_num_joins = len(self.join_col_names)
        self.join_feat_dim = self.total_num_joins + len(JOIN_OPS)

    def one_hot_join_encoding(self, join_conditions) -> np.ndarray:
        join_x = np.zeros((len(join_conditions), self.join_feat_dim))
        for i, (col_name, op) in enumerate(join_conditions):
            join_x[i, self.join_col_names.index(col_name)] = 1
            join_x[i, self.total_num_joins + JOIN_OPS.index(op)] = 1
        return join_x

    def encode_query(self, t1_pred_list, t2_pred_list, join_conditions):
        t1_cols_x, t1_ops_x = one_hot_predicate_encoding(self.table1, t1_pred_list)
        t2_cols_x, t2_ops_x = one_hot_predicate_encoding(self.table2, t2_pred_list)
        n1, n2 = self.table1.num_cols, self.table2.num_cols
        t1_pred_x = np.hstack([t1_cols_x, np.zeros((t1_cols_x.shape[0], n2)), t1_ops_x])
        t2_pred_x = np.hstack([np.zeros((t2_cols_x.shape[0], n1)), t2_cols_x, t2_ops_x])
        join_x = self.one_hot_join_encoding(join_conditions)
        return t1_pred_x, t2_pred_x, join_x

    def encode_batch(self, queries):
        trip = [self.encode_query(*q) for q in queries]
        left, lm = pad_sets([t[0] for t in trip])
        right, rm = pad_sets([t[1] for t in trip])
        # explicit feat: a batch of join-less queries must keep the join
        # feature width instead of collapsing it to 1
        join, jm = pad_sets([t[2] for t in trip], feat=self.join_feat_dim)
        return (left, lm), (right, rm), (join, jm)


class PlanNode:
    """TreeLSTM plan node (TreeNode, `reference/baselines/encoder.py:
    398-407`)."""

    def __init__(self, pred_features, op_features, meta_features, level):
        self.pred_features = pred_features   # (num_pred, pred_feat)
        self.op_features = op_features       # (2 + total_num_joins,)
        self.meta_features = meta_features   # (num_tables,)
        self.level = level
        self.children: List["PlanNode"] = []

    def add_child(self, child):
        self.children.append(child)


class MSCNMultiEncoder:
    def __init__(self, tables: Sequence[TableStats], seed: Optional[int] = None):
        from nngp_tpu_torch.featurize.join import MultiJoinEncoder
        self._mj = MultiJoinEncoder(tables)   # reuse join-triple vocabulary
        self.tables = list(tables)
        self.num_tables = len(tables)
        self.all_join_triples = self._mj.all_join_triples
        self.total_num_joins = len(self.all_join_triples)
        self.join_feat_dim = self.total_num_joins + len(JOIN_OPS)
        self.pred_feat_dim = sum(t.num_cols for t in tables)
        self._pred_offsets = np.cumsum([0] + [t.num_cols for t in tables])
        self._rng = random.Random(seed)

    # parsing is shared with the dense multi-join encoder
    def parse_line(self, line):
        return self._mj.parse_line(line)

    def load_queries(self, query_path):
        return self._mj.load_queries(query_path)

    def one_hot_join_encoding(self, join_infos):
        join_x = np.zeros((len(join_infos), self.join_feat_dim))
        for i, ji in enumerate(join_infos):
            triple = ((ji.t1_id, ji.t2_id, ji.col_name) if ji.t1_id < ji.t2_id
                      else (ji.t2_id, ji.t1_id, ji.col_name))
            join_x[i, self.all_join_triples.index(triple)] = 1
            join_x[i, self.total_num_joins + JOIN_OPS.index("=")] = 1
        return join_x

    def one_hot_table_encoding(self, table_ids):
        table_x = np.zeros((len(table_ids), self.num_tables))
        for i, t in enumerate(table_ids):
            table_x[i, t] = 1
        return table_x

    def one_table_pred_encoding(self, t_id, pred_list):
        if not pred_list:
            return np.zeros((1, self.pred_feat_dim + 3))
        cols_x, ops_x = one_hot_predicate_encoding(self.tables[t_id], pred_list)
        start = self._pred_offsets[t_id]
        end = self._pred_offsets[t_id + 1]
        return np.hstack([
            np.zeros((cols_x.shape[0], start)), cols_x,
            np.zeros((cols_x.shape[0], self.pred_feat_dim - end)), ops_x,
        ])

    def encode_query(self, table_ids, all_pred_list, join_infos):
        table_x = self.one_hot_table_encoding(table_ids)
        pred_x = np.vstack([
            self.one_table_pred_encoding(t, p)
            for t, p in zip(table_ids, all_pred_list)
        ])
        join_x = self.one_hot_join_encoding(join_infos)
        return table_x, pred_x, join_x

    def encode_batch(self, queries):
        trip = [self.encode_query(*q) for q in queries]
        table, tm = pad_sets([t[0] for t in trip])
        pred, pm = pad_sets([t[1] for t in trip])
        join, jm = pad_sets([t[2] for t in trip], feat=self.join_feat_dim)
        return (table, tm), (pred, pm), (join, jm)

    # ----------------------------------------------------------- TreeLSTM
    def one_hot_operator_encoding(self, join_infos=None):
        op_x = np.zeros(2 + self.total_num_joins)
        if not join_infos:
            op_x[0] = 1     # table scan
            return op_x
        op_x[1] = 1         # join
        for ji in join_infos:
            triple = ((ji.t1_id, ji.t2_id, ji.col_name) if ji.t1_id < ji.t2_id
                      else (ji.t2_id, ji.t1_id, ji.col_name))
            op_x[2 + self.all_join_triples.index(triple)] = 1
        return op_x

    def one_hot_meta_encoding(self, table_ids):
        meta_x = np.zeros(self.num_tables)
        meta_x[list(table_ids)] = 1
        return meta_x

    def get_join_order(self, table_ids, join_infos):
        """BFS join order from a random start
        (`reference/baselines/encoder.py:305-335`)."""
        tid_to_join_infos = {t: [] for t in table_ids}
        adj = {t: set() for t in table_ids}
        for ji in join_infos:
            adj[ji.t1_id].add(ji.t2_id)
            adj[ji.t2_id].add(ji.t1_id)
            tid_to_join_infos[ji.t1_id].append(ji)
            tid_to_join_infos[ji.t2_id].append(ji)
        start = self._rng.choice(table_ids)
        join_order, join_infos_order = [start], []
        frontier = set(adj[start])
        while frontier:
            cur = frontier.pop()
            for nxt in adj[cur]:
                if nxt not in join_order:
                    frontier.add(nxt)
            cur_infos = [ji for ji in tid_to_join_infos[cur]
                         if ji.t1_id in join_order or ji.t2_id in join_order]
            join_order.append(cur)
            join_infos_order.append(cur_infos)
        return join_order, join_infos_order

    def encode_plan(self, table_ids, all_pred_list, join_infos) -> PlanNode:
        """Left-deep plan chain (`reference/baselines/encoder.py:
        266-303`)."""
        if len(table_ids) == 1:
            return PlanNode(
                self.one_table_pred_encoding(table_ids[0], all_pred_list[0]),
                self.one_hot_operator_encoding(),
                self.one_hot_meta_encoding(table_ids), level=0)
        join_order, join_infos_order = self.get_join_order(table_ids, join_infos)
        preds = [all_pred_list[table_ids.index(t)] for t in join_order]
        root = PlanNode(self.one_table_pred_encoding(join_order[0], preds[0]),
                        self.one_hot_operator_encoding(),
                        self.one_hot_meta_encoding([join_order[0]]), level=0)
        for l, cur_join_infos in enumerate(join_infos_order, start=1):
            leaf = PlanNode(self.one_table_pred_encoding(join_order[l], preds[l]),
                            self.one_hot_operator_encoding(),
                            self.one_hot_meta_encoding([join_order[l]]), level=0)
            new_root = PlanNode(
                np.vstack([leaf.pred_features, root.pred_features]),
                self.one_hot_operator_encoding(cur_join_infos),
                self.one_hot_meta_encoding(join_order[:l + 1]), level=l)
            new_root.add_child(leaf)
            new_root.add_child(root)
            root = new_root
        return root
