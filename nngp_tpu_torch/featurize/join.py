"""Join-query encoders: binary-join and multi-join feature layouts.

A copy of `nngp_tpu/featurize/join.py`.
Its code differs only in its imports: the port imports nothing of the
JAX package. `tests/test_torch_featurize.py` holds the copy to the
original.

Parity surfaces:
  BinaryJoinEncoder  <->  BinaryJoinQuerySampler encoding/parsing
      (`reference/JoinQuerySampler.py:185-323`): feature =
      hstack(t1_pred_enc, t2_pred_enc, join_onehot); join one-hot has 3
      slots per joinable column keyed by the op's *characters* through
      {'>':0,'<':1,'=':2} — so '<=' sets two bits ('<' and '='), '<>' sets
      bits for '<' and '>' (`:260-266`).
  MultiJoinEncoder   <->  MultiJoinQuerySampler encoding/parsing
      (`reference/JoinQuerySampler.py:370-676`) and the serving
      NNGPEncoder (`reference/neuroestimator/estimator/encoder.py:
      138-304`): feature = concat of predicate encodings for ALL tables in
      schema order (absent tables get the default encoding) + equi-join
      one-hot over the (t1, t2, col) triple vocabulary; plus the card-less
      serving grammar.

Join detection: two tables are joinable on a column iff it exists in both
with the same kind (`JoinQuerySampler.py:190-195,389-393`). This needs only
`TableStats`, so the encoder works without the raw CSVs (serving hosts).
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np

from nngp_tpu_torch.featurize.encoder import SingleTableEncoder
from nngp_tpu_torch.featurize.parser import JoinInfo, QueryInfo, parse_predicates
from nngp_tpu_torch.featurize.stats import TableStats

JOIN_OPS_DICT = {">": 0, "<": 1, "=": 2}
NUMERICAL_JOIN_OPS = ["<", ">", "=", "<=", ">=", "<>"]
CATEGORICAL_JOIN_OPS = ["=", "<>"]


def detect_join_columns(t1: TableStats, t2: TableStats) -> List[Tuple[str, str]]:
    """[(col_name, kind)] joinable between t1 and t2 — same name + kind."""
    t2_kinds = {c.name: c.kind for c in t2.columns}
    out = []
    for c in t1.columns:
        if c.name in t2_kinds and t2_kinds[c.name] == c.kind:
            out.append((c.name, c.kind))
    return out


class BinaryJoinEncoder:
    """Two-table join queries, grammar `t1_preds@t2_preds@joins@card`."""

    def __init__(self, table1: TableStats, table2: TableStats,
                 chunk_norm: bool = False):
        """chunk_norm: rescale packed categorical chunk slots to the
        [0, 1000] numeric scale (see SingleTableEncoder; off = reference
        parity)."""
        self.table1, self.table2 = table1, table2
        self.chunk_norm = bool(chunk_norm)
        self.enc1 = SingleTableEncoder(table1, chunk_norm=chunk_norm)
        self.enc2 = SingleTableEncoder(table2, chunk_norm=chunk_norm)
        joinable = detect_join_columns(table1, table2)
        self.join_col_names = [n for n, _ in joinable]
        self.join_col_types = [k for _, k in joinable]
        self.total_num_joins = len(self.join_col_names)
        self.join_feat_dim = self.total_num_joins * len(JOIN_OPS_DICT)

    @property
    def feat_dim(self):
        return self.table1.feat_dim + self.table2.feat_dim + self.join_feat_dim

    def max_abs_bound(self) -> float:
        """Layout-derived magnitude bound (see SingleTableEncoder); join
        one-hot slots are 0/1."""
        return max(self.enc1.max_abs_bound(), self.enc2.max_abs_bound())

    def parse_line(self, line: str):
        terms = line.strip().split("@")
        t1_preds = parse_predicates(terms[0].strip(), self.table1)
        t2_preds = parse_predicates(terms[1].strip(), self.table2)
        joins = [
            (j.split(",")[0].strip(), j.split(",")[1].strip())
            for j in terms[2].strip().split("#")
        ]
        card = int(terms[3].strip())
        return t1_preds, t2_preds, joins, card

    def join_encoding(self, join_conditions) -> np.ndarray:
        x = np.zeros(self.join_feat_dim, dtype=np.float64)
        for col_name, op in join_conditions:
            idx = self.join_col_names.index(col_name)
            for c in op:
                x[idx * len(JOIN_OPS_DICT) + JOIN_OPS_DICT[c]] = 1
        return x

    def encode_batch(self, queries, dtype=np.float64) -> np.ndarray:
        t1_x = self.enc1.encode_batch([q[0] for q in queries], dtype=dtype)
        t2_x = self.enc2.encode_batch([q[1] for q in queries], dtype=dtype)
        join_x = np.stack([self.join_encoding(q[2]) for q in queries]).astype(dtype)
        return np.hstack([t1_x, t2_x, join_x])

    def load_queries(self, query_path: str):
        import os
        all_queries, all_cards, all_infos = [], [], []
        for fname in sorted(os.listdir(query_path)):
            with open(os.path.join(query_path, fname)) as f:
                for line in f:
                    if not line.strip():
                        continue
                    t1p, t2p, joins, card = self.parse_line(line)
                    all_queries.append((t1p, t2p, joins))
                    all_cards.append(card)
                    is_multi_key = len(joins) > 1
                    is_equal_join = all(op == "=" for _, op in joins)
                    all_infos.append(QueryInfo(
                        num_table=2, num_joins=len(joins),
                        num_predicates=len(t1p) + len(t2p),
                        is_equal_join=is_equal_join, is_multi_key=is_multi_key))
        return all_queries, all_cards, all_infos

    def transform_to_arrays(self, all_queries, all_cards, dtype=np.float64):
        x = self.encode_batch(all_queries, dtype=dtype)
        y = np.log2(np.asarray(all_cards, dtype=np.float64)).reshape(-1, 1).astype(dtype)
        return x, y


class MultiJoinEncoder:
    """K-table acyclic join queries, grammar
    `tables@preds_1@...@preds_k@joins[@card]`."""

    def __init__(self, tables: Sequence[TableStats], chunk_norm: bool = False):
        """chunk_norm: rescale packed categorical chunk slots to the
        [0, 1000] numeric scale (see SingleTableEncoder; off = reference
        parity — measured 3.4x median q-error on the 6-table workload)."""
        self.tables = list(tables)
        self.num_tables = len(tables)
        self.chunk_norm = bool(chunk_norm)
        self.encoders = [SingleTableEncoder(t, chunk_norm=chunk_norm)
                         for t in tables]
        self.tid_to_table_name = {i: t.table_name for i, t in enumerate(tables)}
        self.table_name_to_tid = {t.table_name: i for i, t in enumerate(tables)}

        self.all_join_infos: List[JoinInfo] = []
        self.table_pair_to_join_infos: Dict[Tuple[int, int], List[JoinInfo]] = {}
        for t1 in range(self.num_tables - 1):
            for t2 in range(t1 + 1, self.num_tables):
                for col_name, kind in detect_join_columns(tables[t1], tables[t2]):
                    ji = JoinInfo(t1_id=t1, t2_id=t2, col_name=col_name, col_type=kind)
                    self.all_join_infos.append(ji)
                    self.table_pair_to_join_infos.setdefault((t1, t2), []).append(ji)
        self.all_join_table_pairs = list(self.table_pair_to_join_infos.keys())
        # adjacency of the join graph (replaces networkx in the reference)
        self.join_adj: Dict[int, set] = {i: set() for i in range(self.num_tables)}
        for (a, b) in self.all_join_table_pairs:
            self.join_adj[a].add(b)
            self.join_adj[b].add(a)
        self.all_join_triples = [
            (ji.t1_id, ji.t2_id, ji.col_name) for ji in self.all_join_infos
        ]
        self.all_join_col_names = [ji.col_name for ji in self.all_join_infos]
        self.total_num_joins = len(self.all_join_triples)
        self.join_feat_dim = self.total_num_joins * len(JOIN_OPS_DICT)
        self._table_offsets = np.cumsum(
            [0] + [t.feat_dim for t in self.tables]
        )

    @property
    def feat_dim(self):
        return int(self._table_offsets[-1]) + self.join_feat_dim

    @property
    def col_scale(self) -> np.ndarray:
        """Full-width per-feature scale vector (all ones unless chunk_norm).
        Consumers that bypass encode_batch (the native C++ encoder, whose
        output is bit-exact RAW features) multiply by this."""
        return np.concatenate(
            [e.col_scale for e in self.encoders]
            + [np.ones(self.join_feat_dim)])

    def max_abs_bound(self) -> float:
        """Layout-derived magnitude bound (see SingleTableEncoder); join
        one-hot slots are 0/1."""
        return max(e.max_abs_bound() for e in self.encoders)

    # ------------------------------------------------------------- parsing
    def _parse_joins(self, join_str: str) -> List[JoinInfo]:
        join_infos = []
        for join in ([] if not join_str else join_str.split("#")):
            parts = [p.strip() for p in join.split(",")]
            t1_name, t2_name, col_name = parts[0], parts[1], parts[2]
            t_id = self.table_name_to_tid[t1_name]
            col_idx = self.tables[t_id].col_idx(col_name)
            col_type = self.tables[t_id].columns[col_idx].kind
            join_infos.append(JoinInfo(
                t1_id=self.table_name_to_tid[t1_name],
                t2_id=self.table_name_to_tid[t2_name],
                col_name=col_name, col_type=col_type))
        return join_infos

    def parse_line(self, line: str):
        """`tables@preds_1@...@preds_k@joins@card`
        (`reference/JoinQuerySampler.py:624-644`)."""
        terms = line.strip().split("@")
        table_names = terms[0].strip().split(",")
        table_ids = [self.table_name_to_tid[n] for n in table_names]
        if len(table_ids) + 3 != len(terms):
            raise ValueError("Query format error: wrong number of @-fields")
        all_pred_list = [
            parse_predicates(p.strip(), self.tables[t])
            for t, p in zip(table_ids, terms[1:len(table_ids) + 1])
        ]
        join_infos = self._parse_joins(terms[-2].strip())
        card = int(terms[-1].strip())
        return table_ids, all_pred_list, join_infos, card

    def parse_line_without_card(self, line: str):
        """Serving grammar without the trailing card
        (`reference/neuroestimator/estimator/encoder.py:229-250`)."""
        terms = line.strip().split("@")
        table_names = terms[0].strip().split(",")
        table_ids = [self.table_name_to_tid[n] for n in table_names]
        if len(table_ids) + 2 != len(terms):
            raise ValueError("Query format error: wrong number of @-fields")
        all_pred_list = [
            parse_predicates(p.strip(), self.tables[t])
            for t, p in zip(table_ids, terms[1:len(table_ids) + 1])
        ]
        join_infos = self._parse_joins(terms[-1].strip())
        return table_ids, all_pred_list, join_infos

    @staticmethod
    def query_info(table_ids, all_pred_list, join_infos) -> QueryInfo:
        table_pairs = {(ji.t1_id, ji.t2_id) for ji in join_infos}
        return QueryInfo(
            num_table=len(table_ids), num_joins=len(join_infos),
            num_predicates=sum(len(p) for p in all_pred_list),
            is_equal_join=True,
            is_multi_key=len(table_pairs) < len(join_infos))

    # ------------------------------------------------------------ encoding
    def join_encoding(self, join_infos) -> np.ndarray:
        """Equi-join one-hot (`reference/JoinQuerySampler.py:604-612`)."""
        x = np.zeros(self.join_feat_dim, dtype=np.float64)
        for ji in join_infos:
            triple = ((ji.t1_id, ji.t2_id, ji.col_name) if ji.t1_id < ji.t2_id
                      else (ji.t2_id, ji.t1_id, ji.col_name))
            idx = self.all_join_triples.index(triple)
            x[idx * len(JOIN_OPS_DICT) + JOIN_OPS_DICT["="]] = 1
        return x

    def encode_batch(self, queries, dtype=np.float64) -> np.ndarray:
        """queries: [(table_ids, all_pred_list, join_infos)]. Vectorized:
        one SingleTableEncoder batch per table slice + join scatter."""
        n = len(queries)
        blocks = []
        for t_id, enc in enumerate(self.encoders):
            per_query = []
            for (table_ids, all_pred_list, _joins) in queries:
                if t_id in table_ids:
                    per_query.append(all_pred_list[table_ids.index(t_id)])
                else:
                    per_query.append([])
            blocks.append(enc.encode_batch(per_query, dtype=dtype))
        join_block = np.zeros((n, self.join_feat_dim), dtype=dtype)
        for row, (_tids, _preds, join_infos) in enumerate(queries):
            join_block[row] = self.join_encoding(join_infos)
        blocks.append(join_block)
        return np.hstack(blocks)

    def load_queries(self, query_path: str, use_aux: bool = False,
                     q_error_threshold: float = 100.0,
                     coef_var_threshold: float = 1.0):
        """Read all query files; optionally ingest `join_query_aux.txt`
        feedback lines `query@true_card@q_error@coef_var`, keeping only hard
        queries — kept when q_error >= thr OR coef_var >= thr, matching the
        code not the README (`reference/neuroestimator/estimator/
        encoder.py:263-270`, SURVEY.md section 5 quirks)."""
        import os
        all_queries, all_cards, all_infos = [], [], []
        for fname in sorted(os.listdir(query_path)):
            path = os.path.join(query_path, fname)
            if fname == "join_query_aux.txt":
                if not use_aux:
                    continue
                with open(path) as f:
                    for line in f:
                        if not line.strip():
                            continue
                        items = line.strip().split("@")
                        q_error, coef_var = float(items[-2]), float(items[-1])
                        if q_error < q_error_threshold and coef_var < coef_var_threshold:
                            continue
                        base = "@".join(items[:len(items) - 2])
                        tids, preds, joins, card = self.parse_line(base)
                        all_queries.append((tids, preds, joins))
                        all_cards.append(card)
                        all_infos.append(self.query_info(tids, preds, joins))
                continue
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    tids, preds, joins, card = self.parse_line(line)
                    all_queries.append((tids, preds, joins))
                    all_cards.append(card)
                    all_infos.append(self.query_info(tids, preds, joins))
        return all_queries, all_cards, all_infos

    def transform_to_arrays(self, all_queries, all_cards, dtype=np.float64):
        x = self.encode_batch(all_queries, dtype=dtype)
        y = np.log2(np.asarray(all_cards, dtype=np.float64)).reshape(-1, 1).astype(dtype)
        return x, y
