"""A frozen copy of the Python query-line encoder, the benchmark's own.

Copied from `nngp_tpu_torch/featurize/stats.py` (`TableStats`,
`ColumnStats`), `nngp_tpu_torch/featurize/parser.py` (`parse_predicates`),
`nngp_tpu_torch/featurize/encoder.py` (`SingleTableEncoder.encode_batch`)
and `nngp_tpu_torch/featurize/join.py` (`MultiJoinEncoder`: the join
vocabulary, the serving and labeled grammars, `encode_batch`,
`col_scale`), keeping only what encodes multi-join lines. It imports
nothing of the program, so a change there cannot move the yardstick.

Layout: a numerical column takes 2 slots, (v - min) / denom * 1000 for its
upper and lower bound (an unconstrained column: 0 and 1000); a categorical
column takes ceil(num_cat / chunk) slots of bit-packed chunks, code c
setting bit 2^(chunk - 1 - c % chunk) of slot c // chunk; then 3 slots a
join triple (t1, t2, column), the '=' slot set for each equi-join.
chunk_norm scales the chunk slots by 1000 / 2^chunk.
"""

import json
import math
import os

import numpy as np

NUMERICAL = "numerical"
CATEGORICAL = "categorical"
_JOIN_OPS = 3          # the '>', '<', '=' slots of a join triple
_EQ_SLOT = 2


class TableStats:
    """One table's columns: kinds, numerical ranges, category lists."""

    def __init__(self, payload):
        self.table_name = payload["table_name"]
        self.chunk_size = int(payload["chunk_size"])
        self.columns = []
        for c in payload["columns"]:
            denom = float(c["max"]) - float(c["min"])
            self.columns.append({
                "name": c["name"], "kind": c["kind"], "min": float(c["min"]),
                # the reference Table's 1e-6 floor for constant columns
                "denom": denom if denom > 0 else 1e-6,
                "num_cat": (len(c["categories"])
                            if c["categories"] is not None else 0)})
        self.col_index = {c["name"]: i for i, c in enumerate(self.columns)}
        self.starts = []
        dim = 0
        for c in self.columns:
            self.starts.append(dim)
            dim += (math.ceil(c["num_cat"] / self.chunk_size)
                    if c["kind"] == CATEGORICAL else 2)
        self.feat_dim = dim

    def default_row(self):
        x = np.zeros(self.feat_dim, dtype=np.float64)
        for c, s in zip(self.columns, self.starts):
            if c["kind"] == NUMERICAL:
                x[s + 1] = 1000.0
        return x


def load_stats(stats_dir):
    """The TableStats JSONs of a directory, in sorted filename order (the
    order that lays out the features)."""
    out = []
    for name in sorted(os.listdir(stats_dir)):
        if name.endswith(".json"):
            with open(os.path.join(stats_dir, name)) as f:
                out.append(TableStats(json.load(f)))
    return out


def parse_predicates(text, table):
    """`col,upper,lower#col,c1,c2,...` -> [(col, upper, lower) |
    (col, [codes])]."""
    text = text.strip()
    if not text:
        return []
    preds = []
    for pred in text.split("#"):
        parts = pred.split(",")
        col = table.col_index[parts[0].strip()]
        if table.columns[col]["kind"] == CATEGORICAL:
            preds.append((col, [int(p.strip()) for p in parts[1:]]))
        else:
            preds.append((col, float(parts[1].strip()),
                          float(parts[2].strip())))
    return preds


class MultiJoinEncoder:
    """`t1,...,tk@preds_1@...@preds_k@joins[@card]` lines -> features."""

    def __init__(self, tables, chunk_norm=False):
        self.tables = list(tables)
        self.chunk_norm = bool(chunk_norm)
        self.tid = {t.table_name: i for i, t in enumerate(self.tables)}
        self.triples = []
        for a in range(len(self.tables) - 1):
            for b in range(a + 1, len(self.tables)):
                kinds = {c["name"]: c["kind"] for c in self.tables[b].columns}
                for c in self.tables[a].columns:
                    if kinds.get(c["name"]) == c["kind"]:
                        self.triples.append((a, b, c["name"]))
        self.triple_index = {t: i for i, t in enumerate(self.triples)}
        self.offsets = np.cumsum([0] + [t.feat_dim for t in self.tables])
        self.join_dim = len(self.triples) * _JOIN_OPS
        self.feat_dim = int(self.offsets[-1]) + self.join_dim

    @property
    def col_scale(self):
        """Per-feature scale: 1000 / 2^chunk on chunk slots under
        chunk_norm, else 1."""
        scale = np.ones(self.feat_dim, dtype=np.float64)
        if self.chunk_norm:
            for off, t in zip(self.offsets, self.tables):
                factor = 1000.0 / 2.0 ** t.chunk_size
                for c, s in zip(t.columns, t.starts):
                    if c["kind"] == CATEGORICAL:
                        width = math.ceil(c["num_cat"] / t.chunk_size)
                        scale[off + s:off + s + width] = factor
        return scale

    def parse(self, line, with_card):
        """(table ids, predicate lists, join triples indices[, card])."""
        terms = line.strip().split("@")
        tids = [self.tid[n] for n in terms[0].strip().split(",")]
        if len(tids) + (3 if with_card else 2) != len(terms):
            raise ValueError(f"query format error: {line!r}")
        preds = [parse_predicates(p, self.tables[t])
                 for t, p in zip(tids, terms[1:len(tids) + 1])]
        join_str = terms[len(tids) + 1].strip()
        joins = []
        for j in ([] if not join_str else join_str.split("#")):
            a, b, col = (p.strip() for p in j.split(","))
            ia, ib = self.tid[a], self.tid[b]
            joins.append(self.triple_index[(min(ia, ib), max(ia, ib), col)])
        if with_card:
            return tids, preds, joins, int(terms[-1].strip())
        return tids, preds, joins

    def encode(self, lines, with_card=False):
        """(x (n, feat_dim) fp64, log2 cards or None) of query lines."""
        parsed = [self.parse(l, with_card) for l in lines]
        n = len(parsed)
        x = np.zeros((n, self.feat_dim), dtype=np.float64)
        for t_id, table in enumerate(self.tables):
            off = int(self.offsets[t_id])
            x[:, off:off + table.feat_dim] = table.default_row()
        for row, item in enumerate(parsed):
            tids, preds = item[0], item[1]
            for t_id, plist in zip(tids, preds):
                table, off = self.tables[t_id], int(self.offsets[t_id])
                chunk = table.chunk_size
                for pred in plist:
                    col = table.columns[pred[0]]
                    s = off + table.starts[pred[0]]
                    if col["kind"] == CATEGORICAL:
                        # each code's bit set once, however often listed
                        for code in set(pred[1]):
                            x[row, s + code // chunk] += \
                                2.0 ** (chunk - 1 - code % chunk)
                    else:
                        x[row, s] = ((pred[1] - col["min"]) / col["denom"]
                                     * 1000.0)
                        x[row, s + 1] = ((pred[2] - col["min"])
                                         / col["denom"] * 1000.0)
            for j in item[2]:
                x[row, int(self.offsets[-1]) + j * _JOIN_OPS + _EQ_SLOT] = 1.0
        if self.chunk_norm:
            x *= self.col_scale
        if not with_card:
            return x, None
        return x, np.log2(np.asarray([p[3] for p in parsed], np.float64))
