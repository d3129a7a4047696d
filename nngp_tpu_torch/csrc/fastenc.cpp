// fastenc — native query-line parser + feature encoder.
//
// A copy of the repo-level native/fastenc.cpp, built by
// nngp_tpu_torch/native/fastenc.py (g++ at first use, cached under
// .build/nngp_tpu_torch/ by a hash of this source).
//
// The serving path parses and encodes query strings on the host before the
// device sees anything (`Estimator.predict`, reference
// neuroestimator/estimator/estimator.py:42-61 does it line-by-line in
// Python). This library does the string -> feature-row transformation in
// C++ at ~50-100x the Python encoder's throughput; bindings are ctypes
// (nngp_tpu_torch/native/fastenc.py) with a transparent Python fallback.
//
// Encoding semantics are bit-identical to nngp_tpu_torch/featurize (and
// therefore to the reference):
//   numerical col  -> 2 slots (upper, lower), scaled (v - min)/denom*1000,
//                     default (0, 1000)
//   categorical col-> factorized chunks: += 2^(chunk-1 - code%chunk) into
//                     slot code/chunk, duplicate codes per predicate dedup'd
//   joins          -> one-hot 3 slots per (t1,t2,col) triple, '=' bit set
//
// Schema wire format (built by Python, parsed once into a Schema handle):
//   line 1: ntables default_chunk_size
//   per table: "T <name> <ncols> <chunk_width>" then per column:
//       "C <name> <kind 0|1> <addr_start> <min> <denom> <num_cat>"
//     (addr_start is the GLOBAL feature offset of the column)
//   then: "J <njoins>" and per join triple: "<t1name> <t2name> <colname>"
//   last: "F <feat_dim> <join_offset>"

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>
#include <sstream>

namespace {

struct Column {
  int kind;        // 0 numerical, 1 categorical
  int start;       // global feature offset
  double min;
  double denom;
  int num_cat;
};

struct Table {
  int chunk = 64;    // factorized-encoding chunk width (PER TABLE —
                     // TableStats carries one per table; packing with a
                     // global width silently corrupts categorical slots
                     // when tables differ)
  std::unordered_map<std::string, int> col_index;
  std::vector<Column> cols;
};

struct Schema {
  int chunk_size = 64;
  int feat_dim = 0;
  int join_offset = 0;
  std::vector<Table> tables;
  std::unordered_map<std::string, int> table_index;
  std::unordered_map<std::string, int> join_triple_index;  // "t1|t2|col"
  std::vector<double> default_row;
};

inline const char* find_char(const char* p, const char* end, char c) {
  while (p < end && *p != c) ++p;
  return p;
}

inline std::string trim(const char* b, const char* e) {
  if (b > e) return std::string();  // defensive: caller ranges can invert
  while (b < e && (*b == ' ' || *b == '\t' || *b == '\r')) ++b;
  while (e > b && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) --e;
  return std::string(b, e);
}

// Strict numeric parses: the whole (trimmed) field must be consumed —
// strtol/strtod without endptr checks silently turn garbage into 0, so
// malformed serving lines would produce wrong features instead of the
// clean parse error the Python fallback raises.
inline bool parse_long(const std::string& field, long* out) {
  if (field.empty()) return false;
  char* endp = nullptr;
  errno = 0;
  long v = strtol(field.c_str(), &endp, 10);
  if (errno != 0 || endp != field.c_str() + field.size()) return false;
  *out = v;
  return true;
}

inline bool parse_double(const std::string& field, double* out) {
  if (field.empty()) return false;
  char* endp = nullptr;
  errno = 0;
  double v = strtod(field.c_str(), &endp);
  // Reject overflow (strtod returns +/-HUGE_VAL) via the finiteness check
  // alone — errno==ERANGE also fires on legitimate subnormal UNDERFLOW
  // (e.g. "1e-310"), which must stay accepted like the Python parser does.
  if (endp != field.c_str() + field.size() || !std::isfinite(v))
    return false;
  *out = v;
  return true;
}

// Encode one predicate section ("col,a,b#col,c1,c2,...") for table t into row.
int encode_preds(const Schema* s, int tid, const char* b, const char* e,
                 double* row, int* num_preds) {
  if (trim(b, e).empty()) return 0;
  const Table& t = s->tables[tid];
  const char* p = b;
  while (p < e) {
    const char* q = find_char(p, e, '#');
    // fields split by ','
    const char* f0e = find_char(p, q, ',');
    std::string col_name = trim(p, f0e);
    auto it = t.col_index.find(col_name);
    if (it == t.col_index.end()) return -2;  // unknown column
    const Column& col = t.cols[it->second];
    if (col.kind == 0) {
      const char* f1 = f0e + 1;
      if (f1 > q) return -3;
      const char* f1e = find_char(f1, q, ',');
      if (f1e >= q) return -3;
      double upper, lower;
      if (!parse_double(trim(f1, f1e), &upper) ||
          !parse_double(trim(f1e + 1, q), &lower))
        return -3;
      row[col.start] = (upper - col.min) / col.denom * 1000.0;
      row[col.start + 1] = (lower - col.min) / col.denom * 1000.0;
    } else {
      // Python-encoder semantics exactly (featurize/encoder.py:57-63,80):
      // duplicate codes WITHIN one predicate set a bit once (set()), and
      // the chunk value accumulates as float64 += of 2^bit. Codes are
      // bounds-checked: an out-of-range code would index outside the
      // column's slots and write out of the caller's buffer (the Python
      // path raises IndexError for the same input).
      std::vector<long> seen;
      const char* f = f0e;
      while (f < q) {
        ++f;  // skip ','
        const char* fe = find_char(f, q, ',');
        long code;
        if (!parse_long(trim(f, fe), &code)) return -4;
        if (code < 0 || code >= (long)col.num_cat) return -4;
        bool dup = false;
        for (long c : seen) if (c == code) { dup = true; break; }
        if (!dup) {
          seen.push_back(code);
          int slot = col.start + (int)(code / t.chunk);
          int bit = t.chunk - 1 - (int)(code % t.chunk);
          row[slot] += std::pow(2.0, (double)bit);
        }
        f = fe;
      }
    }
    ++*num_preds;
    p = (q < e) ? q + 1 : e;
  }
  return 0;
}

}  // namespace

extern "C" {

void* fastenc_schema_new(const char* desc) {
  Schema* s = new Schema();
  std::istringstream in(desc);
  int ntables;
  in >> ntables >> s->chunk_size;
  s->tables.resize(ntables);
  for (int i = 0; i < ntables; ++i) {
    std::string tag, name;
    int ncols;
    in >> tag >> name >> ncols;
    if (tag != "T") { delete s; return nullptr; }
    in >> s->tables[i].chunk;
    s->table_index[name] = i;
    Table& t = s->tables[i];
    t.cols.resize(ncols);
    for (int c = 0; c < ncols; ++c) {
      std::string ctag, cname;
      in >> ctag >> cname;
      Column& col = t.cols[c];
      in >> col.kind >> col.start >> col.min >> col.denom >> col.num_cat;
      if (ctag != "C") { delete s; return nullptr; }
      t.col_index[cname] = c;
    }
  }
  std::string jtag;
  int njoins;
  in >> jtag >> njoins;
  for (int j = 0; j < njoins; ++j) {
    std::string t1, t2, col;
    in >> t1 >> t2 >> col;
    s->join_triple_index[t1 + "|" + t2 + "|" + col] = j;
  }
  std::string ftag;
  in >> ftag >> s->feat_dim >> s->join_offset;
  if (!in || ftag != "F") { delete s; return nullptr; }
  // default row: numerical lower slots = 1000
  s->default_row.assign(s->feat_dim, 0.0);
  for (const Table& t : s->tables)
    for (const Column& c : t.cols)
      if (c.kind == 0) s->default_row[c.start + 1] = 1000.0;
  return s;
}

void fastenc_schema_free(void* handle) { delete (Schema*)handle; }

// Multi-join lines `tables@preds_1@..@preds_k@joins[@card]` -> feature rows.
// buf: newline-separated lines. out: (num_lines, feat_dim) float64 buffer.
// cards: per-line card (-1 if the line has no card). num_preds/num_joins:
// per-line counts for QueryInfo. with_card: 1 if lines end with @card.
// Returns number of lines encoded, or -(line_no) on parse error.
long fastenc_encode_multi(void* handle, const char* buf, long buf_len,
                          int with_card, double* out, double* cards,
                          int* num_tables_out, int* num_preds_out,
                          int* num_joins_out) {
  const Schema* s = (const Schema*)handle;
  const char* p = buf;
  const char* bend = buf + buf_len;
  long line_no = 0;
  long phys_line = 0;  // error reports count PHYSICAL lines (blanks incl.)
  while (p < bend) {
    const char* le = find_char(p, bend, '\n');
    ++phys_line;
    if (trim(p, le).empty()) { p = le + 1; continue; }
    double* row = out + line_no * s->feat_dim;
    memcpy(row, s->default_row.data(), s->feat_dim * sizeof(double));
    // split by '@'
    std::vector<std::pair<const char*, const char*>> terms;
    const char* q = p;
    while (q <= le) {
      const char* qe = find_char(q, le, '@');
      terms.emplace_back(q, qe);
      q = qe + 1;
      if (qe >= le) break;
    }
    size_t min_terms = with_card ? 4 : 3;
    if (terms.size() < min_terms) return -phys_line;
    // tables
    std::vector<int> tids;
    {
      const char* b = terms[0].first;
      const char* e = terms[0].second;
      const char* r = b;
      while (r < e) {
        const char* re = find_char(r, e, ',');
        auto it = s->table_index.find(trim(r, re));
        if (it == s->table_index.end()) return -phys_line;
        tids.push_back(it->second);
        r = re + 1;
      }
    }
    size_t expect = tids.size() + (with_card ? 3 : 2);
    if (terms.size() != expect) return -phys_line;
    int npreds = 0;
    for (size_t i = 0; i < tids.size(); ++i) {
      if (encode_preds(s, tids[i], terms[1 + i].first, terms[1 + i].second,
                       row, &npreds) < 0)
        return -phys_line;
    }
    // joins
    int njoins = 0;
    {
      auto [b, e] = terms[tids.size() + 1];
      if (!trim(b, e).empty()) {
        const char* r = b;
        while (r < e) {
          const char* re = find_char(r, e, '#');
          // t1,t2,col[,op]
          const char* c1 = find_char(r, re, ',');
          if (c1 >= re) return -phys_line;          // need t1,t2,col
          const char* c2 = find_char(c1 + 1, re, ',');
          if (c2 >= re) return -phys_line;
          const char* c3 = find_char(c2 + 1, re, ',');
          std::string t1 = trim(r, c1), t2 = trim(c1 + 1, c2),
                      col = trim(c2 + 1, c3 < re ? c3 : re);
          auto i1 = s->table_index.find(t1);
          auto i2 = s->table_index.find(t2);
          if (i1 == s->table_index.end() || i2 == s->table_index.end())
            return -phys_line;
          int a = i1->second, bb = i2->second;
          std::string key = (a < bb)
              ? t1 + "|" + t2 + "|" + col : t2 + "|" + t1 + "|" + col;
          // triple keys are stored by table NAME in sorted-tid order; the
          // python side guarantees name order == tid order in the key
          auto jt = s->join_triple_index.find(key);
          if (jt == s->join_triple_index.end()) return -phys_line;
          row[s->join_offset + jt->second * 3 + 2] = 1.0;  // '=' bit
          ++njoins;
          r = re + 1;
        }
      }
    }
    if (with_card) {
      // Strict parse: a garbage card silently becoming 0.0 would later turn
      // into a log2(0) = -inf label instead of a clean parse error.
      auto [b, e] = terms.back();
      if (!parse_double(trim(b, e), &cards[line_no])) return -phys_line;
    } else if (cards) {
      cards[line_no] = -1.0;
    }
    if (num_tables_out) num_tables_out[line_no] = (int)tids.size();
    if (num_preds_out) num_preds_out[line_no] = npreds;
    if (num_joins_out) num_joins_out[line_no] = njoins;
    ++line_no;
    p = le + 1;
  }
  return line_no;
}

// Single-table lines `preds@card` (treated as tables[0]).
long fastenc_encode_single(void* handle, const char* buf, long buf_len,
                           double* out, double* cards, int* num_preds_out) {
  const Schema* s = (const Schema*)handle;
  const char* p = buf;
  const char* bend = buf + buf_len;
  long line_no = 0;
  long phys_line = 0;  // error reports count PHYSICAL lines (blanks incl.)
  while (p < bend) {
    const char* le = find_char(p, bend, '\n');
    ++phys_line;
    if (trim(p, le).empty()) { p = le + 1; continue; }
    double* row = out + line_no * s->feat_dim;
    memcpy(row, s->default_row.data(), s->feat_dim * sizeof(double));
    const char* at = find_char(p, le, '@');
    if (at >= le) return -phys_line;
    int npreds = 0;
    if (encode_preds(s, 0, p, at, row, &npreds) < 0) return -phys_line;
    if (!parse_double(trim(at + 1, le), &cards[line_no])) return -phys_line;
    if (num_preds_out) num_preds_out[line_no] = npreds;
    ++line_no;
    p = le + 1;
  }
  return line_no;
}

long fastenc_count_lines(const char* buf, long buf_len) {
  long n = 0;
  const char* p = buf;
  const char* e = buf + buf_len;
  while (p < e) {
    const char* le = find_char(p, e, '\n');
    if (!trim(p, le).empty()) ++n;
    p = le + 1;
  }
  return n;
}

}  // extern "C"
