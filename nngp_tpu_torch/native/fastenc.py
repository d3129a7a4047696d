"""ctypes bindings for the native query-line parser/encoder
(`nngp_tpu_torch/csrc/fastenc.cpp`).

A copy of `nngp_tpu/native/fastenc.py` and of the repo-level
`native/fastenc.cpp`, built the port's way: g++ compiles the port's own
source at first use into `.build/nngp_tpu_torch/libfastenc_<hash>.so`,
keyed by a hash of the source and the flags (as `ops/_build.py` does for
`gram.cu`), writing to a temporary path and renaming it into place.

This is a host encoder, not a device kernel, and it degrades as the
original does: `is_available()` is False when no compiler is present, and
callers (`serve.Estimator`) fall back to the Python encoders and report it
in `encoder_kind`. Output is bit-identical to `featurize.encoder` /
`featurize.join` (`tests/test_torch_featurize.py`).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from nngp_tpu_torch.featurize.stats import CATEGORICAL, TableStats

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "fastenc.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".build",
                          "nngp_tpu_torch")
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_failed = False


def library_path() -> str:
    """Where the library for the current source and flags is cached."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_GXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libfastenc_{digest.hexdigest()[:16]}.so")


def _compile() -> Optional[str]:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Compile to a temp path + atomic rename: a timeout-killed g++ must not
    # leave a half-written .so that every later process dlopens.
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = ["g++", *_GXX_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = _compile()
        if so is None:
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            # corrupt/incompatible artifact: degrade gracefully (the
            # documented contract) instead of raising out of is_available()
            _failed = True
            return None
        lib.fastenc_schema_new.restype = ctypes.c_void_p
        lib.fastenc_schema_new.argtypes = [ctypes.c_char_p]
        lib.fastenc_schema_free.argtypes = [ctypes.c_void_p]
        lib.fastenc_encode_multi.restype = ctypes.c_long
        lib.fastenc_encode_multi.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.fastenc_encode_single.restype = ctypes.c_long
        lib.fastenc_encode_single.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int)]
        lib.fastenc_count_lines.restype = ctypes.c_long
        lib.fastenc_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_long]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def _schema_desc(tables: Sequence[TableStats],
                 join_triples, join_offset: int, feat_dim: int,
                 chunk_size: int) -> str:
    """Build the wire-format schema description (see fastenc.cpp header)."""
    lines = [f"{len(tables)} {chunk_size}"]
    offset = 0
    for t in tables:
        lines.append(f"T {t.table_name} {t.num_cols} {t.chunk_size}")
        for col, addr in zip(t.columns, t.addresses):
            kind = 1 if col.kind == CATEGORICAL else 0
            lines.append(
                f"C {col.name} {kind} {offset + addr.start} "
                f"{col.min!r} {col.denominator!r} {col.num_cat}")
        offset += t.feat_dim
    lines.append(f"J {len(join_triples)}")
    for (t1, t2, col) in join_triples:
        lines.append(f"{tables[t1].table_name} {tables[t2].table_name} {col}")
    lines.append(f"F {feat_dim} {join_offset}")
    return "\n".join(lines)


class FastEncoder:
    """Native batch encoder over a fixed schema.

    Single-table mode: FastEncoder([stats]) + encode_single(text).
    Multi-join mode: FastEncoder(stats_list) + encode_multi(text, with_card).
    """

    def __init__(self, tables: Sequence[TableStats]):
        lib = _load()
        if lib is None:
            raise RuntimeError("native fastenc unavailable (no g++?)")
        self._lib = lib
        self.tables = list(tables)
        from nngp_tpu_torch.featurize.join import MultiJoinEncoder
        mj = MultiJoinEncoder(tables)
        self.feat_dim = mj.feat_dim
        self._join_offset = self.feat_dim - mj.join_feat_dim
        desc = _schema_desc(tables, mj.all_join_triples, self._join_offset,
                            self.feat_dim, tables[0].chunk_size)
        self._handle = lib.fastenc_schema_new(desc.encode())
        if not self._handle:
            raise RuntimeError("fastenc schema parse failed")
        self.single_feat_dim = tables[0].feat_dim

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.fastenc_schema_free(self._handle)
            self._handle = None

    def _count(self, data: bytes) -> int:
        return self._lib.fastenc_count_lines(data, len(data))

    def encode_multi(self, text: str, with_card: bool = True,
                     dtype=np.float64):
        """(X, cards, num_tables, num_preds, num_joins) for multi-join lines.
        cards is None when with_card=False."""
        data = text.encode()
        n = self._count(data)
        x = np.zeros((n, self.feat_dim), dtype=np.float64)
        cards = np.zeros(n, dtype=np.float64)
        nt = np.zeros(n, dtype=np.int32)
        npd = np.zeros(n, dtype=np.int32)
        nj = np.zeros(n, dtype=np.int32)
        got = self._lib.fastenc_encode_multi(
            self._handle, data, len(data), int(with_card),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cards.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nt.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            npd.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            nj.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if got < 0:
            raise ValueError(f"fastenc parse error at line {-got}")
        x = x[:got].astype(dtype, copy=False)
        return (x, cards[:got] if with_card else None,
                nt[:got], npd[:got], nj[:got])

    def encode_single(self, text: str, dtype=np.float64):
        """(X, cards, num_preds) for single-table `preds@card` lines
        (encodes into table 0's layout)."""
        data = text.encode()
        n = self._count(data)
        # single-table layout == the full row when there is 1 table + 0 joins
        full = np.zeros((n, self.feat_dim), dtype=np.float64)
        cards = np.zeros(n, dtype=np.float64)
        npd = np.zeros(n, dtype=np.int32)
        got = self._lib.fastenc_encode_single(
            self._handle, data, len(data),
            full.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cards.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            npd.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if got < 0:
            raise ValueError(f"fastenc parse error at line {-got}")
        # contiguous copy: the narrow view would pin the full multi-table
        # buffer alive and force a gather on device_put
        x = np.ascontiguousarray(full[:got, :self.single_feat_dim],
                                 dtype=dtype)
        return x, cards[:got], npd[:got]

    def encode_file(self, path: str, with_card: bool = True,
                    dtype=np.float64):
        with open(path) as f:
            return self.encode_multi(f.read(), with_card=with_card,
                                     dtype=dtype)
