"""Dense and column-block linear algebra around the Gram kernels
(counterpart of `nngp_tpu/ops/linalg.py`).

The dense append and the padded one keep the factor one (n, n) tensor.
Above the dense layout's cap the exact tier keeps it as triangular COLUMN
BLOCKS instead (`BlockLowerTriangular`): `fused_panel_cholesky` factors the
train Gram left-looking, one column panel at a time, from panels that its
caller writes straight into each block's storage, so K + rI never exists
and the factor takes ~n^2/2 elements. The solves
(`block_tri_solve_lower(_t)`) and the append (`block_cholesky_append_rows`)
read the blocks only. These are cuSOLVER/cuBLAS calls through
`torch.linalg` and `addmm_`, as they were XLA code in the JAX package; the
solves run in place on one right-hand-side buffer, and `blocked_cholesky`
and `blocked_tri_solve_lower(_t)`, the dense blocked forms, are the same
loops over column-block views of a dense matrix.

A factor that fails raises `FactorError` (the JAX functions return NaN).

Spans (`utils/profiling.py::span`, off until `profiling.enable()`): the
'blocks' layout of `fused_panel_cholesky`, the exact tier's column-block
fit, records one `exact.block` a block (block k, rows n - s, width e - s,
updates: the k finished blocks applied, solves: the row chunks solved
below the square) around `exact.block.gram` (the caller's `panel_fn`),
`exact.block.update` (the `addmm_` loop) and `exact.block.factor` (the
square's `cholesky_ex` through its info read, then the row solves).
"""

import torch

from nngp_tpu_torch.utils.profiling import span


class FactorError(FloatingPointError):
    """An exact-tier Cholesky factor failed: the ridged train Gram is not
    positive definite in the working dtype. A FloatingPointError, the type
    the JAX Estimator raises for the NaN factor its Cholesky returns.

    op: 'fit' or 'extend'; order: the 1-based order of the leading minor
    that failed (cuSOLVER's / LAPACK's info), of n; diag_reg: the relative
    ridge, where the caller knows it. The message is built from these, so
    a caller that knows diag_reg may set it before re-raising."""

    def __init__(self, op: str, order: int, n: int, dtype,
                 diag_reg=None):
        super().__init__(op, order, n, dtype, diag_reg)
        self.op, self.order, self.n = op, int(order), int(n)
        self.dtype, self.diag_reg = dtype, diag_reg

    def __str__(self):
        ridge = ("" if self.diag_reg is None
                 else f", diag_reg={self.diag_reg:g}")
        dtype = str(self.dtype).replace("torch.", "")
        return (f"the exact tier's Cholesky factor ({self.op}) failed at "
                f"order {self.order} of n={self.n} ({dtype}{ridge}): the "
                f"ridged train Gram is not positive definite in {dtype} "
                "(its condition ~ n / diag_reg exceeds 1 / eps). Raise "
                "diag_reg, fit in float64 (x64), or serve this train set "
                "on the Nystrom tier (tier='auto' or nystrom_m=...)")


def cholesky_append_rows(l11: torch.Tensor, k21: torch.Tensor,
                         k22: torch.Tensor) -> torch.Tensor:
    """Extend a Cholesky factor when rows/columns are appended to the Gram.

    Given L11 = chol(K11) and the new blocks of [[K11, K21^T], [K21, K22]],
    returns the (n + m, n + m) lower factor [[L11, 0], [L21, L22]] with
    L21 = K21 L11^-T and L22 = chol(K22 - L21 L21^T). K22 must already hold
    its ridge. O(n^2 m + m^3).

    The Schur product must run in full IEEE precision: a one-pass bf16
    product put ~0.3% relative error into L21 L21^T, which exceeds the 1e-3
    relative ridge on ill-conditioned Grams and made the synth6 join
    factor indefinite in the JAX package (`nngp_tpu/ops/linalg.py:410-416`).
    `utils/device.py` keeps TF32 off for every float32 matmul on the card.

    A Schur complement that is not positive definite raises FactorError
    (op 'extend', the failing order counted in the appended Gram), where
    the JAX append returns NaN."""
    n, m = l11.shape[0], k22.shape[0]
    if l11.shape != (n, n) or k21.shape != (m, n) or k22.shape != (m, m):
        raise ValueError(f"shapes do not form an append: L11 {tuple(l11.shape)}"
                         f", K21 {tuple(k21.shape)}, K22 {tuple(k22.shape)}")
    # L21 L11^T = K21  <=>  L11 L21^T = K21^T
    l21 = torch.linalg.solve_triangular(l11, k21.mT, upper=False).mT
    l22, info = torch.linalg.cholesky_ex(k22 - l21 @ l21.mT)
    if int(info):
        raise FactorError("extend", n + int(info), n + m, l11.dtype)
    out = l11.new_zeros((n + m, n + m))
    out[:n, :n] = l11
    out[n:, :n] = l21
    out[n:, n:] = l22
    return out


def padded_append_rows_(l: torch.Tensor, y: torch.Tensor,
                        alpha: torch.Tensor, n_real: int, k21: torch.Tensor,
                        k22: torch.Tensor, y_new: torch.Tensor) -> None:
    """Append rows to a padded factor in place: the counterpart of the JAX
    package's `_padded_append` (`nngp_tpu/gp/posterior.py`).

    l (N, N) is the factor of the inert-padded Gram, block diagonal
    [L_real, I] with L_real its leading n_real rows; y (N, 1) the stored
    labels, zero past n_real; alpha (N, 1) = l^-T l^-1 y. The block to
    append is mb >= m rows: k22 (mb, mb) its Gram with its ridge, whose
    rows past m are inert (unit rows: a bucket's padding), and y_new (mb,
    1) its labels, zero past m; k21 (m, N) holds its m real rows' kernel
    against the stored rows, zero in every column from n_real on. Rows
    [n_real, n_real + mb) of l and y are overwritten, and all of alpha, so
    that every tensor keeps its storage (a CUDA graph that reads them
    stays valid).

    L21 (solved against the whole padded factor: its pad rows come out
    exactly zero; the inert rows' columns are zero and not solved for),
    the Schur factor L22 and the new alpha (by blocks: alpha_2 = L22^-T
    L22^-1 (y_new - L21 z), alpha_1 = l^-T (z - L21^T alpha_2) with z =
    l^-1 y) are computed into temporaries first. A Schur complement that
    is not positive definite raises FactorError and a non-finite result
    FloatingPointError, both before anything is written; then the rows
    are committed with copy_."""
    big, m, mb = l.shape[0], k21.shape[0], k22.shape[0]
    end = n_real + mb
    if (l.shape != (big, big) or k21.shape != (m, big)
            or k22.shape != (mb, mb) or y.shape != (big, 1)
            or alpha.shape != (big, 1) or y_new.shape != (mb, 1)
            or not 0 <= n_real or not 1 <= m <= mb or end > big):
        raise ValueError(
            f"shapes do not form a padded append of {mb} rows at {n_real} "
            f"into {big}: L {tuple(l.shape)}, K21 {tuple(k21.shape)}, K22 "
            f"{tuple(k22.shape)}, y {tuple(y.shape)}, alpha "
            f"{tuple(alpha.shape)}, y_new {tuple(y_new.shape)}")
    u = torch.linalg.solve_triangular(l, k21.mT, upper=False)  # (N, m)
    ur = u[:n_real]
    schur = k22.clone()
    schur[:m, :m] -= ur.mT @ ur
    l22, info = torch.linalg.cholesky_ex(schur)
    if int(info):
        raise FactorError("extend", n_real + int(info), end, l.dtype)
    z = torch.linalg.solve_triangular(l, y, upper=False)
    w = y_new.clone()
    w[:m] -= ur.mT @ z[:n_real]
    a2 = torch.linalg.solve_triangular(
        l22.mT, torch.linalg.solve_triangular(l22, w, upper=False),
        upper=True)
    a = torch.linalg.solve_triangular(l.mT, z - u @ a2[:m], upper=True)
    a[n_real:end] = a2
    finite = torch.stack([torch.isfinite(l22).all(),
                          torch.isfinite(a).all()]).cpu()
    if not bool(finite.all()):
        raise FloatingPointError(
            "padded extend produced a non-finite factor or alpha (L22 "
            f"finite: {bool(finite[0])}, alpha finite: {bool(finite[1])}); "
            "the posterior is unchanged")
    rows = l[n_real:end]
    rows[:m].copy_(u.mT)
    rows[m:].zero_()
    rows[:, n_real:end].copy_(l22)
    y[n_real:end].copy_(y_new)
    alpha.copy_(a)


# Rows of a column panel solved against its diagonal factor at a time by
# the panel factorizations, and rows of a block converted to the
# right-hand side's dtype at a time by a solve of a wider right-hand side
# (fp64 against an fp32 factor): each bounds a temporary to (rows, block
# width) beside the factor.
_PANEL_ROWS = 16384
_WIDE_ROWS = 4096


class BlockLowerTriangular:
    """A lower-triangular (n, n) factor stored as triangular column blocks:
    block k is the (n - starts[k], starts[k + 1] - starts[k]) tensor
    L[starts[k]:, starts[k]:starts[k + 1]], the strict upper triangle of
    its leading square zero. The dense n x n tensor never exists: the
    blocks hold ~n^2/2 elements. The JAX package's class, with the layout
    its checkpoints write (`l_block_starts`, `l_block_{i}`).

    The blocks may also be numpy arrays (`convert.posterior_to_numpy`);
    `diagonal` and `to_dense` take tensors."""

    def __init__(self, blocks, starts, n):
        self.blocks = list(blocks)
        self.starts = tuple(int(s) for s in starts)
        self.n = int(n)
        if (len(self.starts) != len(self.blocks) + 1 or not self.blocks
                or self.starts[0] != 0 or self.starts[-1] != self.n
                or any(tuple(b.shape) != (self.n - s, e - s)
                       for b, s, e in zip(self.blocks, self.starts,
                                          self.starts[1:]))):
            raise ValueError(
                f"blocks {[tuple(b.shape) for b in self.blocks]} do not tile "
                f"an ({n}, {n}) factor at starts {self.starts}")

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    def spans(self):
        """(start, end, block) of every block, in order."""
        return zip(self.starts, self.starts[1:], self.blocks)

    def diagonal(self) -> torch.Tensor:
        return torch.cat([b[:b.shape[1]].diagonal() for b in self.blocks])

    def to_dense(self) -> torch.Tensor:
        """The (n, n) lower-triangular tensor."""
        out = self.blocks[0].new_zeros((self.n, self.n))
        for s, e, b in self.spans():
            out[s:, s:e] = b
        return out


def column_blocks(l: torch.Tensor, width: int) -> BlockLowerTriangular:
    """A dense lower-triangular (n, n) tensor as column blocks of `width`
    columns: views, no copy."""
    n = l.shape[0]
    starts = list(range(0, n, int(width))) + [n]
    return BlockLowerTriangular([l[s:, s:e] for s, e in zip(starts,
                                                            starts[1:])],
                                starts, n)


def _factor_panel(col: torch.Tensor) -> int:
    """Factor a column panel in place: col (rows >= w, w) holds the updated
    K[s:, s:e]; its leading square becomes L_kk (strict upper triangle
    zeroed; only its lower triangle is read) and the rows below become
    col[w:] L_kk^-T, solved _PANEL_ROWS rows at a time. Returns the
    diagonal factor's info (0: positive definite)."""
    w = col.shape[1]
    lkk, info = torch.linalg.cholesky_ex(col[:w])
    if int(info):
        return int(info)
    col[:w] = lkk
    for r in range(w, col.shape[0], _PANEL_ROWS):
        rows = col[r:r + _PANEL_ROWS]
        rows.copy_(torch.linalg.solve_triangular(lkk.mT, rows, upper=True,
                                                 left=False))
    return 0


def fused_panel_cholesky(panel_fn, n: int, dtype, block_size: int = 512,
                         layout: str = "inplace",
                         device="cpu"):
    """Left-looking blocked Cholesky of a matrix that is never materialized:
    `panel_fn(s, e, out)` writes K[s:, s:e] (ridge included) into `out`,
    an (n - s, e - s) tensor with contiguous rows that is the factor's own
    storage; the panel is then updated by the finished columns
    (`addmm_` in place, n^3/3 flops in all) and factored. For the GP fit
    the Gram kernels write the panels, so K + rI never exists.

    layout='inplace': one (n, n) tensor, the panel update one tall product
    L[s:, :s] L[s:e, :s]^T. 'blocks': the factor as a
    `BlockLowerTriangular` of (n - s, e - s) blocks, each updated by one
    product per finished block; ~n^2/2 elements. 'columns': the blocks
    assembled into one (n, n) tensor at the end.

    A diagonal square that is not positive definite raises FactorError
    ('fit', the global failing order s + info) after the factor's storage
    is dropped."""
    if layout not in ("inplace", "columns", "blocks"):
        raise ValueError(
            f"layout must be 'inplace', 'columns' or 'blocks', got {layout!r}")
    starts = list(range(0, n, int(block_size))) + [n]
    if layout == "inplace":
        l = torch.zeros((n, n), dtype=dtype, device=device)
        for s, e in zip(starts, starts[1:]):
            col = l[s:, s:e]
            panel_fn(s, e, col)
            if s:
                col.addmm_(l[s:, :s], l[s:e, :s].mT, alpha=-1)
            info = _factor_panel(col)
            if info:
                l = col = None        # the traceback keeps this frame
                raise FactorError("fit", s + info, n, dtype)
        return l
    blocks = []
    for k, (s, e) in enumerate(zip(starts, starts[1:])):
        with span("exact.block", block=k, rows=n - s, width=e - s,
                  updates=k, solves=len(range(e - s, n - s, _PANEL_ROWS))):
            col = torch.empty((n - s, e - s), dtype=dtype, device=device)
            with span("exact.block.gram"):
                panel_fn(s, e, col)
            with span("exact.block.update"):
                for js, blk in zip(starts, blocks):
                    col.addmm_(blk[s - js:], blk[s - js:e - js].mT,
                               alpha=-1)
            with span("exact.block.factor"):
                info = _factor_panel(col)
            if info:
                blocks = col = None
                raise FactorError("fit", s + info, n, dtype)
        blocks.append(col)
    bf = BlockLowerTriangular(blocks, starts, n)
    return bf if layout == "blocks" else bf.to_dense()


def blocked_cholesky(a: torch.Tensor, block_size: int = 512) -> torch.Tensor:
    """Right-looking blocked Cholesky of a dense matrix, reading its lower
    triangle only (a Gram whose strict upper triangle is garbage is
    factored as its lower triangle says): per panel the diagonal factor,
    the panel below solved against it, and the lower block columns to its
    right updated in place. Returns a new lower-triangular tensor; raises
    FactorError ('fit') where the JAX function returns NaN."""
    n = a.shape[0]
    b = int(block_size)
    l = a.clone()
    for s in range(0, n, b):
        e = min(s + b, n)
        info = _factor_panel(l[s:, s:e])
        if info:
            l = None
            raise FactorError("fit", s + info, n, a.dtype)
        panel = l[e:, s:e]
        for js in range(e, n, b):
            je = min(js + b, n)
            l[js:, js:je].addmm_(panel[js - e:], panel[js - e:je - e].mT,
                                 alpha=-1)
    return torch.tril(l)


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def _rows_below(blk: torch.Tensor, w: int, dtype):
    """(offset, rows) over block rows w.. in `dtype`: one view when the
    dtype is the block's, else _WIDE_ROWS converted rows at a time."""
    if blk.dtype == dtype:
        if blk.shape[0] > w:
            yield w, blk[w:]
        return
    for r in range(w, blk.shape[0], _WIDE_ROWS):
        yield r, blk[r:r + _WIDE_ROWS].to(dtype)


def block_tri_solve_lower(bf: BlockLowerTriangular,
                          b: torch.Tensor) -> torch.Tensor:
    """L^-1 b for a column-block factor, by forward substitution in place on
    one copy of b (in b's dtype): per block x[s:e] = L_kk^-1 x[s:e], then
    x[e:] -= L[e:, s:e] x[s:e]. A b of a wider dtype than the blocks' is
    solved in its own, the blocks converted a bounded slice at a time."""
    x = b.clone(memory_format=torch.contiguous_format)
    for s, e, blk in bf.spans():
        w = e - s
        xk = x[s:e]
        xk.copy_(torch.linalg.solve_triangular(_as(blk[:w], x.dtype), xk,
                                               upper=False))
        for r, rows in _rows_below(blk, w, x.dtype):
            x[s + r:s + r + rows.shape[0]].addmm_(rows, xk, alpha=-1)
    return x


def block_tri_solve_lower_t(bf: BlockLowerTriangular,
                            b: torch.Tensor) -> torch.Tensor:
    """L^-T b for a column-block factor, by backward substitution in place:
    block k's rows below its square are the L^T row chunk the update needs,
    so no transposed copy is formed."""
    x = b.clone(memory_format=torch.contiguous_format)
    for s, e, blk in reversed(list(bf.spans())):
        w = e - s
        xk = x[s:e]
        for r, rows in _rows_below(blk, w, x.dtype):
            xk.addmm_(rows.mT, x[s + r:s + r + rows.shape[0]], alpha=-1)
        xk.copy_(torch.linalg.solve_triangular(_as(blk[:w], x.dtype).mT, xk,
                                               upper=True))
    return x


def blocked_tri_solve_lower(l: torch.Tensor, b: torch.Tensor,
                            block_size: int = 1024) -> torch.Tensor:
    """L^-1 b for a dense lower-triangular L, by the block substitution of
    `block_tri_solve_lower` over its column blocks (only L's lower
    triangle is read)."""
    return block_tri_solve_lower(column_blocks(l, block_size), b)


def blocked_tri_solve_lower_t(l: torch.Tensor, b: torch.Tensor,
                              block_size: int = 1024) -> torch.Tensor:
    """L^-T b for a dense lower-triangular L, blocked like
    `blocked_tri_solve_lower`."""
    return block_tri_solve_lower_t(column_blocks(l, block_size), b)


def block_cholesky_append_rows(bf: BlockLowerTriangular, k21: torch.Tensor,
                               k22: torch.Tensor) -> BlockLowerTriangular:
    """`cholesky_append_rows` for a column-block factor: every block gains
    its m rows of L21 and one (m, m) block L22 is added; still no dense
    n x n. K22 must hold its ridge. The new blocks are new tensors (the
    factor appended to is not modified), made one at a time. Raises
    FactorError ('extend') where the Schur complement is not positive
    definite."""
    n, m = bf.n, k22.shape[0]
    if k21.shape != (m, n) or k22.shape != (m, m):
        raise ValueError(f"shapes do not form an append to an ({n}, {n}) "
                         f"factor: K21 {tuple(k21.shape)}, K22 "
                         f"{tuple(k22.shape)}")
    l21t = block_tri_solve_lower(bf, k21.mT)                  # (n, m)
    l22, info = torch.linalg.cholesky_ex(k22 - l21t.mT @ l21t)
    if int(info):
        raise FactorError("extend", n + int(info), n + m, bf.dtype)
    blocks = [torch.cat([blk, l21t[s:e].mT]) for s, e, blk in bf.spans()]
    blocks.append(l22)
    return BlockLowerTriangular(blocks, bf.starts + (n + m,), n + m)
