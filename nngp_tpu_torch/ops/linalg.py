"""Dense linear algebra around the Gram kernels (counterpart of
`nngp_tpu/ops/linalg.py`).

The dense append and the padded one are ported: the factor stays one
(n, n) tensor on an 80 GB card, so the column-block layout (`BlockLowerTriangular`,
`block_cholesky_append_rows`) and the fused panel factorizations, which
exist for a 16 GB chip, are not (ROADMAP, "Not to port"). These are
cuSOLVER/cuBLAS calls through `torch.linalg`, as they were XLA code in the
JAX package.
"""

import torch


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
