"""Dense linear algebra around the Gram kernels (counterpart of
`nngp_tpu/ops/linalg.py`).

Only the dense append is ported: the factor stays one (n, n) tensor on an
80 GB card, so the column-block layout (`BlockLowerTriangular`,
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
