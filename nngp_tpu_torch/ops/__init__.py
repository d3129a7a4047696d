"""Gram kernels, their plain twins and the linear algebra around them."""

from nngp_tpu_torch.ops.gram import panel_gram, panel_symm_matmul
from nngp_tpu_torch.ops.linalg import (BlockLowerTriangular, FactorError,
                                       block_cholesky_append_rows,
                                       block_tri_solve_lower,
                                       block_tri_solve_lower_t,
                                       blocked_cholesky,
                                       blocked_tri_solve_lower,
                                       blocked_tri_solve_lower_t,
                                       fused_panel_cholesky)

__all__ = ["BlockLowerTriangular", "FactorError",
           "block_cholesky_append_rows", "block_tri_solve_lower",
           "block_tri_solve_lower_t", "blocked_cholesky",
           "blocked_tri_solve_lower", "blocked_tri_solve_lower_t",
           "fused_panel_cholesky", "panel_gram", "panel_symm_matmul"]
