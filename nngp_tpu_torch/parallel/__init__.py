"""The multi-device exact tier on `torch.distributed` (PyTorch counterpart
of `nngp_tpu/parallel/`): a `DeviceMesh` with one "data" dimension, the
row-sharded Gram, the block-cyclic distributed Cholesky and solves, and
`DistributedPosterior`. Every function is collective (SPMD): each rank
calls it with the same arguments and keeps its own rows."""

from nngp_tpu_torch.parallel.mesh import make_mesh
from nngp_tpu_torch.parallel.sharded import (
    DistributedPosterior,
    distributed_fit,
    sharded_gram,
    sharded_fit,
    sharded_predict_mean_std,
)
from nngp_tpu_torch.parallel.cholesky import (
    cyclic_storage_order,
    distributed_cholesky,
    distributed_tri_solve_lower,
    distributed_tri_solve_lower_t,
    distributed_cho_solve,
)

__all__ = [
    "make_mesh",
    "DistributedPosterior",
    "distributed_fit",
    "sharded_gram",
    "sharded_fit",
    "sharded_predict_mean_std",
    "cyclic_storage_order",
    "distributed_cholesky",
    "distributed_tri_solve_lower",
    "distributed_tri_solve_lower_t",
    "distributed_cho_solve",
]
