from nngp_tpu_torch.gp.hyperopt import (HyperoptResult,
                                        fit_kernel_hyperparams,
                                        select_kernel)
from nngp_tpu_torch.gp.nystrom import NystromPosterior, fit_nystrom
from nngp_tpu_torch.gp.posterior import (GPPosterior, fit_gp,
                                         select_diag_reg, solve_ridge)

__all__ = ["GPPosterior", "HyperoptResult", "NystromPosterior", "fit_gp",
           "fit_kernel_hyperparams", "fit_nystrom", "select_diag_reg",
           "select_kernel", "solve_ridge"]
