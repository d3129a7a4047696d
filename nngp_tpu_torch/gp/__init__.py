from nngp_tpu_torch.gp.posterior import (GPPosterior, fit_gp,
                                         select_diag_reg, solve_ridge)

__all__ = ["GPPosterior", "fit_gp", "select_diag_reg", "solve_ridge"]
