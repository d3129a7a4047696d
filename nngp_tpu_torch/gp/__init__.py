from nngp_tpu_torch.gp.posterior import GPPosterior, fit_gp, solve_ridge

__all__ = ["GPPosterior", "fit_gp", "solve_ridge"]
