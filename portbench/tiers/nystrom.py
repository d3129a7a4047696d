"""The Nystrom tier: a fit is `gp.fit_nystrom` at the configuration's
inducing rows, precision, moments and finalize. A fit is judged by its
state (x_m, w_solve, c_raw, b_w, ic, beta_w, reg, input_scale), which the
reference reads only to judge it:

- mean_gap, std_gap and their medians, at probe rows: the fit's
  posterior against the reference's fp64 fit of the same rows, worked
  out from the lines. The fp32 moments of an ill-conditioned C + rI
  leave sound fits tenths of a log2 off here, so these catch gross
  faults only; each stage is also checked by itself:
- whiten_resid: the fit's whitening basis against the reference's fp64
  K_mm of its own inducing rows (`reference.nystrom.whiten_residual`);
- c_gap, b_gap: the fit's moments C = psi^T psi and b = psi^T y against
  the reference's fp64 ones taken on from the fit's own basis
  (gram_cross, both 3xTF32 kernels), max |gap| / max |reference|;
- finalize_gap, at probe rows: the widest gap of the fit's posterior mean
  against that of the fp64 solve of its own moments and ridge (its std
  is left out: neither the control nor a fault moves it).
"""

from types import SimpleNamespace

import torch

from portbench.reference import judge
from portbench.reference import nystrom as ref
from portbench.tiers import kernel_spec


def fit(config, device):
    from nngp_tpu_torch.gp import fit_nystrom

    spec = kernel_spec(config)

    def fit(x, y):
        return fit_nystrom(
            spec, x, y, num_inducing=config["num_inducing"],
            diag_reg=config["diag_reg"], get=config["get"],
            seed=config["inducing_seed"], panel_size=config["panel_rows"],
            rank_rtol=config["rank_rtol"], precision=config["precision"],
            moments=config["moments"], finalize=config["finalize"],
            device=str(device))
    return fit


def judge_fit(config, post, x, y, xp):
    """The compared numbers of the fit `post` of rows x (n, d) and labels
    y (n,) at the probe rows xp: fp64 tensors of the reference's own
    encoding, on the device."""
    got = ref.predict(config, post, xp)
    out = judge.gaps(*got, *ref.predict(config, ref.fit(config, x, y), xp))
    out["whiten_resid"] = ref.whiten_residual(config, x, post)
    moments = ref.fit(config, x, y, w=post.w_solve.to(torch.float64),
                      scale=float(post.input_scale))
    out["c_gap"] = judge.rel_gap(post.c_raw, moments.c_raw)
    out["b_gap"] = judge.rel_gap(post.b_w, moments.b_w)
    ic, beta = ref.finalize(post.c_raw, post.b_w, post.reg)
    solved = SimpleNamespace(x_m=post.x_m, w_solve=post.w_solve, ic=ic,
                             beta_w=beta, reg=post.reg,
                             input_scale=post.input_scale)
    out["finalize_gap"] = judge.gaps(
        *got, *ref.predict(config, solved, xp))["mean_gap"]
    return out
