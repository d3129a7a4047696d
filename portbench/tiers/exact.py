"""The exact tier: a fit is `gp.fit_gp` (padded to `pad_to` storage rows
where the configuration sets it), judged by its own served answers at
probe rows against the reference's fp64 exact posterior of the same rows,
worked out from the lines."""

from portbench.reference import exact as ref
from portbench.reference import judge
from portbench.tiers import kernel_spec


def fit(config, device):
    from nngp_tpu_torch.gp import fit_gp

    spec = kernel_spec(config)

    def fit(x, y):
        return fit_gp(spec, x, y, diag_reg=config["diag_reg"],
                      get=config["get"], pad_to=config.get("pad_to"),
                      device=str(device))
    return fit


def judge_fit(config, post, x, y, xp):
    """The gaps of the fit `post` of rows x (n, d) and labels y (n,) at
    the probe rows xp: fp64 tensors on the device."""
    import torch

    dtype = getattr(torch, config["dtype"])
    mean, std = post.predict_mean_std(xp.to(dtype))
    want = ref.predict(config, ref.fit(config, x, y), xp)
    return judge.gaps(mean.reshape(-1), std.reshape(-1), *want)
