"""The exact tier in its column-block layout: a fit is `gp.fit_gp` with no
padding, of a window above the dense layout's cap, whose factor is
column blocks (`ops.linalg.BlockLowerTriangular`); judged by its own
served answers at probe rows against the column-block reference's fp64
exact posterior of the same rows, worked out from the lines once the
program's posterior is freed (the two factors do not fit the card
together at the cell's size)."""

import gc

from portbench.reference import exact_blocks as ref
from portbench.reference import judge
from portbench.tiers import kernel_spec


def fit(config, device):
    from nngp_tpu_torch.gp import fit_gp
    from nngp_tpu_torch.ops.linalg import BlockLowerTriangular

    spec = kernel_spec(config)

    def fit(x, y):
        post = fit_gp(spec, x, y, diag_reg=config["diag_reg"],
                      get=config["get"], device=str(device))
        # the cell would otherwise measure another layout than it names
        if not isinstance(post.l, BlockLowerTriangular):
            raise TypeError(
                f"the fit of {len(x)} rows kept its factor as "
                f"{type(post.l).__name__}, not as column blocks")
        return post
    return fit


def judge_fit(config, held, x, y, xp):
    """The gaps of the fit in `held`, a list holding the posterior alone,
    of rows x (n, d) and labels y (n,) at the probe rows xp: fp64 tensors
    on the device. The posterior's answers come first; then it is taken
    out of `held` and dropped, and the device's cache emptied, before the
    reference is built."""
    import torch

    dtype = getattr(torch, config["dtype"])
    post = held.pop()
    mean, std = post.predict_mean_std(xp.to(dtype))
    del post
    gc.collect()
    if xp.device.type == "cuda":
        torch.cuda.empty_cache()
    want = ref.predict(config, ref.fit(config, x, y), xp)
    return judge.gaps(mean.reshape(-1), std.reshape(-1), *want)
