"""Carry kernel specs and posterior state between `nngp_tpu` (JAX) and this
package. Works on attributes and numpy arrays only, so it never imports
jax: a JAX posterior's arrays are handed over as numpy
(`np.asarray(post.l)`, ...).
"""

import numpy as np
import torch

from nngp_tpu_torch.gp.posterior import GPPosterior
from nngp_tpu_torch.models.kernel_spec import Activation, Dense, KernelSpec

STATE_KEYS = ("x_train", "y_train", "l", "alpha", "reg", "k_tt_nngp",
              "diag_reg", "input_scale")


def layers_from_jax(jax_layers):
    """Map `nngp_tpu.models.kernel_spec` Dense/Activation layers to this
    package's."""
    out = []
    for layer in jax_layers:
        kind = type(layer).__name__
        if kind == "Dense":
            out.append(Dense(int(layer.width), float(layer.w_std),
                             float(layer.b_std)))
        elif kind == "Activation":
            out.append(Activation(layer.name))
        else:
            raise TypeError(f"Unknown layer {layer!r}")
    return tuple(out)


def posterior_from_numpy(state: dict, spec: KernelSpec, get: str,
                         device) -> GPPosterior:
    """A GPPosterior on `device` from the arrays named in STATE_KEYS
    (k_tt_nngp may be None; diag_reg and input_scale are numbers)."""
    device = torch.device(device)

    def tensor(name):  # a copy: the arrays may be read-only JAX views
        return torch.as_tensor(np.array(state[name]), device=device)

    x_train = tensor("x_train")
    y_train = tensor("y_train")
    if y_train.dim() == 1:
        y_train = y_train[:, None]
    k_tt = state.get("k_tt_nngp")
    return GPPosterior(
        x_train=x_train.contiguous(), y_train=y_train,
        l=tensor("l"), alpha=tensor("alpha"), reg=tensor("reg"),
        k_tt_nngp=None if k_tt is None else tensor("k_tt_nngp"),
        spec=spec, get=get, diag_reg=float(state["diag_reg"]),
        input_scale=float(state["input_scale"]))


def posterior_to_numpy(post: GPPosterior) -> dict:
    """The posterior's state as numpy arrays and numbers (STATE_KEYS)."""
    def arr(t):
        return None if t is None else t.detach().cpu().numpy()

    return {
        "x_train": arr(post.x_train), "y_train": arr(post.y_train),
        "l": arr(post.l), "alpha": arr(post.alpha), "reg": arr(post.reg),
        "k_tt_nngp": arr(post.k_tt_nngp), "diag_reg": float(post.diag_reg),
        "input_scale": float(post.input_scale),
    }
