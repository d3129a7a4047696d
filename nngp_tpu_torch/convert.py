"""Carry kernel specs and posterior state between `nngp_tpu` (JAX) and this
package. Works on attributes and numpy arrays only, so it never imports
jax: a JAX posterior's arrays are handed over as numpy
(`np.asarray(post.l)`, ...). A column-block factor (the JAX package's
`BlockLowerTriangular`, or this package's) travels as its blocks and
starts: any object with `blocks`, `starts` and `n` is taken for one.

A distributed posterior travels as the JAX package's distributed
checkpoint holds it: whole arrays in block-cyclic storage order, with the
layout (block size, real row count) beside them; each rank keeps its own
rows (`distributed_from_numpy`).

A Nystrom posterior travels in the JAX package's field layout (the fields
of its `NystromPosterior`, the arrays of its checkpoints): with
moments='df64' the JAX package keeps each fp64 quantity as an fp32 (hi,
lo) pair, hi in the canonical field and lo in a `*_lo` tail, where this
package keeps one fp64 tensor. Going in, hi + lo is summed in fp64; going
out, the fp64 value is split as JAX's `_df_split64` splits it.
"""

import numpy as np
import torch

from nngp_tpu_torch.gp.nystrom import NystromPosterior
from nngp_tpu_torch.gp.posterior import GPPosterior
from nngp_tpu_torch.models.kernel_spec import Activation, Dense, KernelSpec
from nngp_tpu_torch.ops.linalg import BlockLowerTriangular
from nngp_tpu_torch.utils.device import resolve_device

STATE_KEYS = ("x_train", "y_train", "l", "alpha", "reg", "k_tt_nngp",
              "diag_reg", "input_scale", "n_real")


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
    (k_tt_nngp may be None; diag_reg and input_scale are numbers; l an
    array or a column-block factor, which stays one). A padded posterior's
    n_real (the JAX posterior's `int(post.n_real)`, a checkpoint's meta
    n_real) keeps it padded; None or absent, it is exact-shape."""
    device = torch.device(device)

    def tensor(name):  # a copy: the arrays may be read-only JAX views
        return torch.as_tensor(np.array(state[name]), device=device)

    def factor():
        l = state["l"]
        if not hasattr(l, "blocks"):
            return tensor("l")
        return BlockLowerTriangular(
            [torch.as_tensor(np.array(b), device=device) for b in l.blocks],
            l.starts, l.n)

    x_train = tensor("x_train")
    y_train = tensor("y_train")
    if y_train.dim() == 1:
        y_train = y_train[:, None]
    k_tt = state.get("k_tt_nngp")
    n_real = state.get("n_real")
    row_mask = None
    if n_real is not None:
        n_real = int(n_real)
        row_mask = x_train.new_zeros(x_train.shape[0])
        row_mask[:n_real] = 1.0
    return GPPosterior(
        x_train=x_train.contiguous(), y_train=y_train,
        l=factor(), alpha=tensor("alpha"), reg=tensor("reg"),
        k_tt_nngp=None if k_tt is None else tensor("k_tt_nngp"),
        spec=spec, get=get, diag_reg=float(state["diag_reg"]),
        input_scale=float(state["input_scale"]), n_real=n_real,
        row_mask=row_mask)


def posterior_to_numpy(post: GPPosterior) -> dict:
    """The posterior's state as numpy arrays and numbers (STATE_KEYS); a
    column-block factor as a BlockLowerTriangular of numpy blocks (its
    blocks, starts and n are what the JAX class takes)."""
    def arr(t):
        return None if t is None else t.detach().cpu().numpy()

    l = post.l
    if isinstance(l, BlockLowerTriangular):
        l = BlockLowerTriangular([arr(b) for b in l.blocks], l.starts, l.n)
    else:
        l = arr(l)
    return {
        "x_train": arr(post.x_train), "y_train": arr(post.y_train),
        "l": l, "alpha": arr(post.alpha), "reg": arr(post.reg),
        "k_tt_nngp": arr(post.k_tt_nngp), "diag_reg": float(post.diag_reg),
        "input_scale": float(post.input_scale), "n_real": post.n_real,
    }


# the Nystrom posterior's scalar state: the `nystrom` entry of a
# checkpoint's meta.json in the JAX package
NYSTROM_META = ("num_train", "input_scale", "precision", "rank_rtol",
                "panel_size", "finalize", "moments")
# fields that moments='df64' keeps in fp64 here and as (hi, lo) in JAX
_DF_FIELDS = {"c_raw": "c_lo", "b_w": "b_lo", "m1_w": "m1_lo",
              "w_solve": "w_solve_lo", "w_kmm": "w_kmm_lo"}


def df_split64(w64: np.ndarray):
    """fp64 -> (hi, lo) fp32 pair: hi = round(w), lo = round(w - hi)."""
    hi = np.asarray(w64, np.float32)
    lo = np.asarray(w64 - np.asarray(hi, np.float64), np.float32)
    return hi, lo


def nystrom_to_numpy(post: NystromPosterior):
    """(arrays, meta): the posterior in the JAX package's layout, as its
    `Estimator.save` writes it. An fp64 posterior is written with finalize
    'host' (the JAX package's device solve stage takes fp32 posteriors
    only; the two stages give the same model)."""
    def arr(t):
        return t.detach().cpu().numpy()

    arrs = {"x_m": arr(post.x_m), "ic": arr(post.ic),
            "beta_w": arr(post.beta_w), "reg": arr(post.reg),
            "diag_sum": arr(post.diag_sum.to(post.dtype))}
    if post.yty is not None:
        arrs["yty"] = arr(post.yty.to(post.dtype))
    for name, tail in _DF_FIELDS.items():
        t = getattr(post, name)
        if t is None:
            continue
        if post.moments == "df64":
            arrs[name], arrs[tail] = df_split64(arr(t.to(torch.float64)))
        else:
            arrs[name] = arr(t)
    finalize = post.finalize if post.dtype == torch.float32 else "host"
    meta = {"num_train": int(post.num_train),
            "input_scale": float(post.input_scale),
            "precision": post.precision, "rank_rtol": float(post.rank_rtol),
            "panel_size": int(post.panel_size), "finalize": finalize,
            "moments": post.moments}
    return arrs, meta


def nystrom_from_numpy(arrs, meta: dict, spec: KernelSpec, get: str,
                       diag_reg: float, device,
                       finalize=None) -> NystromPosterior:
    """A NystromPosterior on `device` from arrays and meta in the JAX
    layout (`nystrom_to_numpy`'s, or a JAX checkpoint's). A df64 field
    without its tail (checkpoints from before the tails) gets a zero
    tail, as the JAX package does. finalize overrides the meta's (where
    the solve stage runs is a property of the machine, not the model)."""
    device = resolve_device(device)
    moments = meta.get("moments", "fp32")
    mdt = torch.float64 if moments == "df64" else None

    def tensor(a, dtype=None):  # a copy: the arrays may be read-only views
        t = torch.as_tensor(np.array(a), device=device)
        return t if dtype is None else t.to(dtype)

    fields = {}
    for name, tail in _DF_FIELDS.items():
        if name not in arrs:
            fields[name] = None
            continue
        if moments == "df64":
            v = np.asarray(arrs[name], np.float64)
            if tail in arrs:
                v = v + np.asarray(arrs[tail], np.float64)
            fields[name] = tensor(v)
        else:
            fields[name] = tensor(arrs[name])
    return NystromPosterior(
        x_m=tensor(arrs["x_m"]).contiguous(), ic=tensor(arrs["ic"]),
        beta_w=tensor(arrs["beta_w"]), reg=tensor(arrs["reg"]),
        diag_sum=tensor(arrs["diag_sum"], mdt),
        yty=tensor(arrs["yty"], mdt) if "yty" in arrs else None,
        spec=spec, get=get, diag_reg=float(diag_reg),
        num_train=int(meta["num_train"]),
        input_scale=float(meta["input_scale"]),
        precision=meta.get("precision", "highest"),
        rank_rtol=float(meta["rank_rtol"]),
        panel_size=int(meta["panel_size"]),
        finalize=finalize or meta.get("finalize", "host"),
        moments=moments, **fields)


def distributed_from_numpy(arrs, spec: KernelSpec, get: str, mesh,
                           block_size: int, n_real: int,
                           input_scale: float = 1.0, g2e=None,
                           axis_name: str = "data"):
    """The port's DistributedPosterior from a JAX one's arrays: numpy
    x_storage, y_storage, l, alpha, reg and (get='ntk') k_tt, whole and in
    storage order (`np.asarray(post.l)`, or a distributed checkpoint's
    npz). Collective: every rank passes the same arrays and keeps its rows.
    The layout must fit this mesh: n tiles into p * block_size, and g2e,
    when given (the JAX posterior's), is `cyclic_storage_order(n,
    block_size, p)`."""
    from nngp_tpu_torch.parallel.cholesky import (_layout,
                                                  cyclic_storage_order)
    from nngp_tpu_torch.parallel.mesh import mesh_device, topology
    from nngp_tpu_torch.parallel.sharded import DistributedPosterior

    _, p, d = topology(mesh, axis_name)
    n = int(np.asarray(arrs["l"]).shape[0])
    b, _, m = _layout(n, p, int(block_size))
    order = cyclic_storage_order(n, b, p)
    if g2e is not None and not np.array_equal(np.asarray(g2e), order):
        raise ValueError("the arrays' storage order is not the cyclic order "
                         f"of n={n}, block_size={b} on a {p}-rank mesh")
    dev = mesh_device(mesh)

    def mine(name):  # a copy: the arrays may be read-only views
        a = np.array(np.asarray(arrs[name])[d * m:(d + 1) * m])
        return torch.as_tensor(a, device=dev).contiguous()

    y = mine("y_storage")
    return DistributedPosterior(
        x_storage=mine("x_storage"),
        y_storage=y if y.dim() == 2 else y[:, None], l=mine("l"),
        alpha=mine("alpha").reshape(m, -1),
        reg=torch.as_tensor(np.array(arrs["reg"]), device=dev),
        k_tt=mine("k_tt") if get == "ntk" else None, spec=spec, get=get,
        mesh=mesh, axis_name=axis_name, block_size=b, g2e=order,
        n_real=int(n_real), input_scale=float(input_scale))


def distributed_to_numpy(post):
    """(arrays, meta): a DistributedPosterior gathered into the JAX
    package's distributed checkpoint layout, the arrays in rank 0's host
    memory (None on the other ranks). Collective."""
    arrs = post.gather_state()
    meta = {"block_size": int(post.block_size),
            "axis_name": post.axis_name,
            "mesh_size": int(post.mesh.size()),
            "n_real": int(post.num_train),
            "input_scale": float(post.input_scale)}
    return arrs, meta


# ---------------------------------------------------------------- baselines
# JAX parameters of the baseline models, handed over as numpy (a flax
# `params` tree turned into nested dicts of arrays, with or without its
# top-level "params" key; the flat dict of `models/dkl.py` / `models/ski.py`;
# the three (1, 1) arrays of `models/gp_rbf.py`), to the port's state_dicts.
def _tensor(a, transpose=False):
    a = np.array(a)                   # a copy: the arrays may be read-only
    return torch.as_tensor(a.T.copy() if transpose else a)


def _inner(params: dict) -> dict:
    return params["params"] if "params" in params else params


def flax_dense_to_linear(dense: dict, prefix: str = "") -> dict:
    """A flax `Dense` ({"kernel": (in, out), "bias": (out,)}) as the
    `weight` (out, in) and `bias` of an `nn.Linear` named `prefix`."""
    return {f"{prefix}weight": _tensor(dense["kernel"], transpose=True),
            f"{prefix}bias": _tensor(dense["bias"])}


def _dense_state(tree: dict, names: dict) -> dict:
    """state_dict from flax Dense layers: names maps a flax layer name to
    the port's attribute name."""
    out = {}
    for flax_name, name in names.items():
        out.update(flax_dense_to_linear(tree[flax_name], f"{name}."))
    return out


def mlp_state(params: dict) -> dict:
    """`models.baselines.MLP` (and `models.mscn.MLPHead`) from flax."""
    return _dense_state(_inner(params), {"Dense_0": "fc1", "Dense_1": "fc2"})


def multitask_state(params: dict) -> dict:
    return _dense_state(_inner(params), {"Dense_0": "trunk", "Dense_1": "reg",
                                         "Dense_2": "cla"})


def density_state(params: dict) -> dict:
    """`MLPDensityRegressor` and `MCDropoutModel` (trunk, mu, sigma)."""
    return _dense_state(_inner(params), {"Dense_0": "trunk", "Dense_1": "mu",
                                         "Dense_2": "sigma"})


def deep_ensemble_state(params: dict) -> dict:
    """`DeepEnsemble` from the vmapped flax tree: every leaf has a leading
    member axis; kernels stay (member, in, out), biases become
    (member, 1, out)."""
    tree = _inner(params)
    out = {}
    for flax_name, name in (("Dense_0", "trunk"), ("Dense_1", "mu"),
                            ("Dense_2", "sigma")):
        out[f"w_{name}"] = _tensor(tree[flax_name]["kernel"])
        out[f"b_{name}"] = _tensor(tree[flax_name]["bias"])[:, None, :]
    return out


def set_conv_state(tree: dict, prefix: str) -> dict:
    """`SetConvolution` (Dense_0, Dense_1, ...) as `prefix`layers.i."""
    out = {}
    for i in range(len(tree)):
        out.update(flax_dense_to_linear(tree[f"Dense_{i}"],
                                        f"{prefix}layers.{i}."))
    return out


def _head_state(tree: dict, prefix: str = "head.") -> dict:
    return {f"{prefix}{k}": v for k, v in mlp_state(tree).items()}


def _mscn_family_state(params: dict, convs) -> dict:
    tree = _inner(params)
    out = _head_state(tree["_MLPHead_0"])
    for i, name in enumerate(convs):
        out.update(set_conv_state(tree[f"SetConvolution_{i}"], f"{name}."))
    return out


def mscn_state(params: dict) -> dict:
    return _mscn_family_state(params, ("pred_conv",))


def mscn_join_state(params: dict) -> dict:
    return _mscn_family_state(params, ("pred_conv", "join_conv"))


def mscn_multi_state(params: dict) -> dict:
    return _mscn_family_state(params, ("table_conv", "pred_conv",
                                       "join_conv"))


def lstm_step_state(cell: dict, prefix: str = "cell.") -> dict:
    """`LSTMStep` from a flax `OptimizedLSTMCell` tree: the input kernels
    `ii`, `ig`, `io` packed (i, g, o) along the output axis, with the one
    bias each gate has (stored under `hi`, `hg`, `ho`). The recurrent
    kernels, the forget gate's input kernel and its bias multiply the zero
    state and have no counterpart."""
    kernel = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"])
                             for g in "igo"], axis=1)
    bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in "igo"])
    return {f"{prefix}gates.weight": _tensor(kernel, transpose=True),
            f"{prefix}gates.bias": _tensor(bias)}


def tree_lstm_join_state(params: dict) -> dict:
    tree = _inner(params)
    out = _mscn_family_state(params, ("pred_conv", "join_conv"))
    out.update(lstm_step_state(tree["_LSTMStep_0"]["OptimizedLSTMCell_0"]))
    return out


def tree_lstm_multi_state(params: dict) -> dict:
    tree = _inner(params)
    out = _head_state(tree["head"])
    out.update(_dense_state(tree, {"op_nn": "op_nn", "meta_nn": "meta_nn"}))
    out.update(set_conv_state(tree["pred_conv"], "pred_conv."))
    out.update(lstm_step_state(tree["cell"]))
    return out


def flat_params_from_numpy(params: dict, device="cpu", dtype=None) -> dict:
    """The flat parameter dict of `models/dkl.py`, `models/ski.py` or
    `models/gp_rbf.py` (same names and shapes in both packages) as tensors
    on `device`."""
    out = {k: _tensor(v).to(device) for k, v in params.items()}
    return out if dtype is None else {k: v.to(dtype) for k, v in out.items()}


def flat_params_to_numpy(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
