"""Baseline training loops. Port of `nngp_tpu/baselines/trainer.py`.

  - labels for the classification head are cardinality magnitude classes
    idx = ceil(log10(2^y)) capped at max_classes-1;
  - multi-task loss = MSE + coeff * NLL;
  - uncertainty functions entropy/confident/margin/random/consist;
  - Adam with coupled L2 + a staircase exponential LR decay stepped every
    `decay_patience` epochs (counted in optimizer steps).

Each epoch is a loop of minibatch steps over device-resident data; the
minibatch order is a host-side numpy permutation per epoch from
`np.random.default_rng(seed)`, the same stream as the JAX trainers', so with
the same initial parameters (`init=`) training follows the JAX package step
for step. The epoch's loss is summed on the device and read back once per
epoch, and only when `verbose` is given.

Every trainer takes `device` ("cuda" unless the caller asks for the CPU; no
fallback) and returns the trained model, an `nn.Module` on that device that
takes raw features (wrapped in `StandardizedModel` when standardizing). The
sklearn baselines run on the host and import sklearn when called.
"""

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from nngp_tpu_torch.models.baselines import (DeepEnsemble, MCDropoutModel,
                                             MLPDensityRegressor,
                                             MultiTaskMLP, gaussian_nll,
                                             multitask_loss)
from nngp_tpu_torch.utils.device import resolve_device


def magnitude_class(y, max_classes: int = 10, label_base: float = 10.0):
    """idx = ceil(log_base(2^y)) capped, vectorized over log2-card labels."""
    y = np.asarray(y, dtype=np.float64).ravel()
    idx = np.ceil(y * np.log(2.0) / np.log(label_base))
    idx = np.clip(idx, None, max_classes - 1)
    return idx.astype(np.int32)


def compute_uncertainty(kind: str, log_probs, reg_output, rng=None):
    """Classification-head uncertainty, on host arrays."""
    probs = np.exp(np.asarray(log_probs))
    reg = np.asarray(reg_output).ravel()
    if kind == "entropy":
        p = np.clip(probs, 1e-12, 1.0)
        return -np.sum(p * np.log(p), axis=-1)
    if kind == "confident":
        return 1.0 - np.max(probs, axis=-1)
    if kind == "margin":
        s = np.sort(probs, axis=-1)
        return s[:, -1] - s[:, -2]
    if kind == "random":
        rng = np.random.default_rng() if rng is None else rng
        return rng.random(reg.shape[0])
    if kind == "consist":
        reg_mag = np.ceil(np.log10(np.power(2.0, reg)))
        cla_mag = np.argmax(probs, axis=-1)
        return np.power(reg_mag - cla_mag, 2)
    raise ValueError(f"Unsupported uncertainty function {kind!r}")


def _optimizer(params, lr, weight_decay, decay_factor, decay_every_steps):
    """(Adam, per-step scheduler). Coupled L2: wd * param is added to the
    gradient before the Adam moment normalization (AdamW would decay after:
    a different optimizer). The LR is lr * decay_factor^(step //
    decay_every_steps); eps 1e-8 sits outside the sqrt."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=decay_every_steps,
                                            gamma=decay_factor)
    return opt, sched


def _epoch_perm(n, batch_size, rng):
    """Permutation padded (wrap-around) to a whole number of batches,
    reshaped to (num_batches, batch_size)."""
    perm = rng.permutation(n)
    nb = math.ceil(n / batch_size)
    pad = nb * batch_size - n
    if pad:
        perm = np.concatenate([perm, perm[:pad]])
    return perm.reshape(nb, batch_size)


def _fit(model: nn.Module, loss_fn: Callable, x, y_tuple, epochs, batch_size,
         lr, weight_decay, decay_factor, decay_patience, seed=0, verbose=None,
         per_epoch: Optional[Callable] = None):
    """Minibatch Adam over device tensors x and y_tuple. loss_fn(xb, *yb)
    returns the batch loss; with `per_epoch`, per_epoch(num_batches) returns
    a tensor whose i-th slice is passed to loss_fn as a last argument (the
    epoch's dropout masks)."""
    n = x.shape[0]
    steps_per_epoch = max(1, math.ceil(n / batch_size))
    opt, sched = _optimizer(list(model.parameters()), lr, weight_decay,
                            decay_factor, decay_patience * steps_per_epoch)
    rng = np.random.default_rng(seed)
    model.train()
    for epoch in range(epochs):
        batch_idx = torch.as_tensor(_epoch_perm(n, batch_size, rng),
                                    device=x.device)
        extra = per_epoch(batch_idx.shape[0]) if per_epoch else None
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        for i, idx in enumerate(batch_idx):
            args = [x[idx], *(yy[idx] for yy in y_tuple)]
            if extra is not None:
                args.append(extra[i])
            loss = loss_fn(*args)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            sched.step()
            total += loss.detach()
        if verbose:
            verbose(f"{epoch}-th Epochs: Train Loss={float(total):.4f}")
    model.eval()
    return model


class StandardizedModel(nn.Module):
    """Input-standardizing wrapper around a baseline model: the same call
    and `.predict(x, ...)` surface, with x mapped through the train-set
    (mean, std) first.

    Raw features are [0, 1000] range slots and 2^chunk packed integers. At
    forest scale that degenerates the Gaussian-NLL heads: the variance head
    absorbs the error of a collapsed mean head. Standardization is therefore
    the trainers' default; standardize=False restores the raw behaviour."""

    def __init__(self, model: nn.Module, loc, scale):
        super().__init__()
        self.model = model
        self.register_buffer("loc", loc)
        self.register_buffer("scale", scale)

    def _scaled(self, x):
        x = torch.as_tensor(x, dtype=self.loc.dtype, device=self.loc.device)
        return (x - self.loc) / self.scale

    def forward(self, x, *args, **kw):
        return self.model(self._scaled(x), *args, **kw)

    def predict(self, x, *args, **kw):
        return self.model.predict(self._scaled(x), *args, **kw)


def _standardize(x, standardize):
    """(x_scaled, wrapper_fn): wrapper_fn wraps a model so that it takes raw
    features. The std is the population std (ddof 0), as `jnp.std`; without
    standardizing the wrapper's map is the identity (loc 0, scale 1)."""
    if standardize:
        loc = torch.mean(x, dim=0)
        scale = torch.std(x, dim=0, correction=0) + 1e-6
    else:
        loc, scale = torch.zeros_like(x[0]), torch.ones_like(x[0])
    return (x - loc) / scale, lambda model: StandardizedModel(model, loc,
                                                              scale)


def _setup(x_train, y_train, device, standardize, seed):
    """(device, x, y, wrap, init generator): fp32 tensors on the device;
    the generator that draws the initial weights lives on the CPU."""
    device = resolve_device(device)
    x = torch.as_tensor(x_train, dtype=torch.float32,
                        device=device)
    y = torch.as_tensor(y_train, dtype=torch.float32,
                        device=device)
    x, wrap = _standardize(x, standardize)
    return device, x, y, wrap, torch.Generator().manual_seed(seed)


def _place(model, init, device):
    if init is not None:
        model.load_state_dict(init)
    return model.to(device)


def train_multitask(x_train, y_train, num_hid=256, max_classes=10,
                    epochs=40, batch_size=128, lr=1e-3, weight_decay=8e-5,
                    decay_factor=0.85, decay_patience=10, coeff=1.0,
                    seed=0, verbose=None, standardize=True, device="cuda",
                    init=None):
    """MultiTaskMLP trainer. `init` is a state_dict that replaces the seeded
    initial parameters (every trainer takes it)."""
    device, x, y, wrap, gen = _setup(x_train, y_train, device, standardize,
                                     seed)
    labels = torch.as_tensor(magnitude_class(y_train, max_classes),
                             device=device)
    model = _place(MultiTaskMLP(x.shape[1], hid_ch=num_hid,
                                cla_out_ch=max_classes, generator=gen),
                   init, device)

    def loss_fn(xb, yb, lb):
        reg, log_probs = model(xb)
        return multitask_loss(reg, log_probs, yb, lb, coeff=coeff)

    _fit(model, loss_fn, x, (y, labels), epochs, batch_size, lr,
         weight_decay, decay_factor, decay_patience, seed, verbose)
    return wrap(model)


def train_density(x_train, y_train, num_hid=256, epochs=40, batch_size=128,
                  lr=1e-3, weight_decay=8e-5, decay_factor=0.85,
                  decay_patience=10, seed=0, verbose=None, standardize=True,
                  device="cuda", init=None):
    """Single MLPDensityRegressor with Gaussian NLL."""
    device, x, y, wrap, gen = _setup(x_train, y_train, device, standardize,
                                     seed)
    model = _place(MLPDensityRegressor(x.shape[1], hid_ch=num_hid,
                                       generator=gen), init, device)

    def loss_fn(xb, yb):
        mu, s = model(xb)
        return gaussian_nll(yb, mu, s)

    _fit(model, loss_fn, x, (y,), epochs, batch_size, lr, weight_decay,
         decay_factor, decay_patience, seed, verbose)
    return wrap(model)


def train_mc_dropout(x_train, y_train, num_hid=256, dropout=0.5,
                     num_samples=100, epochs=40, batch_size=128, lr=1e-3,
                     weight_decay=8e-5, decay_factor=0.85, decay_patience=10,
                     seed=0, verbose=None, standardize=True, device="cuda",
                     init=None):
    """MCDropout trainer with plain MSE on the stochastic forward (the
    model's NLL loss is defined and not used, as in the JAX package). The
    dropout masks of an epoch are drawn at once from a generator on the
    device, seeded with `seed`."""
    device, x, y, wrap, gen = _setup(x_train, y_train, device, standardize,
                                     seed)
    model = _place(MCDropoutModel(x.shape[1], hid_ch=num_hid,
                                  dropout=dropout, num_samples=num_samples,
                                  generator=gen), init, device)
    mask_gen = torch.Generator(device=device).manual_seed(seed)

    def loss_fn(xb, yb, keep):
        mu, _ = model(xb, keep=keep)
        return torch.mean((mu - yb) ** 2)

    _fit(model, loss_fn, x, (y,), epochs, batch_size, lr, weight_decay,
         decay_factor, decay_patience, seed, verbose,
         per_epoch=lambda nb: model.keep_mask((nb, batch_size, num_hid),
                                              mask_gen))
    return wrap(model)


def train_deep_ensemble(x_train, y_train, num_models=5, num_hid=256,
                        epochs=40, batch_size=128, lr=1e-3, weight_decay=8e-5,
                        decay_factor=0.85, decay_patience=10, seed=0,
                        verbose=None, standardize=True, device="cuda",
                        init=None):
    """Deep ensemble: all members train in one batched program, every
    member on the same minibatches."""
    device, x, y, wrap, gen = _setup(x_train, y_train, device, standardize,
                                     seed)
    ens = _place(DeepEnsemble(x.shape[1], num_models=num_models,
                              hid_ch=num_hid, generator=gen), init, device)
    _fit(ens, ens.loss, x, (y,), epochs, batch_size, lr, weight_decay,
         decay_factor, decay_patience, seed, verbose)
    return wrap(ens)


def train_mlp_regressor(x_train, y_train, num_hid=256, epochs=40,
                        batch_size=128, lr=1e-3, weight_decay=8e-5,
                        seed=0, verbose=None):
    """sklearn MLPRegressor behind a StandardScaler pipeline (same rationale
    as StandardizedModel). Host-side; requires scikit-learn."""
    from sklearn import neural_network
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    reg = make_pipeline(StandardScaler(), neural_network.MLPRegressor(
        hidden_layer_sizes=num_hid, activation="relu", solver="adam",
        alpha=weight_decay, batch_size=batch_size, learning_rate="constant",
        learning_rate_init=lr, power_t=0.5, max_iter=epochs, shuffle=True,
        random_state=seed))
    reg.fit(np.asarray(x_train), np.asarray(y_train).ravel())
    return reg


def sklearn_gp_train_and_test(x_train, y_train, x_test):
    """sklearn exact-GP baseline. Host-side; requires scikit-learn."""
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import RBF
    gp = GaussianProcessRegressor(kernel=RBF(), random_state=0)
    gp.fit(np.asarray(x_train), np.asarray(y_train).ravel())
    return gp.predict(np.asarray(x_test), return_std=True)


def krr_train_and_test(x_train, y_train, x_test, alpha=1.0):
    """Kernel-ridge baseline. Host-side; requires scikit-learn."""
    from sklearn.kernel_ridge import KernelRidge
    clf = KernelRidge(alpha=alpha)
    clf.fit(np.asarray(x_train), np.asarray(y_train).ravel())
    return clf.predict(np.asarray(x_test))


def xgb_train_and_test(x_train, y_train, x_test, n_estimators=32, seed=123,
                       allow_sklearn_fallback=True):
    """Gradient-boosted-tree baseline: XGBRegressor with tree_method='hist',
    grow_policy='lossguide', n_estimators=32 when xgboost is installed.
    Where it is not, by default the branch falls back to sklearn's
    HistGradientBoostingRegressor, the same algorithm family (histogram-
    binned leaf-wise GBT, squared-error objective) with the hyperparameters
    mapped (n_estimators -> max_iter boosting rounds, seed -> random_state;
    early stopping off to match XGB's fixed round count). Pass
    allow_sklearn_fallback=False to require real xgboost."""
    try:
        import xgboost as xgb
    except ImportError as e:
        if not allow_sklearn_fallback:
            raise RuntimeError(
                "xgboost is not installed in this environment; install it "
                "to run the XGB baseline, or use the sklearn "
                "HistGradientBoostingRegressor fallback "
                "(allow_sklearn_fallback=True)") from e
        from sklearn.ensemble import HistGradientBoostingRegressor
        reg = HistGradientBoostingRegressor(
            loss="squared_error", max_iter=n_estimators,
            early_stopping=False, random_state=seed)
        reg.fit(np.asarray(x_train), np.asarray(y_train).ravel())
        return reg.predict(np.asarray(x_test))
    reg = xgb.XGBRegressor(objective="reg:squarederror", tree_method="hist",
                           grow_policy="lossguide",
                           n_estimators=n_estimators, seed=seed)
    reg.fit(np.asarray(x_train), np.asarray(y_train).ravel())
    return reg.predict(np.asarray(x_test))
