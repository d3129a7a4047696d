"""Active learning for the finite-width baselines. Port of
`nngp_tpu/active/baseline_learner.py`; the numpy selection is copied as it
is.

The DNN / MCDropout active learner acquires per round by
classification-head uncertainty (entropy/confident/margin/random/consist) or
MC-dropout predictive std, the deep-ensemble learner by ensemble mixture
variance. Each round merges the selected pool points into the train set and
retrains for `active_epochs`.

The trained model holds its own parameters, so `active_train` returns
(model, history) where the JAX learner returns (model, params, history).
"""

import numpy as np
import torch

from nngp_tpu_torch.baselines.trainer import (
    compute_uncertainty,
    train_deep_ensemble,
    train_mc_dropout,
    train_multitask,
)
from nngp_tpu_torch.eval.qerror import PredictionStatistics
from nngp_tpu_torch.utils.device import resolve_device


class BaselineActiveLearner:
    def __init__(self, model_type: str = "DNN", uncertainty: str = "entropy",
                 budget: int = 1000, active_iters: int = 3,
                 biased_sample: bool = True, num_hid: int = 256,
                 max_classes: int = 10, epochs: int = 40,
                 active_epochs: int = 20, seed: int = 10, device="cuda",
                 **train_kw):
        if model_type not in ("DNN", "MCDropout", "DeepEnsemble"):
            raise ValueError(f"Unsupported model type {model_type!r}")
        self.model_type = model_type
        self.uncertainty = uncertainty
        self.budget = budget
        self.active_iters = active_iters
        self.biased_sample = biased_sample
        self.num_hid = num_hid
        self.max_classes = max_classes
        self.epochs = epochs
        self.active_epochs = active_epochs
        self.seed = seed
        self.device = resolve_device(device)
        self.train_kw = train_kw
        self.rng = np.random.default_rng(seed)
        self.pred_stat = PredictionStatistics()

    def _train(self, x, y, epochs, verbose=None):
        kw = dict(num_hid=self.num_hid, epochs=epochs, seed=self.seed,
                  verbose=verbose, device=self.device, **self.train_kw)
        if self.model_type == "DNN":
            return train_multitask(x, y, max_classes=self.max_classes, **kw)
        if self.model_type == "MCDropout":
            return train_mc_dropout(x, y, **kw)
        return train_deep_ensemble(x, y, **kw)

    def _predict(self, model, x):
        """(mean, uncertainty) on the pool, as host arrays."""
        def host(t):
            return t.cpu().numpy().ravel()

        if self.model_type == "DNN":
            with torch.no_grad():
                reg, log_probs = model(x)
            unc = compute_uncertainty(self.uncertainty,
                                      log_probs.cpu().numpy(),
                                      reg.cpu().numpy(), rng=self.rng)
            return host(reg), np.asarray(unc)
        if self.model_type == "MCDropout":
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            mean, std = model.predict(x, gen)
        else:
            mean, std = model.predict(x)
        return host(mean), host(std)

    def select(self, uncertainty: np.ndarray) -> np.ndarray:
        num_pool = uncertainty.shape[0]
        num_select = min(self.budget, num_pool)
        if self.biased_sample:
            total = uncertainty.sum()
            p = (uncertainty / total if total > 0
                 else np.full(num_pool, 1.0 / num_pool))
            return self.rng.choice(num_pool, size=num_select, replace=False,
                                   p=p)
        return np.argsort(uncertainty)[-num_select:]

    def test(self, model, x_val, y_val, query_infos_val=None, printer=print):
        mean, _ = self._predict(model, x_val)
        errors = mean - np.asarray(y_val).ravel()
        mse = float(np.mean(errors ** 2))
        if printer:
            printer(f"Test MSE Loss:{mse}")
        self.pred_stat.get_prediction_details(
            errors, query_infos_val, partition_keys="num_predicates",
            printer=printer)
        return mse

    def active_train(self, x_train, y_train, x_pool, y_pool, x_val, y_val,
                     query_infos_val=None, printer=print):
        x_train, y_train = np.asarray(x_train), np.asarray(y_train)
        x_pool, y_pool = np.asarray(x_pool), np.asarray(y_pool)
        model = self._train(x_train, y_train, self.epochs, verbose=printer)
        history = [{"iter": -1, "num_train": len(x_train),
                    "val_mse": self.test(model, x_val, y_val,
                                         query_infos_val, printer)}]
        for i in range(self.active_iters):
            if x_pool.shape[0] == 0:
                break
            _, unc = self._predict(model, x_pool)
            sel = self.select(unc)
            if printer:
                printer(f"Active Iteration {i}: Selection {len(sel)}")
            x_train = np.concatenate([x_train, x_pool[sel]])
            y_train = np.concatenate([y_train, y_pool[sel]])
            keep = np.setdiff1d(np.arange(x_pool.shape[0]), sel)
            x_pool, y_pool = x_pool[keep], y_pool[keep]
            model = self._train(x_train, y_train, self.active_epochs,
                                verbose=printer)
            history.append({"iter": i, "num_train": len(x_train),
                            "val_mse": self.test(model, x_val, y_val,
                                                 query_infos_val, printer)})
        return model, history
