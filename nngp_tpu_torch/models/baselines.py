"""Finite-width baseline models: the paper's DNN competitors as `torch.nn`
modules. Port of `nngp_tpu/models/baselines_flax.py`.

  MLP                 in -> hid -> relu -> out
  MultiTaskMLP        shared trunk; regression head + log-softmax
                      classification head over card-magnitude classes
  MLPDensityRegressor mu head + softplus(sigma)+1e-6 head, Gaussian NLL loss
  MCDropoutModel      always-on dropout; predictive mean/std from
                      `num_samples` stochastic forwards
  DeepEnsemble        5x MLPDensityRegressor; mixture mean and
                      std = sqrt(mean(sigma + mu^2) - mu_bar^2)

MC-dropout samples and ensemble members run as a leading batch axis (one
batched GEMM), as the JAX module vmaps them.

Initial weights follow the flax law (`Dense`: lecun-normal kernel, i.e. a
normal of variance 1/fan_in truncated at two standard deviations, and a zero
bias), drawn on the CPU from an explicit `torch.Generator`, so a seed gives
the same init whatever the device: the same law as the JAX package's, not
the same bits. Dropout masks come from a generator too and can be passed in.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides
# by it so that the truncated draw has the variance asked for
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Fill `weight` in place from flax's default `Dense` kernel law."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, mean=0.0, std=std, a=-2.0 * std,
                                     b=2.0 * std, generator=generator)


def dense(in_ch: int, out_ch: int,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """`nn.Linear` initialized as a flax `Dense`."""
    layer = nn.Linear(in_ch, out_ch)
    lecun_normal_(layer.weight, in_ch, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    def __init__(self, in_ch: int, hid_ch: int = 256, out_ch: int = 1,
                 generator=None):
        super().__init__()
        self.fc1 = dense(in_ch, hid_ch, generator)
        self.fc2 = dense(hid_ch, out_ch, generator)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class MultiTaskMLP(nn.Module):
    def __init__(self, in_ch: int, hid_ch: int = 256, reg_out_ch: int = 1,
                 cla_out_ch: int = 10, generator=None):
        super().__init__()
        self.trunk = dense(in_ch, hid_ch, generator)
        self.reg = dense(hid_ch, reg_out_ch, generator)
        self.cla = dense(hid_ch, cla_out_ch, generator)

    def forward(self, x):
        h = torch.relu(self.trunk(x))
        return self.reg(h), F.log_softmax(self.cla(h), dim=1)


def multitask_loss(reg, log_probs, y, classes, coeff: float = 1.0):
    """MSE + coeff * NLL of the magnitude class."""
    mse = torch.mean((reg - y) ** 2)
    nll = -torch.mean(torch.gather(log_probs, 1, classes[:, None].long()))
    return mse + coeff * nll


def gaussian_nll(y, mu, sigma_pos):
    """Gaussian NLL with sigma_pos the variance."""
    return torch.mean(0.5 * (torch.log(sigma_pos) + (y - mu) ** 2
                             / sigma_pos))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class MLPDensityRegressor(nn.Module):
    def __init__(self, in_ch: int, hid_ch: int = 256, generator=None):
        super().__init__()
        self.trunk = dense(in_ch, hid_ch, generator)
        self.mu = dense(hid_ch, 1, generator)
        self.sigma = dense(hid_ch, 1, generator)

    def forward(self, x):
        h = torch.relu(self.trunk(x))
        return self.mu(h), _softplus(self.sigma(h)) + 1e-6

    loss = staticmethod(gaussian_nll)


class MCDropoutModel(nn.Module):
    def __init__(self, in_ch: int, hid_ch: int = 256, out_ch: int = 1,
                 dropout: float = 0.5, num_samples: int = 100,
                 generator=None):
        super().__init__()
        self.dropout = dropout
        self.num_samples = num_samples
        self.trunk = dense(in_ch, hid_ch, generator)
        self.mu = dense(hid_ch, out_ch, generator)
        # unused in predict, kept for parity with the JAX module
        self.sigma = dense(hid_ch, out_ch, generator)

    def keep_mask(self, shape, generator: torch.Generator) -> torch.Tensor:
        """Boolean keep mask, True with probability 1 - dropout, drawn on
        the generator's device."""
        return torch.rand(shape, generator=generator,
                          device=generator.device) >= self.dropout

    def _dropped(self, x, keep):
        h = torch.relu(self.trunk(x))
        # always-on dropout
        return torch.where(keep, h / (1.0 - self.dropout),
                           torch.zeros((), dtype=h.dtype, device=h.device))

    def forward(self, x, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None):
        """(mu, sigma) of one stochastic forward; `keep` (n, hid) is drawn
        from `generator` unless given."""
        if keep is None:
            keep = self.keep_mask((x.shape[0], self.trunk.out_features),
                                  generator)
        h = self._dropped(x, keep)
        return self.mu(h), self.sigma(h)

    @staticmethod
    def loss(mu, y, log_noise):
        sigma = torch.exp(log_noise)
        return torch.mean(torch.log(sigma) + 0.5 * (mu - y) ** 2 / sigma ** 2)

    @torch.no_grad()
    def predict(self, x, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predictive mean/std (population std) over `num_samples`
        stochastic forwards, batched on a leading axis; `keep`
        (num_samples, n, hid) is drawn from `generator` unless given."""
        if keep is None:
            keep = self.keep_mask((self.num_samples, x.shape[0],
                                   self.trunk.out_features), generator)
        mus = self.mu(self._dropped(x, keep))[..., 0]      # (s, n)
        return torch.mean(mus, dim=0), torch.std(mus, dim=0, correction=0)


class DeepEnsemble(nn.Module):
    """Ensemble of MLPDensityRegressors with the members stacked on a
    leading axis of every parameter (kernels stored (member, in, out))."""

    def __init__(self, in_ch: int, num_models: int = 5, hid_ch: int = 256,
                 generator=None):
        super().__init__()
        self.num_models = num_models

        def kernel(fan_in, out):
            w = torch.empty(num_models, fan_in, out)
            return nn.Parameter(lecun_normal_(w, fan_in, generator))

        def bias(out):
            return nn.Parameter(torch.zeros(num_models, 1, out))

        self.w_trunk, self.b_trunk = kernel(in_ch, hid_ch), bias(hid_ch)
        self.w_mu, self.b_mu = kernel(hid_ch, 1), bias(1)
        self.w_sigma, self.b_sigma = kernel(hid_ch, 1), bias(1)

    def forward(self, x):
        """(mus, sigmas) stacked over members: (m, n, 1) each."""
        h = torch.relu(torch.matmul(x, self.w_trunk) + self.b_trunk)
        mu = torch.baddbmm(self.b_mu, h, self.w_mu)
        sigma = _softplus(torch.baddbmm(self.b_sigma, h, self.w_sigma)) + 1e-6
        return mu, sigma

    def loss(self, x, y):
        """Mean over members of each member's Gaussian NLL."""
        mus, sigmas = self(x)
        return torch.mean(torch.mean(
            0.5 * (torch.log(sigmas) + (y - mus) ** 2 / sigmas), dim=(1, 2)))

    @torch.no_grad()
    def predict(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mixture mean/std. sigma_pos is a variance (the NLL is
        0.5*(log s + (y-mu)^2/s)), so it enters the mixture moment
        un-squared."""
        mus, sigmas = self(x)
        mu_bar = torch.mean(mus, dim=0)
        var = torch.mean(sigmas + mus ** 2, dim=0) - mu_bar ** 2
        return mu_bar[:, 0], torch.sqrt(var.clamp_min(0.0))[:, 0]
