from nngp_tpu_torch.baselines.trainer import (
    magnitude_class,
    compute_uncertainty,
    train_multitask,
    train_density,
    train_mc_dropout,
    train_deep_ensemble,
    train_mlp_regressor,
)

__all__ = [
    "magnitude_class",
    "compute_uncertainty",
    "train_multitask",
    "train_density",
    "train_mc_dropout",
    "train_deep_ensemble",
    "train_mlp_regressor",
]
