"""The program side of each tier a configuration names by its `tier`
(`tiers/<tier>.py`, found by file name): `fit(config, device)`, a fit of
host numpy rows and labels as the serving `Estimator` passes them, and
`judge_fit(config, post, x, y, xp)`, the compared numbers of one such fit
against the tier's plain reference (`reference/<tier>.py`)."""


def kernel_spec(config):
    """The program's KernelSpec of the configuration's `kernel` layers."""
    from nngp_tpu_torch.models.kernel_spec import Activation, Dense, \
        KernelSpec

    return KernelSpec([Dense(l[1], l[2], l[3]) if l[0] == "dense"
                       else Activation(l[0]) for l in config["kernel"]])
