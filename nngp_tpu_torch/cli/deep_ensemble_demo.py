"""Toy 1-D deep-ensemble uncertainty demo. Port of
`examples/deep_ensemble_demo.py`: fit a 5-member density-regressor ensemble
on noisy sin data and print per-region predictive uncertainty (it should
blow up outside the training support).

    python -m nngp_tpu_torch.cli.deep_ensemble_demo [--device cpu]
"""

import argparse
import sys

import numpy as np

from nngp_tpu_torch.baselines.trainer import train_deep_ensemble


def main(argv=None):
    p = argparse.ArgumentParser("nngp_tpu_torch deep-ensemble demo")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda raises when no GPU is present")
    p.add_argument("--epochs", type=int, default=200)
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    x = rng.uniform(-3.0, 3.0, (512, 1)).astype(np.float32)
    y = np.sin(x) + 0.1 * rng.standard_normal((512, 1)).astype(np.float32)

    ens = train_deep_ensemble(x, y, num_models=5, num_hid=64,
                              epochs=args.epochs, lr=3e-3, batch_size=128,
                              verbose=None, device=args.device)
    x_grid = np.linspace(-6, 6, 13, dtype=np.float32).reshape(-1, 1)
    mean, std = (t.cpu().numpy() for t in ens.predict(x_grid))
    print(f"{'x':>6} {'true':>8} {'pred':>8} {'std':>8}  in-support")
    for xi, m, s in zip(x_grid.ravel(), mean, std):
        print(f"{xi:6.2f} {np.sin(xi):8.3f} {m:8.3f} {s:8.3f}  "
              f"{'yes' if abs(xi) <= 3 else 'NO'}")
    in_std = std[np.abs(x_grid.ravel()) <= 3].mean()
    out_std = std[np.abs(x_grid.ravel()) > 3.5].mean()
    print(f"\nmean std in-support {in_std:.3f} vs out-of-support {out_std:.3f}")
    if not out_std > in_std:
        raise AssertionError("ensemble should be less certain off-support")
    return in_std, out_std


if __name__ == "__main__":
    main(sys.argv[1:])
