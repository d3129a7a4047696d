"""Where `chip_smoke.py::SWEEP_ANCHORS` comes from, at full size (slow:
~30 minutes on the CPU; `pytest -m slow -s tests/test_torch_sweep_full.py`
prints the rows).

The JAX package's sweep (`nngp_tpu/cli/sweep.py`: forest 10,800 / 3,600,
depths 1, 2, 4, 8, relu and erf, nngp and ntk) in fp64 gives the anchors;
its fp32 CLI rows lie up to ~5% off them (depth-1 relu nngp: 2.654 /
21.27 against 2.5962 / 22.331), so `chip_smoke.py` holds the card's fp32
rows to the fp64 rows at the forest fp32 bounds, median 1% / p95 3%."""

import json
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.slow


def _jax_fp64_rows():
    """The JAX sweep's loop (`nngp_tpu/cli/sweep.py:43-84`) on fp64
    arrays: (depth, activation, kernel) -> (median, p95)."""
    from nngp_tpu.data.workload import load_single_table_workload
    from nngp_tpu.eval.qerror import symmetric_qerror
    from nngp_tpu.eval.splits import train_test_val_split
    from nngp_tpu.gp import fit_gp
    from nngp_tpu.gp.posterior import input_scale_for_bound
    from nngp_tpu.models.kernel_spec import KernelSpec, mlp

    x, y, infos, _ = load_single_table_workload(
        os.path.join(REPO, "workloads", "forest_data"), relation="forest",
        dtype=np.float64)
    x_tr, y_tr, _, x_te, y_te, *_r = train_test_val_split(
        x, y, train_frac=0.6, test_frac=0.2, all_query_infos=infos)
    y_true = np.asarray(y_te).ravel()
    rows = {}
    for depth in (1, 2, 4, 8):
        for act in ("relu", "erf"):
            spec = KernelSpec(mlp(depth, 512, act, 1.0, 0.0))
            scale = input_scale_for_bound(float(np.max(np.abs(x_tr))),
                                          spec.layers)
            for kt in ("nngp", "ntk"):
                post = fit_gp(spec, jnp.asarray(x_tr), jnp.asarray(y_tr),
                              diag_reg=1e-3, get=kt, input_scale=scale)
                mean, _ = post.predict_mean_std(jnp.asarray(x_te))
                q = symmetric_qerror(np.asarray(mean).ravel() - y_true)
                rows[(depth, act, kt)] = (
                    round(float(np.median(q)), 4),
                    round(float(np.quantile(q, 0.95)), 4))
                print(json.dumps([depth, act, kt, *rows[(depth, act, kt)]]),
                      flush=True)
    return rows


def test_sweep_anchors_are_the_jax_fp64_rows_and_the_port_fp64_rows():
    """The anchors are the JAX fp64 rows; the port's fp64 rows hold them
    at rel 2e-3 (on this CPU: to every printed digit). The port's fp32
    rows are printed with their offsets (depth-8 relu nngp lands +1.95% on
    the median here, outside 1%: the fp32 rounding the card's check lets
    through only beside an fp64 run that holds)."""
    from nngp_tpu_torch.cli import sweep

    assert _jax_fp64_rows() == chip_smoke.SWEEP_ANCHORS
    for x64 in (["--x64"], []):
        for row in sweep.main(["--device", "cpu", *x64]):
            med, p95 = chip_smoke.SWEEP_ANCHORS[
                (row["depth"], row["activation"], row["kernel"])]
            d_med, d_p95 = row["median_q"] / med - 1, row["p95_q"] / p95 - 1
            print(f"port {'fp64' if x64 else 'fp32'} {row}: {d_med:+.2%} "
                  f"{d_p95:+.2%}")
            if x64:
                assert abs(d_med) <= 2e-3 and abs(d_p95) <= 2e-3, row
