"""The anchor-number parity gate of `tests/test_parity_gate.py`, run through
the port: the same committed workloads, the seed-10 60/20/20 split, the
reference kernel, diag_reg 1e-3, fp64 on the CPU, at that file's tolerance
(rel 2e-3 on q-error statistics, 1e-3 on the MSE).

The four 2,048-row pins take seconds each and run in the fast gate: one
per committed workload family (forest, synthimdb, synthtpch, synthtpcds),
so a family's featurizer + fit that the port gets wrong shows here. The
full-size anchors (forest 10.8k nngp / ntk, synth6) factor a 10.8k fp64
Gram and are marked slow. The Nystrom pins of the same gate are held in
`tests/test_torch_nystrom.py::test_forest_2048_pins`.
"""

import numpy as np
import pytest
import torch

from nngp_tpu_torch.data.workload import (load_multi_join_workload,
                                          load_single_table_workload)
from nngp_tpu_torch.eval.qerror import symmetric_qerror
from nngp_tpu_torch.eval.splits import train_test_val_split
from nngp_tpu_torch.gp import fit_gp
from nngp_tpu_torch.models.kernel_spec import reference_kernel


def _split(x, y, infos):
    x_tr, y_tr, _, x_te, y_te, *_ = train_test_val_split(
        x, y, train_frac=0.6, test_frac=0.2, all_query_infos=infos)
    return x_tr, y_tr, x_te, y_te


def _family_split(name):
    if name == "forest":
        x, y, infos, _enc = load_single_table_workload(
            "workloads/forest_data", dtype=np.float64)
    else:
        x, y, infos, _enc = load_multi_join_workload(
            f"workloads/{name}_data" if name != "synth6"
            else "workloads/synth6_join_data",
            schema_name=name, dtype=np.float64)
    return _split(x, y, infos)


def _fit_predict_q(x_tr, y_tr, x_te, y_te, get="nngp"):
    post = fit_gp(reference_kernel(), x_tr, y_tr, diag_reg=1e-3, get=get,
                  device="cpu")
    mean, _std = post.predict_mean_std(torch.as_tensor(x_te))
    err = mean.numpy().ravel() - np.asarray(y_te).ravel()
    q = symmetric_qerror(err)
    return (float(np.median(q)), float(np.quantile(q, 0.95)),
            float(np.sum(err ** 2)))


# family -> (median_q, p95_q) at n_tr = 2048 (the split's prefix), all test
# rows: tests/test_parity_gate.py:112, :162-163, :188-189, :205-206
_PINS_2048 = {
    "forest": (3.1046, 42.5145),
    "synthimdb": (3.7554, 113.8391),
    "synthtpch": (2.7015, 30.861),
    "synthtpcds": (5.964, 305.6134),
}


@pytest.mark.parametrize("family", sorted(_PINS_2048))
def test_2048_pin(family):
    x_tr, y_tr, x_te, y_te = _family_split(family)
    med, p95, _ = _fit_predict_q(x_tr[:2048], y_tr[:2048], x_te, y_te)
    pin = _PINS_2048[family]
    assert med == pytest.approx(pin[0], rel=2e-3)
    assert p95 == pytest.approx(pin[1], rel=2e-3)


# (family, get) -> (median_q, p95_q, mse or None): test_parity_gate.py:72-100
_FULL_ANCHORS = {
    ("forest", "nngp"): (2.5962, 22.331, 18208.19),
    ("forest", "ntk"): (2.6333, 26.162, 19725.31),
    ("synth6", "nngp"): (9.776, 5504.05, None),
}


@pytest.mark.slow
@pytest.mark.parametrize("family,get", sorted(_FULL_ANCHORS))
def test_full_size_anchor(family, get):
    x_tr, y_tr, x_te, y_te = _family_split(family)
    med, p95, mse = _fit_predict_q(x_tr, y_tr, x_te, y_te, get=get)
    want = _FULL_ANCHORS[(family, get)]
    assert med == pytest.approx(want[0], rel=2e-3)
    assert p95 == pytest.approx(want[1], rel=2e-3)
    if want[2] is not None:
        assert mse == pytest.approx(want[2], rel=1e-3)
