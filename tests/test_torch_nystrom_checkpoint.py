"""Nystrom checkpoints across the two packages, on the CPU: the JAX
package's `Estimator.save` format (meta.json's `nystrom` entry and the
fields of its NystromPosterior in posterior.npz) read and written by the
port's Estimator (`nngp_tpu_torch.convert.nystrom_to_numpy` /
`nystrom_from_numpy`), on the toy two-table schema of
`tests/test_active_serve.py`.

Tolerances: fp64 rtol 1e-9 (ntk 1e-7, see test_torch_nystrom.py); fp32
moments 2e-3 (the predict's fp32 kernel entries are amplified by the
whitening, up to sqrt(lam_max / lam_cut) = 1e4 at the 1e-8 cut);
moments='df64' 1e-4. A df64 checkpoint keeps each fp64 moment as an fp32
(hi, lo) pair (48 bits), so a restored df64 posterior predicts to fp32
rounding, not bit for bit.
"""

import numpy as np
import pytest

from nngp_tpu.serve.estimator import Estimator as JaxEstimator
from nngp_tpu_torch.serve import Estimator
from tests.test_socket_server import _mk_lines
from tests.test_torch_nystrom_serve import (  # noqa: F401
    LINES, _close, _pair, toy)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("dtype,moments,get", [
    (np.float64, None, "ntk"),
    (np.float32, "fp32", "nngp"),
    (np.float32, "df64", "nngp"),
    (np.float32, "df64", "ntk"),
], ids=["fp64-ntk", "fp32-nngp", "df64-nngp", "df64-ntk"])
def test_checkpoints_cross_both_ways(toy, tmp_path, dtype, moments, get):
    """A JAX Nystrom checkpoint restores in the port and predicts what the
    JAX Estimator predicts; a port checkpoint restores in the JAX package
    and predicts what the port predicts; each side extends its restored
    posterior as the other would. df64 carries its tails (w_kmm_lo for
    ntk) both ways. (fp32 moments with ntk are left out: each package's
    fp32 NTK entries at rho = 1 carry acos's sqrt(eps32) ~ 2e-4 noise, which
    the two packages round differently.)"""
    kw = dict(nystrom_m=20, kernel_type=get, dtype=dtype)
    if moments:
        kw["nystrom_moments"] = moments
    jest, est = _pair(toy, **kw)
    rtol = {"fp32": 2e-3, "df64": 1e-4}.get(moments,
                                            1e-7 if get == "ntk" else 1e-9)
    jest.save(str(tmp_path / "jax"))
    est.save(str(tmp_path / "port"))
    with np.load(tmp_path / "port" / "posterior.npz") as arrs:
        keys = set(arrs.files)
    with np.load(tmp_path / "jax" / "posterior.npz") as arrs:
        assert keys == set(arrs.files)
    if moments == "df64":
        assert {"c_lo", "b_lo", "w_solve_lo"} <= keys
        assert ("w_kmm_lo" in keys) == (get == "ntk")
    on_port = Estimator.restore(str(tmp_path / "jax"), device="cpu")
    on_jax = JaxEstimator.restore(str(tmp_path / "port"))
    assert on_port.posterior.moments == (moments or "fp32")
    _close(on_port.predict(LINES), jest.predict(LINES), rtol)
    _close(on_jax.predict(LINES), est.predict(LINES), rtol)
    new = _mk_lines(np.random.default_rng(4), 6)
    on_port.extend_with_lines(new)
    on_jax.extend_with_lines(new)
    _close(on_port.predict(LINES), on_jax.predict(LINES), rtol)
    back = Estimator.restore(str(tmp_path / "port"), device="cpu")
    _close(back.predict(LINES), est.predict(LINES),
           0.0 if moments != "df64" else 1e-6)
