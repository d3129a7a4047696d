"""How far the distributed tier's posterior sits from the exact tier's, on
the CPU in fp64, in both packages: the bound `chip_smoke.py` phase 11 holds
the card's forest 10,800-row distributed fit to.

    python experiments/torch_dist_vs_exact.py

The distributed Gram is a cross Gram whose diagonal carries the generic
dual at rho = 1; the exact tier writes the exact diagonal. On the forest
split's first 2,048 and 4,096 rows (1,024 test rows), block size 256,
it prints max |d mean| / max |mean| and max |d std| / max |std| of
distributed_fit against fit_gp for each package and kernel.
"""

import contextlib
import io
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import nngp_tpu.parallel as JPAR  # noqa: E402
from nngp_tpu.gp import fit_gp as jax_fit_gp  # noqa: E402
from nngp_tpu.models.kernel_spec import reference_kernel as jax_kernel  # noqa: E402,E501
from nngp_tpu_torch.cli import train  # noqa: E402
from nngp_tpu_torch.gp import fit_gp  # noqa: E402
from nngp_tpu_torch.models.kernel_spec import reference_kernel  # noqa: E402
from nngp_tpu_torch.parallel import distributed_fit, make_mesh  # noqa: E402


def _rel(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def main():
    args = train.build_parser().parse_args(
        ["--query_path", "workloads/forest_data", "--x64"])
    with contextlib.redirect_stdout(io.StringIO()):
        x_tr, y_tr, _, x_te, _, _ = train.load_split(args)
    mesh, jmesh = make_mesh(1, device="cpu"), JPAR.make_mesh(1)
    xt = x_te[:1024]
    for n in (2048, 4096):
        x, y = x_tr[:n], y_tr[:n]
        for get in ("nngp", "ntk"):
            d = distributed_fit(reference_kernel(), x, y, mesh, get=get,
                                block_size=256)
            e = fit_gp(reference_kernel(), x, y, get=get, device="cpu")
            jd = jax.jit(lambda a, b, get=get: JPAR.distributed_fit(
                jax_kernel(), a, b, jmesh, get=get, block_size=256))(
                    jnp.asarray(x), jnp.asarray(y))
            je = jax_fit_gp(jax_kernel(), jnp.asarray(x), jnp.asarray(y),
                            get=get)
            rows = {"port": (d.predict_mean_std(xt),
                             e.predict_mean_std(torch.as_tensor(xt))),
                    "jax": (jd.predict_mean_std(jnp.asarray(xt)),
                            je.predict_mean_std(jnp.asarray(xt)))}
            for pkg, ((md, sd), (me, se)) in rows.items():
                print(f"n={n} {get} {pkg}: max|d mean|/max|mean| "
                      f"{_rel(md, me)!r}, max|d std|/max|std| "
                      f"{_rel(sd, se)!r}", flush=True)


if __name__ == "__main__":
    main()
