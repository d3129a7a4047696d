"""The port's roofline (`nngp_tpu_torch/utils/roofline.py`), the least
time of a kernel launch that `cli/gram_bench.py`, `cli/gemm_bench.py` and
`chip_smoke.py` print as `bound_ms`.

Each case is held to two things: the formula written out below (bytes
over 3.35 TB/s against FLOPs over the type's peak, in ms, the larger
term named), and the benchmark's own frozen copy (`portbench/lib/
roofline.py`'s `pair_bound` and `gemm_bound`, and the symmetric Gram's
`sym_bound` of its gram_sym reader), which returns seconds: the port's
yardstick and the benchmark's cannot drift apart unnoticed. The cases are
the shapes the port times: every Gram shape of `gram_bench.SHAPES`, the
serving buckets 64 and 8,192 against the 14,896 stored fp64 rows of the
exact tier, the Nystrom panel 16,384 x 2,048 x 61 (one output and the
(nngp, ntk) pair), and every product of `chip_smoke.GEMM_SHAPES` at beta
0 and 1.
"""

import importlib.util
import os

import pytest
import torch

import chip_smoke
from nngp_tpu_torch.cli.gram_bench import SHAPES
from nngp_tpu_torch.utils.roofline import gemm_bound, gram_bound
from portbench.lib import roofline as bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYM_READER = os.path.join(REPO, "portbench", "metrics",
                          "gram_sym_roofline.exact-refit.py")
SERVED_ROWS, SYNTH6_D = 14896, 61

CASES = [
    *[pytest.param("gram", (kind, n if kind == "sym" else m, n, d, dtype, 1),
                   id=f"{kind} {name} {str(dtype)[6:]}")
      for name, n, m, d, dtype in SHAPES for kind in ("sym", "cross")],
    *[pytest.param("gram", ("cross", b, SERVED_ROWS, SYNTH6_D, torch.float64,
                            1), id=f"serving bucket {b}") for b in (64, 8192)],
    *[pytest.param("gram", ("cross", 16384, 2048, 61, dtype, outputs),
                   id=f"nystrom panel {str(dtype)[6:]} outputs {outputs}")
      for dtype in (torch.float32, torch.float64) for outputs in (1, 2)],
    *[pytest.param("gemm", (m, n, k, beta), id=f"{label} beta {beta}")
      for label, m, n, k, _, _ in chip_smoke.GEMM_SHAPES
      for beta in (0.0, 1.0)],
]


def written_out_gram(kind, m, n, d, dtype, outputs):
    """The Gram bound as the benches computed it: the rows read once and
    each output written once (the full n x n for sym, whose cases write
    one), 2 d FLOPs per distinct output element, at 3.35 TB/s and 67
    TFLOP/s (fp32 and fp64)."""
    size = torch.empty((), dtype=dtype).element_size()
    if kind == "sym":
        nbytes = (n * d + n * n) * size
        flops = 2.0 * d * n * (n + 1) / 2
    else:
        nbytes = ((m + n) * d + outputs * m * n) * size
        flops = 2.0 * d * m * n
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = flops / 67e12 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def written_out_gemm(m, n, k, beta):
    """The 3xTF32 bound as the benches computed it: three TF32 products'
    2 m n k FLOPs at 495 TFLOP/s, or A and B read once and C written once
    (and read when beta != 0) in fp32 at 3.35 TB/s."""
    t_ops = 3 * 2.0 * m * n * k / 495e12 * 1e3
    t_bytes = (m * k + k * n + m * n * (2 if beta else 1)) * 4 \
        / 3.35e12 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def benchmark_sym_bound():
    spec = importlib.util.spec_from_file_location("gram_sym_reader",
                                                  SYM_READER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.sym_bound


@pytest.mark.parametrize("product,args", CASES)
def test_bench_bound_is_the_store_or_the_dot(product, args):
    """The bound is the longer of the bytes' time and the operations'
    time, as the benches wrote it, and the benchmark's frozen copy gives
    the same figure (in seconds) and the same term."""
    if product == "gram":
        kind, m, n, d, dtype, outputs = args
        got = gram_bound(*args)
        assert got == written_out_gram(*args)
        if kind == "sym":
            want = benchmark_sym_bound()(n, d, str(dtype)[6:])
        else:
            want = bench.pair_bound(m, n, d, str(dtype)[6:], outputs)
    else:
        got = gemm_bound(*args)
        assert got == written_out_gemm(*args)
        want = bench.gemm_bound(*args)
    assert got == (want[0] * 1e3, want[1])
