"""The port's roofline: the peaks of one NVIDIA H100 SXM and the least
time of a kernel launch, which `cli/gram_bench.py`, `cli/gemm_bench.py`
and `chip_smoke.py` print beside a kernel's time as `bound_ms` (and its
share, bound_ms / ms).

The peaks are NVIDIA's data sheet, dense, at the full 700 W power limit:
HBM3 at 3.35 TB/s, 67 TFLOP/s for fp32 outside the tensor cores and for
fp64 on them, and 495 TFLOP/s for TF32 on the tensor cores. A bound is the
longer of two terms: the bytes a launch must move at the HBM rate, and
the FLOPs it must do at its type's rate; the second value names it
('bytes' or 'operations').
"""

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
TF32_FLOPS = 495e12


def gram_bound(kind, m, n, d, dtype, outputs=1):
    """(ms, 'bytes' or 'operations') of one Gram launch over d-wide rows
    writing `outputs` Grams (2 for an (nngp, ntk) pair). kind 'cross': the
    (m, n) Gram of m rows against n, the rows read once and each output
    written once, 2 d FLOPs an element. kind 'sym': the (n, n) Gram of n
    rows (m is not read), the rows read once and every entry written (the
    kernel writes each tile and its mirror), 2 d FLOPs an element of the
    triangle, n (n + 1) / 2 of them."""
    size = torch.empty((), dtype=dtype).element_size()
    if kind == "sym":
        nbytes = (n * d + outputs * n * n) * size
        flops = 2.0 * d * n * (n + 1) / 2
    else:
        nbytes = ((m + n) * d + outputs * m * n) * size
        flops = 2.0 * d * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gemm_bound(m, n, k, beta=0.0):
    """(ms, 'operations' or 'bytes') of one 3xTF32 product (m, k) @ (k, n):
    three TF32 products' 2 m n k FLOPs each at TF32_FLOPS, or A and B read
    once and C written once (and read when beta != 0) in fp32."""
    t_ops = 3 * 2.0 * m * n * k / TF32_FLOPS * 1e3
    t_bytes = (m * k + k * n + m * n * (2 if beta else 1)) * 4 \
        / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
