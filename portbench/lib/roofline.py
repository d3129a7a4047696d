"""Peaks of one NVIDIA H100 SXM and the least time of a launch.

Frozen copies: the peak constants of `nngp_tpu_torch/cli/gram_bench.py`
(`HBM_BYTES_PER_S`, `PEAK_FLOPS`) and of `chip_smoke.py` (`TF32_FLOPS`),
`chip_smoke.py::pair_bound` and `chip_smoke.py::gemm_bound`, returning
seconds where the originals return ms. The peaks are NVIDIA's data sheet,
dense, at the full 700 W power limit.
"""

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 67e12            # fp64 and fp32 outside the tensor cores
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
PEAKS = {"fp64": FP64_FLOPS, "fp32": FP32_FLOPS, "tf32": TF32_FLOPS}
ITEMSIZE = {"float32": 4, "float64": 8}


def pair_bound(m, n, d, dtype, outputs=1):
    """(seconds, 'bytes' or 'operations'): the least time of a Gram cross
    launch writing `outputs` (m, n) Grams of d-wide rows: the rows read
    once and each output written once, or the dot's 2 d FLOPs an element
    at 67 TFLOP/s, whichever is longer. dtype: 'float32' or 'float64'."""
    size = ITEMSIZE[dtype]
    t_bytes = ((m + n) * d + outputs * m * n) * size / HBM_BYTES_PER_S
    t_ops = 2.0 * d * m * n / PEAKS["fp64" if size == 8 else "fp32"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gemm_bound(m, n, k, beta=0.0, flops=None):
    """(seconds, 'operations' or 'bytes'): the least time of one 3xTF32
    product (m, k) @ (k, n): three TF32 products' 2 m n k FLOPs each at
    495 TFLOP/s, or A and B read once and C written once (and read when
    beta != 0) in fp32, whichever is longer. flops: the product's own
    FLOPs where its mathematics needs fewer than 2 m n k (a triangular
    operand, a symmetric result), in place of 2 m n k; the original has
    no such argument."""
    t_ops = 3 * (2.0 * m * n * k if flops is None else flops) / TF32_FLOPS
    t_bytes = (m * k + k * n + m * n * (2 if beta else 1)) * 4 \
        / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def panels(n, panel):
    """The row counts of the panels a fit streams n rows in."""
    return [min(panel, n - s) for s in range(0, n, panel)]


def share(bound_s, seconds):
    """A roofline share in % (None without device time to divide by)."""
    return 100.0 * bound_s / seconds if seconds > 0 else None
