"""nngp_tpu_torch — the NNGP/NTK cardinality estimator in PyTorch + CUDA.

A port of `nngp_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find, and imports its framework-free host
modules (`nngp_tpu.featurize`, `nngp_tpu.eval`) instead of copying them.

Layer map:
  utils/      device and dtype policy (TF32 off), timing
  ops/        dual activations, input Gram, the hand-written CUDA Gram
              kernels (`csrc/gram.cu`) with their plain PyTorch twins
  models/     kernel specs (Dense/activation serial -> nngp/ntk recursion)
  gp/         exact GP posterior fit/predict (nngp + ntk semantics)
  data/       pandas-free single-table workload assembly
  cli/        the training/evaluation entry point
  convert.py  layer specs and posterior state to and from the JAX package

Importing this package imports nothing heavy; `torch` loads with the
submodules that need it.
"""

__version__ = "0.1.0"
