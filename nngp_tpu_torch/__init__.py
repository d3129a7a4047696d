"""nngp_tpu_torch — the NNGP/NTK cardinality estimator in PyTorch + CUDA.

A port of `nngp_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find. It imports nothing of the JAX package,
not even its framework-free host modules: it carries its own copies
(`featurize/`, `eval/`, `native/` with `csrc/fastenc.cpp`, and the serving
front ends), each naming the file it copies. The tests hold each copy to
its original.

Layer map:
  utils/      device and dtype policy (TF32 off), timing
  featurize/  query-line parsing, table stats, single-table and join
              encoders (copies of the JAX package's)
  native/     the g++-built native query-line encoder (`csrc/fastenc.cpp`)
  eval/       q-error profiles, splits, calibration (copies)
  ops/        dual activations, input Gram, the hand-written CUDA Gram
              kernels (`csrc/gram.cu`) with their plain PyTorch twins, the
              Cholesky append
  models/     kernel specs (Dense/activation serial -> nngp/ntk recursion)
  gp/         exact GP posterior fit/predict/extend (nngp + ntk semantics),
              ridge selection by evidence, kernel hyperparameters learned
              by evidence (`hyperopt.py`)
  active/     active learning: biased, top-k and greedy acquisition
  data/       pandas-free single-table and multi-join workload assembly
  serve/      the exact-tier Estimator, streaming batcher, TCP server,
              drift monitor, aux-query feedback merge
  cli/        training, active-learning, serving demo and profiling entry
              points
  convert.py  layer specs and posterior state to and from the JAX package

Importing this package imports nothing heavy; `torch` loads with the
submodules that need it.
"""

__version__ = "0.1.0"
