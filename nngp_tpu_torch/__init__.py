"""nngp_tpu_torch — the NNGP/NTK cardinality estimator in PyTorch + CUDA.

A port of `nngp_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find. It imports nothing of the JAX package,
not even its framework-free host modules: it carries its own copies
(`featurize/`, `eval/`, `native/` with `csrc/fastenc.cpp`, and the serving
front ends), each naming the file it copies. The tests hold each copy to
its original.

Layer map:
  utils/      device and dtype policy (TF32 off), timing, run config,
              profiling (Chrome traces), memory probes
  featurize/  query-line parsing, table stats, PK/FK schema recoding,
              single-table and join encoders (copies of the JAX package's)
  native/     the g++-built native query-line encoder (`csrc/fastenc.cpp`)
  eval/       q-error profiles, splits, calibration, plots (copies)
  ops/        dual activations, input Gram, the hand-written CUDA Gram
              kernels (`csrc/gram.cu`) with their plain PyTorch twins, the
              Cholesky append
  models/     kernel specs (Dense/activation serial -> nngp/ntk recursion)
  gp/         exact GP posterior fit/predict/extend (nngp + ntk semantics),
              ridge selection by evidence, kernel hyperparameters learned
              by evidence (`hyperopt.py`), the Nystrom/DTC tier
  active/     active learning: biased, top-k and greedy acquisition
  data/       the pandas-free data layer: `Table`, CSV loaders, schema
              cleaning, the true-cardinality sampler, workload assembly
  parallel/   the multi-device tier on torch.distributed (SPMD over a
              1-D DeviceMesh): row-sharded Gram, block-cyclic distributed
              Cholesky and solves, DistributedPosterior, a gloo dry run
  serve/      the Estimator (exact, Nystrom and distributed tiers),
              streaming batcher, TCP server, drift monitor, aux-query
              feedback merge
  cli/        training, active-learning, baselines, serving demos, the
              offline query sampler and schema cleaner, the kernel sweep
              and profiling entry points
  convert.py  layer specs and posterior state to and from the JAX package

Importing this package imports nothing heavy; `torch` loads with the
submodules that need it.
"""

__version__ = "0.1.0"
