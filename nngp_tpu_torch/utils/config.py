"""Typed run configuration: a copy of `nngp_tpu/utils/config.py`.

Replaces the reference's per-entry-point argparse blocks with
commented-out preset forests (`reference/train.py:252-287` etc.). One
dataclass per concern, JSON-serializable, with the reference's workload
presets as constructors. A RunConfig JSON written by either package loads
in the other (`tests/test_torch_utils.py`); `cli/train.py --config` seeds
its defaults from one.
"""

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class KernelConfig:
    kernel_type: str = "nngp"          # nngp | ntk
    depth: int = 1
    width: int = 512
    activation: str = "relu"           # relu | erf
    w_std: float = 1.0
    b_std: float = 0.0
    diag_reg: float = 1e-3
    # exact-MLL hyperparameter learning (gp/hyperopt.py): when learn_hyper
    # is set the fit uses the learned (w0, w, b, diag_reg) instead of the
    # pinned values above
    learn_hyper: bool = False
    hyper_steps: int = 100
    hyper_points: int = 4096
    # ARD: learn a per-feature input scale by evidence alongside (w, b, reg)
    hyper_ard: bool = False
    # RE-learn after every acquisition round (active learning), warm-
    # started from the previous optimum — beats learn-once (BASELINE.md)
    relearn_hyper: bool = False


@dataclasses.dataclass
class WorkloadConfig:
    relations: str = "forest"
    names: str = "forest"
    schema_name: Optional[str] = None
    query_path: str = "workloads/forest_data"
    data_path: Optional[str] = None
    chunk_size: int = 64
    feat_encode: str = "dnn-encoder"   # dnn-encoder | one-hot

    @property
    def join_query(self) -> bool:
        # derived exactly as the reference does (`train.py:295-296`)
        return len(self.relations.split(",")) > 1 or self.schema_name is not None


@dataclasses.dataclass
class SplitConfig:
    train_frac: float = 0.6
    test_frac: float = 0.2
    seed: int = 10
    max_num_train: Optional[int] = None


@dataclasses.dataclass
class ActiveConfig:
    budget: int = 1000
    active_iters: int = 3
    biased_sample: bool = True
    refit: str = "incremental"         # incremental | full


@dataclasses.dataclass
class RunConfig:
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    workload: WorkloadConfig = dataclasses.field(default_factory=WorkloadConfig)
    split: SplitConfig = dataclasses.field(default_factory=SplitConfig)
    active: ActiveConfig = dataclasses.field(default_factory=ActiveConfig)
    x64: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        raw = json.loads(text)
        return cls(kernel=KernelConfig(**raw.get("kernel", {})),
                   workload=WorkloadConfig(**raw.get("workload", {})),
                   split=SplitConfig(**raw.get("split", {})),
                   active=ActiveConfig(**raw.get("active", {})),
                   x64=raw.get("x64", False))


# Presets matching the reference's commented-out argparse blocks.
def forest_preset() -> RunConfig:
    return RunConfig()


def imdb_simple_preset(query_path: str, data_path: str) -> RunConfig:
    return RunConfig(workload=WorkloadConfig(
        relations="", names="", schema_name="imdb_simple",
        query_path=query_path, data_path=data_path))


def tpcds_preset(query_path: str, data_path: str) -> RunConfig:
    return RunConfig(workload=WorkloadConfig(
        relations="", names="", schema_name="tpcds",
        query_path=query_path, data_path=data_path))
