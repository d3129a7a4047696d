from nngp_tpu_torch.active.baseline_learner import BaselineActiveLearner
from nngp_tpu_torch.active.greedy import greedy_variance_select
from nngp_tpu_torch.active.learner import ActiveLearner

__all__ = ["ActiveLearner", "BaselineActiveLearner",
           "greedy_variance_select"]
