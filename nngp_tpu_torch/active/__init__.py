from nngp_tpu_torch.active.greedy import greedy_variance_select
from nngp_tpu_torch.active.learner import ActiveLearner

__all__ = ["ActiveLearner", "greedy_variance_select"]
