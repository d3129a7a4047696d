from nngp_tpu_torch.serve.drift import DriftMonitor, DriftReport
from nngp_tpu_torch.serve.estimator import Estimator
from nngp_tpu_torch.serve.feedback import merge_query_res
from nngp_tpu_torch.serve.follower import LeadEstimator, follow
from nngp_tpu_torch.serve.socket_server import EstimatorSocketServer
from nngp_tpu_torch.serve.streaming import StreamingBatcher

__all__ = ["Estimator", "merge_query_res", "EstimatorSocketServer",
           "StreamingBatcher", "DriftMonitor", "DriftReport",
           "LeadEstimator", "follow"]
