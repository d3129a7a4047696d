from nngp_tpu_torch.eval.splits import (train_test_val_split,
                                         uneven_train_test_split)
from nngp_tpu_torch.eval.qerror import (
    PredictionStatistics,
    qerror_profile,
    symmetric_qerror,
)
from nngp_tpu_torch.eval.calibration import (
    calibration_mae,
    calibration_table,
    conformal_quantile,
    conformal_scores,
    fit_std_scale,
)

__all__ = [
    "train_test_val_split",
    "uneven_train_test_split",
    "PredictionStatistics",
    "qerror_profile",
    "symmetric_qerror",
    "calibration_mae",
    "calibration_table",
    "conformal_quantile",
    "conformal_scores",
    "fit_std_scale",
]
