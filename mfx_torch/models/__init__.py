from mfx_torch.models.mf import MFModel, baseline_biases, init_model
from mfx_torch.models.timesvd import (TimeFeatures, TimeSVDModel,
                                      fit_time_features, init_timesvd)

__all__ = ["MFModel", "init_model", "baseline_biases", "TimeFeatures",
           "TimeSVDModel", "fit_time_features", "init_timesvd"]
