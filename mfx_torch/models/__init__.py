from mfx_torch.models.mf import MFModel, baseline_biases, init_model
from mfx_torch.models.svdpp import (SVDppModel, implicit_scale,
                                    implicit_sums, init_svdpp)
from mfx_torch.models.timesvd import (TimeFeatures, TimeSVDModel,
                                      fit_time_features, init_timesvd)

__all__ = ["MFModel", "init_model", "baseline_biases", "SVDppModel",
           "init_svdpp", "implicit_scale", "implicit_sums", "TimeFeatures",
           "TimeSVDModel", "fit_time_features", "init_timesvd"]
