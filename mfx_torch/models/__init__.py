from mfx_torch.models.mf import MFModel, baseline_biases, init_model

__all__ = ["MFModel", "init_model", "baseline_biases"]
