from mfx_torch.models.mf import MFModel, init_model

__all__ = ["MFModel", "init_model"]
