from mfx_torch.eval.metrics import rmse, rmse_mae

__all__ = ["rmse", "rmse_mae"]
