from mfx_torch.eval.metrics import rmse, rmse_mae, sampled_auc
from mfx_torch.eval.ranking import hr_ndcg_at_k

__all__ = ["rmse", "rmse_mae", "sampled_auc", "hr_ndcg_at_k"]
