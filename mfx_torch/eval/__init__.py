from mfx_torch.eval.metrics import rmse, rmse_mae, sampled_auc
from mfx_torch.eval.ranking import (full_hr_ndcg_at_k, hr_ndcg_at_k,
                                    user_topk_metrics)

__all__ = ["rmse", "rmse_mae", "sampled_auc", "hr_ndcg_at_k",
           "full_hr_ndcg_at_k", "user_topk_metrics"]
