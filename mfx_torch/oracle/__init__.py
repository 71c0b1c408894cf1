"""The sequential Java-parity oracle (``java_oracle``), the port's own copy
of ``mfx/oracle``."""

from mfx_torch.oracle.java_oracle import (
    OracleState, init_oracle, init_oracle_from_arrays, oracle_rmse,
    train_epoch_sequential,
)

__all__ = ["OracleState", "init_oracle", "init_oracle_from_arrays",
           "train_epoch_sequential", "oracle_rmse"]
