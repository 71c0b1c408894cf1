"""Java-parity oracle, the port's own copy of ``mfx/oracle/java_oracle.py``
(verbatim but for its import of the port's ``RatingsCOO``).

A pure-NumPy *sequential* SGD matrix factorizer implementing exactly the
canonical update rule of the reference program (the standard FunkSVD
algorithm):

    e    = r - (mu + bu[u] + bi[i] + p_u · q_i)
    p_u += lr * (e * q_i - reg * p_u)        (q_i read before its update)
    q_i += lr * (e * p_u_old - reg * q_i)
    bu  += lr * (e - reg * bu[u])
    bi  += lr * (e - reg * bi[i])

one rating at a time, in the given order. The port's minibatch trainer
with ``batch_size=1`` must track it (``tests/test_torch_java_parity.py``,
``chip_smoke.py`` phase 13). Python-loop slow by design — use only on
small data.
"""

from __future__ import annotations

import numpy as np

from mfx_torch.data.coo import RatingsCOO

__all__ = ["OracleState", "init_oracle", "init_oracle_from_arrays",
           "train_epoch_sequential", "oracle_rmse"]


class OracleState:
    def __init__(self, P, Q, bu, bi, mu):
        self.P, self.Q, self.bu, self.bi, self.mu = P, Q, bu, bi, mu


def init_oracle(
    num_users: int,
    num_items: int,
    rank: int,
    global_mean: float,
    seed: int = 0,
    init_scale: float | None = None,
) -> OracleState:
    """Same init distribution family as mfx.models.init_model (scaled normal)."""
    if init_scale is None:
        init_scale = 1.0 / np.sqrt(rank)
    rng = np.random.default_rng(seed)
    return OracleState(
        P=rng.normal(0.0, 1.0, (num_users, rank)).astype(np.float64) * init_scale,
        Q=rng.normal(0.0, 1.0, (num_items, rank)).astype(np.float64) * init_scale,
        bu=np.zeros(num_users, np.float64),
        bi=np.zeros(num_items, np.float64),
        mu=float(global_mean),
    )


def init_oracle_from_arrays(P, Q, bu, bi, mu) -> OracleState:
    """Start the oracle from externally-provided factors (for exact-parity
    tests that share the init with the JAX model)."""
    return OracleState(
        np.array(P, np.float64),
        np.array(Q, np.float64),
        np.array(bu, np.float64),
        np.array(bi, np.float64),
        float(mu),
    )


def train_epoch_sequential(
    state: OracleState,
    coo: RatingsCOO,
    order: np.ndarray,
    lr: float,
    reg: float,
    use_bias: bool = True,
) -> float:
    """One sequential epoch in ``order``; returns the epoch's train RMSE
    (computed on-the-fly from pre-update residuals, as the Java version
    typically reports)."""
    P, Q, bu, bi, mu = state.P, state.Q, state.bu, state.bi, state.mu
    users, items, ratings = coo.user, coo.item, coo.rating
    sse = 0.0
    for idx in order:
        u = users[idx]
        i = items[idx]
        r = ratings[idx]
        pu = P[u]
        qi = Q[i]
        pred = mu + pu @ qi
        if use_bias:
            pred += bu[u] + bi[i]
        e = r - pred
        sse += e * e
        pu_old = pu.copy()
        P[u] = pu + lr * (e * qi - reg * pu)
        Q[i] = qi + lr * (e * pu_old - reg * qi)
        if use_bias:
            bu[u] += lr * (e - reg * bu[u])
            bi[i] += lr * (e - reg * bi[i])
    return float(np.sqrt(sse / max(1, len(order))))


def oracle_rmse(state: OracleState, coo: RatingsCOO) -> float:
    pred = (
        np.einsum("bk,bk->b", state.P[coo.user], state.Q[coo.item])
        + state.bu[coo.user]
        + state.bi[coo.item]
        + state.mu
    )
    err = coo.rating - pred
    return float(np.sqrt(np.mean(err * err)))
