"""Log-domain Sinkhorn normalisation with an optional slack row and column
(deepsir_tpu/ops/sinkhorn.py).

A fixed number of iterations and no early exit, as in the JAX package.
"""
from __future__ import annotations

import torch


def compute_affinity(beta: torch.Tensor, feat_distance: torch.Tensor, alpha=0.5) -> torch.Tensor:
    """The log of the initial match matrix, -beta * (dist - alpha).

    beta (B,); feat_distance (B, J, K); alpha a float or a (B,) tensor.
    """
    if not torch.is_tensor(alpha) or alpha.dim() == 0:
        return -beta[:, None, None] * (feat_distance - alpha)
    return -beta[:, None, None] * (feat_distance - alpha[:, None, None])


def sinkhorn(log_alpha: torch.Tensor, n_iters: int = 5, slack: bool = True) -> torch.Tensor:
    """Sinkhorn iterations towards a doubly stochastic matrix, in the log
    domain: log_alpha (B, J, K) -> (B, J, K).

    With `slack` a zero row and column are appended first; each iteration
    normalises the real rows over every column, then the real columns over
    every row, so the slack absorbs unmatched mass; it is cut off at the end.
    """
    if slack:
        la = torch.nn.functional.pad(log_alpha, (0, 1, 0, 1))
        for _ in range(n_iters):
            body = la[:, :-1, :]
            la = torch.cat([body - torch.logsumexp(body, dim=2, keepdim=True),
                            la[:, -1:, :]], dim=1)
            body = la[:, :, :-1]
            la = torch.cat([body - torch.logsumexp(body, dim=1, keepdim=True),
                            la[:, :, -1:]], dim=2)
        return la[:, :-1, :-1]
    la = log_alpha
    for _ in range(n_iters):
        la = la - torch.logsumexp(la, dim=2, keepdim=True)
        la = la - torch.logsumexp(la, dim=1, keepdim=True)
    return la
