"""Batch-diverse acquisition: greedy conditional-variance selection
(PyTorch counterpart of `nngp_tpu/active/greedy.py`).

Top-k std and biased sampling score pool points independently, so a large
batch buys near-duplicates from one under-covered region. Greedy selection
conditions instead: pick the max-variance point, condition the pool
covariance on observing it (the GP posterior covariance does not depend on
y, so no label is needed), repeat. Each step is a Schur complement

    C <- C - c c^T / (C[s, s] + noise),   c = C[:, s]

so the batch is the pivot set of a partial pivoted Cholesky of the pool
covariance. This stays plain PyTorch, as the JAX package runs it as plain
XLA ops: the k rank-1 updates of the (P, P) matrix are the whole cost,
one in-place pass over it each.
"""

import torch


def greedy_variance_select(cov: torch.Tensor, k: int, noise=0.0,
                           num_valid=None) -> torch.Tensor:
    """Greedy max-conditional-variance batch of `k` indices.

    cov: (P, P) posterior covariance of the candidate pool. noise: the
    fantasy observation-noise variance added to the pivot before
    conditioning (the fit's effective ridge, in the units of `cov`); 0.0
    selects by pure pivoted Cholesky. num_valid: only rows < num_valid are
    candidates.

    Tie rules of the JAX function: the argmax takes the first maximum,
    selected pivots are masked with -inf, and a pivot whose c[s, s] +
    noise is at or below the dtype's smallest normal is a no-op update.
    The pivot stays a 0-dim device tensor: no host sync per step.

    Returns (k,) int64 indices into the pool, distinct, in selection
    order."""
    p = cov.shape[0]
    if k > p:
        raise ValueError(f"cannot select {k} from a pool of {p}")
    c = cov.clone()
    noise = torch.as_tensor(noise, dtype=c.dtype, device=c.device)
    tiny = torch.finfo(c.dtype).tiny
    idx = torch.arange(p, device=c.device)
    mask = (idx >= num_valid if num_valid is not None
            else torch.zeros(p, dtype=torch.bool, device=c.device))
    sel = torch.zeros(k, dtype=torch.int64, device=c.device)
    for j in range(k):
        d = torch.where(mask, -torch.inf, torch.diagonal(c))
        s = torch.argmax(d).reshape(1)
        col = c.index_select(1, s)[:, 0]
        denom = col.index_select(0, s)[0] + noise
        inv = torch.where(denom > tiny, 1.0 / torch.clamp_min(denom, tiny),
                          0.0)
        # one in-place rank-1 pass over C, no (P, P) temporary
        c.addr_(col * -inv, col)
        mask.index_fill_(0, s, True)
        sel[j] = s[0]
    return sel
