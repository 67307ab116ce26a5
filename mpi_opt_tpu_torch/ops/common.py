"""Shared tensor idioms for the decision ops."""

from __future__ import annotations

import torch


def rank_descending(scores: torch.Tensor, valid: torch.Tensor | None = None):
    """Dense descending rank of each score (0 = best).

    The sorts are stable, as ``jnp.argsort`` is: accuracies are
    multiples of 1/n_val, so ties are common and their order decides
    the exploit. NaNs (and invalid entries) rank after every valid
    finite entry.

    Returns (rank int64[n], order int64[n]): ``order`` sorts the scores
    descending and ``rank`` is its inverse.
    """
    masked = scores if valid is None else torch.where(valid, scores, -torch.inf)
    order = torch.argsort(-masked, stable=True)
    rank = torch.argsort(order, stable=True)
    return rank, order
