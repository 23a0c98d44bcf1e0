"""Loss functions (unidefense_tpu/losses/functional.py:17-126).

The registry has the reference loss package's names: mse, bce,
factorization, cross_entropy, aw_triplet and kl_div (batchmean, log target).
Every loss is a plain function of tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-12


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels (nn.CrossEntropyLoss)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """nn.BCEWithLogitsLoss (mean reduction)."""
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits)).mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def kl_div_log_target(log_pred: torch.Tensor, log_target: torch.Tensor) -> torch.Tensor:
    """nn.KLDivLoss(reduction='batchmean', log_target=True):
    sum(exp(log_t) * (log_t - log_p)) / batch_size."""
    return (log_target.exp() * (log_target - log_pred)).sum() / log_pred.shape[0]


def soft_margin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """nn.SoftMarginLoss: mean(log(1 + exp(-y*x)))."""
    return F.softplus(-y * x).mean()


def _euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise euclidean distance (m, d) x (n, d) -> (m, n), clamped below
    for a finite gradient at 0."""
    xx = (x ** 2).sum(dim=1, keepdim=True)
    yy = (y ** 2).sum(dim=1, keepdim=True).t()
    return (xx + yy - 2.0 * (x @ y.t())).clamp(min=_EPS).sqrt()


def asymmetric_weighted_triplet(features: torch.Tensor, labels: torch.Tensor,
                                n_real: int) -> torch.Tensor:
    """Asymmetrical Weighted Triplet loss. The anchors are the first
    ``n_real`` rows (real, label 0): the batch is real first. For each real
    anchor the positives are the other reals and the negatives all fakes;
    softmax-weighted distances feed a soft-margin loss. ``labels`` is unused
    beyond that contract, as in the reference."""
    dist = _euclidean_dist(features, features)
    anchor_rows = dist[:n_real]
    # the positives without the diagonal: row i takes columns j + (i <= j)
    j = torch.arange(n_real - 1, device=features.device)
    i = torch.arange(n_real, device=features.device)
    idx = j[None, :] + (i[:, None] <= j[None, :]).long()
    dist_ap = anchor_rows[:, :n_real].gather(1, idx)
    dist_an = anchor_rows[:, n_real:]

    exp_ap = dist_ap.exp()
    exp_an = (-dist_an).exp()
    wp = exp_ap / (exp_ap.sum(dim=1, keepdim=True) + _EPS)
    wn = exp_an / (exp_an.sum(dim=1, keepdim=True) + _EPS)
    final_wp = (wp * dist_ap).sum(dim=1)
    final_wn = (wn * dist_an).sum(dim=1)
    return soft_margin(final_wn - final_wp, torch.ones_like(final_wn))


def factorization(emb_a: torch.Tensor, emb_b: torch.Tensor, off_diag_weight: float = 0.005,
                  eps: float = 1e-6) -> torch.Tensor:
    """Barlow-Twins-style cross-correlation loss: mean((diag(C)-1)^2) +
    w * mean(offdiag(C)^2), C the normalised cross-correlation of the two
    embeddings, with torch's unbiased std."""
    a = (emb_a - emb_a.mean(dim=0)) / (emb_a.std(dim=0) + eps)
    b = (emb_b - emb_b.mean(dim=0)) / (emb_b.std(dim=0) + eps)
    c = (a.t() @ b) / emb_a.shape[0]
    d = c.shape[0]
    diag = torch.diagonal(c)
    on_diag = ((diag - 1.0) ** 2).mean()
    off_diag = ((c ** 2).sum() - (diag ** 2).sum()) / (d * d - d)
    return on_diag + off_diag_weight * off_diag


LOSSES = {
    "mse": mse,
    "bce": binary_cross_entropy_with_logits,
    "factorization": factorization,
    "cross_entropy": cross_entropy,
    "aw_triplet": asymmetric_weighted_triplet,
    "kl_div": kl_div_log_target,
}


def get_loss(name: str = "cross_entropy"):
    """Registry lookup by the reference's names."""
    if name not in LOSSES:
        raise KeyError(f"Loss '{name}' not found; available: {sorted(LOSSES)}")
    return LOSSES[name]
