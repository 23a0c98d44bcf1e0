from unidefense_torch.losses.functional import (
    LOSSES,
    asymmetric_weighted_triplet,
    binary_cross_entropy_with_logits,
    cross_entropy,
    factorization,
    get_loss,
    kl_div_log_target,
    mse,
    soft_margin,
)

__all__ = [
    "cross_entropy",
    "binary_cross_entropy_with_logits",
    "mse",
    "kl_div_log_target",
    "soft_margin",
    "asymmetric_weighted_triplet",
    "factorization",
    "get_loss",
    "LOSSES",
]
