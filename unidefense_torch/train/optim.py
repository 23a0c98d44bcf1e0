"""Optimizer and LR schedule (unidefense_tpu/train/optim.py:25-108,191-348).

The JAX package builds optax chains; the port writes the same updates with
plain tensor ops (``torch._foreach_*`` over every trained tensor at once):

* adam / adamw, with or without amsgrad, as optax's ``scale_by_adam`` and
  ``scale_by_amsgrad`` compute them. optax's amsgrad keeps the running
  maximum of the BIAS-CORRECTED second moment and divides by its root;
  ``torch.optim.AdamW(amsgrad=True)`` keeps the maximum of the uncorrected
  moment and corrects afterwards, which differs once the second moment
  falls. So no ``torch.optim`` class is used.
* weight decay after the core for adamw (decoupled), added to the gradient
  before it for adam (coupled); none for tensors with ndim <= 1, biases and
  tensors that are not trained (timm's ``param_groups_weight_decay``);
* the update scaled by -lr·lr_scale, lr = schedule(c) with c the count of
  updates made before this one. The two-pass step makes two updates per
  train step, so the schedule maps c to the train step s = c // 2 + 1 and
  both updates of a step use the same lr.

The other optimizers of the JAX registry (sgd, adamax, adadelta, adagrad,
rmsprop, asgd) are not ported yet (ROADMAP.md queue 3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

_NOT_PORTED = ("sgd", "asgd", "adamax", "adadelta", "adagrad", "rmsprop")


def decays(name: str, p: torch.Tensor) -> bool:
    """True where weight decay applies: a trained tensor with ndim > 1 that
    is not a bias."""
    return p.requires_grad and p.dim() > 1 and name.rsplit(".", 1)[-1] != "bias"


def build_lr_schedule(base_lr: float, warmup_step: int = 0,
                      scheduler_cfg: Optional[dict] = None,
                      updates_per_step: int = 2) -> Callable[[int], float]:
    """lr as a function of the update count c. ``scheduler_cfg`` follows the
    reference YAML ({name: StepLR, step_size, gamma}, …); None is
    ConstantLR. Warm-up is linear over the first ``warmup_step`` train
    steps; the scheduler counts the steps after it."""
    cfg = dict(scheduler_cfg or {})
    name = cfg.pop("name", "ConstantLR")

    if name in ("ConstantLR", "ReduceLROnPlateau"):
        # the plateau factor is fed by a metric, not the count: the train
        # state's lr_scale carries it (ReduceLROnPlateau below)
        def decay(k):
            return 1.0
    elif name in ("StepLR", "TimmStepLR"):
        if name == "StepLR":
            step_size, gamma = int(cfg["step_size"]), float(cfg.get("gamma", 0.1))
        else:
            step_size = int(cfg.get("decay_t", cfg.get("step_size", 1)))
            gamma = float(cfg.get("decay_rate", cfg.get("gamma", 0.1)))

        def decay(k):
            return gamma ** (k // step_size)
    elif name == "MultiStepLR":
        milestones = sorted(int(m) for m in cfg["milestones"])
        gamma = float(cfg.get("gamma", 0.1))

        def decay(k):
            return gamma ** sum(k >= m for m in milestones)
    elif name == "ExponentialLR":
        gamma = float(cfg["gamma"])

        def decay(k):
            return gamma ** k
    elif name in ("CosineAnnealingLR", "TimmCosineLR"):
        t_max = int(cfg.get("T_max", cfg.get("t_initial", 1)))
        eta_min = float(cfg.get("eta_min", cfg.get("lr_min", 0.0)))

        def decay(k):
            cos = 0.5 * (1 + math.cos(math.pi * min(k, t_max) / t_max))
            return (eta_min + (base_lr - eta_min) * cos) / base_lr
    elif name == "CosineAnnealingWarmRestarts":
        t0 = int(cfg.get("T_0", 1))
        eta_min = float(cfg.get("eta_min", 0.0))

        def decay(k):
            cos = 0.5 * (1 + math.cos(math.pi * (k % t0) / t0))
            return (eta_min + (base_lr - eta_min) * cos) / base_lr
    else:
        raise KeyError(f"Scheduler '{name}' not supported")

    def schedule(count: int) -> float:
        s = count // updates_per_step + 1  # 1-indexed train step
        if warmup_step and s <= warmup_step:
            return base_lr * s / warmup_step
        return base_lr * decay(max(0, s - 1 - warmup_step))

    return schedule


@dataclass
class OptState:
    """Moments of every trained tensor (by parameter name) and the count of
    updates made."""

    count: int = 0
    mu: dict = field(default_factory=dict)
    nu: dict = field(default_factory=dict)
    nu_max: dict = field(default_factory=dict)  # amsgrad only


@dataclass
class Adam:
    """adam / adamw, optionally amsgrad, as optax chains them
    (``get_optimizer``, optim.py:270-329)."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    decoupled: bool = True  # adamw; False is adam's coupled L2
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    amsgrad: bool = False

    def init(self, model: torch.nn.Module) -> OptState:
        state = OptState()
        for name, p in model.named_parameters():
            if p.requires_grad:
                state.mu[name] = torch.zeros_like(p)
                state.nu[name] = torch.zeros_like(p)
                if self.amsgrad:
                    state.nu_max[name] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def update(self, model: torch.nn.Module, state: OptState,
               lr_scale: Optional[float] = None) -> None:
        """One update of every trained parameter from its ``.grad``, in
        place; ``state`` advances by one count."""
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        names = [n for n, _ in named]
        params = [p for _, p in named]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        decay_idx = [i for i, (n, p) in enumerate(named) if decays(n, p)]
        wd = self.weight_decay
        b1, b2 = self.betas
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]

        if wd and not self.decoupled:  # adam: g' = g + wd * p before the core
            grads = list(grads)
            for i in decay_idx:
                grads[i] = grads[i] + wd * params[i]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
        nu_hat = torch._foreach_div(nu, 1 - b2 ** count)
        if self.amsgrad:
            nu_max = [state.nu_max[n] for n in names]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        if wd and self.decoupled and decay_idx:  # adamw: + wd * p after the core
            torch._foreach_add_([updates[i] for i in decay_idx],
                                [params[i] for i in decay_idx], alpha=wd)
        torch._foreach_mul_(updates, -self.schedule(state.count))
        if lr_scale is not None:
            torch._foreach_mul_(updates, lr_scale)
        torch._foreach_add_(params, updates)
        state.count = count


def get_optimizer(name: str, schedule: Callable[[int], float], weight_decay: float = 0.0,
                  betas=(0.9, 0.999), amsgrad: bool = False, eps: float = 1e-8,
                  **kwargs) -> Adam:
    """The optimizer for a reference optimizer name. adam couples weight
    decay (L2 on the gradient), adamw decouples it."""
    name = name.lower()
    if name in ("adam", "adamw"):
        return Adam(schedule, weight_decay, decoupled=name == "adamw", betas=tuple(betas),
                    eps=eps, amsgrad=amsgrad)
    if name in _NOT_PORTED:
        raise KeyError(f"Optimizer '{name}' is not ported to unidefense_torch yet "
                       "(ROADMAP.md queue 3)")
    raise KeyError(f"Optimizer '{name}' not implemented")


def build_optimizer(config_cfg: dict) -> tuple[Adam, Callable[[int], float]]:
    """(optimizer, lr schedule) from the reference ``config:`` YAML section
    (config_template/forgery/model_udeb4.yml:12-25)."""
    optim_cfg = dict(config_cfg.get("optimizer") or {"name": "sgd", "lr": 0.01})
    name = optim_cfg.pop("name")
    base_lr = float(optim_cfg.pop("lr"))
    wd = float(optim_cfg.pop("weight_decay", 0.0))
    warmup = int(config_cfg.get("warmup_step", 0) or 0)
    schedule = build_lr_schedule(base_lr, warmup, config_cfg.get("scheduler"))
    return get_optimizer(name, schedule, weight_decay=wd, **optim_cfg), schedule


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics on the host:
    ``step(metric)`` returns the cumulative LR multiplier (1.0, then factor,
    factor², … floored at min_lr/base_lr), which the train state carries as
    ``lr_scale``."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0, eps: float = 1e-8):
        if factor >= 1.0:
            raise ValueError("Factor should be < 1.0.")
        self.base_lr = float(base_lr)
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.eps = float(eps)
        self.lr = self.base_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, a: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < self.best * (1.0 - self.threshold)
            return a < self.best - self.threshold
        if self.threshold_mode == "rel":
            return a > self.best * (1.0 + self.threshold)
        return a > self.best + self.threshold

    def step(self, metric: float) -> float:
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.scale

    @property
    def scale(self) -> float:
        return self.lr / self.base_lr


def build_plateau(config_cfg: dict, default_mode: str = "min") -> Optional[ReduceLROnPlateau]:
    """ReduceLROnPlateau when the scheduler YAML asks for it, else None.
    ``default_mode`` is the direction of the metric the caller feeds, used
    when the YAML omits ``mode``."""
    sched = dict(config_cfg.get("scheduler") or {})
    if sched.pop("name", None) != "ReduceLROnPlateau":
        return None
    base_lr = float((config_cfg.get("optimizer") or {}).get("lr", 1e-3))
    known = {"mode", "factor", "patience", "threshold", "threshold_mode", "cooldown",
             "min_lr", "eps"}
    kwargs = {k: v for k, v in sched.items() if k in known}
    kwargs.setdefault("mode", default_mode)
    return ReduceLROnPlateau(base_lr, **kwargs)
