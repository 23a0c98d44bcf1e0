"""Optimizers and LR schedule (unidefense_tpu/train/optim.py:25-348).

The JAX package builds optax chains; the port writes the same updates with
plain tensor ops (``torch._foreach_*`` over every trained tensor at once),
following optax where it and ``torch.optim`` differ:

* adam / adamw, with or without amsgrad, as optax's ``scale_by_adam`` and
  ``scale_by_amsgrad`` compute them. optax's amsgrad keeps the running
  maximum of the BIAS-CORRECTED second moment and divides by its root;
  ``torch.optim.AdamW(amsgrad=True)`` keeps the maximum of the uncorrected
  moment and corrects afterwards, which differs once the second moment
  falls. So no ``torch.optim`` class is used;
* sgd (with momentum, ``optax.trace``), adamax, adadelta (optax's rho 0.9),
  adagrad and rmsprop (eps inside the root, as in optax), and asgd, the
  JAX package's own transform, with its Polyak average
  (:func:`averaged_params`);
* weight decay after the core for adamw (decoupled), added to the gradient
  before it for every other optimizer (coupled); none for tensors with
  ndim <= 1, biases and tensors that are not trained (timm's
  ``param_groups_weight_decay``);
* the update scaled by -lr·lr_scale, lr = schedule(c) with c the count of
  updates made before this one (asgd applies its own lr inside). The
  two-pass step makes two updates per train step, so the schedule maps c
  to the train step s = c // 2 + 1 and both updates of a step use the same
  lr.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

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
    """The count of updates made, each per-tensor slot of the optimizer
    (slot name -> {parameter name: tensor}: Adam's ``mu``, ``nu`` and, with
    amsgrad, ``nu_max``; ASGD's ``ax``; ...) and its per-run numbers
    (``scalars``: ASGD's ``eta`` and ``mu``)."""

    count: int = 0
    slots: dict = field(default_factory=dict)
    scalars: dict = field(default_factory=dict)

    def tensors(self) -> list:
        """Every slot's tensors, slot by slot in the order the optimizer
        made them."""
        return [t for slot in self.slots.values() for t in slot.values()]


def _trained(model: torch.nn.Module) -> list:
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def _slot(state: OptState, slot: str, names: list) -> list:
    return [state.slots[slot][n] for n in names]


class Optimizer:
    """An optax chain over every trained tensor of a model, in
    ``torch._foreach_*`` ops: the gradient (plus ``weight_decay * p`` on the
    tensors that decay, for every optimizer but adamw) goes through the
    core transform (:meth:`_core`), whose result is scaled by -schedule(c)
    and then by ``lr_scale`` where one is set
    (unidefense_tpu/train/step.py:231-232,255-256). ``init(model)`` starts
    the state; ``update(model, state, lr_scale)`` applies one update from
    each parameter's ``.grad`` in place and advances ``state.count``.
    Subclasses are dataclasses with ``schedule`` and ``weight_decay``."""

    slot_names: tuple = ()  # the per-tensor slots of its state, each from zeros
    coupled_decay = True  # False: adamw adds wd * p after the core instead

    def init(self, model: torch.nn.Module) -> OptState:
        state = OptState()
        for slot in self.slot_names:
            state.slots[slot] = {n: torch.zeros_like(p) for n, p in _trained(model)}
        return state

    def _grads(self, named: list) -> tuple[list, list, list]:
        """(params, gradients with the coupled decay added, indices of the
        tensors that decay)."""
        params = [p for _, p in named]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        decay_idx = [i for i, (n, p) in enumerate(named) if decays(n, p)]
        if self.weight_decay and self.coupled_decay:  # g' = g + wd * p before the core
            for i in decay_idx:
                grads[i] = grads[i] + self.weight_decay * params[i]
        return params, grads, decay_idx

    def _core(self, names: list, grads: list, state: OptState) -> list:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, model: torch.nn.Module, state: OptState,
               lr_scale: Optional[float] = None) -> None:
        """One update of every trained parameter from its ``.grad``, in
        place; ``state`` advances by one count."""
        named = _trained(model)
        params, grads, decay_idx = self._grads(named)
        updates = self._core([n for n, _ in named], grads, state)
        if self.weight_decay and not self.coupled_decay and decay_idx:  # + wd * p after it
            torch._foreach_add_([updates[i] for i in decay_idx],
                                [params[i] for i in decay_idx], alpha=self.weight_decay)
        updates = torch._foreach_mul(updates, -self.schedule(state.count))
        if lr_scale is not None:
            torch._foreach_mul_(updates, lr_scale)
        torch._foreach_add_(params, updates)
        state.count += 1


@dataclass
class Adam(Optimizer):
    """adam / adamw, optionally amsgrad: optax's ``scale_by_adam`` and
    ``scale_by_amsgrad`` (optim.py:305-308)."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    decoupled: bool = True  # adamw; False is adam's coupled L2
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    amsgrad: bool = False

    @property
    def coupled_decay(self) -> bool:
        return not self.decoupled

    @property
    def slot_names(self) -> tuple:
        return ("mu", "nu", "nu_max") if self.amsgrad else ("mu", "nu")

    def _core(self, names, grads, state):
        b1, b2 = self.betas
        mu, nu = _slot(state, "mu", names), _slot(state, "nu", names)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
        nu_hat = torch._foreach_div(nu, 1 - b2 ** count)
        if self.amsgrad:
            nu_max = _slot(state, "nu_max", names)
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom)


@dataclass
class SGD(Optimizer):
    """sgd: ``optax.trace(decay=momentum)`` (a trace from zero, t = g +
    momentum t) when momentum is set, else the gradient itself."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    momentum: float = 0.0

    @property
    def slot_names(self) -> tuple:
        return ("trace",) if self.momentum else ()

    def _core(self, names, grads, state):
        if not self.momentum:
            return grads
        trace = _slot(state, "trace", names)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        return trace


@dataclass
class Adamax(Optimizer):
    """adamax: ``optax.scale_by_adamax`` — mu an EMA of g, nu = max(b2 nu,
    |g| + eps), the update (mu / (1 - b1^t)) / nu."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8

    slot_names = ("mu", "nu")

    def _core(self, names, grads, state):
        b1, b2 = self.betas
        mu, nu = _slot(state, "mu", names), _slot(state, "nu", names)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        abs_g = torch._foreach_abs(grads)
        torch._foreach_add_(abs_g, self.eps)
        torch._foreach_maximum_(nu, abs_g)
        mu_hat = torch._foreach_div(mu, 1 - b1 ** (state.count + 1))
        return torch._foreach_div(mu_hat, nu)


@dataclass
class Adadelta(Optimizer):
    """adadelta: ``optax.scale_by_adadelta(eps=eps)`` at optax's rho 0.9
    (the JAX package passes no rho) — e_g an EMA of g², the update
    sqrt(e_x + eps) / sqrt(e_g + eps) g with the previous e_x, then e_x an
    EMA of the update²."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    eps: float = 1e-8
    rho: float = 0.9

    slot_names = ("e_g", "e_x")

    def _core(self, names, grads, state):
        rho, eps = self.rho, self.eps
        e_g, e_x = _slot(state, "e_g", names), _slot(state, "e_x", names)
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, grads, grads, value=1 - rho)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        updates = torch._foreach_mul(num, grads)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, updates, updates, value=1 - rho)
        return updates


@dataclass
class Adagrad(Optimizer):
    """adagrad: ``optax.scale_by_rss(initial_accumulator_value=0.0, eps)`` —
    the update g rsqrt(Σg² + eps) where Σg² > 0, else 0 (eps inside the
    root, unlike ``torch.optim.Adagrad``)."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    eps: float = 1e-8

    slot_names = ("sum_of_squares",)

    def _core(self, names, grads, state):
        sums = _slot(state, "sum_of_squares", names)
        torch._foreach_addcmul_(sums, grads, grads)
        inv = torch._foreach_add(sums, self.eps)
        torch._foreach_rsqrt_(inv)
        # optax's where(Σg² > 0, rsqrt, 0): Σg² is 0 only where every g so far
        # was 0, so the product is 0 there unless rsqrt(0 + eps) is inf (eps
        # 0); capping inf at the largest float keeps that product 0
        if inv:
            torch._foreach_clamp_max_(inv, torch.finfo(inv[0].dtype).max)
        return torch._foreach_mul(inv, grads)


@dataclass
class RMSprop(Optimizer):
    """rmsprop: ``optax.scale_by_rms(decay=alpha, eps)`` — nu an EMA of g²
    from 0, the update g rsqrt(nu + eps) (eps inside the root, unlike
    ``torch.optim.RMSprop``)."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    alpha: float = 0.99
    eps: float = 1e-8

    slot_names = ("nu",)

    def _core(self, names, grads, state):
        nu = _slot(state, "nu", names)
        torch._foreach_mul_(nu, self.alpha)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.alpha)
        inv = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(inv)
        return torch._foreach_mul(inv, grads)


@dataclass
class ASGD(Optimizer):
    """asgd: the JAX package's ``scale_by_asgd`` (optim.py:111-179, after
    ``torch.optim.ASGD``), a complete transform that no schedule scaling
    follows. With eta and mu in ``state.scalars`` (eta = schedule(0) and
    mu = 1 at the start) and g' the gradient with the coupled decay:

      p_new = p (1 - lambd eta) - eta g'
      ax    = p_new if mu == 1 else ax + mu (p_new - ax)
      eta   = schedule(t) / (1 + lambd schedule(t) t)^alpha,  mu = 1 / max(1, t - t0)

    with t the count after the update. ``lr_scale`` scales the parameters'
    delta after ``ax`` took the unscaled one, as the JAX step scales the
    transform's output. :func:`averaged_params` reads ax."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0
    lambd: float = 1e-4
    alpha: float = 0.75
    t0: float = 1e6

    def init(self, model: torch.nn.Module) -> OptState:
        return OptState(slots={"ax": {n: p.detach().float().clone() for n, p in _trained(model)}},
                        scalars={"eta": float(self.schedule(0)), "mu": 1.0})

    @torch.no_grad()
    def update(self, model: torch.nn.Module, state: OptState,
               lr_scale: Optional[float] = None) -> None:
        named = _trained(model)
        params, grads, _ = self._grads(named)
        eta, mu = state.scalars["eta"], state.scalars["mu"]
        deltas = torch._foreach_mul(params, -(self.lambd * eta))
        torch._foreach_add_(deltas, grads, alpha=-eta)
        p_new = torch._foreach_add(params, deltas)
        ax = _slot(state, "ax", [n for n, _ in named])
        if mu == 1.0:
            torch._foreach_copy_(ax, p_new)
        else:
            torch._foreach_sub_(p_new, ax)
            torch._foreach_add_(ax, p_new, alpha=mu)
        if lr_scale is not None:
            torch._foreach_mul_(deltas, lr_scale)
        torch._foreach_add_(params, deltas)
        t = state.count + 1
        lr = float(self.schedule(t))
        state.scalars["eta"] = lr / (1.0 + self.lambd * lr * t) ** self.alpha
        state.scalars["mu"] = 1.0 / max(1.0, t - self.t0)
        state.count = t


def averaged_params(opt_state: OptState) -> Optional[dict]:
    """ASGD's Polyak average by parameter name (optim.py:182-188), or None
    for an optimizer that keeps none."""
    return opt_state.slots.get("ax")


def get_optimizer(name: str, schedule: Callable[[int], float], weight_decay: float = 0.0,
                  betas=(0.9, 0.999), amsgrad: bool = False, momentum: float = 0.0,
                  eps: float = 1e-8, **kwargs) -> Optimizer:
    """The optimizer for a reference optimizer name (optim.py:270-331).
    Weight decay is coupled (added to the gradient) for every optimizer but
    adamw, which decouples it. Keys an optimizer does not take (nesterov,
    dampening, ...) are ignored, as the JAX package's ``**kwargs`` ignores
    them. The one key ``alpha`` is rmsprop's decay and asgd's power."""
    name = name.lower()
    wd = float(weight_decay)
    betas = tuple(float(b) for b in betas)
    if name in ("adam", "adamw"):
        return Adam(schedule, wd, decoupled=name == "adamw", betas=betas, eps=float(eps),
                    amsgrad=bool(amsgrad))
    if name == "sgd":
        return SGD(schedule, wd, momentum=float(momentum))
    if name == "adamax":
        return Adamax(schedule, wd, betas=betas, eps=float(eps))
    if name == "adadelta":
        return Adadelta(schedule, wd, eps=float(eps))
    if name == "adagrad":
        return Adagrad(schedule, wd, eps=float(eps))
    if name == "rmsprop":
        return RMSprop(schedule, wd, alpha=float(kwargs.get("alpha", 0.99)), eps=float(eps))
    if name == "asgd":
        return ASGD(schedule, wd, lambd=float(kwargs.get("lambd", 1e-4)),
                    alpha=float(kwargs.get("alpha", 0.75)), t0=float(kwargs.get("t0", 1e6)))
    raise KeyError(f"Optimizer '{name}' not implemented")


def build_optimizer(config_cfg: dict) -> tuple[Optimizer, Callable[[int], float]]:
    """(optimizer, lr schedule) from the reference ``config:`` YAML section
    (config_template/forgery/model_udeb4.yml:12-25); sgd at lr 0.01 where it
    has no ``optimizer:``, as in JAX."""
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
