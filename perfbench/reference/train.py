"""The reference's training step and scoring, plain float32 PyTorch.

``two_pass_step`` is the UniDefense two-pass step as the configuration
states it (the paper's recipe, as the port's ``train/step.make_train_step``
implements it): K1's normalisation and flip, pass 1 (cross entropy, mask
sparsity, the asymmetric weighted triplet, the real-only pixel and rFFT
reconstruction losses), update 1, the perturbation of pass 2, pass 2 (after
10% of the steps KL consistency of the masks with pass 1's, the
factorization loss against pass 1's embedding), update 2 with the pass-1
gradient kept (faithful accumulation). With R ranks it is the data-parallel
step over their rows at once: BatchNorm over every rank's rows, each loss
over its rank's rows, the mean of the ranks' losses differentiated.

``AdamW`` is optax's ``adamw`` with ``scale_by_amsgrad`` (the running
maximum of the bias-corrected second moment), decoupled weight decay on the
trained tensors of two or more dimensions that are not biases, and
``StepLR`` on the train step (two updates a step).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from perfbench.reference.model import nchw
from perfbench.reference.numerics import Draws
from perfbench.reference.perturb import PerturbDraws, perturb_input

_EPS = 1e-12


# ------------------------------------------------------------------ losses

def cross_entropy(logits, labels):
    return -torch.log_softmax(logits, -1).gather(-1, labels.long()[:, None])[:, 0].mean()


def kl_div_log_target(log_pred, log_target):
    return (log_target.exp() * (log_target - log_pred)).sum() / log_pred.shape[0]


def aw_triplet(feat, n_real: int):
    """Asymmetric weighted triplet: real anchors (the first ``n_real`` rows),
    the other reals as positives, every fake as a negative."""
    sq = (feat * feat).sum(1, keepdim=True)
    dist = (sq + sq.t() - 2.0 * feat @ feat.t()).clamp(min=_EPS).sqrt()
    rows = dist[:n_real]
    off = ~torch.eye(n_real, dtype=torch.bool, device=feat.device)
    d_ap = rows[:, :n_real][off].view(n_real, n_real - 1)
    d_an = rows[:, n_real:]
    wp = d_ap.exp() / (d_ap.exp().sum(1, keepdim=True) + _EPS)
    wn = (-d_an).exp() / ((-d_an).exp().sum(1, keepdim=True) + _EPS)
    margin = (wn * d_an).sum(1) - (wp * d_ap).sum(1)
    return F.softplus(-margin).mean()


def factorization(a, b, off_weight: float = 0.005, eps: float = 1e-6):
    a = (a - a.mean(0)) / (a.std(0) + eps)
    b = (b - b.mean(0)) / (b.std(0) + eps)
    c = a.t() @ b / a.shape[0]
    d = c.shape[0]
    diag = torch.diagonal(c)
    off = ((c ** 2).sum() - (diag ** 2).sum()) / (d * d - d)
    return ((diag - 1.0) ** 2).mean() + off_weight * off


# --------------------------------------------------------------- optimizer

class AdamW:
    def __init__(self, model, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = False, step_size: int = 0,
                 gamma: float = 1.0):
        self.named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.wd, self.amsgrad, self.step_size, self.gamma = weight_decay, amsgrad, step_size, gamma
        self.count = 0
        self.frozen = False  # a fault for the control's readings: updates change nothing
        self.mu = {n: torch.zeros_like(p) for n, p in self.named}
        self.nu = {n: torch.zeros_like(p) for n, p in self.named}
        self.nu_max = {n: torch.zeros_like(p) for n, p in self.named}

    def lr_now(self) -> float:
        step = self.count // 2 + 1
        return self.lr * (self.gamma ** ((step - 1) // self.step_size) if self.step_size else 1.0)

    @torch.no_grad()
    def update(self) -> None:
        if self.frozen:
            return
        lr, t = self.lr_now(), self.count + 1
        for n, p in self.named:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            nu_hat = nu / (1 - self.b2 ** t)
            if self.amsgrad:
                torch.maximum(self.nu_max[n], nu_hat, out=self.nu_max[n])
                nu_hat = self.nu_max[n]
            u = (mu / (1 - self.b1 ** t)) / (nu_hat.sqrt() + self.eps)
            if self.wd and p.dim() > 1 and not n.endswith(".bias"):
                u = u + self.wd * p
            p.sub_(lr * u)
        self.count += 1


def build_optimizer(model, config_cfg: dict) -> AdamW:
    opt = dict(config_cfg["optimizer"])
    if opt.pop("name").lower() != "adamw":
        raise NotImplementedError("the reference has AdamW only")
    sched = dict(config_cfg.get("scheduler") or {})
    if sched and sched.get("name") != "StepLR":
        raise NotImplementedError("the reference has StepLR only")
    return AdamW(model, lr=float(opt["lr"]), betas=tuple(float(b) for b in opt["betas"]),
                 weight_decay=float(opt.get("weight_decay", 0.0)),
                 amsgrad=bool(opt.get("amsgrad", False)),
                 step_size=int(sched.get("step_size", 0)), gamma=float(sched.get("gamma", 1.0)))


# ---------------------------------------------------------------- the step

def normalize(u8, flip=None, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
    """uint8 NHWC -> float32 NHWC, (u/255 - mean)/std, mirrored along W
    where ``flip``."""
    x = u8
    if flip is not None:
        x = torch.where(flip.view(-1, 1, 1, 1), x.flip(2), x)
    m = torch.tensor(mean, dtype=torch.float32, device=u8.device)
    s = torch.tensor(std, dtype=torch.float32, device=u8.device)
    return (x.float() / 255.0 - m) / s


def _rank_losses(out, labels, sl, n_real):
    ld = out["loss_dict"]
    real = slice(sl.start, sl.start + n_real)
    return {
        "cls_loss": cross_entropy(out["cls_out"][sl], labels[sl]),
        "triplet_loss": sum(aw_triplet(f[sl], n_real) for f in ld["triplet"]),
        "real_rec_loss": ld["spatial"][real].mean(),
        "real_freq_loss": ld["freq"][real].mean(),
    }


def _log_softmax_rows(m):
    return torch.log_softmax(m.reshape(m.shape[0], -1), -1)


def two_pass_step(model, opt: AdamW, images_u8: torch.Tensor, gens: list, n_real: int,
                  n_fake: int, cur_step: int, config_cfg: dict, num_steps: int,
                  hflip_p: float = 0.5, rows_kept: Optional[int] = None) -> dict:
    """One two-pass step on the rows of ``len(gens)`` ranks, rank r's
    [n_real reals ‖ n_fake fakes] at rows r·(n_real + n_fake) on, its draws
    from ``gens[r]`` in the program's order (the flips; pass 1's masks; the
    perturbation; pass 2's masks). Returns pass 1's total loss (the ranks'
    mean) and rank 0's pass-1 logits. ``rows_kept``: a fault for the
    control's readings, every loss of a rank taken over its first
    ``rows_kept`` reals and fakes only."""
    lam = {k: float(config_cfg.get(f"lambda_{k}", 1.0))
           for k in ("mask", "triplet", "recons", "freq", "fac")}
    n = n_real + n_fake
    ranks = len(gens)
    dev = images_u8.device
    labels = torch.tensor(([0] * n_real + [1] * n_fake) * ranks, device=dev)
    flips = [torch.rand((n,), generator=g, device=g.device).to(dev) < hflip_p for g in gens]
    x = normalize(images_u8, torch.cat(flips))
    sl = [slice(r * n, (r + 1) * n) for r in range(ranks)]
    kept = n_real if rows_kept is None else rows_kept
    keep = torch.cat([torch.cat([torch.arange(s.start, s.start + kept),
                                 torch.arange(s.start + n_real, s.start + n_real + kept)])
                      for s in sl]).to(dev)

    def per_rank(out):
        if rows_kept is None:
            return out, labels, sl, n_real
        ld = dict(out["loss_dict"])
        cut = {k: ld[k][keep] for k in ("factorization", "freq_mask", "spat_mask", "spatial",
                                        "freq")}
        cut["triplet"] = [f[keep] for f in ld["triplet"]]
        m = 2 * kept
        return ({"cls_out": out["cls_out"][keep], "loss_dict": cut}, labels[keep],
                [slice(r * m, (r + 1) * m) for r in range(ranks)], kept)

    model.train()
    for p in model.parameters():
        p.grad = None
    out = model(nchw(x), draws=Draws(gens, [n] * ranks))
    o, lab, rs, nr = per_rank(out)
    ld = o["loss_dict"]
    totals = []
    for s in rs:
        aux = _rank_losses(o, lab, s, nr)
        totals.append(aux["cls_loss"] + lam["mask"] * ld["freq_mask"][s].mean()
                      + lam["mask"] * ld["spat_mask"][s].mean()
                      + lam["triplet"] * aux["triplet_loss"] + lam["recons"] * aux["real_rec_loss"]
                      + lam["freq"] * aux["real_freq_loss"])
    total1 = torch.stack(totals).mean()
    logits = out["cls_out"][sl[0]].detach().clone()
    gts = {k: ld[k].detach() for k in ("freq_mask", "spat_mask", "factorization")}
    total1.backward()
    del out, o, ld
    opt.update()

    noisy = []
    for r, g in enumerate(gens):
        pd = PerturbDraws.draw(g, n_real, n_fake, (n, *x.shape[1:]))
        noisy.append(perturb_input(x[sl[r]], n_real, n_fake, draws=pd))
    noise_x = torch.cat(noisy)
    out = model(nchw(x), noise_x=nchw(noise_x.contiguous()), draws=Draws(gens, [n] * ranks))
    o, lab, rs, nr = per_rank(out)
    ld = o["loss_dict"]
    totals = []
    for s in rs:
        aux = _rank_losses(o, lab, s, nr)
        if cur_step > num_steps * 0.1:
            fm = kl_div_log_target(_log_softmax_rows(ld["freq_mask"][s]),
                                   _log_softmax_rows(gts["freq_mask"][s]))
            sm = kl_div_log_target(_log_softmax_rows(ld["spat_mask"][s]),
                                   _log_softmax_rows(gts["spat_mask"][s]))
        else:
            fm, sm = ld["freq_mask"][s].mean(), ld["spat_mask"][s].mean()
        totals.append(0.1 * aux["cls_loss"] + lam["mask"] * fm + lam["mask"] * sm
                      + lam["triplet"] * aux["triplet_loss"]
                      + lam["recons"] * 0.1 * aux["real_rec_loss"]
                      + lam["freq"] * 0.1 * aux["real_freq_loss"]
                      + lam["fac"] * factorization(ld["factorization"][s], gts["factorization"][s]))
    torch.stack(totals).mean().backward()
    del out, o, ld
    opt.update()
    return {"total_loss": float(total1.detach()), "logits": logits}


@torch.no_grad()
def frame_scores(model, frames_u8: torch.Tensor, block: int = 32) -> torch.Tensor:
    """P(real) of every frame, eval mode, in blocks of ``block`` frames."""
    model.eval()
    out = []
    for i in range(0, frames_u8.shape[0], block):
        x = normalize(frames_u8[i:i + block])
        logits = model(nchw(x))["cls_out"]
        out.append(torch.softmax(logits, -1)[:, 0])
    return torch.cat(out)


def median(values) -> float:
    v = sorted(values)
    m = len(v) // 2
    return v[m] if len(v) % 2 else 0.5 * (v[m - 1] + v[m])
