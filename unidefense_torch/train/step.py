"""Step builders (unidefense_tpu/train/step.py:53-358): the UniDefense
two-pass train step, the single-pass step and the eval step.

The two-pass step (``make_train_step``):

  pass 1 (clean):     forward, CE + mask sparsity + AW-triplet + real-only
                      pixel/rFFT reconstruction losses, backward, update 1.
                      The pass-1 masks and bottleneck embedding are kept,
                      detached, as targets for pass 2.
  pass 2 (perturbed): forward on the updated params (and the BatchNorm
                      statistics pass 1 left) with a perturbed backbone
                      input; after 10% of ``num_steps`` the mask losses are
                      KL consistency against the pass-1 masks; the
                      factorization loss is taken against the pass-1
                      embedding; backward, update 2 in the same step.

With ``faithful_grad_accumulation`` (the reference zeroes gradients once per
step) update 2 applies the SUM of the pass-1 and pass-2 gradients: the
step simply does not clear ``.grad`` between the passes.

With a process ``group`` (data parallelism, ``parallel.mesh``) each
backward pass is followed by ``mean_gradients`` before its update, as JAX
pmeans g1 and g2 (step.py:228-229,250-251), and the metrics are averaged
over the ranks in one collective (:264-265); ``cls_out`` stays this
rank's. Under faithful accumulation ``.grad`` holds mean(g1) + g2 of this
rank when pass 2's backward ends, and its mean over the ranks, mean(g1) +
mean(g2), is what update 2 applies: the sum is reduced, where JAX reduces
g2 alone and then adds g1. The two differ by the rounding of one fp32
addition per element (a few ulp of |g1| + |g2|).

With a ``mesh`` (the 2-D mode, ``parallel.mesh.create_mesh_2d``; JAX's
step built without ``axis_name`` under ``gspmd_train_step``) the step has
global-batch semantics: ``sum_real``/``sum_fake`` count the global batch,
each rank takes its rows ``mesh.rows(N)`` of it, and every rank computes
what one process computes on the whole batch. The BatchNorms sync over
'data' (``gspmd_train_step``); the triplet features, the real and fake
reconstruction errors, the masks, the embeddings and ``cls_out`` are
gathered over 'data' before the losses (``parallel.mesh.gather_rows``,
whose backward keeps this rank's rows); the gradients are summed over
'data' after each backward, the replicated ones then copied from model
index 0 of the data row (``parallel.mesh.sum_gradients``; under faithful
accumulation update 2 applies g1 + the sum of g2); the perturbation's
partners are taken from the gathered batch; every draw is made at the
global batch's shape and cut to this rank's rows
(``parallel.mesh.BatchRows``), and ``draws`` passed in are the global
batch's. The metrics and the returned ``cls_out`` are the global batch's,
the same on every rank.

Each step marks its phases with ``utils.tracing.span``: ``ud.train.step``
around the call, ``ud.train.forward``, ``ud.train.backward`` and
``ud.train.update`` in each pass, ``ud.train.perturb`` between the passes.

The model, its optimizer state, the step count and the plateau factor live
in :class:`TrainState`; the step updates them in place. Randomness comes
from one explicit ``torch.Generator``; the tests pass the flip mask and the
perturbation draws in instead (:class:`StepDraws`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn as nn

from unidefense_torch.device import DeviceLike, nchw, resolve_device
from unidefense_torch.losses import (
    asymmetric_weighted_triplet, binary_cross_entropy_with_logits, cross_entropy, factorization,
    kl_div_log_target)
from unidefense_torch.parallel.mesh import (
    Mesh2D, all_reduce_mean, batch_rows, gather_rows, mean_gradients, sum_gradients)
from unidefense_torch.train.optim import Optimizer, OptState
from unidefense_torch.train.perturb import PerturbDraws, perturb_input
from unidefense_torch.utils.tracing import span


@dataclass
class TrainState:
    model: nn.Module
    opt_state: OptState
    step: int = 0  # completed train steps
    # metric-fed LR multiplier (ReduceLROnPlateau); None means 1.0
    lr_scale: Optional[float] = None


@dataclass
class StepDraws:
    """Random choices of one train step, passed in instead of drawn."""

    flip: Optional[torch.Tensor] = None  # (N,) bool, for the preprocessing
    perturb: Optional[PerturbDraws] = None


def create_train_state(model: nn.Module, tx: Optimizer, device: DeviceLike = None) -> TrainState:
    """Move ``model`` to the device (``cuda`` unless told otherwise, in
    channels_last) and start its optimizer state."""
    model = model.to(resolve_device(device), memory_format=torch.channels_last)
    return TrainState(model=model, opt_state=tx.init(model))


def _classification_loss(cls_out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    if cls_out.shape[-1] == 1:
        return binary_cross_entropy_with_logits(cls_out[:, 0], labels.to(cls_out.dtype))
    return cross_entropy(cls_out, labels)


def _shared_losses(out: dict, labels: torch.Tensor, sum_real: int, sum_fake: int) -> dict:
    """Losses computed alike in both passes; the batch is real first."""
    ld = out["loss_dict"]
    spatial, freq = ld["spatial"], ld["freq"]
    fake = slice(sum_real, sum_real + sum_fake)
    return {
        "cls_loss": _classification_loss(out["cls_out"].float(), labels),
        "triplet_loss": sum(asymmetric_weighted_triplet(f.float(), labels, sum_real)
                            for f in ld["triplet"]),
        "real_rec_loss": spatial[:sum_real].mean(),
        "fake_rec_loss": spatial[fake].mean(),
        "real_freq_loss": freq[:sum_real].mean(),
        "fake_freq_loss": freq[fake].mean(),
    }


def _flat_log_softmax(m: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(m.reshape(m.shape[0], -1).float(), dim=-1)


def _clear_grads(model: nn.Module) -> None:
    for p in model.parameters():
        p.grad = None


def _sync_grads(model: nn.Module, group, mesh: Optional[Mesh2D] = None) -> None:
    if group is not None:
        mean_gradients(model, group)
    elif mesh is not None:
        sum_gradients(model, mesh)


# the loss_dict entries the 2-D mode gathers over 'data': every one a model
# emits, each batch-leading (triplet: a list of such tensors)
_GATHERED = ("triplet", "spatial", "freq", "freq_mask", "spat_mask", "factorization")


def _global_outputs(out: dict, mesh: Optional[Mesh2D]) -> dict:
    """``out`` with ``cls_out`` and the loss inputs of the loss_dict over the
    global batch (gathered over 'data'); ``out`` itself without a data
    axis. A loss_dict entry outside ``_GATHERED`` raises there: a loss a
    model reduced over its own rows has no global value to gather."""
    if mesh is None or mesh.data_group is None:
        return out
    ld = dict(out.get("loss_dict", {}))
    other = sorted(set(ld) - set(_GATHERED))
    if other:
        raise NotImplementedError(f"the 2-D mode gathers the loss_dict's {_GATHERED} over "
                                  f"'data', not {other}")
    triplet = list(ld.get("triplet", []))
    keys = [k for k in _GATHERED[1:] if ld.get(k) is not None]
    got = gather_rows([out["cls_out"], *triplet, *(ld[k] for k in keys)], mesh)
    ld.update(zip(keys, got[1 + len(triplet):]), triplet=list(got[1:1 + len(triplet)]))
    return {**out, "cls_out": got[0], "loss_dict": ld}


def _metrics(values: dict, group) -> dict:
    """Detached metrics, averaged over the ranks of ``group`` in one
    collective."""
    metrics = {k: v.detach() for k, v in values.items()}
    if group is None:
        return metrics
    mean = all_reduce_mean(torch.stack([v.float().reshape(()) for v in metrics.values()]), group)
    return dict(zip(metrics, mean.unbind()))


def _lambdas(config_cfg: dict, *names: str) -> list[float]:
    # the reference's .get(key, 1.) for every loss weight
    return [float(config_cfg.get(f"lambda_{n}", 1.0)) for n in names]


def _prepare(state: TrainState, batch: dict, generator, draws, preprocess,
             rows: Optional[slice] = None):
    """(x, labels) on the model's device, preprocessed; ``rows``: this rank's
    rows of the global batch (the 2-D mode), which the flips passed in are
    cut to."""
    if generator is None and draws is None:
        raise ValueError("a train step draws its flips, perturbation and dropout masks from "
                         "`generator`: pass one, or pass `draws`")
    dev = next(state.model.parameters()).device
    x, labels = batch["image"].to(dev), batch["label"].to(dev)
    if preprocess is not None:
        flip = None if draws is None else draws.flip
        if flip is not None and rows is not None:
            flip = flip[rows]
        x = preprocess(x, generator, flip)
    return x.contiguous(), labels


def _rows(mesh: Optional[Mesh2D], batch: dict, n: int) -> Optional[slice]:
    """This rank's rows of the global batch of ``n``, checked against the
    batch it was given; None without a mesh."""
    if mesh is None:
        return None
    rows = mesh.rows(n)
    if batch["label"].shape[0] != rows.stop - rows.start:
        raise ValueError(f"data rank {mesh.data_index} of {mesh.dp} takes rows "
                         f"{rows.start}:{rows.stop} of the global batch of {n}, not "
                         f"{batch['label'].shape[0]} rows")
    return rows


def _check_modes(group, mesh) -> None:
    if group is not None and mesh is not None:
        raise ValueError("a step takes `group` (the 1-D mode) or `mesh` (the 2-D mode), "
                         "not both")


def _on_rows(body: Callable, mesh: Optional[Mesh2D], n: int) -> Callable:
    """The step ``train_step(state, batch, generator=None, draws=None)`` that
    runs ``body(state, batch, generator, draws, rows)``: with a mesh on
    this rank's ``rows`` of the global batch of ``n``, its draws from a
    ``BatchRows`` copy of ``generator`` whose advanced state goes back to
    ``generator``."""

    def train_step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
                   draws: Optional[StepDraws] = None):
        with span("ud.train.step"):
            rows = _rows(mesh, batch, n)
            gen = generator if rows is None else batch_rows(generator, n, rows)
            try:
                return body(state, batch, gen, draws, rows)
            finally:
                if gen is not generator:
                    generator.set_state(gen.get_state())

    return train_step


def make_train_step(tx: Optimizer, config_cfg: dict, num_steps: int, sum_real: int, sum_fake: int,
                    faithful_grad_accumulation: bool = True, preserve_color: bool = True,
                    freq_norm: str = "ortho", preprocess: Optional[Callable] = None,
                    group=None, mesh: Optional[Mesh2D] = None) -> Callable:
    """The two-pass step ``train_step(state, batch, generator, draws=None)
    -> (state, metrics, cls_out)``. ``batch`` = {'image': NHWC (uint8 when
    ``preprocess`` is set, e.g. ``DevicePipeline(hflip_p=0.5)``), 'label':
    (N,)}, this rank's. ``config_cfg`` supplies the loss weights (lambda_*).
    The metrics are 0-d tensors: pass 1's losses and total, pass 2's mask
    and factorization losses; ``cls_out`` is pass 1's. ``group``: the
    process group gradients and metrics are averaged over (None: one
    process). ``mesh``: the 2-D mode (see the module docstring; wrap the
    step with ``parallel.mesh.gspmd_train_step``)."""
    _check_modes(group, mesh)
    lam_mask, lam_triplet, lam_recons, lam_freq, lam_fac = _lambdas(
        config_cfg, "mask", "triplet", "recons", "freq", "fac")
    kl_switch_step = num_steps * 0.1
    n = sum_real + sum_fake

    def two_pass(state: TrainState, batch: dict, generator, draws, rows):
        model = state.model
        model.train()
        x, labels = _prepare(state, batch, generator, draws, preprocess, rows)
        labels = gather_rows([labels], mesh)[0] if mesh is not None else labels
        cur_step = state.step + 1  # 1-indexed like the reference loop

        # ---- pass 1 (clean) ----
        _clear_grads(model)
        with span("ud.train.forward"):
            out = _global_outputs(model(nchw(x), generator=generator), mesh)
            ld = out["loss_dict"]
            aux1 = _shared_losses(out, labels, sum_real, sum_fake)
            total1 = (aux1["cls_loss"]
                      + lam_mask * ld["freq_mask"].float().mean()
                      + lam_mask * ld["spat_mask"].float().mean()
                      + lam_triplet * aux1["triplet_loss"]
                      + lam_recons * aux1["real_rec_loss"]
                      + lam_freq * aux1["real_freq_loss"])
            aux1["total_loss"] = total1
            gts = {"freq_mask": ld["freq_mask"].detach(), "spat_mask": ld["spat_mask"].detach(),
                   "factorization": ld["factorization"].detach().float()}
            cls_out = out["cls_out"].detach()
        with span("ud.train.backward"):
            total1.backward()
        del out, ld
        with span("ud.train.update"):
            _sync_grads(model, group, mesh)
            tx.update(model, state.opt_state, state.lr_scale)

        # ---- pass 2 (perturbed) ----
        with span("ud.train.perturb"):
            # the global batch's draws; in the 2-D mode the partners from any rank
            pd = None if draws is None else draws.perturb
            if pd is None:
                pd = PerturbDraws.draw(generator, sum_real, sum_fake, (n, *x.shape[1:]))
            source = gather_rows([x], mesh)[0] if mesh is not None and pd.style else None
            noise_x = perturb_input(x, sum_real, sum_fake, draws=pd,
                                    preserve_color=preserve_color, freq_norm=freq_norm,
                                    source=source, rows=rows)
        g1 = None
        if not faithful_grad_accumulation:
            _clear_grads(model)
        elif mesh is not None and mesh.data_group is not None:  # g2 alone is summed
            g1 = [p.grad for p in model.parameters()]
            _clear_grads(model)
        with span("ud.train.forward"):
            out = _global_outputs(model(nchw(x), noise_x=nchw(noise_x.contiguous()),
                                        generator=generator), mesh)
            ld = out["loss_dict"]
            losses = _shared_losses(out, labels, sum_real, sum_fake)
            if cur_step > kl_switch_step:  # mask consistency after 10% of the steps
                freq_mask_loss = kl_div_log_target(_flat_log_softmax(ld["freq_mask"]),
                                                   _flat_log_softmax(gts["freq_mask"]))
                spat_mask_loss = kl_div_log_target(_flat_log_softmax(ld["spat_mask"]),
                                                   _flat_log_softmax(gts["spat_mask"]))
            else:  # sparsity before
                freq_mask_loss = ld["freq_mask"].float().mean()
                spat_mask_loss = ld["spat_mask"].float().mean()
            fac_loss = factorization(ld["factorization"].float(), gts["factorization"])
            total2 = (0.1 * losses["cls_loss"]
                      + lam_mask * freq_mask_loss
                      + lam_mask * spat_mask_loss
                      + lam_triplet * losses["triplet_loss"]
                      + lam_recons * 0.1 * losses["real_rec_loss"]
                      + lam_freq * 0.1 * losses["real_freq_loss"]
                      + lam_fac * fac_loss)
        with span("ud.train.backward"):
            total2.backward()
        del out, ld
        with span("ud.train.update"):
            _sync_grads(model, group, mesh)
            if g1 is not None:
                for p, g in zip(model.parameters(), g1):
                    if g is not None:
                        p.grad = g if p.grad is None else g.add_(p.grad)
            tx.update(model, state.opt_state, state.lr_scale)

        state.step = cur_step
        aux2 = {"freq_mask_loss": freq_mask_loss, "spat_mask_loss": spat_mask_loss,
                "fac_loss": fac_loss}
        return state, _metrics({**aux1, **aux2}, group), cls_out

    return _on_rows(two_pass, mesh, n)


def make_normal_train_step(tx: Optimizer, config_cfg: dict, sum_real: int, sum_fake: int,
                           preprocess: Optional[Callable] = None, group=None,
                           mesh: Optional[Mesh2D] = None) -> Callable:
    """Single-pass step (the reference's train_normal_model): one
    forward/backward/update with CE + triplet + real-only reconstruction
    losses, plus the aux_cls_loss / aux_spatial / aux_freq terms of models
    that emit them. Same call, ``group`` and ``mesh`` as
    :func:`make_train_step`'s step (step.py:327-328,338-339)."""
    _check_modes(group, mesh)
    lam_triplet, lam_recons, lam_freq, lam_aux_cls = _lambdas(
        config_cfg, "triplet", "recons", "freq", "aux_cls")
    n = sum_real + sum_fake

    def single_pass(state: TrainState, batch: dict, generator, draws, rows):
        model = state.model
        model.train()
        x, labels = _prepare(state, batch, generator, draws, preprocess, rows)
        labels = gather_rows([labels], mesh)[0] if mesh is not None else labels
        _clear_grads(model)
        with span("ud.train.forward"):
            out = _global_outputs(model(nchw(x), generator=generator), mesh)
            ld = out.get("loss_dict", {})
            aux = _shared_losses(out, labels, sum_real, sum_fake)
            total = (aux["cls_loss"] + lam_triplet * aux["triplet_loss"]
                     + lam_recons * aux["real_rec_loss"] + lam_freq * aux["real_freq_loss"])
            if ld.get("aux_cls_loss") is not None:
                total = total + lam_aux_cls * ld["aux_cls_loss"]
            if ld.get("aux_spatial") is not None:  # real-only by contract, at 0.1x
                total = total + 0.1 * lam_recons * ld["aux_spatial"].mean()
            if ld.get("aux_freq") is not None:
                total = total + 0.1 * lam_freq * ld["aux_freq"].mean()
            aux["total_loss"] = total
        with span("ud.train.backward"):
            total.backward()
        with span("ud.train.update"):
            _sync_grads(model, group, mesh)
            tx.update(model, state.opt_state, state.lr_scale)
        state.step += 1
        return state, _metrics(aux, group), out["cls_out"].detach()

    return _on_rows(single_pass, mesh, n)


def make_eval_step(model: torch.nn.Module, preprocess: Optional[Callable] = None) -> Callable:
    """Inference step: P(real) = softmax(cls_out)[:, 0]. The returned
    ``eval_step(x, generator=None)`` takes an NHWC batch (uint8 when
    ``preprocess`` is set) and returns (probs, cls_out, rec)."""

    @torch.inference_mode()
    def eval_step(x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if preprocess is not None:
            x = preprocess(x, generator)
        out = model(nchw(x.contiguous()))
        probs = torch.softmax(out["cls_out"].float(), dim=-1)[:, 0]
        return probs, out["cls_out"], out["rec"]

    return eval_step
