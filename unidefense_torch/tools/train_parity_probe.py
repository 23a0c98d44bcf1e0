"""Where the fp32 two-pass training step of a model leaves the card and the
CPU apart: a probe of ``chip_smoke.py``'s ``[train-parity-*]`` phase.

    python -m unidefense_torch.tools.train_parity_probe --model UDR18 [--out FILE]
    python -m unidefense_torch.tools.train_parity_probe --model UDR18 --device cpu

Logs, first, ``perturbation``: the step's pass-2 perturbation (CORAL,
then the FFT amplitude mix) stage by stage, the CPU's fp32 against float64
and the card's against the CPU's (``perturbation_stages``). Then it runs
the phase's step (256^2, 2 real + 2 fake, fp32, every rate 0, fixed draws,
the model's YAML optimizer, ``chip_smoke.seeded_weights``) and logs the
phase's readings (the largest pass-1 loss gap, each pass-2 loss's gap, the
largest gradient-norm gap) of each step against a reference:

- ``fp64``: the CPU step against the same step with the model and every
  loss in float64 (the fp32 step's own rounding error);
- ``cuda``: the card's step against the CPU's;
- ``cuda lr0``: both with lr 0, so that pass 2 runs on pass 1's weights;
- ``cpu from cuda update 1``: the CPU's pass 2 from the card's weights
  after update 1, against the card (a pass-2 gap that stays comes from
  pass 2, not from update 1);
- ``cuda plain sfconv``: the card's step with the SFConv frequency branch
  in plain torch ops instead of K2 and K2-bwd, against the CPU's;
- ``cuda again``: the card's step against itself, run again;

and, for the bottleneck embedding that ``fac_loss`` compares (pass 2's
against pass 1's), ``embedding``: how far the perturbed pass-2 input, the
pooled pass-2 features and the embeddings are from the reference's (max
|d| over max |e|, each pass), ``fac_loss`` evaluated in float64 from these
embeddings against from the reference's, how far ``fac_loss`` moves when
the reference's pass-2 embedding moves by 1e-6 of its largest value
(N(0, 1), seeded), and the spread of the pooled features that the
bottleneck normalises over the batch (std over |mean| per feature:
smallest, median).

With ``--device cpu`` only the CPU's readings run (``perturbation``,
``fp64``, ``fp64 embedding``); seeded weights then come from the CPU. The
card's TF32 is off throughout, as in the phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# the losses of pass 2, computed after update 1
PASS2_LOSSES = ("freq_mask_loss", "spat_mask_loss", "fac_loss")


class _Recording:
    """The step's optimizer; after update 1 it keeps the weights, and sets
    them to ``after1`` when that is given."""

    def __init__(self, tx, after1: dict | None = None):
        self.tx, self.after1, self.calls = tx, after1, 0
        self.params1: dict = {}

    def init(self, model):
        return self.tx.init(model)

    def update(self, model, state, lr_scale=None):
        self.calls += 1
        self.tx.update(model, state, lr_scale)
        if self.calls == 1:
            if self.after1 is not None:
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        p.copy_(self.after1[n].to(p.dtype))
            self.params1 = {n: p.detach().double().cpu().clone()
                            for n, p in model.named_parameters()}


@contextlib.contextmanager
def _float64_losses():
    """``Tensor.float()`` keeps float64 tensors float64, so the step's
    losses and statistics stay in float64 when the model is."""
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (self if self.dtype == torch.float64
                                                else cast(self, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = cast


@contextlib.contextmanager
def _plain_sfconv():
    """The SFConv frequency branch in plain torch ops (autograd for the
    backward) instead of K2 and K2-bwd."""
    from unidefense_torch.models import layers
    from unidefense_torch.ops.sfconv_spatial import sfconv_freq_spatial

    kernel = layers.sfconv_freq
    layers.sfconv_freq = sfconv_freq_spatial
    try:
        yield
    finally:
        layers.sfconv_freq = kernel


def run_step(weights: dict, model: str, device: str, lr: float | None = None,
             after1: dict | None = None, float64: bool = False,
             plain_sfconv: bool = False) -> dict:
    """The ``[train-parity]`` step: its losses, gradient norms (pass 1 plus
    pass 2), weights after update 1, and the bottleneck's input and output
    in each pass (float64, on the CPU)."""
    import chip_smoke as cs
    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.models.registry import build_model
    from unidefense_torch.train.optim import build_optimizer
    from unidefense_torch.train.perturb import PerturbDraws
    from unidefense_torch.train.step import StepDraws, create_train_state, make_train_step

    spec = cs.model_spec(model)
    config = spec["config"]
    if lr is not None:
        config = dict(config, optimizer=dict(config["optimizer"], lr=lr))
    cfg = dict(spec["model"], drop_rate=0.0, drop_connect_rate=0.0, feat_drop_rate=0.0)
    draws = PerturbDraws.draw(torch.Generator().manual_seed(cs.SEED + 7), 2, 2, (4, 256, 256, 3))
    draws = StepDraws(flip=torch.tensor([True, False, False, True]),
                      perturb=dataclasses.replace(draws, style=True, freq=True))
    dtype = torch.float64 if float64 else torch.float32
    net = build_model(model, cfg, dtype=dtype).to(dtype)
    net.load_state_dict(weights, strict=True)
    tx = _Recording(build_optimizer(config)[0], after1)
    state = create_train_state(net, tx, device=device)
    step = make_train_step(tx, config, spec["num_steps"], 2, 2,
                           preprocess=DevicePipeline(hflip_p=0.5))
    pooled, emb, noise_x = [], [], []
    from unidefense_torch.train import step as step_module
    perturb = step_module.perturb_input

    def perturbed(*args, **kwargs):
        out = perturb(*args, **kwargs)
        noise_x.append(out.detach().double().cpu())
        return out

    def keep(m, args, out):
        pooled.append(args[0].detach().double().cpu())
        emb.append(out.detach().double().cpu())

    hook = state.model.bottleneck.register_forward_hook(keep)
    with contextlib.ExitStack() as stack:
        stack.callback(setattr, step_module, "perturb_input", perturb)
        step_module.perturb_input = perturbed
        if float64:
            stack.enter_context(_float64_losses())
        if plain_sfconv:
            stack.enter_context(_plain_sfconv())
        _, metrics, _ = step(state, cs._train_batch(2, 2, 256, cs.SEED + 8, device), None, draws)
    hook.remove()
    return dict(losses={k: float(v) for k, v in metrics.items()},
                grad_norms={n: float(p.grad.norm()) for n, p in state.model.named_parameters()
                            if p.grad is not None},
                params1=tx.params1, pooled=pooled, emb=emb, noise_x=noise_x[0])


def compare(got: dict, ref: dict) -> dict:
    """The phase's readings of ``got`` against ``ref``: the largest relative
    gap of the pass-1 losses, every pass-2 loss's gap, and the largest
    gradient-norm gap by |g| + 1e-4 of the total."""
    lg, lc = got["losses"], ref["losses"]

    def rel(k):
        return abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12)

    gc = ref["grad_norms"]
    total = sum(v * v for v in gc.values()) ** 0.5
    grad, worst = max((abs(got["grad_norms"][n] - v) / (v + 1e-4 * total), n)
                      for n, v in gc.items())
    return {"pass1_losses": max(rel(k) for k in lc if k not in PASS2_LOSSES),
            **{k: rel(k) for k in PASS2_LOSSES},
            "grad_norms": grad, "grad_worst": worst}


def embedding(got: dict | None, ref: dict) -> dict:
    """``fac_loss``'s inputs: ``got``'s embeddings against ``ref``'s, the
    loss in float64 from each, its response to a 1e-6 move of ``ref``'s
    pass-2 embedding, and the spread of ``ref``'s pooled features."""
    from unidefense_torch.losses import factorization

    e1, e2 = ref["emb"]
    fac = float(factorization(e2, e1))
    noise = torch.randn(e2.shape, generator=torch.Generator().manual_seed(0), dtype=e2.dtype)
    moved = float(factorization(e2 + 1e-6 * e2.abs().max() * noise, e1))
    spread = (ref["pooled"][1].std(0) / ref["pooled"][1].mean(0).abs().clamp_min(1e-30))
    out = {"fac_loss_f64": fac, "fac_loss_moved_1e-6": abs(moved - fac) / fac,
           "pooled_spread_min": float(spread.min()),
           "pooled_spread_median": float(spread.median())}
    if got is not None:
        g1, g2 = got["emb"]
        x = ref["noise_x"]
        out.update(
            noise_x_max_rel=float((got["noise_x"] - x).abs().max() / x.abs().max()),
            pooled2_max_rel=float((got["pooled"][1] - ref["pooled"][1]).abs().max()
                                  / ref["pooled"][1].abs().max()),
            pass1_max_rel=float((g1 - e1).abs().max() / e1.abs().max()),
            pass2_max_rel=float((g2 - e2).abs().max() / e2.abs().max()),
            fac_loss_f64_from_got=abs(float(factorization(g2, g1)) - fac) / fac)
    return out


def perturbation_stages(device: str) -> dict:
    """The step's pass-2 perturbation (CORAL, then the FFT amplitude mix)
    stage by stage on ``device`` in fp32 and on the CPU in fp32 and float64:
    max |d| over max |ref| of each stage, fp32 against float64 on the CPU
    and ``device`` against the CPU. "cov summed in fp32" is the source
    covariance as a plain product in the input's dtype; "cov" is
    ``coral._cov``'s (products summed in float64)."""
    import chip_smoke as cs
    from unidefense_torch.data.transforms import DevicePipeline
    from unidefense_torch.ops import coral
    from unidefense_torch.ops.eig3 import sym_eig3x3
    from unidefense_torch.ops.style import frequency_style_transfer
    from unidefense_torch.train.perturb import PerturbDraws

    d = PerturbDraws.draw(torch.Generator().manual_seed(cs.SEED + 7), 2, 2, (4, 256, 256, 3))
    flip = torch.tensor([True, False, False, True])
    x = DevicePipeline()(cs._train_batch(2, 2, 256, cs.SEED + 8, "cpu")["image"], None, flip)

    def stages(x):
        x_s = torch.cat([x[:2][d.perm_real.to(x.device)], x[2:][d.perm_fake.to(x.device)]])
        f, m, sd = coral._flatten_mean_std(x_s.float())
        n = (f - m) / sd
        cov = coral._cov(n)
        vals, vecs = sym_eig3x3(cov)
        # the same product summed in n's dtype, as the port summed it before
        cov_plain = n @ n.transpose(1, 2) + torch.eye(3, dtype=n.dtype, device=n.device)
        out = {"cov summed in fp32": cov_plain, "cov": cov, "eigvals": vals, "eigvecs": vecs,
               "inv_sqrt": coral._mat_inv_sqrt(cov), "coral": coral.coral(x_s, x)}
        out["freq_transfer"] = frequency_style_transfer(x, out["coral"], d.lmda.to(x.device))
        return {k: v.detach().double().cpu() for k, v in out.items()}

    def rel(a, b):
        return {k: float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in b}

    cpu = stages(x)
    with _float64_losses():
        f64 = stages(x.double())
    out = {"cpu vs fp64": rel(cpu, f64)}
    if device != "cpu":
        out[f"{device} vs cpu"] = rel(stages(x.to(device)), cpu)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="UDR18", choices=("UDEB4", "UDR18", "UDR50"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the fp64 and the CPU's embedding readings only")
    ap.add_argument("--out", help="write the readings as JSON here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("train_parity_probe: no CUDA device", file=sys.stderr)
            return 2
        card = cs.card_line()
        weights = cs.seeded_weights(card, args.model)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    else:
        card = "cpu"
        weights = cs.seeded_weights(card, args.model, "cpu")
    readings = {"perturbation": perturbation_stages(args.device)}
    cpu = run_step(weights, args.model, "cpu")
    f64 = run_step(weights, args.model, "cpu", float64=True)
    readings.update({"fp64": compare(cpu, f64), "fp64 embedding": embedding(cpu, f64)})
    if args.device == "cuda":
        cuda = run_step(weights, args.model, "cuda")
        readings["cuda"] = compare(cuda, cpu)
        readings["cuda embedding"] = embedding(cuda, cpu)
        readings["cuda lr0"] = compare(run_step(weights, args.model, "cuda", lr=0.0),
                                       run_step(weights, args.model, "cpu", lr=0.0))
        readings["cpu from cuda update 1"] = compare(
            run_step(weights, args.model, "cpu", after1=cuda["params1"]), cuda)
        plain = run_step(weights, args.model, "cuda", plain_sfconv=True)
        readings["cuda plain sfconv"] = compare(plain, cpu)
        readings["cuda plain sfconv embedding"] = embedding(plain, cpu)
        readings["cuda again"] = compare(run_step(weights, args.model, "cuda"), cuda)
    for k, v in readings.items():
        cs.log(f"[probe] {args.model} {k}: {json.dumps(v)}")
    cs.log(f"[probe] {card}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(model=args.model, card=card, **readings),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
