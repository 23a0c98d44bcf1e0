"""The UDR18 two-pass step of tests/test_torch_udr_train.py (64², 2 real + 2
fake, the same bridged weights and draws) run in float64 on both sides, to
tell the port's gaps from JAX's own: not a test (pytest does not collect
it), a probe whose readings ROADMAP.md quotes.

    JAX_PLATFORMS=cpu python tests/probe_udr_float64.py

float64: ``jax_enable_x64`` with ``jnp.float32`` read as float64 (the JAX
package casts to it in its layers, losses and FFTs), and the port built in
float64 with ``Tensor.float()`` keeping float64; both preprocess the uint8
frames in float64. The constants both sides round to fp32 (the Hilbert
matrix, the JAX DFT and resize matrices) stay fp32. Prints, for each pair,
the largest relative gap of every loss and of each gradient norm (pass 1,
and pass 1 plus pass 2 as update 2 applies it), over the tensors whose
norm exceeds 1e-3 of the total and over the sf_coef scalars:

- port against JAX;
- JAX against JAX from weights scaled by 1 + 1e-14 N(0, 1) (seeded);
- the port against the port from the same weights.
"""

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tests.test_torch_models import _randomise  # noqa: E402
from tests.test_torch_resnet import _scaled  # noqa: E402
from tests.test_torch_train import (  # noqa: E402
    N, NUM_STEPS, SUM_FAKE, SUM_REAL, RecordingAdam, _batch, _recorder, _step_draws, _step_key)
from tests.test_torch_udr_train import CFG  # noqa: E402
from unidefense_torch.models.convert import state_dict_from_jax  # noqa: E402
from unidefense_torch.models.registry import build_model  # noqa: E402
from unidefense_torch.train import optim as toptim  # noqa: E402
from unidefense_torch.train.step import create_train_state, make_train_step  # noqa: E402
from unidefense_tpu.data.transforms import DevicePipeline as JaxDevicePipeline  # noqa: E402
from unidefense_tpu.models.unidefense import UniDefenseModelRes18  # noqa: E402
from unidefense_tpu.train import optim as joptim  # noqa: E402
from unidefense_tpu.train.step import TrainState as JaxTrainState  # noqa: E402
from unidefense_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402

JITTER = 1e-14


@contextlib.contextmanager
def float64():
    cast, f32 = torch.Tensor.float, jnp.float32
    torch.Tensor.float = lambda self, *a, **k: (self if self.dtype == torch.float64
                                                else cast(self, *a, **k))
    jnp.float32 = jnp.float64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        torch.Tensor.float, jnp.float32 = cast, f32


def jax_step(v):
    """(metrics, pass-1 gradients, update-2 gradients) of the JAX step."""
    jm = UniDefenseModelRes18(drop_rate=0.0, feat_drop_rate=0.0, dtype=jnp.float64)
    tx = optax.chain(_recorder(), joptim.build_optimizer(CFG, v["params"])[0])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    step = jax.jit(jax_make_train_step(jm, tx, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE,
                                       preprocess=JaxDevicePipeline(hflip_p=0.5,
                                                                    out_dtype=jnp.float64)))
    frames, labels = _batch()
    state, metrics, _ = step(state, {"image": jnp.asarray(frames), "label": jnp.asarray(labels)},
                             _step_key(0, "freq_style"))
    grads = [state_dict_from_jax({"params": jax.tree.map(np.asarray, g)})
             for g in state.opt_state[0][::-1]]
    return {k: float(m) for k, m in metrics.items()}, *grads


def port_step(sd):
    """The same for the port from the torch state_dict ``sd``."""
    model = build_model("UDR18", {"drop_rate": 0.0, "feat_drop_rate": 0.0},
                        dtype=torch.float64).to(torch.float64)
    model.load_state_dict(sd, strict=True)
    tx = RecordingAdam(**toptim.build_optimizer(CFG)[0].__dict__)
    state = create_train_state(model, tx, device="cpu")

    def preprocess(x, generator, flip):  # the JAX pipeline's plain path, in float64
        x = x.double() / 255.0
        x = torch.where(flip.view(-1, 1, 1, 1), x.flip(2), x)
        return (x - 0.5) / 0.5

    step = make_train_step(tx, CFG, NUM_STEPS, SUM_REAL, SUM_FAKE, preprocess=preprocess)
    frames, labels = _batch()
    _, metrics, _ = step(state, {"image": torch.from_numpy(frames),
                                 "label": torch.from_numpy(labels)}, None,
                         _step_draws(_step_key(0, "freq_style")))
    return {k: float(m) for k, m in metrics.items()}, *tx.seen


def gaps(a, b) -> str:
    """``a``'s losses and gradient norms against ``b``'s."""
    la, lb = a[0], b[0]
    loss, lk = max((abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-300), k) for k in lb)
    parts = [f"losses {loss:.3g} at {lk}"]
    for label, ga, gb in (("pass-1", a[1], b[1]), ("update-2", a[2], b[2])):
        norms = {n: float(torch.as_tensor(t).double().norm()) for n, t in gb.items() if n in ga}
        total = sum(v * v for v in norms.values()) ** 0.5

        def rel(n):
            return abs(float(torch.as_tensor(ga[n]).double().norm()) - norms[n]) / norms[n]

        big = max((rel(n), n) for n, v in norms.items() if v > 1e-3 * total)
        sf = max((rel(n), n) for n in norms if n.endswith("sf_coef"))
        parts.append(f"{label} gradients {big[0]:.3g} at {big[1]} (norm > 1e-3 of the "
                     f"total), sf_coef {sf[0]:.3g} at {sf[1]}")
    return "; ".join(parts)


def main():
    jm = UniDefenseModelRes18(drop_rate=0.0, feat_drop_rate=0.0, dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((N, 64, 64, 3)), train=False)
    v = jax.tree.map(np.asarray, _scaled(_randomise(v)))
    sd = state_dict_from_jax(v)
    rng = np.random.default_rng(11)
    with float64():
        v64 = jax.tree.map(lambda a: a.astype(np.float64) if a.dtype.kind == "f" else a, v)
        moved = jax.tree.map(lambda a: a * (1 + JITTER * rng.standard_normal(a.shape))
                             if a.dtype.kind == "f" else a, v64)
        gen = torch.Generator().manual_seed(11)
        sd_moved = {k: t.double() * (1 + JITTER * torch.randn(t.shape, generator=gen,
                                                                dtype=torch.float64))
                    if t.is_floating_point() else t for k, t in sd.items()}
        jax_ref, port = jax_step(v64), port_step(sd)
        print(f"port vs JAX: {gaps(port, jax_ref)}", flush=True)
        print(f"JAX from weights moved by {JITTER:g} vs JAX: {gaps(jax_step(moved), jax_ref)}",
              flush=True)
        print(f"port from weights moved by {JITTER:g} vs port: {gaps(port_step(sd_moved), port)}",
              flush=True)


if __name__ == "__main__":
    main()
