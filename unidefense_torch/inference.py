"""Serving API (unidefense_tpu/inference.py): a ``Predictor`` that holds a
model on the card and scores uint8 RGB frames, K1 preprocessing included.
Weights come from a port run's checkpoint (``from_run``), a reference
``{'model': state_dict}`` file (``from_torch_checkpoint``), a
``state_dict`` or a JAX model's variables; ``quantize="int8"`` holds the
>= 2-D weights as int8 with per-channel scales (ops/quant.py);
``num_devices=N`` holds N replicas (unidefense_tpu/inference.py:36-39,85-91)
and splits every batch over them.

Example:
    pred = Predictor.from_run("runs/UDEB4/exp1", "UDEB4", input_size=380)
    probs = pred.predict_frames(frames_u8)           # (N,) P(real)
    video = pred.predict_video(frames_u8)            # scalar P(real)
"""

from __future__ import annotations

import contextlib
import copy
from typing import Iterable, Optional

import numpy as np
import torch

from unidefense_torch.data.transforms import DevicePipeline, resize_plain
from unidefense_torch.device import DeviceLike, resolve_device
from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.models.convert import load_unidefense_checkpoint, state_dict_from_jax
from unidefense_torch.models.registry import build_model
from unidefense_torch.ops.quant import Int8Weights, param_bytes
from unidefense_torch.parallel.mesh import check_num_devices
from unidefense_torch.train.step import make_eval_step
from unidefense_torch.utils.tracing import span


def _on(dev: torch.device):
    """The replica's card as the current device (the kernels launch on the
    current device); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def resize_frames(frames_u8: np.ndarray, size: int) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, size, size, 3) uint8 (``resize_plain``):
    within one intensity level of ``cv2.resize``'s INTER_LINEAR."""
    return resize_plain(frames_u8, size, size)


class Predictor:
    """Runs on ``cuda`` unless ``device`` says otherwise. Without
    ``state_dict`` the weights are random, drawn from ``seed``.
    ``v4_widths``: the SFConv widths routed to K3 (default ``UD_SFCONV_V4``,
    see ``models/layers.SFConv``). ``quantize``: None or ``"int8"``, whose
    weights stay on the device as int8 and per-channel scales and are
    dequantized in ``dtype`` into the model's weights before each batch.
    ``num_devices``: N replicas of the model (int8 weights each their own),
    on cuda:0..N-1 (on ``device`` N times for the CPU); each batch is split
    into N equal chunks, every chunk launched on its replica before any is
    waited on, and the probabilities come back in frame order.
    ``batch_size`` must be a multiple of N, and N at most the cards of this
    host. ``counts`` holds, since construction, the ``frames`` asked for,
    the batch ``slots`` run (``batch_size`` a batch, padding included) and
    the ``batches``."""

    def __init__(self, model_name: str, model_cfg: Optional[dict] = None,
                 state_dict: Optional[dict] = None, input_size: int = 256,
                 batch_size: int = 32, dtype: torch.dtype = torch.bfloat16,
                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                 device: DeviceLike = None, seed: int = 0,
                 v4_widths: Optional[Iterable[int]] = None, quantize: Optional[str] = None,
                 num_devices: Optional[int] = None):
        if num_devices and batch_size % num_devices:
            raise ValueError(
                f"batch_size {batch_size} not divisible by num_devices {num_devices}"
            )
        self.device = resolve_device(device)
        self.num_devices = num_devices
        if num_devices and num_devices > 1:
            check_num_devices(num_devices, self.device)
        self.model_name = model_name
        self.model_cfg = dict(model_cfg or {})
        self.input_size = input_size
        self.batch_size = batch_size
        self.dtype = dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = build_model(model_name, self.model_cfg, dtype=dtype, v4_widths=v4_widths)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.device_tf = DevicePipeline(mean=mean, std=std, hflip_p=0.0)
        self.quantize = quantize
        self.counts = {"frames": 0, "slots": 0, "batches": 0}
        self._install()

    def _replica_devices(self) -> list:
        n = self.num_devices or 1
        if n == 1:
            return [self.device]
        if self.device.type == "cuda":
            return [torch.device("cuda", i) for i in range(n)]
        return [self.device] * n

    def _install(self) -> None:
        """The replicas of the model's current weights, each with its eval
        step, quantized when ``quantize`` asks for it. Checked here, not only
        in __init__, so that a constructor that sets ``quantize`` after
        loading gets the same check."""
        if self.quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {self.quantize!r} (use 'int8')")
        self._replicas = []
        for i, dev in enumerate(self._replica_devices()):
            model = self.model if i == 0 else copy.deepcopy(self.model).to(dev)
            self._replicas.append((dev, make_eval_step(model, preprocess=self.device_tf),
                                   Int8Weights(model) if self.quantize == "int8" else None))
        _, self._eval, self._int8 = self._replicas[0]

    def param_bytes(self) -> int:
        """Parameter bytes of one replica as stored (int8-aware; no buffers,
        as the JAX package counts its ``params`` tree, replicated once)."""
        return param_bytes(self.model) if self._int8 is None else self._int8.nbytes()

    @classmethod
    def from_jax_variables(cls, variables: dict, model_name: str, **kw) -> "Predictor":
        """Serve the weights of a JAX model ({'params', 'batch_stats'})."""
        return cls(model_name, state_dict=state_dict_from_jax(variables), **kw)

    @classmethod
    def from_run(cls, run_dir: str, model_name: str, model_cfg: Optional[dict] = None,
                 best: bool = True, **kw) -> "Predictor":
        """Serve a port run's checkpoint (``ckpt/best``, or ``ckpt/latest``
        with best=False); the optimizer state is not read."""
        state_dict, _ = CheckpointManager(run_dir).restore_serving(best=best)
        return cls(model_name, model_cfg, state_dict=state_dict, **kw)

    @classmethod
    def from_torch_checkpoint(cls, ckpt_path: str, model_name: str,
                              model_cfg: Optional[dict] = None, **kw) -> "Predictor":
        """Serve a reference-format checkpoint (``{'model': state_dict}``
        .bin, as released or as ``tools/export_checkpoint`` writes it),
        loaded non-strict (``models/convert.load_unidefense_checkpoint``):
        tensors the file lacks keep the seeded init. Quantizes after
        loading when asked."""
        quantize = kw.pop("quantize", None)
        pred = cls(model_name, model_cfg, **kw)
        load_unidefense_checkpoint(pred.model, ckpt_path)
        pred.quantize = quantize
        pred._install()
        return pred

    def predict_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 RGB -> (N,) P(real), in fixed-size batches (the
        last one padded by repeating its last frame). Adds to ``counts``."""
        with span("ud.serve.request"):
            n = frames_u8.shape[0]
            self.counts["frames"] += n
            if frames_u8.shape[1:3] != (self.input_size, self.input_size):
                frames_u8 = resize_frames(frames_u8, self.input_size)
            bs = self.batch_size
            chunk = bs // len(self._replicas)
            batches = []  # (each replica's probabilities, valid frames), read at the end
            for start in range(0, n, bs):
                with span("ud.serve.stage"):
                    idx = list(range(start, min(n, start + bs)))
                    n_valid = len(idx)
                    idx += [idx[-1]] * (bs - n_valid)
                    frames = np.ascontiguousarray(frames_u8[idx])
                    inputs = []
                    for r, (dev, _, _) in enumerate(self._replicas):
                        with _on(dev):
                            inputs.append(
                                torch.from_numpy(frames[r * chunk:(r + 1) * chunk]).to(dev))
                with span("ud.serve.forward"):
                    parts = []
                    for (dev, eval_step, int8), batch in zip(self._replicas, inputs):
                        with _on(dev):
                            if int8 is not None:
                                int8.dequantize_into(self.dtype)
                            parts.append(eval_step(batch)[0])
                batches.append((parts, n_valid))
                self.counts["slots"] += bs
                self.counts["batches"] += 1
            if not batches:
                return np.empty(0, np.float32)
            return torch.cat([torch.cat([p.cpu() for p in parts])[:n_valid]
                              for parts, n_valid in batches]).numpy()

    def predict_video(self, frames_u8: np.ndarray) -> float:
        """Mean frame probability (the reference's video-level rule)."""
        return float(self.predict_frames(frames_u8).mean())

    def classify(self, frames_u8: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        """0 = real, 1 = attack, at the given P(real) threshold."""
        return (self.predict_frames(frames_u8) <= threshold).astype(np.int64)
