"""Serving API (unidefense_tpu/inference.py): a ``Predictor`` that holds a
model on the card and scores uint8 RGB frames, K1 preprocessing included.
Weights come from a port run's checkpoint (``from_run``), a reference
``{'model': state_dict}`` file (``from_torch_checkpoint``), a
``state_dict`` or a JAX model's variables; ``quantize="int8"`` holds the
>= 2-D weights as int8 with per-channel scales (ops/quant.py).

Example:
    pred = Predictor.from_run("runs/UDEB4/exp1", "UDEB4", input_size=380)
    probs = pred.predict_frames(frames_u8)           # (N,) P(real)
    video = pred.predict_video(frames_u8)            # scalar P(real)
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from unidefense_torch.data.transforms import DevicePipeline, resize_plain
from unidefense_torch.device import DeviceLike, resolve_device
from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.config import check_num_devices
from unidefense_torch.models.convert import load_unidefense_checkpoint, state_dict_from_jax
from unidefense_torch.models.registry import build_model
from unidefense_torch.ops.quant import Int8Weights, param_bytes
from unidefense_torch.train.step import make_eval_step


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
    ``num_devices``: one device; more waits for ROADMAP.md's parallelism
    item."""

    def __init__(self, model_name: str, model_cfg: Optional[dict] = None,
                 state_dict: Optional[dict] = None, input_size: int = 256,
                 batch_size: int = 32, dtype: torch.dtype = torch.bfloat16,
                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                 device: DeviceLike = None, seed: int = 0,
                 v4_widths: Optional[Iterable[int]] = None, quantize: Optional[str] = None,
                 num_devices: Optional[int] = None):
        check_num_devices(num_devices)
        self.device = resolve_device(device)
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
        self._eval = make_eval_step(self.model, preprocess=self.device_tf)
        self.quantize = quantize
        self._install()

    def _install(self) -> None:
        """Quantize the model's current weights when ``quantize`` asks for
        it. Checked here, not only in __init__, so that a constructor that
        sets ``quantize`` after loading gets the same check."""
        if self.quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {self.quantize!r} (use 'int8')")
        self._int8 = Int8Weights(self.model) if self.quantize == "int8" else None

    def param_bytes(self) -> int:
        """Parameter bytes as stored (int8-aware; no buffers, as the JAX
        package counts its ``params`` tree)."""
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
        last one padded by repeating its last frame)."""
        n = frames_u8.shape[0]
        if frames_u8.shape[1:3] != (self.input_size, self.input_size):
            frames_u8 = resize_frames(frames_u8, self.input_size)
        bs = self.batch_size
        probs = []
        for start in range(0, n, bs):
            idx = list(range(start, min(n, start + bs)))
            n_valid = len(idx)
            idx += [idx[-1]] * (bs - n_valid)
            batch = torch.from_numpy(np.ascontiguousarray(frames_u8[idx])).to(self.device)
            if self._int8 is not None:
                self._int8.dequantize_into(self.dtype)
            p, _, _ = self._eval(batch)
            probs.append(p[:n_valid])
        return torch.cat(probs).cpu().numpy() if probs else np.empty(0, np.float32)

    def predict_video(self, frames_u8: np.ndarray) -> float:
        """Mean frame probability (the reference's video-level rule)."""
        return float(self.predict_frames(frames_u8).mean())

    def classify(self, frames_u8: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        """0 = real, 1 = attack, at the given P(real) threshold."""
        return (self.predict_frames(frames_u8) <= threshold).astype(np.int64)
