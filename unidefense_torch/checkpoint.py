"""Checkpoints with real resume (unidefense_tpu/checkpoint.py:26-171).

A checkpoint carries the whole train state: the model's ``state_dict``
(BatchNorm running statistics included), the optimizer's moments and count
(``OptState``) and the step, plus the engine's best-metric bookkeeping in a
JSON sidecar, so training resumes exactly.

Layout: ``<run_dir>/ckpt/{best,latest}/`` holding ``model.pt`` (the
``state_dict`` and the step) and ``opt.pt`` (the ``OptState``), each a
``torch.save``, beside ``{best,latest}.meta.json``. A save writes
``<name>.tmp`` and its sidecar first, then removes the old checkpoint and
renames the new one into place, in the JAX package's order. A crash while
the files are written leaves the previous checkpoint whole. A kill between
the removal and the last rename leaves no checkpoint of that name (a resume
then starts fresh) or one without its sidecar (a resume then takes the step
from ``model.pt`` and starts its best-metric bookkeeping anew). The plateau
LR multiplier ``lr_scale`` rides in the sidecar.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from unidefense_torch.train.optim import OptState
from unidefense_torch.train.step import TrainState


def _read_meta(path: str) -> dict:
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _host(tensors: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tensors.items()}


class CheckpointManager:
    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "ckpt")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, best: bool) -> str:
        return os.path.join(self.ckpt_dir, "best" if best else "latest")

    def save(self, state: TrainState, meta: dict, best: bool = False):
        """Save the state and the scalar metadata; the per-validation
        best/latest scheme of engine/forgery_engine.py:215-223."""
        path = self._path(best)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        if state.lr_scale is not None:
            meta = dict(meta, lr_scale=float(state.lr_scale))
        opt = state.opt_state
        torch.save({"model": _host(state.model.state_dict()), "step": state.step},
                   os.path.join(tmp, "model.pt"))
        torch.save({"count": opt.count, "mu": _host(opt.mu), "nu": _host(opt.nu),
                    "nu_max": _host(opt.nu_max)}, os.path.join(tmp, "opt.pt"))
        with open(tmp + ".meta.json", "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        if os.path.exists(path + ".meta.json"):
            os.remove(path + ".meta.json")
        os.rename(tmp, path)
        os.rename(tmp + ".meta.json", path + ".meta.json")

    def exists(self, best: bool = False) -> bool:
        return os.path.exists(self._path(best))

    def restore_serving(self, best: bool = True) -> tuple[dict, dict]:
        """(state_dict, meta) on the CPU without reading the optimizer state
        (an AdamW-amsgrad checkpoint holds three more copies of the
        weights)."""
        path = self._path(best)
        payload = torch.load(os.path.join(path, "model.pt"), map_location="cpu")
        return payload["model"], _read_meta(path)

    def restore(self, target_state: TrainState, best: bool = False) -> tuple[TrainState, dict]:
        """Load a checkpoint into ``target_state`` in place, on the device of
        its model: the weights and statistics, the optimizer's moments and
        count, the step and ``lr_scale``."""
        path = self._path(best)
        device = next(target_state.model.parameters()).device
        model = torch.load(os.path.join(path, "model.pt"), map_location=device)
        opt = torch.load(os.path.join(path, "opt.pt"), map_location=device)
        target_state.model.load_state_dict(model["model"], strict=True)
        target_state.step = int(model["step"])
        target_state.opt_state = OptState(count=int(opt["count"]), mu=opt["mu"], nu=opt["nu"],
                                          nu_max=opt["nu_max"])
        meta = _read_meta(path)
        if meta.get("lr_scale") is not None:
            target_state.lr_scale = float(meta["lr_scale"])
        return target_state, meta


def save_params_only(path: str, model: torch.nn.Module):
    """Export inference weights (the ``state_dict``, no optimizer state)."""
    torch.save(_host(model.state_dict()), os.path.abspath(path))


def load_params_only(path: str, target: Optional[torch.nn.Module] = None):
    """The ``state_dict`` saved by :func:`save_params_only`, loaded into
    ``target`` (strict) when one is given; returns ``target`` or the dict."""
    state_dict = torch.load(os.path.abspath(path), map_location="cpu")
    if target is None:
        return state_dict
    target.load_state_dict(state_dict, strict=True)
    return target
