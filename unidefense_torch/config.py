"""Configuration loading (unidefense_tpu/config.py:24-83): the reference's
two-level YAML surface and ``main.py``'s flags.

A model config has `model:` / `config:` / `data:` sections, where `data.file`
points at a dataset YAML (methods, fpv, num_steps, transform lists, ...).
Additive keys, as in the JAX package:

* config.precision: 'fp32' (default, reference parity) or 'bf16' (bf16
  compute, fp32 params and optimizer state);
* config.faithful_grad_accumulation: the reference's no-zero-grad-between-
  passes quirk (default true; see train/step.py).

``--engine`` defaults to ``UE`` (the UniAttack engine), as in the JAX CLI.
The port runs on one card: ``--num_devices`` above 1 is refused
(:func:`check_num_devices`).
"""

from __future__ import annotations

import argparse
import copy
from typing import Optional

import yaml


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.load(f, Loader=yaml.FullLoader)


def load_config(
    config_path: str,
    engine: str = "UE",
    local_rank: int = 0,
    exp_id: Optional[str] = None,
    ds_config: Optional[str] = None,
) -> dict:
    """Load the model config and apply CLI overrides (main.py:44-53)."""
    config = load_yaml(config_path)
    config.setdefault("config", {})
    config["config"]["local_rank"] = local_rank
    config["config"]["engine"] = engine
    config["cfg_path"] = config_path
    if exp_id is not None:
        config["config"]["id"] = exp_id
    if ds_config is not None:
        config.setdefault("data", {})["file"] = ds_config
    return config


def load_dataset_config(config: dict) -> dict:
    """Resolve data.file into the dataset options dict
    (engine/forgery_engine.py:54-56)."""
    return load_yaml(config["data"]["file"])


def arg_parser(argv=None) -> argparse.Namespace:
    """CLI parity with the reference's main.py:8-35."""
    parser = argparse.ArgumentParser(
        description="Training and Testing Script for UniDefense (PyTorch, one GPU)."
    )
    parser.add_argument("--config", type=str, required=True,
                        help="Path of the configuration file to be used.")
    parser.add_argument("--engine", type=str, default="UE",
                        choices=["FE", "OCIM", "UE"],
                        help="Engine: 'FE' (Forgery), 'OCIM' (FAS), 'UE' (UniAttack).")
    parser.add_argument("--local_rank", "-r", type=int, default=0,
                        help="Process index for multi-host training, or the device "
                             "index for single-device testing; 0 on one card.")
    parser.add_argument("--exp_id", type=str, default=None, help="Overwrite exp id.")
    parser.add_argument("--ds_config", type=str, default=None,
                        help="Overwrite dataset config path.")
    parser.add_argument("--offline", action="store_true",
                        help="Disable external experiment tracking (local JSONL only).")
    parser.add_argument("--test", action="store_true",
                        help="Activate test mode (otherwise: training mode).")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Number of GPUs; the port runs on one (ROADMAP.md: parallelism).")
    return parser.parse_args(argv)


def deep_copy_cfg(cfg: dict) -> dict:
    return copy.deepcopy(cfg)


def check_num_devices(num_devices) -> None:
    """The port trains, tests and serves on one card; more waits for
    ROADMAP.md's parallelism item."""
    if num_devices is not None and int(num_devices) > 1:
        raise NotImplementedError(
            f"num_devices={num_devices}: unidefense_torch runs on one GPU; data parallelism "
            "waits for ROADMAP.md's item 'parallelism'")
