"""Experiment tracking (unidefense_tpu/utils/logging.py:17-76): JSONL metrics
+ optional wandb.

The reference logs to Weights & Biases (rank 0) and tees stdout to
records.txt (engine/abstract_engine.py:73-111, utils/misc.py:25-36). Here the
primary sink is a local metrics.jsonl (always works offline); wandb is used
when importable and not --offline, with the same project/group/name scheme.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class TrainLogger:
    def __init__(
        self,
        run_dir: Optional[str],
        project: str = "UniDefense",
        group: str = "Abstract",
        name: str = "run",
        config: Optional[dict] = None,
        offline: bool = False,
        enabled: bool = True,
    ):
        self.enabled = enabled and run_dir is not None
        self._jsonl = None
        self._wandb = None
        if not self.enabled:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if not offline:
            try:
                import wandb  # type: ignore

                self._wandb = wandb
                wandb.init(dir=run_dir, project=project, group=group, name=name)
                if config:
                    wandb.config.update(config, allow_val_change=True)
            except Exception:
                self._wandb = None

    def log(self, info: dict, step: int):
        if not self.enabled:
            return
        rec = {"step": step, "ts": time.time(), **info}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(info, step=step)

    def log_image(self, name: str, figure, step: int):
        """Upload a matplotlib figure to the tracker (reference:
        engine/abstract_engine.py:103-106 logs recon grids via
        wandb.log({name: wandb.Image(fig)})). JSONL records the event; the
        pixels go to wandb when available."""
        if not self.enabled:
            return
        rec = {"step": step, "ts": time.time(), "image": name}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            try:
                self._wandb.log({name: self._wandb.Image(figure)}, step=step)
            except Exception:
                pass

    def finish(self):
        if not self.enabled:
            return
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
