"""Export a port run's checkpoint to the reference's torch format
(tools/export_checkpoint.py).

The port's ``ckpt/{best,latest}/model.pt`` holds the model's ``state_dict``
under the reference's key names, apart from the optimizer state, so the
export reads no optimizer and builds no model: it writes
``{'model': state_dict, 'step', 'best_*'}``, the reference's save format
(engine/forgery_engine.py:215-223), which the reference's test path,
``Predictor.from_torch_checkpoint`` and ``config.init_weights`` read.

    python -m unidefense_torch.tools.export_checkpoint --run runs/UDEB4/my-exp \\
        --out exported_udeb4.bin [--best]
"""

from __future__ import annotations

import argparse
from typing import Optional

from unidefense_torch.checkpoint import CheckpointManager
from unidefense_torch.models.convert import write_checkpoint


def export_run(run_dir: str, out_path: str, best: bool = False) -> int:
    """Write the run's best (or latest) checkpoint to ``out_path``, with the
    scalar entries of its sidecar; returns its step."""
    ckpt = CheckpointManager(run_dir)
    if not ckpt.exists(best):
        raise FileNotFoundError(f"no ckpt/{'best' if best else 'latest'} in {ckpt.run_dir}")
    state_dict, meta = ckpt.restore_serving(best=best)
    step = int(meta.get("step", 0))
    write_checkpoint(state_dict, out_path, step,
                     {k: v for k, v in meta.items() if isinstance(v, (int, float, str))})
    return step


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", required=True, help="run directory (holds ckpt/)")
    ap.add_argument("--out", required=True, help="output .bin path")
    ap.add_argument("--best", action="store_true", help="export best (default: latest)")
    args = ap.parse_args(argv)
    step = export_run(args.run, args.out, args.best)
    print(f"exported {args.run} step {step} -> {args.out}")


if __name__ == "__main__":
    main()
