"""Time K1 (``normalize_flip``) of two source trees in turns on one card.

    git archive <parent> | tar -x -C parent_tree      # a tree .gitignore lists
    python -m unidefense_torch.tools.k1_ab --parent parent_tree

Each turn is a process of its own with that tree's ``unidefense_torch``
first on the path, so it builds and launches that tree's kernel through that
tree's wrapper. The inputs (seeded on the card), the shapes (the serving and
training batches at 380^2, fp32 and bf16) and the timing are the same for
both: this tree's ``chip_smoke.time_cold_ms`` (L2 evicted before each
launch), ``time_queued_ms`` (back to back behind a spin on the card, so the
host's cost per call does not show) and ``time_ms`` (back to back as the
host issues them). The default order is parent, change, change, parent.
Prints a line per turn and shape. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = ((32, 380), (20, 380))

# one turn: argv = tree, path of the chip_smoke.py whose timing is used
_TURN = r"""
import importlib.util, json, sys
tree, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("k1_ab_timing", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
import unidefense_torch
from unidefense_torch.ops.preprocess import normalize_flip
if not unidefense_torch.__file__.startswith(tree):
    raise RuntimeError(f"imported {unidefense_torch.__file__}, not the tree {tree}")
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
out = {}
for n, size in %(shapes)r:
    x = torch.randint(0, 256, (n, size, size, 3), generator=gen, device="cuda", dtype=torch.uint8)
    flip = torch.rand(n, generator=gen, device="cuda") < 0.5
    for dt in (torch.float32, torch.bfloat16):
        def fn():
            return normalize_flip(x, flip, cs.K1_MEAN, cs.K1_STD, dt)
        out[f"{n}x{size}x{size}x3 {dt}"] = dict(
            cold=cs.time_cold_ms(fn), queued=cs.time_queued_ms(fn), warm=cs.time_ms(fn))
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree")
    ap.add_argument("--order", default="PCCP", help="P = parent, C = this tree")
    args = ap.parse_args()
    trees = {"P": Path(args.parent).resolve(), "C": ROOT}
    code = _TURN % {"shapes": SHAPES}
    failed = False
    for i, tag in enumerate(args.order):
        proc = subprocess.run([sys.executable, "-c", code, str(trees[tag]), str(ROOT / "chip_smoke.py")],
                              cwd=trees[tag], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"[k1_ab] run {i} ({tag}): exit {proc.returncode}\n{proc.stderr[-4000:]}", flush=True)
            failed = True
            continue
        for key, t in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            print(f"[k1_ab] run {i} ({tag}) {key}: cold {t['cold']:.4f} ms, queued "
                  f"{t['queued']:.4f} ms, warm {t['warm']:.4f} ms", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
