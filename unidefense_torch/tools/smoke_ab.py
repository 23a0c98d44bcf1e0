"""Run ``chip_smoke.py`` of two source trees in turns on one card and
summarise the readings side by side.

    git archive <parent> | tar -x -C parent_tree      # a tree .gitignore lists
    python -m unidefense_torch.tools.smoke_ab --parent parent_tree [--out DIR]

The default order is parent, change, change, parent (``--order PCCP``), so
that a drift of the card over the call falls on both trees alike. Each run's
full output goes to ``<out>/smoke_ab_<i>_<P|C>.log`` (default
``smoke_ab_logs/``); the summary prints, per run, the summed kernel lines
(``[K2] per UDEB4 forward ...``), K1's time per batch, the serving and training rates and the
profiled device time and busy share. Every run builds its tree's kernels in
that tree. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_PATTERNS = {
    # a kernel summed over a workload: per UDEB4, UDR18 or UDR50 pass, or per A/B pass
    "kernel": re.compile(r"^\[(K\d(?:-bwd)?)\] (per .*?) \(\d+ launches\): kernel ([\d.]+) ms"),
    # K1 per batch: warm back to back (every tree), cold (trees that time it)
    "k1": re.compile(r"^\[K1\] (\d+x\d+x\d+)x3 -> torch\.(\w+).*?(?:kernel|warm) ([\d.]+) ms"),
    "k1_cold": re.compile(r"^\[K1\] (\d+x\d+x\d+)x3 -> torch\.(\w+).*?kernel cold ([\d.]+) ms"),
    "rate": re.compile(r"^\[((?:serve|train)(?:-v4|-udr18|-udr50)?)\] .*?([\d.]+) img/s"),
    "profile": re.compile(r"^\[profile\] (.*?): wall ([\d.]+) ms, device busy ([\d.]+) ms "
                          r"\(busy share ([\d.]+)\)"),
}


def summarise(text: str) -> dict:
    """Readings of one chip_smoke log: {name: value}."""
    got: dict = {}
    for line in text.splitlines():
        if m := _PATTERNS["kernel"].match(line):
            got[f"{m[1]} {m[2]} ms"] = float(m[3])
        elif m := _PATTERNS["k1"].match(line):
            got[f"K1 {m[1]} {m[2]} warm ms"] = float(m[3])
            if c := _PATTERNS["k1_cold"].match(line):
                got[f"K1 {m[1]} {m[2]} cold ms"] = float(c[3])
        elif m := _PATTERNS["rate"].match(line):
            got[f"[{m[1]}] img/s"] = float(m[2])
        elif m := _PATTERNS["profile"].match(line):
            got[f"{m[1]}: device ms"] = float(m[3])
            got[f"{m[1]}: busy share"] = float(m[4])
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree")
    ap.add_argument("--order", default="PCCP", help="P = parent, C = this tree")
    ap.add_argument("--quick", action="store_true", help="pass --quick to chip_smoke.py")
    ap.add_argument("--out", default=str(ROOT / "smoke_ab_logs"), help="directory for the logs")
    args = ap.parse_args()
    trees = {"P": Path(args.parent).resolve(), "C": ROOT}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs, failed = [], False
    for i, tag in enumerate(args.order):
        cmd = [sys.executable, "chip_smoke.py"] + (["--quick"] if args.quick else [])
        proc = subprocess.run(cmd, cwd=trees[tag], capture_output=True, text=True)
        log = out / f"smoke_ab_{i}_{tag}.log"
        log.write_text(proc.stdout + proc.stderr)
        print(f"[smoke_ab] run {i} ({tag}, {trees[tag]}): exit {proc.returncode}, log {log}",
              flush=True)
        failed |= proc.returncode != 0
        runs.append((tag, summarise(proc.stdout)))
    keys = sorted({k for _, r in runs for k in r})
    print("[smoke_ab] reading | " + " | ".join(f"{i} {t}" for i, (t, _) in enumerate(runs)))
    for k in keys:
        print(f"[smoke_ab] {k} | " + " | ".join(str(r.get(k, "-")) for _, r in runs))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
