"""Time two checkouts of this repository on one card in turns: before,
after, after, before.  The shared part of the before / after tools
(``w4_before_after``, ``proto_before_after``).

Each turn is a fresh process, started in the checkout's root with only that
checkout on ``PYTHONPATH``, that runs a tool's worker script: it builds the
checkout's kernel sources into the checkout's own ``build/`` and prints one
JSON line per timed case, each with ``kernel``, ``case``, ``shape``, ``ms``
and optionally ``graph_ms``.  :func:`compare` prints the card, every turn's
lines and then, per case, both checkouts' means and their ratio, on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

SIDES = ("before", "after", "after", "before")
TIMES = ("ms", "graph_ms")


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def run_turn(tool: str, checkout: Path, worker: str, arg: str) -> list[dict]:
    """One process in ``checkout`` running ``worker`` with ``arg``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(checkout)
    done = subprocess.run([sys.executable, "-c", worker, arg], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=1200)
    if done.returncode != 0:
        raise SystemExit(f"{tool}: the turn in {checkout} failed:\n{done.stderr}")
    return [json.loads(line) for line in done.stdout.splitlines() if line.startswith("{")]


def compare(tool: str, before: Path, after: Path, worker: str, arg: str) -> int:
    """Run the four turns and print their lines and the per-case summary.
    Returns 2 without a card."""
    import torch

    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device; this tool measures the card", file=sys.stderr)
        return 2
    print(json.dumps({"card": card()}), flush=True)
    times: dict = {}
    for turn, side in enumerate(SIDES):
        checkout = (before if side == "before" else after).resolve()
        for row in run_turn(tool, checkout, worker, arg):
            print(json.dumps({"turn": turn, "side": side, **row}), flush=True)
            times.setdefault((row["kernel"], row["case"]), {}).setdefault(side, []).append(row)
    for (kernel, case), sides in times.items():
        out = {"kernel": kernel, "case": case, "shape": sides["after"][0]["shape"]}
        for key in TIMES:
            if key in sides["after"][0]:
                out.update({f"{side}_{key}": statistics.mean(r[key] for r in rows)
                            for side, rows in sides.items()})
                out[f"after_over_before_{key}"] = out[f"after_{key}"] / out[f"before_{key}"]
        print(json.dumps(out), flush=True)
    return 0


def main(tool: str, description: str, worker: str, arg: str, argv=None) -> int:
    """The tools' command line: ``--before DIR [--after DIR]``, ``--after``
    by default the checkout this module is in."""
    ap = argparse.ArgumentParser(prog=f"python -m physicedit_torch.tools.{tool}",
                                 description=description)
    ap.add_argument("--before", required=True, type=Path, help="root of the earlier checkout")
    ap.add_argument("--after", type=Path, default=Path(__file__).resolve().parents[2],
                    help="root of the later checkout (default: this one)")
    args = ap.parse_args(argv)
    return compare(tool, args.before, args.after, worker, arg)
