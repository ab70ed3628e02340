"""Readings that set a cell's limits: the compared numbers of the program
over many seeds, and of the control, the plain reference computed one
precision below the configuration's (``reference.control`` in the
configuration file) and put in the program's place, on some of them.

    python3 pebench/control.py --workload <cell> --seeds 11,12,13 \
        [--control-seeds 11,12,13] [--fault half_batch] [--out readings.jsonl]

Each seed runs one whole edit of the cell's traffic through the timed path
(set-up anew from that seed, a window of one edit), then reads the checked
steps against the reference.  One JSON line a seed, with ``correct`` as
the run's check would judge those readings under the configuration's
limits, and ``rows_apart``, how far the two CFG rows' outputs lie apart.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).parent]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pebench import run as R  # noqa: E402


def control_run(bench: dict, cell_name: str, seeds: list, control_seeds: list,
                device: str = "cuda", root: Path = R.ROOT, fault: str | None = None):
    """Yields one dict of readings a seed; ``fault`` plants one of
    ``faults.FAULTS`` under the timed path."""
    import contextlib

    import torch

    from pebench.faults import FAULTS
    from pebench.reference.arith import Arith

    cell = R.find_cell(bench, cell_name)
    config, traffic, runner_mod = R.cell_files(bench, cell, root)
    arith = Arith(config["reference"]["arith"])
    control = Arith(config["reference"]["control"])
    for seed in seeds:
        t0 = time.perf_counter()
        runner = runner_mod.Runner(config, traffic, seed, torch.device(device))
        runner.setup()
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            win = runner.window(0.0)
        runner.release()
        t1 = time.perf_counter()
        if seed in control_seeds:
            prog, ctrl = runner.control_readings(arith, control)
        else:
            prog, ctrl = runner.readings(arith), None
        got = dict(prog, nonfinite_edits=runner.failed())
        yield {"workload": cell_name, "seed": seed, "fault": fault, "check_steps": runner.check_steps,
               "correct": all(got[k] <= lim for k, lim in config["limits"].items()),
               "rows_apart": runner.rows_apart(), "program": prog, "control": ctrl,
               "failed": got["nonfinite_edits"],
               "edit_s": win["seconds"], "setup_and_edit_s": t1 - t0,
               "reference_s": time.perf_counter() - t1}
        del runner
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    R._environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None, help="plant a fault of pebench/faults.py")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pebench.control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    print(json.dumps(R.card_line()), flush=True)
    try:
        for rec in control_run(R.load_bench(), args.workload, seeds, ctrl,
                                  fault=args.fault):
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    R._guard("after the readings")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
