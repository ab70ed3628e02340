"""Run one cell of ``BENCHMARK.json`` once and print one result line.

    python3 pebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``pebench/configs/<name>.json``) and a
traffic mix (``pebench/traffic/<name>.json``), whose ``runner`` names the
general code that runs that kind of traffic (``pebench/runners/``).  A
runner's ``window`` returns ``seconds``, ``attempted`` and whatever else
its ``end_to_end`` reads, all copied into the result's ``window``;
``failed`` counts the attempts that failed and ``check`` gives the numbers
compared, each with its limit.  The per-layer metrics of a traced run are
the files ``pebench/metrics/<name>.py`` that ``BENCHMARK.json`` lists for
the cell.  A run: set-up (imports, kernel build from the checkout's cache,
weights and inputs drawn on the card from the seed, a warm-up at the
window's shapes), the window, then the check of what the window produced
against the plain reference (``pebench/reference/``).  The last line of
standard output is the result, its only line; standard error opens with
the card's name, power limit and clocks, and ends with the numbers
compared, each beside its limit, which are the result's last key
too.  Without a CUDA device, or with fewer than the cell asks for, the
run exits with code 2 and prints no result; if the process has loaded JAX
or the JAX package, it exits with code 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "physicedit_tpu")


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("USE_TF", "0")
    # run as a script, the interpreter put pebench/ first on the path, where
    # its modules would shadow others of the same name
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def _guard(when: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"pebench: {when}: the process has loaded {', '.join(found[:20])}",
              file=sys.stderr)
        raise SystemExit(3)


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"pebench: no workload {name!r} in BENCHMARK.json")


def cell_files(bench: dict, cell: dict, root: Path = ROOT):
    """(configuration, traffic, runner module) of a cell, found by name."""
    import importlib

    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "pebench" / "traffic" / f"{cell['traffic']}.json").read_text())
    runner = importlib.import_module(f"pebench.runners.{traffic['runner']}")
    return config, traffic, runner


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The cell's end-to-end (``end_to_end``) or per-layer (``per_layer``)
    metric entries."""
    return [m for m in bench[kind] if cell["name"] in m.get("workloads", [cell["name"]])]


def card_line() -> dict:
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"nvidia-smi: {exc}"
    return {"card": out.splitlines()[0] if out else ""}


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None, root: Path = ROOT) -> dict:
    """One run of a cell; returns the result dict.  On a device other than
    CUDA (the CPU tests) the timed numbers are left out: ``metrics`` is empty."""
    import torch

    from pebench import tracing as T

    t_start = T_START if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cell = find_cell(bench, cell_name)
    config, traffic, runner_mod = cell_files(bench, cell, root)
    runner = runner_mod.Runner(config, traffic, seed, dev)
    t_setup = time.perf_counter()
    runner.setup()
    _guard("after set-up")
    setup_s = time.perf_counter() - t_start
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = T.Tracer(dev) if trace else None
    win = runner.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    _guard("after the window")

    metrics, breakdown, dev_info = {}, None, {"platform": "cpu", "kind": "cpu", "count": 0,
                                              "memory_peak_bytes": 0}
    if on_card:
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                    "memory_peak_bytes": int(peak)}
    if trace:
        run = tracer.run(runner.shapes())
        if on_card:
            from pebench import metrics as M

            for m in cell_metrics(bench, cell, "per_layer"):
                value = M.load(m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev_info["busy_s"] = run.busy_s
            dev_info["window_s"] = run.window_s
            breakdown = T.breakdown(run)
        del run, tracer
    elif on_card:
        e2e = {"setup_s": setup_s, "peak_mem_gb": peak / 1e9}
        e2e.update(runner.end_to_end(win))
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    runner.release()
    checks = runner.check()
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": runner.failed(), "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # where set-up went: before the runner's (imports, the card's query),
    # then the runner's own phases
    phases = {"start_s": t_setup - t_start, **getattr(runner, "setup_phases", {})}
    result["window"] = {**win, "setup_s": setup_s, "setup_phases": phases, "seed": seed}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"pebench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    print(json.dumps(card_line()), file=sys.stderr, flush=True)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    _guard("before the result")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
