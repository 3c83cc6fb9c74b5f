#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on one CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last: each number compared with its limit);
the last lines of standard error are those numbers again.  Exits non-zero,
with no result, without a CUDA card, when the checkout lacks the program, or
when the JAX package (or JAX, ``bench.py``, ``chip_smoke.py``, ``tests/``) has
been imported.  See benchmark/README.md."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT  # the checkout's root, not this folder
    # kernel caches inside the checkout, at fixed paths (the program builds
    # its own under build/ too)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

REFUSED = ("jax", "jaxlib", "flax", "kmer_id_tpu", "bench", "chip_smoke", "tests")


def refused_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is refused: ``kmer_id_tpu_torch`` is not ``kmer_id_tpu``."""
    return sorted(m for m in modules if m.split(".", 1)[0] in REFUSED)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def result_line(cell, rec, peak: int, checked, traced: bool, device: str) -> dict:
    from benchmark import spec
    from benchmark.check import LIMITS

    numbers, failed, attempted = checked
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    import torch

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": failed == 0 and all(numbers[k] <= LIMITS[k] for k in numbers),
            "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        p = rec.trace.profile
        dev["busy_s"], dev["window_s"] = p.busy_s, p.window_s
        line["breakdown"] = {"device_ops": p.device_ops, "idle_gaps": p.idle_gaps}
    line["checks"] = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    return line


def main(argv=None, device: str = "cuda", overrides=None) -> int:
    """One run.  ``device`` and ``overrides`` ({"config": {...}, "traffic":
    {...}} merged into the cell's files) are for the CPU tests only: the
    command line always asks for the card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import cell as cellmod
    from benchmark import spec

    cell = spec.load_cell(args.workload)
    for part, values in (overrides or {}).items():
        getattr(cell, part).update(values)
    if device != "cpu":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        cellmod.say(f"card: {card_line()}")
    rec, peak, checked = cellmod.run(cell, args.seed, args.seconds, bool(args.trace), device,
                                     T_START)
    bad = refused_modules(sys.modules)
    if bad:
        print(f"refused modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(cell, rec, peak, checked, bool(args.trace), device)
    print(json.dumps(line), flush=True)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
