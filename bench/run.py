"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix and
metrics are found by name from BENCHMARK.json. The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device` and, traced, `breakdown`; then `info` and, last, `checks`, each
number compared with its limit, which also close standard error. The run
needs a CUDA device: without one, or with fewer than the cell asks for, it
exits with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build caches live at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from bench import harness
    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[error] {args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        log(f"[error] the program (src/repro_torch) is missing: {e}")
        return 2
    # the window's load is this one thread's dispatch: no intra-op pool
    # spinning beside it on the host's shared cores
    torch.set_num_threads(1)
    out = harness.run(ROOT, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START, log)
    if out is None:
        return 3
    emit(out)
    return 0


def emit(out: dict) -> None:
    """The checks as the last lines of standard error, then the result."""
    for name, c in out["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
