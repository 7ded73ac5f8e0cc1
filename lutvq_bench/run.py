#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 lutvq_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root.  The cell is an entry of ``BENCHMARK.json``; its
configuration, traffic mix, limit and metric readers are files found by
name (``core/spec.py``).  The run loads the program (``tpu_lutvq_torch``)
and its seeded model, ramps the clients in, measures for ``--seconds``,
frees the program and judges the served tokens against the plain
reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checked``: each number
compared with its limit); the line before it holds the window's
per-request tails and the card's power limit.  The last lines of standard
error repeat each compared number beside its limit.  Without a card, or
with fewer than the cell asks for, or without the program beside it, it
prints no result and exits with a code other than 0; it never falls back
to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_lutvq")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program stays in the checkout
    build = ROOT / "build"
    os.environ["TPU_LUTVQ_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from lutvq_bench.core import harness
    from lutvq_bench.core.spec import Cell

    cell = Cell.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    try:
        import tpu_lutvq_torch
    except ImportError as e:
        log(f"the program is not beside the benchmark ({e}): no result")
        return 2
    if ROOT not in Path(tpu_lutvq_torch.__file__).resolve().parents:
        log(f"tpu_lutvq_torch comes from {tpu_lutvq_torch.__file__}, not this checkout: no result")
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    log(f"setup: process to card {time.perf_counter() - T_START:.3f} s")
    result, info = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                               log)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}: no result")
        return 3
    from tpu_lutvq_torch.kernels import _build

    info["setup"]["kernels_build_or_load_s"] = getattr(_build, "BUILD_SECONDS", None)
    log("setup: " + json.dumps(info["setup"]))
    print(json.dumps({**info, "card": harness.power_limit()}), flush=True)
    print(json.dumps(result), flush=True)
    for name, v in result["checked"].items():
        log(f"checked {name} {v['value']} limit {v['limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
