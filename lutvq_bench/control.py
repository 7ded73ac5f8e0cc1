#!/usr/bin/env python3
"""The readings behind a cell's correctness limit (not run by the benchmark's
own runs).

    python3 lutvq_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 40

For each seed, in one process: a run of the cell as the benchmark runs it
(set-up, ramp, a window of ``--seconds``), the sample the judge draws, and
then the control on the same sample: the program's own lower-precision
path (``quality="fast"``, W8A8: int8 activations and codebook tables, the
step below the configuration's bf16) run over each prompt and its served
tokens, its first choice at each served position.  Once the program is
freed, the judge that decides ``correct`` in a run (``harness.check``)
reads the served tokens (the sound run's reading), the control's choices
(the control's) and the exact path's own choices over the same tokens
(a second witness).  One JSON line a seed, with each set's verdict; the
limit lies between the sound runs' largest and the control's smallest.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_tokens(cfg, weights, sample, device, quality: str) -> list:
    """The program's first choice at each served position of each request,
    from one forward pass over its prompt and served tokens at ``quality``."""
    import torch

    from tpu_lutvq_torch.models.llama import init_caches, llama_forward

    out = []
    for r in sample:
        toks = torch.tensor([list(r.prompt) + list(r.output[:-1])], dtype=torch.long, device=device)
        logits, _ = llama_forward(cfg, weights, toks, init_caches(cfg, 1, device=device), 0,
                                  strategy="auto", quality=quality)
        t0 = len(r.prompt)
        out.append(logits[0, t0 - 1:].argmax(dim=-1).cpu())
        del logits
    return out


def reading(cell, seed: int, seconds: float, device, t_start: float, log) -> dict:
    import torch

    from lutvq_bench.core import harness

    rec, finished, (cfg, weights, batcher), _ = harness.serve(cell, seed, seconds, False, device,
                                                             t_start, log)
    sample = harness.sample(cell, seed, rec, finished)
    chosen = {"served": [r.output for r in sample],
              "control": control_tokens(cfg, weights, sample, device, "fast"),
              "exact_forced": control_tokens(cfg, weights, sample, device, "exact")}
    del cfg, weights, batcher
    gc.collect()
    torch.cuda.empty_cache()
    judged = harness.check(cell, seed, sample, chosen, device)
    out = {"seed": seed, "tokens": len(judged["served"]["gaps"]),
           "requests": [len(r.prompt) for r in sample], "setup_s": rec.window_open - t_start}
    for name, j in judged.items():
        out[f"{name}_widest_gap"] = j["checked"]["widest_gap"]["value"]
        out[f"{name}_correct"] = j["correct"]
        out[f"{name}_disagree"] = sum(g > 0 for g in j["gaps"]) / len(j["gaps"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ["TPU_LUTVQ_TORCH_BUILD_DIR"] = str(build / "kernels")
    sys.path.insert(0, str(ROOT))
    import torch

    from lutvq_bench.core.spec import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = Cell.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = reading(cell, seed, args.seconds, device, t0,
                    lambda m: print(m, file=sys.stderr, flush=True))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
