r"""The two readings that a cell's limits are set from, for many seeds in one
process (the CUDA context and the kernel libraries are loaded once):

* the program's numbers: what the timed path delivered in a short window
  at the cell's own load, against the reference in fp32;
* the control's numbers: the reference in the program's place, computed
  one precision below the configuration's (bfloat16 operands, fp32 sums,
  where the configuration runs TF32), against the reference in fp32, on
  the same compared sequences.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> ...

One JSON line a seed. Not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from portbench import check, harness
    from portbench.trace import Tracer

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    os.environ["A3GC_TORCH_BUILD_DIR"] = harness.BUILD_DIR
    cell = harness.Cell(harness._json(os.path.join(harness.ROOT,
                                                   "BENCHMARK.json")),
                        args.workload)
    dev = harness.card(cell)
    for seed in args.seeds:
        t0 = time.monotonic()
        run = cell.driver.Run(cell, seed, dev, Tracer(False))
        setup_s = time.monotonic() - t0
        try:
            m = run.window(args.seconds)
        finally:
            run.close()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        ref = run.reference_answers("fp32")
        ref_s = time.monotonic() - t1
        low = run.reference_answers("bf16")
        answers = run.program_answers()
        print(json.dumps({
            "seed": seed, "setup_s": setup_s, "reference_s": ref_s,
            "frames_per_s": m.frames / m.window_s, "failed": m.failed,
            "compared": len(answers),
            "frames_compared": int(sum(len(a) for a in answers)),
            "program": check.numbers(answers, ref),
            "control": check.numbers(low, ref)}), flush=True)
