"""This checkout's parallel exchanges and rounds beside another
checkout's, in turns, on one CUDA card.

1. Every exchange of chip_smoke.py's EXCHANGE_CASES (pair allgather, pair
   reduce-scatter at comm_groups 1, 2 and 7, bf16 reduce-scatter at 7;
   4 shards sharing the card) through chip_smoke.exchange_profile, each
   checkout in a fresh process of its own, in the turns this, other,
   other, this, on the same inputs: device kernels a shard an exchange,
   device ms, host us (every shard's own host work, the barriers' waits
   taken out) and wall us an exchange, and whether both give the same
   results.
2. Each checkout's own chip_smoke.phase_parallel (3 rounds of the data,
   feature and voting learners at 4 shards on the bench data, beside
   serial rounds), run from that checkout's root in a fresh process, in
   the turns other, this, this, other; the round times of each run and,
   for each learner, the median of every run's rounds after the first.

Run from the root of a checkout, with the other one unpacked in a
directory .gitignore lists:

    python3 -m lightgbm_tpu_torch.bench.parallel_turns --root DIR
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

# the parallel phase of the checkout in the working directory, on the
# bench data; prints the round times of every learner
PHASE_SRC = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import hist_kernels as hk
x, y = cs.make_data(cs.N_ROWS, 42)
ds = lgt.Dataset(x, y, params=cs.BENCH_PARAMS).construct(device="cuda")
res, _ = cs.phase_parallel(torch, lgt, hk, cs.Timer(torch), ds, y, 42)
print(json.dumps({k: v["round_ms"] for k, v in res.items()
                  if isinstance(v, dict) and "round_ms" in v}))
"""


def rounds(root):
    """{learner: round ms} of phase_parallel run from `root`."""
    proc = subprocess.run([sys.executable, "-c", PHASE_SRC], cwd=root,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"parallel phase at {root} failed:\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other checkout's root")
    args = ap.parse_args()
    here, other = os.path.abspath(os.getcwd()), os.path.abspath(args.root)
    sys.path.insert(0, here)
    import chip_smoke as cs
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "other": other}), flush=True)

    rng = np.random.RandomState(59)
    inputs = {name: cs.exchange_words(rng, cs.PARALLEL_SHARDS,
                                      (f, cs.MAX_BIN, 3))
              for name, _, _, f, _ in cs.EXCHANGE_CASES}
    first = None
    for who, root in (("this", ""), ("other", other), ("other", other),
                      ("this", "")):
        res, results = cs.exchange_profile(torch, inputs, root)
        first = first or results
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for name in first
                   for a, b in zip(first[name], results[name]))
        print(json.dumps({"exchanges": who, "same_results": same,
                          **res}), flush=True)

    runs = {}
    for who, root in (("other", other), ("this", here), ("this", here),
                      ("other", other)):
        got = rounds(root)
        print(json.dumps({"rounds": who, **got}), flush=True)
        for learner, ms in got.items():
            runs.setdefault(learner, {}).setdefault(who, []).extend(ms[1:])
    print(json.dumps({"median_round_ms_after_the_first": {
        learner: {who: float(np.median(ms)) for who, ms in d.items()}
        for learner, d in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
