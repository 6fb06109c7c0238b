"""Sweep hist_pair_fold's plan constants on one CUDA card.

csrc/hist.cu plans hist_pair_fold's launch from constants such as the
threads a block (kFoldThreads, one warp a feature of a sum job), the
blocks an SM the plan counts on (kResident), the list entries staged at
once (kSeg) and the partials a fold job stages (kFoldBytes). This builds
a copy of the source for each combination of the values given (the
constants rewritten), runs each on fold_profile's inputs (28 x R uint8
bins at 255 bins, a carry in flight; R = 262,144 and 65,536; leaf 5 of
rows spread over 63 leaves, and leaves of 50% and 100% of the rows),
requires the bits of the plain version on the CPU, and prints each
build's plan and time (CUDA events, L2 flushed, chip_smoke's Timer). Run
from the root of a checkout:

    python3 -m lightgbm_tpu_torch.bench.fold_tiles \
        --knobs "kFoldBytes=16384,32768;kSeg=256,512"
"""

import argparse
import ctypes
import itertools
import json
import os
import re
import subprocess
import tempfile

import numpy as np
import torch

from lightgbm_tpu_torch.bench.fold_profile import inputs
from lightgbm_tpu_torch.ops import hist_kernels as hk


def build_variant(knobs, work):
    """hist.cu with the constants of `knobs` rewritten, compiled into
    `work`; returns (library path, nvcc process)."""
    name = "_".join(f"{k}{v}" for k, v in knobs.items())
    out = os.path.join(work, name)
    os.makedirs(out, exist_ok=True)
    for src in ("chunk_hist.cuh", "hist.cu"):
        with open(os.path.join(hk._CSRC, src)) as f:
            text = f.read()
        if src == "hist.cu":
            for knob, value in knobs.items():
                text, n = re.subn(rf"constexpr int {knob} = [^;]+;",
                                  f"constexpr int {knob} = {value};", text)
                assert n == 1, f"hist.cu: one {knob} expected"
        with open(os.path.join(out, src), "w") as f:
            f.write(text)
    lib = os.path.join(out, "libhist.so")
    cmd = [hk._nvcc(), *hk.NVCC_FLAGS, "-o", lib, os.path.join(out, "hist.cu")]
    return name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--knobs", default="kFoldBytes=16384,32768",
                    help="NAME=v1,v2;NAME=...: the combinations built")
    args = ap.parse_args()
    import chip_smoke as cs   # the checkout's root, the working directory
    hk.build(("hist.cu",))
    wrapper_lib = hk._library("hist.cu")
    axes = [(k, v.split(",")) for k, v in
             (part.split("=") for part in args.knobs.split(";"))]
    combos = [dict(zip([k for k, _ in axes], values))
              for values in itertools.product(*[v for _, v in axes])]
    timer = cs.Timer(torch)
    rng = np.random.RandomState(16)
    f, b = cs.N_FEATURES, cs.MAX_BIN
    with tempfile.TemporaryDirectory(prefix="fold_tiles_") as work:
        procs = [build_variant(k, work) for k in combos]
        libs = {}
        for name, path, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name}:\n{out}")
            lib = ctypes.CDLL(path)
            hk._bind_hist(lib)
            libs[name] = lib
        try:
            for rows in (262_144, 65_536):
                for share in (None, 0.5, 1.0):
                    dev, carry = inputs(rng, rows, share, f, b)
                    host = [t.cpu() for t in dev]
                    want = hk.hist_pair_fold_plain(
                        *(t.cpu().clone() for t in carry), *host, b)
                    scratch = hk.FoldScratch(rows, f, b, "cuda")
                    row = {"rows": rows,
                           "share": share if share is not None else "1/63",
                           "leaf_rows": int((host[2] == 5).sum()),
                           "plan": {}, "ms": {}}
                    for name, lib in libs.items():
                        hk._LOADED["hist.cu"] = lib
                        acc, comp = (t.clone() for t in carry)
                        hk.hist_pair_fold(acc, comp, *dev, b,
                                          scratch=scratch)
                        for g, w in zip((acc.cpu(), comp.cpu()), want):
                            if not torch.equal(g.view(torch.int32),
                                               w.view(torch.int32)):
                                raise RuntimeError(f"{name}: other bits")
                        row["plan"][name] = hk.fold_plan(rows, f, b)
                        row["ms"][name] = timer(
                            lambda: hk.hist_pair_fold(acc, comp, *dev, b,
                                                      scratch=scratch), 20)
                    print(json.dumps(row), flush=True)
        finally:
            hk._LOADED["hist.cu"] = wrapper_lib
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
