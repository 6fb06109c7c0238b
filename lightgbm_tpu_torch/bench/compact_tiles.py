"""Sweep compacted_hist's job plan on one CUDA card.

The sorted route of csrc/compact_hist.cu plans its jobs on the device
from the count: gather jobs split until the grid has kJobsPerBlock of
them a block (up to kMaxGatherParts pieces a chunk), and sum jobs of the
least feature tile (up to kMaxTile) that gives the grid kJobsPerBlock
of them a block. This builds the source once per (jobs, tile) pair (the
two constants rewritten in a copy of the source), runs each build on
the same compacted leaves of the bench shape (1,048,576 x 28, uint8 at
255 bins: a leaf of 1%, 10% and 50% of the rows, and a 10% leaf whose
feature 3 has 90% of its rows in bin 0; int16 at 300 bins, 10%),
requires the bits of the wrapper's build, and prints each build's time
(CUDA events, L2 flushed, chip_smoke's Timer). With --rounds R it then
trains the bench workload (chip_smoke's 1,000,000 x 28 binary data, 63
leaves, hist_compaction=true) fused with each build in turn (the
build's library put in the wrapper's place before the booster captures
its graph), prints the median time of a round over three blocks of R
and the model text's equality across builds, and times each build at
the 62 smaller-child counts of the first tree (leaves of that many
random rows of the uint8 matrix above), printing the sum. Run from the
root of a checkout:

    python3 -m lightgbm_tpu_torch.bench.compact_tiles [--jobs 1,2,4]
        [--tiles 2,4] [--rounds 5]
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from lightgbm_tpu_torch.ops import hist_kernels as hk

SHARES = (0.01, 0.10, 0.50)


def build_variant(jobs, tile, work):
    """compact_hist.cu with kJobsPerBlock = jobs and kMaxTile = tile,
    compiled into `work`."""
    out = os.path.join(work, f"j{jobs}t{tile}")
    os.makedirs(out, exist_ok=True)
    for name in ("chunk_hist.cuh", "compact_hist.cu"):
        with open(os.path.join(hk._CSRC, name)) as f:
            text = f.read()
        if name == "compact_hist.cu":
            for knob, value in (("kJobsPerBlock", jobs),
                                ("kMaxTile", tile)):
                text, n = re.subn(rf"constexpr int {knob} = [^;]+;",
                                  f"constexpr int {knob} = {value};", text)
                assert n == 1, f"compact_hist.cu: one {knob} expected"
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    lib = os.path.join(out, "libcompact_hist.so")
    cmd = [hk._nvcc(), *hk.NVCC_FLAGS, "-o", lib,
           os.path.join(out, "compact_hist.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def time_builds(libs, timer, bins, ghc, row_leaf, b, reps=20):
    """The leaf row_leaf == 7 compacted, each build's time on it (bits
    required equal to the wrapper's): (count, {build: ms})."""
    n = bins.shape[1]
    src = torch.empty(n, dtype=torch.int32, device="cuda")
    cnt = torch.empty(1, dtype=torch.int32, device="cuda")
    hk.compact_rows(row_leaf, torch.tensor([7], dtype=torch.int32,
                                           device="cuda"), src, cnt)
    scratch = hk.CompactScratch(bins, b)
    want = hk.compacted_hist(bins, ghc, src, cnt, b, **scratch.hist_kwargs())
    ms = {}
    for name, lib in libs.items():
        got = call(lib, bins, ghc, src, cnt, b, scratch)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"{name}: other bits")
        ms[name] = timer(lambda: call(lib, bins, ghc, src, cnt, b, scratch),
                         reps)
    return int(cnt[0]), ms


def call(lib, bins, ghc, src, cnt, b, scratch):
    f, _ = bins.shape
    hi = torch.empty((f, b, 3), dtype=torch.float32, device=bins.device)
    lo = torch.empty_like(hi)
    status = lib.compacted_hist(bins.data_ptr(), scratch.rows.data_ptr(),
                                scratch.rows.shape[1], bins.element_size(),
                                ghc.data_ptr(), src.data_ptr(),
                                cnt.data_ptr(), f, bins.shape[1], b,
                                scratch.partials.data_ptr(),
                                scratch.words.data_ptr(),
                                scratch.gathered.data_ptr(), hi.data_ptr(),
                                lo.data_ptr(), hk._stream(bins.device))
    if status != 0:
        raise RuntimeError(lib.compact_hist_status_string(status).decode())
    return hi, lo


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", default="1,2,4")
    ap.add_argument("--tiles", default="2,4")
    ap.add_argument("--rounds", type=int, default=0)
    args = ap.parse_args()
    import chip_smoke as cs   # the checkout's root, the working directory
    knobs = [(int(j), int(t)) for j in args.jobs.split(",")
             for t in args.tiles.split(",")]
    hk.build()
    with tempfile.TemporaryDirectory() as work:
        procs = {f"j{j}t{t}": build_variant(j, t, work) for j, t in knobs}
        libs = {}
        for name, (path, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name}:\n{out}")
            lib = ctypes.CDLL(path)
            hk._bind_compact_hist(lib)
            libs[name] = lib
        rng = np.random.RandomState(42)
        n, f = 1 << 20, cs.N_FEATURES
        timer = cs.Timer(torch)
        inbag = (rng.rand(n) < 0.8).astype(np.float32)
        ghc = torch.from_numpy(np.stack([
            rng.randn(n).astype(np.float32) * inbag,
            rng.rand(n).astype(np.float32) * inbag, inbag])).cuda()
        other = torch.from_numpy(rng.randint(0, 7, size=n).astype(np.int32))
        bins8 = torch.from_numpy(rng.randint(0, 255, size=(f, n))
                                 .astype(np.uint8))
        skewed = bins8.clone()
        cases = [("uint8", bins8, 255, share) for share in SHARES]
        cases += [("uint8 skewed", skewed, 255, 0.10),
                  ("int16", torch.from_numpy(rng.randint(
                      0, 300, size=(f, n)).astype(np.int16)), 300, 0.10)]
        for label, bins, b, share in cases:
            rl = torch.where(torch.from_numpy(rng.rand(n) < share), 7,
                             other).to(torch.int32)
            if bins is skewed:
                rows = torch.from_numpy(np.flatnonzero(rl.numpy() == 7))
                bins[3, rows[torch.from_numpy(rng.rand(len(rows)) < 0.9)]] = 0
            row = {"bins": label, "B": b, "ms": {}}
            row["cnt"], row["ms"] = time_builds(libs, timer, bins.cuda(),
                                                ghc, rl.cuda(), b)
            print(json.dumps(row), flush=True)
        if args.rounds:
            counts = train_rounds(cs, libs, args.rounds)
            leaves = []
            for c in counts:
                rl = other.clone()
                rl[torch.from_numpy(rng.choice(n, c, replace=False))] = 7
                leaves.append(rl.cuda())
            total = dict.fromkeys(libs, 0.0)
            bins = bins8.cuda()
            for rl in leaves:
                for name, ms in time_builds(libs, timer, bins, ghc, rl,
                                            255, reps=5)[1].items():
                    total[name] += ms
            print(json.dumps({"real_tree_counts": len(counts),
                              "rows": int(sum(counts)),
                              "compacted_hist_ms_sum": total}), flush=True)
    return 0


def train_rounds(cs, libs, rounds):
    """Fused bench rounds with each build of compacted_hist in turn."""
    import time
    import lightgbm_tpu_torch as lgt
    x, y = cs.make_data(cs.N_ROWS, 42)
    ds = lgt.Dataset(x, y)
    params = dict(cs.BENCH_PARAMS, hist_compaction="true")
    texts, counts = {}, None
    for name, lib in list(libs.items()) * 2:    # each build twice, in turns
        hk._LOADED["compact_hist.cu"] = lib
        booster = lgt.Booster(params, ds)
        booster.gbdt.warm_up_fused(rounds)
        block_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            booster.gbdt.train_many(rounds)
            torch.cuda.synchronize()
            block_ms.append(1e3 * (time.perf_counter() - t0))
        texts.setdefault(name, booster.model_to_string())
        if counts is None:
            counts = cs.smaller_child_counts(booster.gbdt.models[0])
        print(json.dumps({"build": name, "round_ms":
                          float(np.median(block_ms)) / rounds,
                          "blocks_ms": block_ms}), flush=True)
        del booster
    print(json.dumps({"model_text_equal_across_builds":
                      len(set(texts.values())) == 1}), flush=True)
    return counts


if __name__ == "__main__":
    sys.exit(main())
