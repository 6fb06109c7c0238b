"""Sweep compacted_hist's feature tile on one CUDA card.

Builds csrc/compact_hist.cu once per tile width (kFeatureTile of its
GatherRows policy, rewritten in a copy of the source), runs each build
on the same compacted leaves of the bench shape (1,048,576 x 28, uint8
at 255 bins; int16 at 300), requires the bits of the wrapper's build,
and prints each build's time (CUDA events, L2 flushed, chip_smoke's
Timer). With --rounds R it then trains the bench workload (chip_smoke's
1,000,000 x 28 binary data, 63 leaves, hist_compaction=true) fused with
each build in turn (the build's library put in the wrapper's place
before the booster captures its graph) and prints the median time of a
round over three blocks of R, and the model text's equality across
builds. Run from the root of a checkout:

    python3 -m lightgbm_tpu_torch.bench.compact_tiles [--tiles 1,2,4,8,32]
        [--rounds 5] [--peers tags,match]

--peers match builds each tile width a second time with the peer search
forced to __match_any_sync (the accumulator's fallback where the tag
words do not fit), named "<tile>m".
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


def build_variant(tile, work, match=False):
    """compact_hist.cu with kFeatureTile = tile (and with match, the
    peer search by __match_any_sync), compiled into `work`."""
    out = os.path.join(work, f"t{tile}{'m' if match else ''}")
    os.makedirs(out, exist_ok=True)
    for name in ("chunk_hist.cuh", "compact_hist.cu"):
        with open(os.path.join(hk._CSRC, name)) as f:
            text = f.read()
        if name == "compact_hist.cu":
            text, n = re.subn(r"kFeatureTile = [^;]+;",
                              f"kFeatureTile = {tile};", text)
            assert n == 1, "compact_hist.cu: one kFeatureTile expected"
        elif match:
            text, n = re.subn(r"const bool use_tags = [^;]+;",
                              "const bool use_tags = false;", text)
            assert n == 1, "chunk_hist.cuh: one use_tags expected"
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    lib = os.path.join(out, "libcompact_hist.so")
    cmd = [hk._nvcc(), *hk.NVCC_FLAGS, "-o", lib,
           os.path.join(out, "compact_hist.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def call(lib, bins, ghc, src, cnt, b):
    f, n = bins.shape
    partials = torch.empty((n // hk.HIST_CHUNK) * f * b * 3,
                           dtype=torch.float32, device=bins.device)
    hi = torch.empty((f, b, 3), dtype=torch.float32, device=bins.device)
    lo = torch.empty_like(hi)
    status = lib.compacted_hist(bins.data_ptr(), bins.element_size(),
                                ghc.data_ptr(), src.data_ptr(),
                                cnt.data_ptr(), f, n, b, partials.data_ptr(),
                                hi.data_ptr(), lo.data_ptr(),
                                hk._stream(bins.device))
    if status != 0:
        raise RuntimeError(lib.compact_hist_status_string(status).decode())
    return hi, lo


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", default="1,2,4,8,32")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--peers", default="tags")
    args = ap.parse_args()
    import chip_smoke as cs   # the checkout's root, the working directory
    tiles = [int(t) for t in args.tiles.split(",")]
    hk.build()
    with tempfile.TemporaryDirectory() as work:
        peers = args.peers.split(",")
        procs = {f"{t}{'m' if p == 'match' else ''}":
                 build_variant(t, work, p == "match")
                 for t in tiles for p in peers}
        libs = {}
        for t, (path, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"tile {t}:\n{out}")
            lib = ctypes.CDLL(path)
            hk._bind_compact_hist(lib)
            libs[t] = lib
        rng = np.random.RandomState(42)
        n, f = 1 << 20, cs.N_FEATURES
        timer = cs.Timer(torch)
        inbag = (rng.rand(n) < 0.8).astype(np.float32)
        ghc = torch.from_numpy(np.stack([
            rng.randn(n).astype(np.float32) * inbag,
            rng.rand(n).astype(np.float32) * inbag, inbag])).cuda()
        other = torch.from_numpy(rng.randint(0, 7, size=n).astype(np.int32))
        for dtype, b, shares in ((np.uint8, 255, SHARES),
                                 (np.int16, 300, (0.10,))):
            bins = torch.from_numpy(rng.randint(0, b, size=(f, n))
                                    .astype(dtype)).cuda()
            for share in shares:
                rl = torch.where(torch.from_numpy(rng.rand(n) < share), 7,
                                 other).to(torch.int32).cuda()
                src = torch.empty(n, dtype=torch.int32, device="cuda")
                cnt = torch.empty(1, dtype=torch.int32, device="cuda")
                hk.compact_rows(rl, torch.tensor([7], dtype=torch.int32,
                                                 device="cuda"), src, cnt)
                want = hk.compacted_hist(bins, ghc, src, cnt, b)
                row = {"bins": str(np.dtype(dtype)), "B": b,
                       "cnt": int(cnt[0]), "ms": {}}
                for t, lib in libs.items():
                    got = call(lib, bins, ghc, src, cnt, b)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise RuntimeError(f"tile {t}: other bits")
                    row["ms"][t] = timer(
                        lambda: call(lib, bins, ghc, src, cnt, b), 20)
                print(json.dumps(row), flush=True)
        if args.rounds:
            train_rounds(cs, libs, args.rounds)
    return 0


def train_rounds(cs, libs, rounds):
    """Fused bench rounds with each build of compacted_hist in turn."""
    import time
    import lightgbm_tpu_torch as lgt
    x, y = cs.make_data(cs.N_ROWS, 42)
    ds = lgt.Dataset(x, y)
    params = dict(cs.BENCH_PARAMS, hist_compaction="true")
    texts = {}
    for t, lib in list(libs.items()) * 2:    # each build twice, in turns
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
        texts.setdefault(t, booster.model_to_string())
        print(json.dumps({"tile": t, "round_ms": float(np.median(block_ms))
                          / rounds, "blocks_ms": block_ms}), flush=True)
        del booster
    print(json.dumps({"model_text_equal_across_tiles":
                      len(set(texts.values())) == 1}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
