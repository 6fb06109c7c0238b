"""Block timeline and times of hist_pair_fold on one CUDA card.

Builds a copy of csrc/hist.cu (and the headers it includes) in which
thread 0 of every block of every kernel records its SM, its thread
count and %globaltimer and clock64 where the block starts and where it
returns, runs hist_pair_fold through its wrapper on that copy, and
prints for each kernel of the call: its blocks, the SMs they ran on,
the most blocks one SM held at once, the block durations (10th, 50th,
90th percentile and the longest, us), the kernel's span from its first
block's start to its last block's end, and its achieved occupancy (the
warps resident over the span, against 64 an SM on every SM of the
card), and for pair_fold_kernel the phases of its blocks (marks added
at anchors of the source). That call is L2-flushed, as the timed ones
are. Then it times the wrapper on the build without timestamps (CUDA
events, L2 flushed, chip_smoke's Timer; also L2-warm, and 20 calls back
to back in one CUDA graph) beside masked_hist on the same rows and one
index_add_ over the leaf's rows (also back to back), and prints the bytes the
function needs (row_leaf, and the leaf's rows' bins and statistics)
beside the bytes a design that stages every row reads. The inputs are
chip_smoke's out-of-core blocks (28 x R uint8 bins at 255 bins, a
carry in flight) at R = 262,144 and 65,536, for leaf 5 of rows spread
over 63 leaves, and leaves of 50% and 100% of the rows. Run from the
root of a checkout:

    python3 -m lightgbm_tpu_torch.bench.fold_profile
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from lightgbm_tpu_torch.ops import hist_kernels as hk

CAP = 1 << 16
PROBE = f"""#pragma once
#include <cuda_runtime.h>
__device__ long long g_probe[{CAP} * 8];
__device__ unsigned g_probe_n;
__device__ __forceinline__ long long probe_ns() {{
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}}
struct FoldProbe {{
  int tag;
  long long t0, c0;
  __device__ explicit FoldProbe(int k) : tag(k) {{
    if (threadIdx.x == 0) {{ t0 = probe_ns(); c0 = clock64(); }}
  }}
  __device__ ~FoldProbe() {{
    if (threadIdx.x != 0) return;
    const long long c1 = clock64(), t1 = probe_ns();
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const unsigned i = atomicAdd(&g_probe_n, 1u);
    if (i >= {CAP}) return;
    long long* r = g_probe + 8 * i;
    r[0] = tag; r[1] = blockIdx.x; r[2] = sm; r[3] = blockDim.x;
    r[4] = t0; r[5] = t1; r[6] = c0; r[7] = c1;
  }}
}};
__device__ long long g_mark[{CAP} * 8];
#define FOLD_MARK(k) \
  if (threadIdx.x == 0) g_mark[8 * blockIdx.x + (k)] = probe_ns();
extern "C" int fold_probe_reset() {{
  const unsigned zero = 0;
  static long long blank[{CAP} * 8];
  cudaError_t e = cudaMemcpyToSymbol(g_mark, blank, sizeof(blank));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_probe_n, &zero, sizeof(zero));
}}
extern "C" int fold_probe_marks(long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_mark, sizeof(long long) * {CAP} * 8);
}}
extern "C" int fold_probe_read(long long* out, unsigned* n) {{
  cudaError_t e = cudaMemcpyFromSymbol(n, g_probe_n, sizeof(unsigned));
  if (e != cudaSuccess) return (int)e;
  const unsigned k = *n < {CAP} ? *n : {CAP};
  return (int)cudaMemcpyFromSymbol(out, g_probe, 8 * sizeof(long long) * k);
}}
"""
# pair_fold_kernel's phases: (anchor in hist.cu, mark added after it).
# Every block: 2 list built, 3 first segment landed, 4 walk done, 5
# counted on the tile; a block that folds: 6 every partial counted, 7
# partials staged (its last slice's, for the tile's last block).
MARKS = [
    ("  __syncthreads();  // the list is in; hist and tags zeroed\n",
     "FOLD_MARK(2)\n"),
    ("    __syncthreads();  // this segment landed for every thread\n",
     "if (s == 0) FOLD_MARK(3)\n"),
    ("  // the partial, then one count on the tile\n", "FOLD_MARK(4)\n"),
    ("  if (t == 0) misc[kFoldWarps] = atomicAdd(w.arrived + tile, 1);\n",
     "FOLD_MARK(5)\n"),
    ("  __syncthreads();  // every chunk's partial counted; smem free\n",
     "FOLD_MARK(6)\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n  if (mine) {\n",
     "FOLD_MARK(7)\n"),
]
# (kind, the mark a block of that kind has, its phases as (name, from
# mark, to mark); mark 0 is the block's start, 8 its end)
PHASES = {"sum": (2, [("list", 0, 2), ("first segment", 2, 3),
                      ("walk", 3, 4), ("publish", 4, 5), ("exit", 5, 8)]),
          "fold": (6, [("wait", 5, 6), ("stage", 6, 7), ("fold", 7, 8)])}
KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\([^{;]*\)\s*\{")
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def instrumented_build(work):
    """hist.cu and its headers copied into `work`, a FoldProbe at the top
    of every kernel's body; returns (library, {tag: kernel name})."""
    names, todo = {}, ["hist.cu"]
    while todo:
        src = todo.pop()
        with open(os.path.join(hk._CSRC, src)) as f:
            text = f.read()
        todo += INCLUDE.findall(text)

        def probe(m):
            names[len(names)] = m.group(1)
            return m.group(0) + f"\n  FoldProbe fold_probe_({len(names) - 1});"

        text = KERNEL.sub(probe, text)
        for anchor, mark in MARKS:
            if text.count(anchor) == 1:
                text = text.replace(anchor, anchor + mark)
        with open(os.path.join(work, src), "w") as f:
            f.write('#include "fold_probe.cuh"\n' + text)
    with open(os.path.join(work, "fold_probe.cuh"), "w") as f:
        f.write(PROBE)
    lib = os.path.join(work, "libhist_probe.so")
    subprocess.run([hk._nvcc(), *hk.NVCC_FLAGS, "-o", lib,
                    os.path.join(work, "hist.cu")], check=True,
                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return lib, names


def inputs(rng, rows, share, f=28, b=255):
    """chip_smoke's fold block: bins, ghc_t, row_leaf, the leaf id 5 and
    a carry; share None spreads the rows over 63 leaves."""
    inbag = (rng.rand(rows) < 0.8).astype(np.float32)
    rl = rng.randint(0, 63, size=rows).astype(np.int32)
    if share is not None:
        rl = np.where(rng.rand(rows) < share, 5, rl % 5).astype(np.int32)
    host = [rng.randint(0, b, size=(f, rows)).astype(np.uint8),
            np.stack([rng.randn(rows).astype(np.float32) * inbag,
                      rng.rand(rows).astype(np.float32) * inbag, inbag]),
            rl, np.array([5], np.int32)]
    carry = [rng.randn(f, b, 3).astype(np.float32),
             (rng.randn(f, b, 3) * 1e-7).astype(np.float32)]
    return ([torch.from_numpy(a).cuda() for a in host],
            [torch.from_numpy(a).cuda() for a in carry])


def phases(rec, marks):
    """Each job kind's phase durations (50th and 90th percentile, us)
    from the marks, and the end of its last job after the kernel's first
    block start (us)."""
    first = rec[:, 4].min()
    out = {}
    for kind, (has, steps) in PHASES.items():
        rows = []
        for r in rec:
            m = marks[r[1]].copy()
            if m[has] == 0:
                continue
            m[0] = r[4]
            rows.append([((r[5] if b == 8 else m[b]) - m[a]) / 1e3
                         for _, a, b in steps] + [(r[5] - first) / 1e3])
        if rows:
            a = np.array(rows)
            out[kind] = {"jobs": len(rows), **{
                name: [round(float(np.percentile(a[:, i], q)), 3)
                       for q in (50, 90)]
                for i, (name, _, _) in enumerate(steps)},
                "last_end": round(float(a[:, -1].max()), 3)}
    return out


def timeline(lib, names, call, sms, timer):
    """One call on the copy with timestamps, L2 flushed before it as the
    Timer does."""
    lib.fold_probe_reset()
    timer.flush.zero_()
    torch.cuda._sleep(2_000_000)
    call()
    torch.cuda.synchronize()
    n = ctypes.c_uint(0)
    buf = np.zeros((CAP, 8), np.int64)
    st = lib.fold_probe_read(buf.ctypes.data_as(ctypes.c_void_p),
                             ctypes.byref(n))
    if st != 0:
        raise RuntimeError(f"fold_probe_read: {st}")
    rec = buf[:min(n.value, CAP)]
    marks = np.zeros((CAP, 8), np.int64)
    st = lib.fold_probe_marks(marks.ctypes.data_as(ctypes.c_void_p))
    if st != 0:
        raise RuntimeError(f"fold_probe_marks: {st}")
    out = {}
    if marks.any():
        out["phases_us_p50_p90"] = phases(rec, marks)
    for tag in sorted(set(rec[:, 0].tolist())):
        r = rec[rec[:, 0] == tag]
        t0, t1 = r[:, 4], r[:, 5]
        span = int(t1.max() - t0.min())
        dur = (t1 - t0) / 1e3
        # the most blocks one SM held at once
        most = 0
        for sm in set(r[:, 2].tolist()):
            ev = sorted([(a, 1) for a in t0[r[:, 2] == sm]]
                        + [(b, -1) for b in t1[r[:, 2] == sm]],
                        key=lambda e: (e[0], e[1]))
            cur = 0
            for _, d in ev:
                cur += d
                most = max(most, cur)
        warps = float(((t1 - t0) * (r[:, 3] // 32)).sum())
        out[names[tag]] = {
            "blocks": int(len(r)), "threads": int(r[0, 3]),
            "sms": int(len(set(r[:, 2].tolist()))),
            "most_blocks_an_sm": most,
            "block_us_p10_p50_p90_max": [float(np.percentile(dur, q))
                                         for q in (10, 50, 90)]
            + [float(dur.max())],
            "span_us": span / 1e3,
            "achieved_occupancy": warps / max(span, 1) / (sms * 64)}
    return out


def back_to_back(fn, reps=20):
    """Mean device time a call of `reps` calls captured in one CUDA graph
    and replayed (CUDA events around the replay; no host time between
    the launches, L2 warm)."""
    fn()
    torch.cuda.synchronize()
    graph = hk.CapturedGraph()
    with graph.capture():
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import chip_smoke as cs   # the checkout's root, the working directory
    hk.build(("hist.cu",))
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "sms": sms}), flush=True)
    timer = cs.Timer(torch)
    rng = np.random.RandomState(16)
    work = tempfile.mkdtemp(prefix="fold_profile_")
    try:
        path, names = instrumented_build(work)
        probe = ctypes.CDLL(path)
        hk._bind_hist(probe)
        probe.fold_probe_reset.restype = ctypes.c_int
        probe.fold_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        probe.fold_probe_read.restype = ctypes.c_int
        probe.fold_probe_marks.argtypes = [ctypes.c_void_p]
        probe.fold_probe_marks.restype = ctypes.c_int
        plain_lib = hk._library("hist.cu")
        f, b = cs.N_FEATURES, cs.MAX_BIN
        for rows in (262_144, 65_536):
            for share in (None, 0.5, 1.0):
                dev, carry = inputs(rng, rows, share, f, b)
                leaf_rows = int((dev[2] == 5).sum())
                acc, comp = (t.clone() for t in carry)
                scratch = hk.FoldScratch(rows, f, b, "cuda")

                def fold():
                    hk.hist_pair_fold(acc, comp, *dev, b, scratch=scratch)

                hk._LOADED["hist.cu"] = probe
                try:
                    tl = timeline(probe, names, fold, sms, timer)
                finally:
                    hk._LOADED["hist.cu"] = plain_lib
                in_leaf = (dev[2] == 5).nonzero()[:, 0]
                keys = (torch.arange(f, device="cuda")[:, None] * b
                        + dev[0][:, in_leaf].long()).reshape(-1)
                src = (dev[1][:, in_leaf].t()[None].expand(f, -1, 3)
                       .reshape(-1, 3).contiguous())
                row = {
                    "rows": rows, "leaf_rows": leaf_rows,
                    "share": share if share is not None else "1/63",
                    "ms": timer(fold, 20),
                    "ms_l2_warm": timer(fold, 20, flush=False),
                    "ms_back_to_back": back_to_back(fold),
                    "index_add_back_to_back": back_to_back(
                        lambda: torch.zeros(f * b, 3, device="cuda")
                        .index_add_(0, keys, src)),
                    "masked_hist_ms": timer(
                        lambda: hk.masked_hist(*dev, b), 20),
                    "index_add_ms": timer(lambda: torch.zeros(
                        f * b, 3, device="cuda").index_add_(0, keys, src),
                        5),
                    "needed_bytes": 4 * rows + leaf_rows * (f + 12)
                    + 2 * 2 * f * b * 12,
                    "all_rows_bytes": rows * (f + 16) + 2 * 2 * f * b * 12,
                    "timeline": tl}
                print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
