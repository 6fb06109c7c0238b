"""Where a linear lane's time goes in tree_lin_raw, on one CUDA card.

Builds a copy of csrc/traverse.cu in which
- thread 0 of every block records its SM, %globaltimer and clock64
  where the block starts, where its rows and first roots are staged
  (the first __syncthreads) and where it returns;
- every lane of tree_lin_raw reads clock64 before its walk, after it,
  after the first load of its leaf's linear block returns (the count in
  the layout of separate arrays, the record in the one-record layout),
  after the row's 8 values arrive where they are loaded apart from the
  dot (lin_dot), and after its linear value is made; each warp adds its
  lanes' cycles of the four stages (walk, first load, row loads, the
  rest: the other loads of the block where the first did not bring it
  all, the dot) into per-block counters (row loads 0 where not apart).
A clock read waits for the value it follows (a branch on it), so each
stage ends when its load has returned.

It runs tree_lin_raw through the checkout's wrapper on that copy (L2
flushed first, as chip_smoke's Timer does) on chip_smoke's 100 random
linear trees of 63 leaves at 4096 rows and at 1 row, and prints the
cycles a lane spends in each stage (mean over the lanes), the SM clock
(cycles over nanoseconds of the blocks), the blocks' spans, and the
wrapper's times on the build without clocks (CUDA events, L2 flushed
and L2-warm) beside tree_raw on the same forest. With --knobs, each
set of constants (NAME=VALUE,...; sets apart by ';') is written into
another copy of traverse.cu without clocks, and tree_lin_raw is timed
on that build too, in the same way; with --plans, at 4096 rows under
each launch plan given (rows, window, slots, threads), on every build.
Run from the root of a checkout:

    python3 lightgbm_tpu_torch/bench/lin_profile.py [--root DIR]
        [--knobs "NAME=VALUE,..."] [--plans "rows=16,window=1,..."]

With --root, DIR's lightgbm_tpu_torch (another checkout) is profiled
instead; the forest, the rows and the timer are this checkout's
chip_smoke.py's.
"""

import argparse
import ctypes
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

CAP = 1 << 14
SLOTS = 64          # per-block lane counters, spread over SLOTS addresses
PROBE = f"""#pragma once
#include <cuda_runtime.h>
__device__ long long g_blk[{CAP} * 8];
__device__ unsigned g_blk_n;
__device__ unsigned long long g_lane[{SLOTS} * 5];
__device__ int g_sink;
__device__ __forceinline__ long long lp_ns() {{
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}}
// clock64 once `dep` has arrived (the branch waits for it)
__device__ __forceinline__ long long lp_clock(unsigned dep) {{
  if (dep == 0x9e3779b9u) g_sink = 1;
  long long v;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(v)::"memory");
  return v;
}}
__device__ __forceinline__ void lp_lane(long long t0, long long t1,
                                        const long long* ta, long long t2) {{
  const unsigned m = __activemask();
  const unsigned w = __reduce_add_sync(m, (unsigned)(t1 - t0));
  const unsigned a = __reduce_add_sync(m, (unsigned)(ta[0] - t1));
  const unsigned x = __reduce_add_sync(m, (unsigned)(ta[1] - ta[0]));
  const unsigned r = __reduce_add_sync(m, (unsigned)(t2 - ta[1]));
  if ((threadIdx.x & 31) == __ffs(m) - 1) {{
    unsigned long long* c = g_lane + 5 * (blockIdx.x % {SLOTS});
    atomicAdd(c + 0, (unsigned long long)w);
    atomicAdd(c + 1, (unsigned long long)a);
    atomicAdd(c + 2, (unsigned long long)x);
    atomicAdd(c + 3, (unsigned long long)r);
    atomicAdd(c + 4, (unsigned long long)__popc(m));
  }}
}}
struct BlockProbe {{
  long long t0, c0;
  __device__ BlockProbe() {{
    if (threadIdx.x == 0) {{ t0 = lp_ns(); c0 = clock64(); }}
  }}
  __device__ ~BlockProbe() {{
    if (threadIdx.x != 0) return;
    const long long c1 = clock64(), t1 = lp_ns();
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const unsigned i = atomicAdd(&g_blk_n, 1u);
    if (i >= {CAP}) return;
    long long* r = g_blk + 8 * i;
    r[0] = blockIdx.x; r[1] = blockIdx.y; r[2] = sm; r[3] = t0;
    r[4] = t1; r[5] = c0; r[6] = c1;
  }}
}};
__device__ long long g_staged[{CAP}];
extern "C" int lp_reset() {{
  static long long blank[{CAP} * 8];
  static unsigned long long lanes[{SLOTS} * 5];
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(g_blk, blank, sizeof(blank));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_lane, lanes, sizeof(lanes));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_staged, blank, sizeof(long long) * {CAP});
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_blk_n, &zero, sizeof(zero));
  return (int)e;
}}
extern "C" int lp_read(long long* blk, unsigned* n, long long* staged,
                       unsigned long long* lanes) {{
  cudaError_t e = cudaMemcpyFromSymbol(n, g_blk_n, sizeof(unsigned));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(blk, g_blk, sizeof(long long) * 8 * {CAP});
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(staged, g_staged, sizeof(long long) * {CAP});
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(lanes, g_lane, sizeof(lanes[0]) * {SLOTS} * 5);
  return (int)e;
}}
"""
KERNEL = re.compile(r"(__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"walk_kernel\s*\([^{;]*\)\s*\{)")
# (pattern, replacement): the walk, the value stage and the staging mark
LANE = [
    (re.compile(r"(\n(\s*)int node = walk<kFast, kCat>\()"),
     r"\n\2long long lp_t0 = lp_clock(0), lp_ta[2] = {0, 0};\1"),
    (re.compile(r"(int node = walk<kFast, kCat>\([^;]*;)"),
     r"\1 const long long lp_t1 = lp_clock(node); "
     r"lp_ta[0] = lp_ta[1] = lp_t1;"),
    (re.compile(r"(\n\s*v = linear_value\((?:[^;]*?))\);"),
     r"\1, lp_ta), lp_lane(lp_t0, lp_t1, lp_ta, "
     r"lp_clock(__float_as_uint(v)));"),
    (re.compile(r"(\n  __syncthreads\(\);\n)(  const char\* xbase)"),
     r"\1  if (threadIdx.x == 0 && blockIdx.y == 0) "
     r"g_staged[blockIdx.x % " + str(CAP) + r"] = lp_ns();\n\2"),
]
# where the row's values are loaded apart from the dot: a stamp once all
# 8 have arrived (lin_dot takes the stamps from linear_value)
X_LOADS = [
    ("__device__ __forceinline__ float lin_dot(const LinRecord& rec,\n"
     "                                         const float* xr)",
     "__device__ __forceinline__ float lin_dot(const LinRecord& rec,\n"
     "                                         const float* xr,"
     " long long* lp_ta)"),
    ("  return lin_dot(rec, xr);", "  return lin_dot(rec, xr, lp_ta);"),
    ("  for (int j = 0; j < kCoefPad; ++j) xv[j] = xr[rec_col(rec, j)];\n",
     "  for (int j = 0; j < kCoefPad; ++j) xv[j] = xr[rec_col(rec, j)];\n"
     "  {\n    unsigned lp_x = 0;\n"
     "    for (int j = 0; j < kCoefPad; ++j) lp_x ^= __float_as_uint(xv[j]);\n"
     "    lp_ta[1] = lp_clock(lp_x);\n  }\n"),
]
# the first load of a leaf's linear block, in each layout: (the line,
# the value it loads)
FIRST_LOAD = [
    ("  const int cn = __ldg(lin.cnt + li);\n", "cn"),
    ("  const LinRecord rec = load_record(lin.rec + li);\n", "rec.w[3].w"),
]


def instrumented_source(csrc, work):
    """traverse.cu of `csrc` with the clocks above, written to `work`."""
    with open(os.path.join(csrc, "traverse.cu")) as f:
        text = f.read()
    text = KERNEL.sub(r"\1\n  BlockProbe lp_block_;", text)
    for pat, rep in LANE:
        text, n = pat.subn(rep, text, count=1)
        if n != 1:
            raise RuntimeError(f"anchor not found: {pat.pattern}")
    # linear_value takes the stamp after its first load
    head = re.compile(r"(__device__ __forceinline__ float linear_value\("
                      r"[^)]*?)\)\s*\{")
    text, n = head.subn(r"\1, long long* lp_ta) {", text, count=1)
    if n != 1:
        raise RuntimeError("linear_value's signature not found")
    if all(anchor in text for anchor, _ in X_LOADS):
        for anchor, stamped in X_LOADS:
            text = text.replace(anchor, stamped, 1)
    for line, dep in FIRST_LOAD:
        if line in text:
            text = text.replace(line, line + f"  lp_ta[0] = lp_ta[1] = "
                                f"lp_clock((unsigned)({dep}));\n", 1)
            break
    else:
        raise RuntimeError("linear_value's first load not found")
    with open(os.path.join(work, "traverse.cu"), "w") as f:
        f.write('#include "lin_probe.cuh"\n' + text)
    with open(os.path.join(work, "lin_probe.cuh"), "w") as f:
        f.write(PROBE)


def knob_source(csrc, work, knobs):
    """traverse.cu of `csrc` with each `constexpr <type> NAME = ...;` of
    `knobs` ({NAME: VALUE}) rewritten, written to `work`."""
    with open(os.path.join(csrc, "traverse.cu")) as f:
        text = f.read()
    for name, value in knobs.items():
        text, n = re.subn(rf"(constexpr [\w ]+ {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"constant {name} not found")
    with open(os.path.join(work, "traverse.cu"), "w") as f:
        f.write(text)


def lin_ptxas(text):
    """ptxas's registers and spills of the tree_lin_raw instantiations
    (walk_kernel with kLin, mangled ...Lb1EEEv) in nvcc's -v output."""
    import chip_smoke as cs
    return [(r["registers"], r["spill_stores"], r["spill_loads"])
            for r in cs.ptxas_usage(text) if "Lb1EEEv" in r["kernel"]]


def build(hk, work, name):
    """The library of `work`'s traverse.cu and its tree_lin_raw
    instantiations' (registers, spill stores, spill loads)."""
    path = os.path.join(work, name)
    proc = subprocess.run([hk._nvcc(), *hk.NVCC_FLAGS, "-o", path,
                           os.path.join(work, "traverse.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    return ctypes.CDLL(path), lin_ptxas(proc.stdout)


def planned_ms(tk, timer, call, x, forest, pl):
    """`call` timed with its launch plan replaced by `pl` (rows, window,
    slots, threads; the group stays the whole forest)."""
    b, f = x.shape
    t, s = forest.sf.shape
    base = tk.plan(b, f, t, s, 1)
    p = base._replace(rows=pl["rows"], window=pl["window"],
                      slots=pl["slots"], threads=pl["threads"])
    p = p._replace(smem=tk.smem_bytes(p.rows, p.group, p.window, p.slots,
                                      p.stage_rows, f, s, 1, True))
    arg = p.args(forest.categorical)
    planned = tk._planned
    tk._planned = lambda *a: (p, arg, ctypes.addressof(arg))
    try:
        return timer(call, 50)
    finally:
        tk._planned = planned


def run_probe(lib, call, timer):
    """One call on the instrumented copy, L2 flushed first; the lanes'
    stage cycles and the blocks' times."""
    import torch
    st = lib.lp_reset()
    if st != 0:
        raise RuntimeError(f"lp_reset: {st}")
    timer.flush.zero_()
    torch.cuda._sleep(2_000_000)
    call()
    torch.cuda.synchronize()
    n = ctypes.c_uint(0)
    blk = np.zeros((CAP, 8), np.int64)
    staged = np.zeros(CAP, np.int64)
    lanes = np.zeros((SLOTS, 5), np.uint64)
    st = lib.lp_read(blk.ctypes.data_as(ctypes.c_void_p), ctypes.byref(n),
                     staged.ctypes.data_as(ctypes.c_void_p),
                     lanes.ctypes.data_as(ctypes.c_void_p))
    if st != 0:
        raise RuntimeError(f"lp_read: {st}")
    rec = blk[:min(n.value, CAP)]
    tot = lanes.astype(np.float64).sum(axis=0)
    t0, t1 = rec[:, 3], rec[:, 4]
    ghz = float(((rec[:, 6] - rec[:, 5]) / np.maximum(t1 - t0, 1)).mean())
    dur = (t1 - t0) / 1e3
    stage = staged[rec[:, 0] % CAP] - t0
    lanes_n = max(tot[4], 1.0)
    return {
        "lanes": int(tot[4]),
        "lane_cycles": {"walk": tot[0] / lanes_n,
                        "first_load": tot[1] / lanes_n,
                        "row_loads": tot[2] / lanes_n,
                        "rest": tot[3] / lanes_n},
        "sm_ghz": ghz,
        "blocks": int(len(rec)), "sms": int(len(set(rec[:, 2].tolist()))),
        "block_us_p50_max": [float(np.median(dur)), float(dur.max())],
        "staging_us_p50": float(np.median(stage)) / 1e3,
        "span_us": float(t1.max() - t0.min()) / 1e3}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="another checkout whose tree_lin_raw is profiled")
    ap.add_argument("--knobs", default="",
                    help="sets of traverse.cu constants to time, "
                         "NAME=VALUE,...;...")
    ap.add_argument("--plans", default="",
                    help="launch plans to time tree_lin_raw with at 4096 "
                         "rows, rows=R,window=W,slots=S,threads=T;...")
    args = ap.parse_args()
    plans = [{k: int(v) for k, v in (kv.split("=") for kv in ps.split(","))}
             for ps in args.plans.split(";") if ps]
    knob_sets = [dict(kv.split("=") for kv in ks.split(","))
                 for ks in args.knobs.split(";") if ks]
    here = os.path.abspath(os.getcwd())
    sys.path.insert(0, os.path.abspath(args.root) if args.root else here)
    import torch
    from lightgbm_tpu_torch.ops import hist_kernels as hk
    from lightgbm_tpu_torch.ops import traverse_kernels as tk
    sys.path.insert(1, here)
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    tk.library()
    print(json.dumps({"card": card, "package": tk.__file__,
                      "ptxas": lin_ptxas(hk.BUILD_OUTPUT.get(tk.SOURCE,
                                                             ""))}),
          flush=True)
    timer = cs.Timer(torch)
    rng = np.random.RandomState(17)
    arrays, lv = cs.random_forest(rng, cs.SERVE_ROUNDS, 63, cs.N_FEATURES)
    forest = tk.freeze(*arrays, "cuda")
    blocks = cs.random_linear_blocks(rng, *lv.shape, cs.N_FEATURES)
    if "values" in inspect.signature(tk.freeze_linear).parameters:
        lin = tk.freeze_linear(*blocks, lv, torch.float32, "cuda")
    else:                     # a checkout whose records hold no values
        lin = tk.freeze_linear(*blocks, torch.float32, "cuda")
    lv32 = torch.from_numpy(lv).cuda()
    x_host, _ = cs.make_data(cs.SERVE_BUCKET, 17)
    x_all = torch.from_numpy(cs.plant_nan(x_host, rng)).cuda()
    plain = tk.library()
    work = tempfile.mkdtemp(prefix="lin_profile_")
    try:
        csrc = os.path.join(os.path.dirname(hk.__file__), os.pardir, "csrc")
        variants = []
        for i, knobs in enumerate(knob_sets):
            knob_source(csrc, work, knobs)
            lib, ptxas = build(hk, work, f"libtraverse_knobs{i}.so")
            tk._bind(lib)
            variants.append((dict(knobs, ptxas=ptxas), lib))
        instrumented_source(csrc, work)
        probe, _ = build(hk, work, "libtraverse_probe.so")
        tk._bind(probe)
        probe.lp_reset.restype = ctypes.c_int
        probe.lp_read.argtypes = [ctypes.c_void_p] * 4
        probe.lp_read.restype = ctypes.c_int
        for rows in (cs.SERVE_BUCKET, 1):
            x = x_all[:rows].contiguous()

            def lin_call():
                tk.tree_lin_raw(x, forest, lv32, lin, 1)

            tk._LIB = probe
            try:
                prof = run_probe(probe, lin_call, timer)
            finally:
                tk._LIB = plain
            ghz = prof["sm_ghz"]
            prof["lane_ns"] = {k: v / ghz for k, v in
                               prof["lane_cycles"].items()}
            row = {"rows": rows, "trees": cs.SERVE_ROUNDS, "leaves": 63,
                   "plan": tk.plan(rows, x.shape[1], cs.SERVE_ROUNDS,
                                   forest.sf.shape[1], 1)._asdict(),
                   "ms": timer(lin_call, 50),
                   "ms_warm": timer(lin_call, 50, flush=False),
                   "tree_raw_ms": timer(lambda: tk.tree_raw(
                       x, forest, lv32, 1), 50),
                   "tree_raw_ms_warm": timer(lambda: tk.tree_raw(
                       x, forest, lv32, 1), 50, flush=False),
                   "profile": prof}
            for knobs, lib in [({}, plain)] + variants:
                tk._LIB = lib
                try:
                    if knobs:
                        row.setdefault("knobs", []).append(
                            {**knobs, "ms": timer(lin_call, 50),
                             "ms_warm": timer(lin_call, 50, flush=False)})
                    if rows == cs.SERVE_BUCKET:
                        for pl in plans:
                            row.setdefault("plans", []).append(dict(
                                pl, knobs=knobs.get("ptxas") and {
                                    k: v for k, v in knobs.items()
                                    if k != "ptxas"},
                                ms=planned_ms(tk, timer, lin_call, x,
                                              forest, pl)))
                finally:
                    tk._LIB = plain
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
