"""Where compacted_hist's sorted route spends its time, on one CUDA card.

Builds a copy of csrc/compact_hist.cu with timestamps added (thread 0 of
a block writes %globaltimer at each job's start, after its wait and at
its end, and clock64 at the phases of a sum job's first feature), runs
it on compacted leaves of the bench shape (1,048,576 x 28, uint8 at 255
bins; leaves of 1%, 10% and 50% of the rows, and a 10% leaf whose
feature 3 has 90% of its rows in bin 0), requires the bits of the
wrapper's build, and prints for each leaf: the kernel's time (CUDA
events, L2 flushed, chip_smoke's Timer, on the copy with timestamps),
the span from the first job's start to the last job's end, and for
gather, sum and fold jobs their count, first start and last end, and
their durations and waits (10th, 50th and 90th percentiles, us); and
the median cycles of a sum job's first feature from its bins' arrival
to the end of the first counting pass, the later passes, the run
bounds and the adds. Run from the root of a checkout:

    python3 -m lightgbm_tpu_torch.bench.compact_timeline
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from lightgbm_tpu_torch.ops import hist_kernels as hk

SHARES = (0.01, 0.10, 0.50)
MAX_JOBS = 65536
# (anchor in compact_hist.cu, line added after it)
MARKS = [
    ("    if (t == 0) next = atomicAdd(w.ticket, 1u);\n\n", "JOB_MARK(0, 9);\n"),
    ("      publish(w.ready + chunk);\n", "JOB_MARK(2, 0);\n"),
    ("      wait_for(w.done + tile, plan.chunks);\n", "JOB_MARK(1, 2);\n"),
    ("        w.released[tile] = 0;\n      }\n", "JOB_MARK(2, 2);\n"),
    ("    wait_for(w.ready + chunk, plan.gathers);\n", "JOB_MARK(1, 1);\n"),
    ("    publish(w.done + tile);\n", "JOB_MARK(2, 1);\n"),
    ("      for (int b = t; b < num_bins; b += kThreads) start_s[b] = end_s[b] "
     "= 0;\n      __syncthreads();\n", "if (f == f_lo) CLOCK_MARK(0);\n"),
    ("          scatter_by_digit(ent, keep, 16, rows_s, keys_s, cnt_s, misc);\n",
     "if (f == f_lo) CLOCK_MARK(1);\n"),
    ("      // each bin's run [start, end) of the sorted rows, from the sorted\n",
     "if (f == f_lo) CLOCK_MARK(2);\n"),
    ("      if (f == f_lo) cp_async_wait<1>();  // this thread's statistics\n"
     "      __syncthreads();\n", "if (f == f_lo) CLOCK_MARK(3);\n"),
    ("      __syncthreads();  // the sort buffers and run bounds are reused\n",
     "if (f == f_lo) CLOCK_MARK(4);\n"),
]
HEAD = f"""
__device__ long long g_job[{MAX_JOBS} * 4];
__device__ long long g_clock[{MAX_JOBS} * 8];
__device__ __forceinline__ long long global_ns() {{
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}}
#define JOB_MARK(k, kind) do {{ if (threadIdx.x == 0 && job < {MAX_JOBS}) {{ \\
  g_job[job * 4 + 1 + (k)] = global_ns(); \\
  if ((kind) != 9) g_job[job * 4] = (kind) + 1; }} }} while (0)
#define CLOCK_MARK(k) do {{ if (threadIdx.x == 0 && job < {MAX_JOBS}) \\
  g_clock[job * 8 + (k)] = clock64(); }} while (0)
"""


def build(work):
    """The patched copy of compact_hist.cu, compiled and bound."""
    for name in ("chunk_hist.cuh", "compact_hist.cu"):
        with open(os.path.join(hk._CSRC, name)) as f:
            text = f.read()
        if name == "compact_hist.cu":
            for anchor, mark in MARKS:
                if text.count(anchor) != 1:
                    raise RuntimeError(f"compact_hist.cu: anchor not found "
                                       f"once: {anchor!r}")
                text = text.replace(anchor, anchor + mark)
            text = text.replace('#include "chunk_hist.cuh"\n',
                                '#include "chunk_hist.cuh"\n' + HEAD, 1)
            text += ('\nextern "C" int timeline_copy(long long* jobs, '
                     'long long* clocks) {\n'
                     '  cudaError_t e = cudaMemcpyFromSymbol(jobs, g_job, '
                     'sizeof(g_job));\n'
                     '  if (e == cudaSuccess) e = cudaMemcpyFromSymbol('
                     'clocks, g_clock, sizeof(g_clock));\n'
                     '  return (int)e;\n}\n'
                     'extern "C" int timeline_clear() {\n'
                     f'  static long long zero[{MAX_JOBS} * 8];\n'
                     '  cudaError_t e = cudaMemcpyToSymbol(g_job, zero, '
                     'sizeof(g_job));\n'
                     '  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_clock, '
                     'zero, sizeof(g_clock));\n'
                     '  return (int)e;\n}\n')
        with open(os.path.join(work, name), "w") as f:
            f.write(text)
    lib_path = os.path.join(work, "libcompact_timeline.so")
    out = subprocess.run([hk._nvcc(), *hk.NVCC_FLAGS, "-o", lib_path,
                          os.path.join(work, "compact_hist.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(out.stdout + out.stderr)
    lib = ctypes.CDLL(lib_path)
    hk._bind_compact_hist(lib)
    lib.timeline_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.timeline_copy.restype = ctypes.c_int
    lib.timeline_clear.restype = ctypes.c_int
    return lib


def percentiles(v):
    return [round(float(np.percentile(v, q)), 2) for q in (10, 50, 90)]


def summary(jobs, clocks):
    """The job timeline (us from the first job's start) and the median
    cycles of the sum jobs' first-feature phases."""
    p = jobs.reshape(-1, 4)
    p = p[p[:, 0] != 0]
    t0 = p[:, 1].min()
    out = {"span_us": (p[:, 3].max() - t0) / 1e3}
    for kind, name in ((1, "gather"), (2, "sum"), (3, "fold")):
        q = p[p[:, 0] == kind]
        if not len(q):
            continue
        wait = (q[:, 2] - q[:, 1]) / 1e3 if kind > 1 else np.zeros(len(q))
        out[name] = {"jobs": len(q),
                     "first_start_us": (q[:, 1].min() - t0) / 1e3,
                     "last_end_us": (q[:, 3].max() - t0) / 1e3,
                     "duration_us": percentiles((q[:, 3] - q[:, 1]) / 1e3),
                     "wait_us": percentiles(wait)}
    c = clocks.reshape(-1, 8)
    c = c[(c[:, 0] != 0) & (c[:, 4] != 0)]
    if len(c):
        out["sum_first_feature_cycles"] = {
            name: int(np.median(c[:, i + 1] - c[:, i]))
            for i, name in enumerate(("first_pass", "later_passes",
                                      "run_bounds", "adds"))}
    return out


def main():
    import chip_smoke as cs   # the checkout's root, the working directory
    hk.build()
    rng = np.random.RandomState(42)
    n, f = 1 << 20, cs.N_FEATURES
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    ghc = torch.from_numpy(np.stack([
        rng.randn(n).astype(np.float32) * inbag,
        rng.rand(n).astype(np.float32) * inbag, inbag])).cuda()
    other = torch.from_numpy(rng.randint(0, 7, size=n).astype(np.int32))
    plain = torch.from_numpy(rng.randint(0, cs.MAX_BIN, size=(f, n))
                             .astype(np.uint8))
    timer = cs.Timer(torch)
    with tempfile.TemporaryDirectory() as work:
        lib = build(work)
        for share, skew in [(s, False) for s in SHARES] + [(0.10, True)]:
            rl = torch.where(torch.from_numpy(rng.rand(n) < share), 7,
                             other).to(torch.int32)
            bins = plain.clone()
            if skew:
                rows = torch.from_numpy(np.flatnonzero(rl.numpy() == 7))
                bins[3, rows[torch.from_numpy(rng.rand(len(rows)) < 0.9)]] = 0
            bins, rl = bins.cuda(), rl.cuda()
            scratch = hk.CompactScratch(bins, cs.MAX_BIN)
            src = torch.empty(n, dtype=torch.int32, device="cuda")
            cnt = torch.empty(1, dtype=torch.int32, device="cuda")
            hk.compact_rows(rl, torch.tensor([7], dtype=torch.int32,
                                             device="cuda"), src, cnt)
            want = hk.compacted_hist(bins, ghc, src, cnt, cs.MAX_BIN,
                                     **scratch.hist_kwargs())

            def call():
                hi = torch.empty((f, cs.MAX_BIN, 3), device="cuda")
                lo = torch.empty_like(hi)
                status = lib.compacted_hist(
                    bins.data_ptr(), scratch.rows.data_ptr(),
                    scratch.rows.shape[1], 1, ghc.data_ptr(),
                    src.data_ptr(), cnt.data_ptr(), f, n, cs.MAX_BIN,
                    scratch.partials.data_ptr(), scratch.words.data_ptr(),
                    scratch.gathered.data_ptr(), hi.data_ptr(),
                    lo.data_ptr(), hk._stream(bins.device))
                if status != 0:
                    raise RuntimeError(
                        lib.compact_hist_status_string(status).decode())
                return hi, lo

            got = call()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise RuntimeError("the copy with timestamps gave other bits")
            ms = timer(call, 20)
            if lib.timeline_clear() != 0:
                raise RuntimeError("timeline_clear failed")
            timer.flush.zero_()
            torch.cuda._sleep(cs.SLEEP_CYCLES)
            call()
            torch.cuda.synchronize()
            jobs = np.zeros(MAX_JOBS * 4, np.int64)
            clocks = np.zeros(MAX_JOBS * 8, np.int64)
            if lib.timeline_copy(jobs.ctypes.data, clocks.ctypes.data) != 0:
                raise RuntimeError("timeline_copy failed")
            print(json.dumps({"share": share, "skew": skew,
                              "cnt": int(cnt[0]), "ms": ms,
                              **summary(jobs, clocks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
