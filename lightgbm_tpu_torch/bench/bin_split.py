"""Split bin_dense's time into its loads, searches and stores on one card.

csrc/bin.cu has two routes: the lane route (bin_lane_kernel: values
loaded straight into registers, searches in a bank-free (P, 32) table,
32-byte stores) and the direct route (bin_dense_kernel, the first
design: scalar loads, searches in lockstep, a shared transpose tile).
This builds copies of the source in a temp dir, one per part:

  full    the kernel as shipped;
  load    the loads, no search: a bin is a compare of the value with 0.5;
  search  the searches on values made from the row index, no load of x;
  store   neither: the stores of values made from the row index,

times two PyTorch yardsticks under the same timer (a fill_ of the
output's bytes, a sum of x), runs each part of each route (the direct
route from copies whose lane route takes no bounds, kLaneMaxP 0) on
the bench matrix (1,000,000 x 28 float32, normal values, uint8 at 255
bins; int16 at 1,023; and each width at the other bin count), requires
the full builds' bits to equal the wrapper's, and prints each time (CUDA
events, L2 flushed, chip_smoke's Timer) beside the byte bound. The
copies are for measurement only. Run from the root of a checkout on the
card:

    python3 -m lightgbm_tpu_torch.bench.bin_split [--out chiprun_out]
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import tempfile

import numpy as np
import torch

from lightgbm_tpu_torch.ops import bin_kernels as bk
from lightgbm_tpu_torch.ops import hist_kernels as hk

ROUTES = ("lane", "direct")
PARTS = ("full", "load", "search", "store")

# (pattern, replacement) of each part; each pattern must match
_SYNTH = "(float)(((unsigned)({row}) * 2654435761u) >> 16) * 1e-4f - 3.0f"
_LANE_LOAD = (r"const int64_t left = n - r;",
              "const int64_t left = n - r;\n#pragma unroll\n  for (int k = 0; "
              "k < kIlp; ++k) v[k] = " + _SYNTH.format(row="r + k + col")
              + ";\n  if (false)")   # the loads below never run
_LANE_SEARCH = [(r"q\[k\] \+= q\[k\]\[\(st - 1\) \* 32\] < v\[k\] \? st \* 32 "
                 r": 0;", ""),
                (r"const int pos = \(int\)\(\(q\[k\] - tcol\) >> 5\) \+ "
                 r"\(\*q\[k\] < v\[k\] \? 1 : 0\);",
                 "const int pos = v[k] > 0.5f ? 1 : 0;")]
_DIRECT_LOAD = (r"v\[k\] = rk < rows \? x\[\(r0 \+ rk\) \* c \+ col\] : "
                r"-CUDART_INF_F;",
                "v[k] = " + _SYNTH.format(row="rk + r0 + col") + ";")
_DIRECT_SEARCH = [
    (r"pos\[k\] \+= frow\[pos\[k\] \+ s - 1\] < v\[k\] \? s : 0;", ""),
    (r"pos\[k\] \+= frow\[pos\[k\]\] < v\[k\] \? 1 : 0;",
     "pos[k] += v[k] > 0.5f ? 1 : 0;")]
_EDITS = {
    "full": [],
    "load": _LANE_SEARCH + _DIRECT_SEARCH,
    "search": [_LANE_LOAD, _DIRECT_LOAD],
    "store": [_LANE_LOAD, _DIRECT_LOAD] + _LANE_SEARCH + _DIRECT_SEARCH,
}


def build_variant(part, work, knobs=None):
    """bin.cu with the part's edits and the `knobs` ({"kLaneIlp": 8,
    ...}: the lane plan; {"kLaneMaxP": 0}: the direct route at every
    width), compiled into `work`: (library path, nvcc process)."""
    with open(os.path.join(hk._CSRC, "bin.cu")) as f:
        text = f.read()
    edits = list(_EDITS[part])
    for knob, value in (knobs or {}).items():
        edits.append((rf"constexpr (int|bool) {knob} = [^;]+;",
                      rf"constexpr \g<1> {knob} = {value};"))
    for pattern, repl in edits:
        if knobs and pattern.startswith("constexpr"):
            text, count = re.subn(pattern, repl, text)
        else:
            text, count = re.subn(pattern, lambda _m, r=repl: r, text)
        assert count >= 1, f"bin.cu: {pattern!r} not found"
    name = part + "".join(f"_{k}{v}" for k, v in (knobs or {}).items())
    out = os.path.join(work, name)
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "bin.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out, "libbin.so")
    cmd = [hk._nvcc(), *hk.NVCC_FLAGS, "-o", lib, src]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def call(lib, x, cols, bounds, out):
    """The C entry point of a built copy."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    status = lib.bin_dense(x.data_ptr(), x.shape[0], x.shape[1],
                           cols.data_ptr(), cols.shape[0], bounds.data_ptr(),
                           bounds.shape[1], out.data_ptr(),
                           out.element_size(), sms,
                           torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(lib.bin_status_string(status).decode())
    return out


def quantile_bounds(x, bins):
    """(F, bins) float32 bounds: each column's bins - 1 inner quantiles
    and +inf, through dense_bounds (rounded toward -inf)."""
    qs = np.linspace(0, 1, bins + 1)[1:-1]
    return bk.dense_bounds([np.append(np.quantile(x[:, j].astype(np.float64),
                                                  qs), np.inf)
                            for j in range(x.shape[1])])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the whole kernel at every lane plan "
                         "(kLaneIlp 4/8/16 x kLaneThreads 256/512)")
    args = ap.parse_args()
    import chip_smoke as cs   # the checkout's root, the working directory
    hk.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as work:
        procs = {f"{route}_{part}": build_variant(
                     part, work, {"kLaneMaxP": 0} if route == "direct"
                     else None)
                 for route in ROUTES for part in PARTS}
        plans = ([{"kLaneIlp": i, "kLaneThreads": t}
                  for i in (4, 8, 16) for t in (256, 512)]
                 if args.sweep else [])
        for plan in plans:
            name = "plan " + " ".join(f"{k}={v}" for k, v in plan.items())
            procs[name] = build_variant("full", work, plan)
        libs = {}
        for key, (path, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{key}:\n{out}")
            lib = ctypes.CDLL(path)
            hk._bind_bin(lib)
            libs[key] = lib
        rng = np.random.RandomState(42)
        n, f = cs.N_ROWS, cs.N_FEATURES
        x_np = rng.randn(n, f).astype(np.float32)
        x = torch.from_numpy(x_np).cuda()
        cols = torch.arange(f, dtype=torch.int32, device="cuda")
        timer = cs.Timer(torch)
        report = {"card": smi, "rows": n, "features": f, "cases": []}
        # the bench's two cases, then each output width at the other
        # table size (which of the two moves a time)
        for label, bins, dt in (("uint8", 255, torch.uint8),
                                ("int16", 1023, torch.int16),
                                ("int16 at 255 bins", 255, torch.int16),
                                ("uint8 at 1023 bins", 1023, torch.uint8)):
            bounds = torch.from_numpy(quantile_bounds(x_np, bins)).cuda()
            want = bk.bin_dense(x, cols, bounds, dt)
            bound_ms, bound_by = cs.bin_bound_ms(n, f, bounds.shape[1],
                                                 want.element_size())
            # yardsticks under the same timer: writing the output's bytes
            # (fill_), reading x's (sum)
            sink = torch.empty_like(want)
            case = {"case": label, "bins": int(bounds.shape[1]),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "wrapper_ms": timer(lambda: bk.bin_dense(
                        x, cols, bounds, dt), 20),
                    "fill_output_ms": timer(lambda: sink.fill_(1), 20),
                    "sum_x_ms": timer(lambda: x.sum(), 20), "ms": {}}
            for key, lib in libs.items():
                out = torch.empty_like(want)
                call(lib, x, cols, bounds, out)
                torch.cuda.synchronize()
                if key.endswith("_full") or key.startswith("plan"):
                    assert torch.equal(out, want), f"{key}: other bits"
                case["ms"][key] = timer(
                    lambda: call(lib, x, cols, bounds, out), 20)
            report["cases"].append(case)
            print(json.dumps(case), flush=True)
    print(smi)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "bin_split.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
