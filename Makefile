# Build system for the native pieces of lightgbm_tpu.
#
# Reference: /root/reference/CMakeLists.txt:1-98 builds the CLI binary
# `lightgbm` plus shared lib `lib_lightgbm.so` (the C API). Here the CLI
# is `python -m lightgbm_tpu`, so the only native artifact is the C API
# shim: lib_lightgbm.so embeds CPython and forwards every LGBM_* call to
# lightgbm_tpu.capi_bridge.
#
#   make            -> lib_lightgbm.so (repo root, where find_lib_path looks)
#   make test-capi  -> build + run the ported C API smoke test
#   make clean

PYTHON       ?= python3
PY_INCLUDES  := $(shell $(PYTHON)-config --includes)
PY_LDFLAGS   := $(shell $(PYTHON)-config --ldflags --embed 2>/dev/null || $(PYTHON)-config --ldflags)
CXX          ?= g++
CXXFLAGS     ?= -O2 -std=c++17 -fPIC -Wall
TARGET       := lib_lightgbm.so

all: $(TARGET)

$(TARGET): src_native/c_api_shim.cpp
	$(CXX) $(CXXFLAGS) -shared $(PY_INCLUDES) $< -o $@ $(PY_LDFLAGS)

test-capi: $(TARGET)
	$(PYTHON) -m pytest tests/test_c_api.py -q

# the PyTorch port's C API (lightgbm_tpu_torch/native/c_api_shim.cpp),
# built where the port builds it at first use
# (lightgbm_tpu_torch/csrc/build/capi_<hash>/lib_lightgbm_torch.so)
.PHONY: lib_lightgbm_torch
lib_lightgbm_torch:
	$(PYTHON) -c "from lightgbm_tpu_torch import native; print(native.build_library())"

# static-analysis gate (graftlint, lightgbm_tpu/analysis/ — docs/
# Static-Analysis.md): first the fixture corpus self-check (every rule
# must flag its known-bad snippets and stay silent on its known-good
# ones), then the live tree, which must be clean modulo the committed,
# justified baseline (tools/lint_baseline.json). Runs through the
# jax-free tools/graftlint.py shim: stdlib-ast only, a few seconds,
# no accelerator runtime
GRAFTLINT_JSON ?= /tmp/graftlint-$(shell id -u).json

verify-lint:
	$(PYTHON) tools/graftlint.py --self-check
	$(PYTHON) tools/graftlint.py --json $(GRAFTLINT_JSON)

# the default CI aggregate: every verify target, cheapest gate first
# (a lint violation fails in seconds, before any training run starts)
verify: verify-lint verify-fault verify-serve verify-obs verify-quality \
	verify-linear verify-perf verify-ooc verify-elastic verify-fleet \
	verify-resilience verify-dist verify-dist-perf

# fault-injection suite: checkpoint/resume determinism, corrupt-snapshot
# fallback, non-finite guardrails, distributed-init hardening
verify-fault:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/test_fault_tolerance.py -q

# distributed supervisor suite: heartbeat expiry, watchdog-armed
# collective timeout, rank-crash -> supervisor restart -> model parity,
# shrunken-world restart — real two-process jax.distributed runs on
# CPU, under a hard timeout so a regression can never hang CI
verify-dist:
	timeout -k 10 900 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_supervisor.py tests/test_distributed.py -q

# distributed comms guard (bench dist_probe via tools/verify_perf.py
# --dist): the 2-process gloo CPU data-parallel rung's per-tree
# collective wire bytes must stay within 15% of the committed
# BENCH_BASELINE.json dist_collective_bytes_per_tree AND >=3x below
# the legacy allgather-pair exchange measured side by side
verify-dist-perf:
	timeout -k 10 900 env JAX_PLATFORMS=cpu $(PYTHON) tools/verify_perf.py --dist

# online-inference suite: CompiledPredictor parity across objectives,
# NaN categorical routing, micro-batcher coalescing, streaming
# predict_file, and the end-to-end `python -m lightgbm_tpu.serve`
# smoke test — under a hard timeout so a hung server can never hang CI
verify-serve:
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_serving.py -q

# observability suite: span tracer nesting/isolation, registry
# thread-safety, journal atomicity across hard kills, multi-rank merge,
# /trainz + /metricz (JSON and Prometheus exposition), compile ledger,
# roofline table, trace export, comm-latency attribution + fleet
# aggregator + run-history sentinel (tests/test_comm_obs.py) — then
# the journal-schema lint + trace-export roundtrip on a freshly
# generated journal (check_journal.py --demo trains a tiny run with
# telemetry_trace on, validates every record incl. memory/compile/
# spans/comm + a run_summary history record, exports the trace and
# re-loads it through the event-invariant check), and the sentinel
# self-check (a seeded clean history passes, an injected >20%
# train-time regression trips). The disttrace leg covers the
# distributed-tracing layer end to end: header roundtrip, tail
# sampling, the collector stitching a live router + 2-replica run
# into one cross-process tree, Perfetto flow export through
# validate_trace, and the flight recorder's blackbox dump — then the
# acceptance guard (bench trace_probe via tools/verify_perf.py
# --trace: serving p99 overhead with tracing on at the default
# sample rate must stay under 1% / the CI noise slack vs tracing off)
verify-obs:
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_telemetry.py tests/test_comm_obs.py tests/test_disttrace.py -q
	env JAX_PLATFORMS=cpu $(PYTHON) tools/check_journal.py --demo
	env JAX_PLATFORMS=cpu $(PYTHON) tools/sentinel.py --self-check
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) tools/verify_perf.py --trace

# perf guardrail: the scaled CPU rung (warm compile cache) must stay
# within 15% of the committed BENCH_BASELINE.json train time at an AUC
# within 0.002, and the telemetry journal's phase deltas must sum back
# to the tracer totals (tools/verify_perf.py)
verify-perf:
	timeout -k 10 900 env JAX_PLATFORMS=cpu $(PYTHON) tools/verify_perf.py

# model-quality suite: split-ledger importance parity (split/gain vs
# reference semantics, bit-identical across serial/compacted/fused/
# out-of-core learners), dataset-profile capture + persistence
# roundtrips (binary cache, block store, model-file sidecar), PSI
# math, and the drift/skew e2e (train -> profile -> serve -> shifted
# replay trips psi_warn on /driftz + Prometheus + the structured log
# while unshifted traffic stays quiet) — tier-1 pytest flags, hard
# timeout
verify-quality:
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_quality.py tests/test_drift.py -q -m 'not slow' \
	  -p no:cacheprovider -p no:xdist -p no:randomly

# linear-leaf suite (docs/Linear-Trees.md): fit quality vs constant
# leaves, serial==out-of-core byte parity, format_version=2 round-trip
# + forward-compat rejection, checkpoint crash-resume byte parity,
# serving exact-path bit parity + bf16 pinned bound, and the hot-swap
# of a linear challenger over a constant incumbent — then the
# acceptance guard (bench linear_probe via tools/verify_perf.py
# --linear: trees-at-equal-AUC / AUC-delta win condition, fused-kernel
# p99 ratio vs the constant model, zero cold dispatches)
verify-linear:
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_linear_trees.py -q \
	  -p no:cacheprovider -p no:xdist -p no:randomly
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) tools/verify_perf.py --linear

# fleet suite: model registry atomicity/CRC/rollback, hot-swap under
# concurrent traffic (no mixed-version responses, no 5xx, zero cold
# dispatches), bf16 serving-precision bound, graceful drain — then the
# acceptance guard (bench fleet_probe via tools/verify_perf.py
# --fleet: sustained-QPS rung with a mid-run hot-swap; p99 during the
# swap gated against steady-state and BENCH_BASELINE.json, bf16
# throughput win + pinned accuracy bound). The pytest leg includes the
# end-to-end drift -> retrain -> validate -> promote rung on a
# shifted-traffic replay.
verify-fleet:
	timeout -k 10 900 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_fleet.py -q \
	  -p no:cacheprovider -p no:xdist -p no:randomly
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) tools/verify_perf.py --fleet

# out-of-core suite: block-store build/validate/reuse, streamed-vs-
# in-RAM bitwise parity across objectives/sampling, crash->resume,
# corrupt-store detection — then the acceptance guard (bench ooc_probe
# via tools/verify_perf.py --ooc: >=10x-resident dataset trains
# bit-identical with >=60% prefetch overlap and bounded peak RSS)
verify-ooc:
	timeout -k 10 900 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_out_of_core.py -q
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) tools/verify_perf.py --ooc

# elastic out-of-core suite: shared-store gang ownership math,
# preemption/bit-rot fault injection, shrink/grow chaos rungs
# (tests/test_elastic_ooc.py tier-1 portion) — then the acceptance
# guard (bench elastic_probe via tools/verify_perf.py --elastic: one
# binning pass across cold -> snapshot-resume -> 2-process gang over
# the SAME block store, resume cheaper than re-binning, comm +
# prefetch overlap both attributed on the gang run)
verify-elastic:
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_elastic_ooc.py tests/test_single_core.py -q -m 'not slow' \
	  -p no:cacheprovider -p no:xdist -p no:randomly
	timeout -k 10 900 env JAX_PLATFORMS=cpu $(PYTHON) tools/verify_perf.py --elastic

# front-door resilience suite (docs/Resilience.md): deadline
# propagation + queue shedding + brownout, chaos-fault determinism,
# circuit-breaker state machine, retry/hedge budgets, plus the slow
# chaos rung (3 replicas behind the router; one killed mid-traffic,
# one slowed 10x — zero 5xx to well-deadlined clients, amplification
# capped). Then the acceptance guard (bench router_probe via
# tools/verify_perf.py --router: 150 qps through the router with a
# kill + slowdown + error burst; zero 5xx/transport errors,
# amplification <= 1.05, breaker opens AND re-closes, p99-under-chaos
# gated against steady-state and BENCH_BASELINE.json)
verify-resilience:
	timeout -k 10 600 env JAX_PLATFORMS=cpu $(PYTHON) -m pytest \
	  tests/test_resilience.py -q \
	  -p no:cacheprovider -p no:xdist -p no:randomly
	timeout -k 10 900 env JAX_PLATFORMS=cpu $(PYTHON) tools/verify_perf.py --router

clean:
	rm -f $(TARGET)

.PHONY: all test-capi verify verify-lint verify-fault verify-dist \
	verify-dist-perf verify-serve verify-obs verify-perf verify-quality \
	verify-linear verify-fleet verify-ooc verify-elastic \
	verify-resilience clean
