"""Config system: parameter structs, parsing, alias table.

The port's copy of lightgbm_tpu/config.py. Every key of the JAX
package's Config is kept, so one params dict drives both packages; the
persistent XLA compile cache (setup_compilation_cache) has no
counterpart here. `check_slice` rejects the settings whose code paths
the port does not have yet.

Reference: include/LightGBM/config.h:20-406, src/io/config.cpp:15-349.
One flat Config object holds every parameter (the reference splits them
into IO/Objective/Metric/Tree/Boosting/Network sub-structs; we keep the
same names and defaults, flat, because the TPU build passes a single
hashable config into jitted tree-build steps).
"""

from dataclasses import dataclass, fields

from .utils.log import Log, check
from .utils.random import Random

# nonfinite_guard policies (lightgbm_tpu/utils/guardrails.py POLICIES)
NONFINITE_POLICIES = ("raise", "warn_skip", "clamp", "off")

# Alias table, reference config.h:316-406 (~70 entries).
PARAMETER_ALIASES = {
    "config": "config_file",
    "nthread": "num_threads",
    "random_seed": "seed",
    "num_thread": "num_threads",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "tranining_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "subsample_freq": "bagging_freq",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "mlist": "machine_list_file",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "categorical_feature": "categorical_column",
    "cat_column": "categorical_column",
    "cat_feature": "categorical_column",
    "predict_raw_score": "is_predict_raw_score",
    "predict_leaf_index": "is_predict_leaf_index",
    "raw_score": "is_predict_raw_score",
    "leaf_index": "is_predict_leaf_index",
    "min_split_gain": "min_gain_to_split",
    "topk": "top_k",
    "reg_alpha": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "num_classes": "num_class",
    "save_period": "snapshot_freq",
    "checkpoint_freq": "snapshot_freq",
    "checkpoint_dir": "snapshot_dir",
    "nan_policy": "nonfinite_guard",
}


def key_alias_transform(params: dict) -> dict:
    """Normalize aliased keys; explicit canonical keys win (config.h:394-404)."""
    out = dict(params)
    for k, v in params.items():
        canon = PARAMETER_ALIASES.get(k)
        if canon is not None:
            out.pop(k, None)
            if canon not in params:
                out[canon] = v
    return out


def str2map(parameters: str) -> dict:
    """Parse 'k1=v1 k2=v2' strings (config.cpp Str2Map)."""
    params = {}
    for arg in parameters.replace("\t", " ").replace("\n", " ").replace("\r", " ").split(" "):
        arg = arg.strip()
        if not arg:
            continue
        kv = arg.split("=")
        if len(kv) == 2:
            key = kv[0].strip().strip('"').strip("'")
            val = kv[1].strip().strip('"').strip("'")
            if key:
                params[key] = val
        else:
            Log.warning("Unknown parameter %s", arg)
    return key_alias_transform(params)


def _parse_bool(value) -> bool:
    if isinstance(value, bool):
        return value
    v = str(value).lower()
    if v in ("false", "-", "0"):
        return False
    if v in ("true", "+", "1"):
        return True
    Log.fatal('Parameter should be "true"/"+" or "false"/"-", got [%s]', value)


@dataclass
class Config:
    """All parameters, reference defaults (config.h:91-226)."""

    # --- overall (config.h:229-244) ---
    task: str = "train"
    seed: int = None  # fans out to sub-seeds when set (config.cpp:40-47)
    num_threads: int = 0
    boosting_type: str = "gbdt"
    objective: str = "regression"
    metric: tuple = ()
    tree_learner: str = "serial"

    # --- IO (config.h:91-133) ---
    max_bin: int = 256
    num_class: int = 1
    data_random_seed: int = 1
    data: str = ""
    valid_data: tuple = ()
    output_model: str = "LightGBM_model.txt"
    output_result: str = "LightGBM_predict_result.txt"
    input_model: str = ""
    verbose: int = 1
    num_iteration_predict: int = -1
    is_pre_partition: bool = False
    is_enable_sparse: bool = True
    # EFB conflict tolerance: fraction of rows a bundle may have in
    # conflict (0.0 = only perfectly-exclusive features share a slot;
    # conflicting cells keep the first member's bin). The reference v0
    # predates EFB — its per-feature sparse bins tolerate any overlap
    # (sparse_bin.hpp); this knob recovers that capacity for
    # NEAR-exclusive wide data.
    max_conflict_rate: float = 0.0
    use_two_round_loading: bool = False
    is_save_binary_file: bool = False
    enable_load_from_binary_file: bool = True
    bin_construct_sample_cnt: int = 50000
    is_predict_leaf_index: bool = False
    is_predict_raw_score: bool = False
    has_header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_column: str = ""

    # --- objective (config.h:136-151) ---
    sigmoid: float = 1.0
    label_gain: tuple = ()
    max_position: int = 20
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0

    # --- metric (config.h:154-162) ---
    ndcg_eval_at: tuple = (1, 2, 3, 4, 5)

    # --- tree (config.h:166-186) ---
    min_data_in_leaf: int = 100
    min_sum_hessian_in_leaf: float = 10.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    num_leaves: int = 127
    feature_fraction_seed: int = 2
    feature_fraction: float = 1.0
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    top_k: int = 20
    # piece-wise linear leaves (Shi et al., arXiv:1802.05640; models/
    # linear_leaves.py, docs/Linear-Trees.md): after the split search
    # fixes the structure, fit a ridge model per leaf on the leaf's
    # root->leaf path features (host f64 normal equations, one stacked
    # solve across the frontier). Leaves too small or degenerate fall
    # back to their constant Newton value.
    linear_tree: bool = False
    # ridge regularizer added to the feature diagonal of each leaf's
    # normal matrix (the intercept is not regularized)
    linear_lambda: float = 0.01
    # cap on per-leaf model width: the first N distinct path features
    # in root-first order; must stay <= serving's COEF_PAD (8) so a
    # linear challenger reuses the warmed serving kernels
    linear_max_features: int = 8

    # --- boosting (config.h:195-216) ---
    metric_freq: int = 1
    is_training_metric: bool = False
    num_iterations: int = 10
    learning_rate: float = 0.1
    bagging_fraction: float = 1.0
    bagging_seed: int = 3
    bagging_freq: int = 0
    early_stopping_round: int = 0
    drop_rate: float = 0.01
    drop_seed: int = 4
    # GOSS (post-reference extension, models/goss.py)
    top_rate: float = 0.2
    other_rate: float = 0.1

    # --- network (config.h:219-226) ---
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_file: str = ""
    # jax.distributed.initialize hardening (parallel/distributed.py):
    # retry count and first backoff delay (doubles per retry, capped);
    # the per-attempt timeout is `time_out` seconds
    init_retries: int = 3
    init_backoff_s: float = 1.0
    # --- mesh communication (parallel/mesh.py; the reference's analog
    # is the hand-rolled collective selection in src/network/) ---
    # precision of histogram payloads AT THE COLLECTIVE BOUNDARY only
    # (on-device arithmetic stays f32): "pair" exchanges both Kahan
    # words (the serial==data-parallel bit-parity default), "f32" the
    # collapsed word (half the bytes, deterministic), "bf16" quarter
    # the bytes (lossy; AUC-tolerance territory)
    comm_precision: str = "pair"
    # data-parallel histogram exchange: "auto" = reduce-scatter (each
    # rank reduces + searches only its owned feature block; ~W x fewer
    # wire bytes), "reduce_scatter" forces it, "allgather" restores the
    # full-histogram pair allgather (and is what bundled datasets use)
    hist_exchange: str = "auto"
    # feature-shard groups the reduce-scatter exchange is split into:
    # group g+1's collective can be in flight while group g's split
    # search runs (compute/comms overlap); 1 disables grouping
    comm_groups: int = 2

    # --- distributed supervisor (parallel/heartbeat.py, supervisor.py;
    # no reference equivalent) ---
    # peer declared dead after this many seconds without a heartbeat
    # change (0 = heartbeats off); beats publish every timeout/4
    heartbeat_timeout_s: float = 0.0
    # watchdog around blocking collectives: abort (exit code 117) when a
    # device-sync point blocks longer than this (0 = off). Must exceed
    # the worst-case legitimate sync, including a first-iteration compile
    collective_timeout_s: float = 0.0
    # elastic-restart launcher (`python -m lightgbm_tpu.supervisor`):
    # relaunch after a failure, at most max_restarts times
    restart_on_failure: bool = True
    max_restarts: int = 2

    # --- telemetry (lightgbm_tpu/telemetry/; no reference equivalent) ---
    # master switch for the structured run journal (+ /trainz wiring);
    # span tracing and the metrics registry are always on — in-memory
    # and near-free (docs/Observability.md)
    telemetry: bool = False
    # journal directory (rank-suffixed JSONL files, rank 0 merges); the
    # CLI defaults it to the shared run dir (snapshot_dir, else
    # <output_model>.snapshots) so aborts/restarts/resumes land in the
    # same timeline as training progress
    telemetry_dir: str = ""
    # >0 serves the live GET /trainz endpoint on 127.0.0.1:<port>
    telemetry_port: int = 0
    # wrap tracer spans in jax.profiler.TraceAnnotation so host-side
    # phases line up with XLA device traces (`profile=1` workflow)
    telemetry_jax_annotations: bool = False
    # dump the tracer's recent-span ring into the journal at close (a
    # `spans` record) so `python -m lightgbm_tpu_torch.telemetry.export`
    # renders fine-grained per-thread slices next to the journal timeline
    telemetry_trace: bool = False
    # warn at end of run for histogram kernels whose live achieved
    # bytes/s (telemetry/roofline.py) fall below this fraction of the
    # measured STREAM copy peak; 0 = off
    roofline_warn_fraction: float = 0.0
    # serving: requests slower than this emit a structured slow-request
    # log line (the `python -m lightgbm_tpu.serve --slow-request-ms`
    # flag mirrors it); 0 = off
    slow_request_ms: float = 1000.0
    # collective latency/overlap attribution (telemetry/comm_profile.py):
    # one `comm` journal record per iteration/block with per-collective
    # host-visible waits, comm_overlap_pct and the straggler view on
    # /trainz. On by default — it only measures when `telemetry` is on
    # (the timing sink is what arms the guarded sections)
    comm_telemetry: bool = True
    # append one `run_summary` record to this JSONL file at run_end
    # (telemetry/history.py; `tools/sentinel.py` trends over the last K
    # records and verify-perf gates on it); "" = off
    run_history: str = ""
    # distributed request tracing (telemetry/disttrace.py): the
    # deterministic hash(trace_id) fraction of healthy traces kept by
    # the tail sampler; error/504/shed and slow-over-slow_request_ms
    # traces are ALWAYS kept regardless (docs/Observability.md)
    trace_sample_rate: float = 0.01
    # keep ONLY error/slow traces: drops even the hash-sampled healthy
    # fraction (the lowest-overhead setting that still catches every
    # incident trace)
    trace_slow_only: bool = False
    # crash flight recorder: dump the span ring + registry snapshot +
    # journal tail to <telemetry_dir>/blackbox-<rank>.json on watchdog
    # abort (exit 117/118), SIGQUIT and unhandled serving exceptions
    blackbox: bool = True
    # documented default port for the fleet aggregator CLI
    # (`python -m lightgbm_tpu_torch.telemetry.aggregate --port`); multi-rank
    # CLI runs offset `telemetry_port` by rank so every rank of a
    # single-host gang is scrapable (application.py)
    aggregate_port: int = 0

    # --- serving resilience (serving/admission.py, fleet/router.py;
    # no reference equivalent — the reference's only resilience is the
    # socket linker's connect-retry loop) ---
    # deadline budget assumed for predict requests that carry no
    # X-Deadline-Ms header (`--deadline-default-ms` serve flag);
    # 0 = requests without a header are never deadline-shed
    deadline_default_ms: float = 0.0
    # admission control: shed (429 + Retry-After) when estimated queue
    # wait exceeds this fraction of the request's deadline budget;
    # brownout (drift/skew/shadow sampling off) engages at half of it
    # (`--shed-queue-budget` serve flag)
    shed_queue_budget: float = 1.0
    # router circuit breaker: consecutive upstream failures that open a
    # replica's breaker (`fleet route --breaker-failures`)
    breaker_failures: int = 5
    # router hedging: send a second copy of a slow predict to another
    # replica once its latency passes this ring quantile (e.g. 0.99);
    # 0 = hedging off (`fleet route --hedge-quantile`)
    hedge_quantile: float = 0.0
    # router retries: extra upstream attempts allowed per client
    # request, as a fraction (0.1 = 10% retry budget bounds error
    # amplification at 1.1x; `fleet route --retry-budget`)
    retry_budget: float = 0.1

    # --- model-quality observability (telemetry/quality.py,
    # io/profile.py, serving/drift.py; no reference equivalent beyond
    # the feature_importance C API) ---
    # journal one `quality` record per iteration/block: split ledger
    # deltas (splits/gain, top features by gain), leaf-value
    # distribution, importance drift; surfaced on /trainz + Prometheus.
    # Requires `telemetry` for the journal; gauges work without it.
    quality_telemetry: bool = False
    # drift comparisons fold each feature's bins into at most this many
    # contiguous groups before PSI (both the training profile baseline
    # and the serving-side rolling histogram fold identically); <= 0 =
    # native mapper resolution
    profile_bins: int = 10
    # serving drift monitor: fraction of request rows run through the
    # bin mappers for the rolling histograms (the `--drift-sample-rate`
    # serve flag mirrors it); 0 = drift monitoring off. The default is
    # sized so the monitor stays under 1% of the raw predict pipe
    # (serving/drift.py cost model); raise it on low-traffic services
    drift_sample_rate: float = 0.001
    # per-feature PSI at or above this emits a structured drift_warn
    # log line and counts into drift_features_over_warn (0.2 is the
    # conventional "investigate" threshold)
    psi_warn: float = 0.2
    # serving skew monitor: fraction of request rows shadow-scored
    # through the host f64 reference path (`--skew-sample-rate`);
    # 0 = skew monitoring off. One diverging row already warns, so a
    # trickle suffices to catch systematic skew
    skew_sample_rate: float = 0.0001
    # structured skew_warn once the diverging-row count reaches this
    # (the serving path is bit-exact vs the reference, so the first
    # skewed row is already a bug); 0 = never warn
    skew_warn: int = 1

    # --- fault tolerance (utils/checkpoint.py; no reference equivalent) ---
    snapshot_freq: int = 0     # checkpoint every k iterations (0 = off)
    snapshot_dir: str = ""     # default: <output_model>.snapshots
    snapshot_keep: int = 3     # rotation: keep the newest k checkpoints
    snapshot_resume: bool = True  # CLI auto-resume from newest valid one
    # NaN/Inf policy for gradients/hessians/scores
    # (utils/guardrails.py): raise | warn_skip | clamp | off
    nonfinite_guard: str = "raise"
    # CSV/TSV ingestion: quarantine up to this many malformed rows
    # (io/parser.py) instead of failing on the first one; 0 = strict
    max_bad_rows: int = 0

    # --- prediction routing (models/gbdt.py predict_raw; no reference
    # equivalent — the reference predicts per-row under OpenMP) ---
    # rows x trees at or above this run the jitted device traversal
    # instead of the host loop ("auto" routing)
    device_predict_cells: int = 20_000_000
    # host-path (rows x trees) cells per traversal block (peak memory)
    host_traverse_cells: int = 4_000_000
    # "auto" = cells-threshold routing; "true" forces the device path,
    # "false" forces the host path. The LIGHTGBM_TPU_DEVICE_PREDICT env
    # flag overrides this knob when set (docs/Parameters.md)
    device_predict: str = "auto"
    # task=predict streams the input file in chunks of this many rows
    # (application.py predict_file) so serving-scale scoring files never
    # materialize as one matrix
    predict_chunk_rows: int = 65536

    # --- out-of-core block-store training (lightgbm_tpu/data/; no
    # reference equivalent — the reference caps datasets at host RAM).
    # out_of_core=true bins the TRAIN dataset once into an on-disk
    # packed-bin block store and trains by streaming blocks through a
    # double-buffered async prefetcher (docs/Out-of-Core.md); trees are
    # bit-identical to in-RAM training with the masked histogram engine
    # (hist_compaction=false) on the same binning
    out_of_core: bool = False
    # rows per on-disk block; rounded up to a multiple of the histogram
    # scan chunk (device_row_chunk) so block boundaries align with the
    # Kahan chunk grid — the alignment the bitwise-parity contract
    # rests on
    block_rows: int = 262144
    # decoded blocks kept resident in an LRU cache on top of the
    # staging ring (0 = staging buffers only)
    block_cache_blocks: int = 0
    # staging buffers the background reader may fill ahead of the
    # consumer; resident bin memory is bounded at (2*prefetch_depth + 1)
    # blocks (staging ring + detached staged blocks in the queue + the
    # one the consumer holds) plus the cache
    prefetch_depth: int = 2
    # block-store directory; default: "<data>.blocks" next to the data
    # file, a fresh temp dir for in-memory matrices
    ooc_dir: str = ""
    # verify each block's manifest digest on its first read
    ooc_verify: bool = True
    # gang training over one shared store: seconds non-zero ranks wait
    # for rank 0's build to publish a signature-matching manifest
    # before giving up (data/block_store.py load_block_store_gang)
    ooc_build_wait_s: float = 600.0

    # derived from tree_learner/num_machines in check_param_conflict,
    # not user knobs — exempt from the Parameters.md row requirement
    is_parallel: bool = False  # graftlint: disable=config-doc-drift
    is_parallel_find_bin: bool = False  # graftlint: disable=config-doc-drift

    # TPU-specific knobs (no reference equivalent)
    device_row_chunk: int = 16384  # rows per histogram-matmul chunk
    # leaf-contiguous builder (models/partitioned.py): "true" turns it
    # on; "auto" resolves to the masked builder in this package
    partitioned_build: str = "auto"
    # gather-compacted smaller-child histograms on the dense (masked)
    # builder (ops/histogram.py compacted_histograms): "auto" = on
    # whenever the dense builder runs on more than one 4096-row chunk;
    # "false" restores the full-scan O(N)-per-split path
    hist_compaction: str = "auto"
    # histogram kernel formulation (ops/histogram.py): "auto" = the
    # Pallas streaming kernels on TPU, the f64 np.bincount host
    # callback on CPU, the one-hot einsum elsewhere;
    # "pallas"/"einsum"/"segment"/"bincount" force one formulation
    # (einsum/segment/bincount on TPU disable the Pallas kernels — the
    # supported escape hatch). Resolved once per learner init; the
    # LIGHTGBM_TPU_HIST_MODE env var seeds the process default.
    hist_mode: str = "auto"
    # multi-leaf frontier histogram batching (ops/histogram.py
    # frontier_histograms): "auto"/"true" = the root/bagging re-init
    # pass and the cache-less builder's both-children pass run the
    # one-pass multi-leaf primitive; "false" = per-leaf passes only
    hist_frontier: str = "auto"
    # canonicalize padded row counts to a 3-bit-mantissa grid
    # (ops/ordered_hist.py canonical_row_chunks) so nearby dataset sizes
    # share lowered executables through the persistent compile cache
    shape_bucketing: str = "auto"
    # persistent XLA compilation cache: "auto" = LIGHTGBM_TPU_CACHE_DIR
    # or ~/.cache/lightgbm_tpu/jax_cache, "off" disables, any other
    # value is the cache directory (setup_compilation_cache below)
    compile_cache: str = "auto"
    profile: str = ""              # jax.profiler trace dir ("1" = default dir)

    @classmethod
    def from_params(cls, params) -> "Config":
        """Build a Config from a dict or 'k=v ...' string, applying aliases,
        seed fan-out and conflict checks."""
        if isinstance(params, str):
            params = str2map(params)
        else:
            params = key_alias_transform({k: v for k, v in params.items() if v is not None})
        cfg = cls()
        type_map = {f.name: f.type for f in fields(cls)}
        for key, value in params.items():
            if key in ("config_file", "data", "valid_data", "metric", "label_gain",
                       "ndcg_eval_at", "task", "objective", "boosting_type",
                       "tree_learner", "seed"):
                continue  # handled specially below
            if key not in type_map:
                Log.warning("Unknown parameter: %s", key)
                continue
            cur = getattr(cfg, key)
            if isinstance(cur, bool):
                setattr(cfg, key, _parse_bool(value))
            elif isinstance(cur, int) or cur is None and key != "seed":
                setattr(cfg, key, int(float(value)))
            elif isinstance(cur, float):
                setattr(cfg, key, float(value))
            else:
                setattr(cfg, key, value)

        # seed fan-out (config.cpp:40-47)
        if "seed" in params:
            cfg.seed = int(params["seed"])
            rand = Random(cfg.seed)
            int_max = 2**31 - 1
            cfg.data_random_seed = rand.next_int(0, int_max)
            cfg.bagging_seed = rand.next_int(0, int_max)
            cfg.drop_seed = rand.next_int(0, int_max)
            cfg.feature_fraction_seed = rand.next_int(0, int_max)

        # enum-ish fields
        if "task" in params:
            t = str(params["task"]).lower()
            if t in ("train", "training"):
                cfg.task = "train"
            elif t in ("predict", "prediction", "test"):
                cfg.task = "predict"
            elif t == "refit":
                cfg.task = "refit"
            else:
                Log.fatal("Unknown task type %s", t)
        if "boosting_type" in params:
            b = str(params["boosting_type"]).lower()
            if b in ("gbdt", "gbrt"):
                cfg.boosting_type = "gbdt"
            elif b in ("dart", "goss"):
                cfg.boosting_type = b
            else:
                Log.fatal("Unknown boosting type %s", b)
        if "objective" in params:
            cfg.objective = str(params["objective"]).lower()
        if "tree_learner" in params:
            v = str(params["tree_learner"]).lower()
            mapping = {"serial": "serial",
                       "feature": "feature", "feature_parallel": "feature",
                       "data": "data", "data_parallel": "data",
                       "voting": "voting", "voting_parallel": "voting"}
            if v not in mapping:
                Log.fatal("Unknown tree learner type %s", v)
            cfg.tree_learner = mapping[v]
        if "metric" in params:
            raw = params["metric"]
            if isinstance(raw, str):
                raw = raw.lower().split(",")
            seen, mts = set(), []
            for m in raw:
                m = str(m).strip().lower()
                if m and m not in seen:
                    seen.add(m)
                    mts.append(m)
            cfg.metric = tuple(mts)
        if "data" in params:
            cfg.data = str(params["data"])
        if "valid_data" in params:
            raw = params["valid_data"]
            cfg.valid_data = tuple(raw.split(",")) if isinstance(raw, str) else tuple(raw)
        if "label_gain" in params:
            raw = params["label_gain"]
            cfg.label_gain = tuple(float(x) for x in
                                   (raw.split(",") if isinstance(raw, str) else raw))
        if "ndcg_eval_at" in params:
            raw = params["ndcg_eval_at"]
            ats = sorted(int(x) for x in (raw.split(",") if isinstance(raw, str) else raw))
            check(all(a > 0 for a in ats), "ndcg_eval_at must be positive")
            cfg.ndcg_eval_at = tuple(ats)

        if not cfg.label_gain:
            # label_gain = 2^i - 1 (config.cpp:237-243)
            cfg.label_gain = tuple([0.0] + [float((1 << i) - 1) for i in range(1, 31)])

        cfg.validate()
        cfg.check_param_conflict()
        Log.set_level_from_verbosity(cfg.verbose)
        return cfg

    def validate(self):
        """CHECKs from config.cpp:275-330."""
        check(self.max_bin > 0, "max_bin should be > 0")
        check(self.min_sum_hessian_in_leaf > 1.0 or self.min_data_in_leaf > 0,
              "need min_sum_hessian_in_leaf > 1.0 or min_data_in_leaf > 0")
        check(self.lambda_l1 >= 0.0, "lambda_l1 should be >= 0")
        check(self.lambda_l2 >= 0.0, "lambda_l2 should be >= 0")
        check(self.min_gain_to_split >= 0.0, "min_gain_to_split should be >= 0")
        check(self.num_leaves > 1, "num_leaves should be > 1")
        check(0.0 < self.feature_fraction <= 1.0, "feature_fraction in (0, 1]")
        check(self.max_depth > 1 or self.max_depth < 0, "max_depth should be > 1 or < 0")
        check(self.num_iterations >= 0, "num_iterations should be >= 0")
        check(self.bagging_freq >= 0, "bagging_freq should be >= 0")
        check(0.0 < self.bagging_fraction <= 1.0, "bagging_fraction in (0, 1]")
        check(self.learning_rate > 0.0, "learning_rate should be > 0")
        check(self.early_stopping_round >= 0, "early_stopping_round should be >= 0")
        check(0.0 <= self.drop_rate <= 1.0, "drop_rate in [0, 1]")
        check(self.num_machines >= 1, "num_machines should be >= 1")
        check(self.linear_lambda >= 0.0, "linear_lambda should be >= 0")
        check(self.linear_max_features >= 1,
              "linear_max_features should be >= 1")
        check(0.0 <= self.max_conflict_rate < 1.0,
              "max_conflict_rate in [0, 1)")
        check(self.num_class >= 1, "num_class should be >= 1")
        check(self.max_position > 0, "max_position should be > 0")
        check(self.snapshot_freq >= 0, "snapshot_freq should be >= 0")
        check(self.snapshot_keep >= 1, "snapshot_keep should be >= 1")
        check(self.init_retries >= 0, "init_retries should be >= 0")
        check(str(self.comm_precision).lower() in ("pair", "f32", "bf16"),
              "comm_precision must be pair|f32|bf16")
        check(str(self.hist_exchange).lower() in
              ("auto", "reduce_scatter", "allgather"),
              "hist_exchange must be auto|reduce_scatter|allgather")
        check(self.comm_groups >= 1, "comm_groups should be >= 1")
        check(self.heartbeat_timeout_s >= 0,
              "heartbeat_timeout_s should be >= 0")
        check(self.collective_timeout_s >= 0,
              "collective_timeout_s should be >= 0")
        check(self.max_restarts >= 0, "max_restarts should be >= 0")
        check(self.telemetry_port >= 0, "telemetry_port should be >= 0")
        check(self.aggregate_port >= 0, "aggregate_port should be >= 0")
        check(0.0 <= self.roofline_warn_fraction <= 1.0,
              "roofline_warn_fraction in [0, 1]")
        check(self.slow_request_ms >= 0,
              "slow_request_ms should be >= 0")
        check(self.deadline_default_ms >= 0,
              "deadline_default_ms should be >= 0")
        check(self.shed_queue_budget > 0,
              "shed_queue_budget should be > 0")
        check(self.breaker_failures >= 1,
              "breaker_failures should be >= 1")
        check(0.0 <= self.hedge_quantile < 1.0,
              "hedge_quantile in [0, 1)")
        check(self.retry_budget >= 0,
              "retry_budget should be >= 0")
        check(0.0 <= self.drift_sample_rate <= 1.0,
              "drift_sample_rate in [0, 1]")
        check(0.0 <= self.skew_sample_rate <= 1.0,
              "skew_sample_rate in [0, 1]")
        check(self.psi_warn >= 0.0, "psi_warn should be >= 0")
        check(self.skew_warn >= 0, "skew_warn should be >= 0")
        check(self.max_bad_rows >= 0, "max_bad_rows should be >= 0")
        check(self.device_predict_cells > 0,
              "device_predict_cells should be > 0")
        check(self.host_traverse_cells > 0,
              "host_traverse_cells should be > 0")
        check(str(self.device_predict).lower() in ("auto", "true", "false"),
              "device_predict must be auto|true|false")
        check(self.predict_chunk_rows > 0,
              "predict_chunk_rows should be > 0")
        check(self.block_rows > 0, "block_rows should be > 0")
        check(self.block_cache_blocks >= 0,
              "block_cache_blocks should be >= 0")
        check(self.prefetch_depth >= 1, "prefetch_depth should be >= 1")
        check(str(self.hist_mode).lower() in
              ("auto", "pallas", "einsum", "segment", "bincount"),
              "hist_mode must be auto|pallas|einsum|segment|bincount")
        check(self.nonfinite_guard in NONFINITE_POLICIES,
              "nonfinite_guard must be one of " + "|".join(NONFINITE_POLICIES))

    def check_slice(self):
        """Reject settings whose code paths the port does not have yet,
        each naming its item of ROADMAP.md queue 1. Training runs every
        learner of the JAX package: the serial learner with any of its
        histogram engines (masked, frontier, gather-compacted;
        models/tree_learner.py), the leaf-contiguous builder
        (partitioned_build=true), the out-of-core streaming learner
        (out_of_core=true) and its gang over one shared store
        (tree_learner=data, data/ooc_parallel.py), with gbdt, dart or
        goss boosting and constant or linear leaves; and the data-,
        feature- and voting-parallel learners on an in-process mesh of
        num_machines shards or on a process group of num_machines ranks
        from a machine list (parallel/learners.py,
        parallel/distributed.py), with heartbeats and collective timeouts
        (parallel/heartbeat.py). Nothing of training is refused now; the
        registry follower of serving is (serving/server.py)."""

    def check_param_conflict(self):
        """Reference config.cpp:139-187."""
        is_multiclass = self.objective == "multiclass"
        if is_multiclass:
            if self.num_class <= 1:
                Log.fatal("Number of classes should be specified and greater than 1 for multiclass training")
        elif self.task == "train" and self.num_class != 1:
            Log.fatal("Number of classes must be 1 for non-multiclass training")
        for mt in self.metric:
            mt_multiclass = mt in ("multi_logloss", "multi_error")
            if is_multiclass != mt_multiclass:
                Log.fatal("Objective and metrics don't match")

        if self.num_machines > 1:
            self.is_parallel = True
        else:
            self.is_parallel = False
            self.tree_learner = "serial"
        if self.tree_learner == "serial":
            self.is_parallel = False
            self.num_machines = 1
        if self.linear_tree and (self.num_machines > 1
                                 or self.tree_learner != "serial"):
            # the leaf refit accumulates normal equations over the FULL
            # row range on one host; meshed/gang learners would need a
            # cross-rank reduction of the per-leaf (k+1)^2 matrices
            Log.fatal("linear_tree=true is single-process "
                      "(tree_learner=serial, num_machines=1); got "
                      "tree_learner=%s num_machines=%d"
                      % (self.tree_learner, self.num_machines))
        if self.tree_learner in ("serial", "feature"):
            self.is_parallel_find_bin = False
        elif self.tree_learner == "data":
            self.is_parallel_find_bin = True
            if self.histogram_pool_size >= 0:
                Log.warning("Histogram LRU queue was enabled (histogram_pool_size=%f). "
                            "Will disable this to reduce communication costs", self.histogram_pool_size)
                self.histogram_pool_size = -1


def load_config_file(path: str) -> dict:
    """Parse a `key = value` config file (application.cpp:62-98; '#' comments)."""
    params = {}
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            kv = line.split("=", 1)
            if len(kv) == 2:
                params[kv[0].strip()] = kv[1].strip()
    return key_alias_transform(params)
