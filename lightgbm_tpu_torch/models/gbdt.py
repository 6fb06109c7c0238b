"""GBDT: the boosting loop (port of lightgbm_tpu/models/gbdt.py).

Reference: src/boosting/gbdt.h:17-310, src/boosting/gbdt.cpp. The
port covers the per-iteration, single-process loop (train_one_iter
:835-955) for one tree or K class trees an iteration, record- and
query-unit bagging (_bagging :769-832), the hooks its subclasses DART
(models/dart.py, _score_for_boosting) and GOSS (models/goss.py, in-bag
weights from the gradients) override, linear leaves (linear_tree=true:
_fit_linear_tree refits each leaf on the host in float64, :961-994),
continued training (merge_from), parameter and training-data resets
(reset_config, reset_training_data), metric output with early
stopping, prediction and the model text (save_model_to_string /
load_model_from_string :1837-1945; format version 2 when a tree is
linear), and the training state of a checkpoint
(capture_training_state / restore_training_state :1969-2195; a
crash point at every iteration and fused block, utils/faults.py).

Under a process group (parallel/distributed.py) a row-sharded learner's
ranks each hold their row block: the train score, the gradients and the
bag cover the local rows, and every rank grows the same trees. A
snapshot stores the global train score, gathered in rank order
(_gather_global_train_score; layout "global_rows"), and a restore
re-slices it to the rank's block. The rank faults fire at every
iteration, and the tree's fetch, where a dead peer's collective shows
on the card, is armed with the collective watchdog
(parallel/heartbeat.py).

Prediction routes as the JAX package's does (predict_raw and
_use_device_predict :1679-1760): below DEVICE_PREDICT_CELLS rows x
trees the host float64 traversal (_traverse_host) with per-class
float64 sums, which pins the bits; above it, or with device_predict=
true, the device path (f32_safe_thresholds :47-62), one tree_raw
launch per block (ops/traverse_kernels.py; device_traverse :65-97 is
its plain version). Leaf indices always come from the host traversal.
Linear-leaf models always predict on the host (:1693-1741); their device
route is the serving kernel tree_lin_raw (serving/compiled_model.py).

One tree costs one host sync: the learner builds it on the device
without reading anything back, then fetches all its arrays in one
transfer. The train-score gather and the valid-set traversals are
queued after that fetch and run asynchronously.

The fused multi-iteration trainer (train_many, train_many_eval; the
JAX package's lax.scan over iterations, _get_fused_fn :1041-1174) runs
a block of T iterations with one host sync: on the card one boosting
iteration (gradients, tree build, train-score update, the tree's
arrays into slot t of a stacked buffer) is captured once as a CUDA
graph and replayed T times; on the CPU the same step runs eagerly.
The trees it grows are the per-iteration loop's, bit for bit. GOSS
draws its in-bag weights inside the step, from the step's gradients and
the iteration number held on the device.

Bagging draws an exact-count bag (int(bagging_fraction * N) rows, or
whole queries: int(bagging_fraction * num_queries) of them) from a
torch.Generator on the training device, seeded from
(bagging_seed, iteration // bagging_freq): bags are redrawn every
bagging_freq iterations and are a pure function of the window, as in
the JAX package. The bits differ from jax.random's; the tests feed both
packages one mask where they compare trees.
"""

import copy
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import hist_kernels, traverse_kernels
from ..parallel import heartbeat
from ..telemetry import disttrace
from ..telemetry import journal as run_journal
from ..telemetry.quality import tree_coeff_importance
from ..telemetry.registry import MetricsRegistry
from ..telemetry.trace import SpanTracer
from ..utils import common, faults, guardrails
from ..utils.device import resolve_device
from ..utils.log import LightGBMError, Log
from .score_updater import ScoreUpdater
from .tree import Tree
from .tree_learner import (SerialTreeLearner, create_tree_learner,
                           pack_tree, tree_views, unpack_tree)

K_MIN_SCORE = -np.inf

# model text format versions this reader accepts (2 = linear leaves);
# the writer emits version 2 for a model with linear leaves, else
# version 1 (no format_version line)
MODEL_FORMAT_VERSION = 2

# rows per device-predict block (bounds the (rows, trees) node state)
PREDICT_BLOCK = 1 << 16


def f32_safe_thresholds(thr, dt):
    """f32 cast of f64 numeric thresholds rounded toward -inf so
    `x <= thr32` equals the f64 `x <= thr` for every f32-representable
    x. Categorical thresholds are exact category ids."""
    thr32 = thr.astype(np.float32)
    numeric = dt != Tree.CATEGORICAL
    lifted = numeric & (thr32.astype(np.float64) > thr)
    return np.where(lifted,
                    np.nextafter(thr32, np.float32(-np.inf),
                                 dtype=np.float32),
                    thr32)


def device_traverse(xb, sf, thr, cat, lc, rc, node0, depth):
    """Lockstep traversal of a (B, F) float32 row block through all
    stacked (T, S) trees: every (row, tree) pair walks `depth` steps
    (leaves freeze as ~leaf) and the final (B, T) node states come
    back. NaN goes right on numeric nodes (`<=` is False) and on
    categorical nodes (a missing value is not a category id)."""
    b = xb.shape[0]
    t_cnt, s = sf.shape
    base = (torch.arange(t_cnt, device=xb.device) * s)[None, :]
    sf_f, thr_f, cat_f = sf.reshape(-1), thr.reshape(-1), cat.reshape(-1)
    lc_f, rc_f = lc.reshape(-1), rc.reshape(-1)
    xs = torch.nan_to_num(xb)
    node = node0[None, :].expand(b, t_cnt)
    for _ in range(depth):
        idx = base + node.clamp(min=0).long()                # (B, T)
        feat = sf_f[idx].long()
        th = thr_f[idx]
        fval = torch.gather(xb, 1, feat)
        fcat = torch.gather(xs, 1, feat)
        go_left = torch.where(
            cat_f[idx],
            (fcat.to(torch.int32) == th.to(torch.int32)) & ~torch.isnan(fval),
            fval <= th)
        nxt = torch.where(go_left, lc_f[idx], rc_f[idx])
        node = torch.where(node < 0, node, nxt)
    return node


class FusedBlock(NamedTuple):
    """One fused block's result: the (T, K, P) packed trees still on the
    device, the full iterations kept (t_eff), the partial-class trees
    kept at a natural stop (k_stop), the model count before the block,
    the train score before it and the feature sampler before its
    masks were drawn."""
    stacked: torch.Tensor
    t_eff: int
    k_stop: int
    n_before: int
    base: torch.Tensor
    rng: object


class FusedRunner:
    """One boosting iteration over static buffers, the counterpart of
    the scan body of the JAX package's _get_fused_fn.

    The step computes the objective's gradients from the train score,
    grows each class's tree with the feature mask at row `counter` of
    the block's (capacity, K, F) mask buffer and the in-bag mask in a
    static (N,) buffer (times GOSS's weights of iteration it0 + counter,
    drawn from these gradients, when the booster has that hook), adds `leaf_value * shrinkage` to the train score
    in place, and copies the packed tree into row `counter` of a
    (capacity, K, P) stack; then counter += 1, all on the device.

    On the card the step is captured once as a CUDA graph (after one
    warm-up step on a side stream, which loads the kernel libraries and
    sets their attributes, its score change undone) and each iteration
    of a block is one replay: a 63-leaf masked tree is about 17,000
    device ops, so one graph per iteration, not per block. On the CPU
    the same step runs eagerly. A capture or replay that fails raises.
    The graph reads and writes the train score tensor it was captured
    with: whoever rebinds that tensor drops the runner
    (GBDT._get_fused_fn checks)."""

    def __init__(self, gbdt, capacity):
        learner = gbdt.tree_learner
        dev = gbdt.device
        k = gbdt.num_class
        self.gbdt = gbdt
        self.capacity = int(capacity)
        self.score = gbdt.train_score_updater.score
        self.fmasks = torch.ones((self.capacity, k, learner.f_pad),
                                 dtype=torch.bool, device=dev)
        self.inbag = torch.ones(gbdt.num_data, dtype=torch.float32,
                                device=dev)
        self._inbag_src = None
        self._weights_fn = gbdt._fused_weights_fn()
        self.it0 = torch.zeros(1, dtype=torch.int64, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.stacked = torch.zeros((self.capacity, k, learner.packed_size),
                                   dtype=torch.int32, device=dev)
        self.graph = None
        self.warm_step_s = self.capture_s = 0.0
        if dev.type == "cuda":
            self._capture()

    def _step(self):
        gb = self.gbdt
        learner = gb.tree_learner
        updater = gb.train_score_updater
        g, h = gb.objective.get_gradients(self.score)
        fmask = self.fmasks.index_select(0, self.counter)[0]     # (K, F)
        inbag = self.inbag
        if self._weights_fn is not None:
            inbag = self._weights_fn(self.it0 + self.counter, g, h) * inbag
        rows = []
        for k in range(gb.num_class):
            out = learner.train_device(g[k], h[k], inbag,
                                       fmask=fmask[k])
            updater.add_score_by_partition(
                out["leaf_value"] * gb.shrinkage_rate,
                out["row_leaf"][:gb.num_data], k)
            rows.append(pack_tree(out))
        self.stacked.index_copy_(0, self.counter, torch.stack(rows)[None])
        self.counter += 1

    def _capture(self):
        """The warm-up step on a side stream, then the capture; each
        timed apart (warm_step_s, capture_s), the warm-up ending in a
        sync."""
        t0 = time.perf_counter()
        dev = self.score.device
        saved = self.score.clone()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.score.copy_(saved)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        self.warm_step_s = t1 - t0
        self.graph = hist_kernels.CapturedGraph()
        with self.graph.capture():
            self._step()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t1

    def run(self, num_iters, fmasks, inbag_fn, it0):
        """`num_iters` iterations from iteration `it0` with the host's
        (num_iters, K, F) feature masks, copied to the device in one
        asynchronous copy; `inbag_fn(it)` gives iteration it's bag
        (None: no bagging), copied into the static buffer when it
        changes. Returns the (num_iters, K, P) stacked trees. No host
        sync."""
        self.counter.zero_()
        self.it0.fill_(int(it0))
        self.gbdt.tree_learner.load_fmask(fmasks, self.fmasks[:num_iters])
        for t in range(num_iters):
            if inbag_fn is not None:
                mask = inbag_fn(it0 + t)
                if mask is not self._inbag_src:
                    self.inbag.copy_(mask)
                    self._inbag_src = mask
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()
        return self.stacked[:num_iters]


class _BlockSnapshots:
    """Per-iteration score snapshots over one fused block
    (gbdt.py:205-329).

    After GBDT._run_fused_block the block's trees are still stacked on
    the device. For every bound dataset the score after in-block
    iteration t is the base score plus the block's trees 0..t, added
    one at a time in order from one batched traversal per chunk of at
    most CHUNK_BYTES of deltas: the per-iteration loop's scores bit for
    bit, so the engine can replay the per-iteration eval / early-stop
    callbacks (gbdt.cpp:210-349) after the block. The caller walks t
    forward, so chunks stream.

    Valid updaters are pointed at each snapshot; the train score, whose
    tensor the fused graph holds, is copied into instead, and its final
    value kept aside for finalize().
    """

    CHUNK_BYTES = ScoreUpdater.CHUNK_BYTES

    def __init__(self, gbdt, block, base_valids, natural_stop):
        self._gbdt = gbdt
        self._block = block
        self._natural_stop = natural_stop
        self._final_train = None
        self._states = [self._new_state(gbdt.train_score_updater,
                                        block.base)]
        for u, b in zip(gbdt.valid_score_updaters, base_valids):
            self._states.append(self._new_state(u, b))

    @staticmethod
    def _new_state(updater, base):
        return {"updater": updater, "base": base, "row": base, "t": -1,
                "c0": 0, "chunk": None}

    def _row_at(self, st, t):
        gb = self._gbdt
        k = gb.num_class
        if t < st["t"]:
            raise ValueError("snapshots must be walked forward")
        while st["t"] < t:
            nxt = st["t"] + 1
            if st["chunk"] is None or nxt * k >= st["c0"] + st["chunk"].shape[0]:
                csz = max(1, min(self._block.t_eff - nxt, self.CHUNK_BYTES
                                 // max(1, k * st["updater"].num_data * 4)))
                st["c0"] = nxt * k
                st["chunk"] = st["updater"].deltas_by_stacked_device_trees(
                    gb._block_trees(self._block, nxt * k, (nxt + csz) * k),
                    gb.shrinkage_rate)
            i = nxt * k - st["c0"]
            st["row"] = st["row"] + st["chunk"][i:i + k]
            st["t"] = nxt
        return st["row"]

    def drop_tail_to(self, t):
        """Early-stop break at in-block iteration t: drop every tree past
        iteration t without touching the scores (the caller has set all
        of them to the t snapshot), the k_stop partial-class trees of a
        natural stop included."""
        gb = self._gbdt
        n_drop = (self._block.t_eff - (t + 1)) * gb.num_class
        if self._natural_stop:
            n_drop += self._block.k_stop
        if n_drop > 0:
            del gb.models[-n_drop:]
        gb.iter -= self._block.t_eff - (t + 1)
        gb._device_model_cache = None

    def set_scores_at(self, t, with_train=False):
        """Point every bound updater's score at the post-iteration-t
        state (t 0-based within the block). The train score only moves
        when with_train (train-set metrics, or an early-stop break)."""
        for st in self._states[1:]:
            st["updater"].score = self._row_at(st, t)
        if with_train:
            train = self._gbdt.train_score_updater.score
            if self._final_train is None:
                self._final_train = train.clone()
            train.copy_(self._row_at(self._states[0], t))

    def finalize(self):
        """After a completed walk (no early-stop break): the train score
        back to the block's final value, or, after a natural stop, the
        state of the kept trees. Returns True at a natural stop."""
        gb = self._gbdt
        if self._final_train is not None:
            gb.train_score_updater.score.copy_(self._final_train)
        if not self._natural_stop:
            return False
        gb._natural_stop(self._block)
        if self._block.k_stop > 0:
            # the stop iteration kept classes [0, k_stop), whose deltas
            # the per-full-iteration walk never applied
            stk = gb._block_trees(self._block, 0,
                                  len(gb.models) - self._block.n_before)
            for st in self._states[1:]:
                st["updater"].score = st["base"].clone()
                st["updater"].add_score_by_stacked_trees(
                    stk, gb.num_class, gb.shrinkage_rate)
        return True


class GBDT:
    name = "gbdt"

    # predict routing (lightgbm_tpu/models/gbdt.py:1570-1583): rows x
    # trees at or above this run the device traversal, below it the host
    # float64 path; the `device_predict_cells` / `host_traverse_cells` /
    # `device_predict` knobs override per booster (apply_predict_config)
    DEVICE_PREDICT_CELLS = 20_000_000
    # host-path (rows x trees) cells per traversal block (peak memory)
    _HOST_TRAVERSE_CELLS = 4_000_000
    device_predict = "auto"
    # a precision reference (serving/drift.py host_reference_scorer)
    # stays on the host path whatever the knobs and the environment say
    force_host_predict = False

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.models = []            # Tree list, class-major per iteration
        self.iter = 0
        self.num_init_iteration = 0
        self.num_iteration_for_pred = 0
        self.num_class = 1
        self.sigmoid = -1.0
        self.label_idx = 0
        self.max_feature_idx = 0
        self.feature_names = []
        self.train_data = None
        self.config = None
        self.objective = None
        self.tree_learner = None
        self.train_score_updater = None
        self.valid_score_updaters = []
        self.valid_metrics = []
        self.training_metrics = []
        self.early_stopping_round = 0
        self.shrinkage_rate = 0.1
        self.best_iter = []
        self.best_score = []
        self.best_msg = []
        self._bag_rows = None
        self._bag_window = None
        self._row_query = None
        self._device_model_cache = None
        self._fused_cache = {}
        # per-booster telemetry (telemetry/): the span tracer, the
        # metrics registry, the run journal (telemetry=true), the
        # /trainz server, the split-ledger tracker (quality_telemetry),
        # the collective wait profiler (comm_telemetry)
        self.tracer = SpanTracer()
        self.metrics = MetricsRegistry()
        self.journal = None
        self._trainz_server = None
        self.quality = None
        self.dataset_profile = None
        self._last_metric_values = {}
        self.comm_profile = None
        self._collectives_seen = {}

    # ------------------------------------------------------------------ init
    def init(self, config, train_data, objective, training_metrics=()):
        """gbdt.cpp:42-115: the first training data, through
        reset_training_data."""
        self.iter = 0
        self.num_class = config.num_class
        self.config = None
        self.train_data = None
        self.reset_training_data(config, train_data, objective,
                                 training_metrics)

    def reset_training_data(self, config, train_data, objective,
                            training_metrics=()):
        """gbdt.cpp:42-115 (lightgbm_tpu/models/gbdt.py:390): a new config
        and objective, and new training data binned with the old data's
        mappers. The learner is initialised on the data (on the card the
        compacted engine's scratch is made for its row count); the bag,
        the row -> query map and the fused runners go, since a captured
        graph holds the old tensors' addresses and the old objective. On
        new data a new ScoreUpdater starts from its init score and this
        booster's own trees are replayed onto it (merged init trees are
        covered by the init score, gbdt.cpp:77-79)."""
        config.check_slice()
        data_changed = train_data is not self.train_data
        if (data_changed and self.train_data is not None
                and not self.train_data.check_align(train_data)):
            Log.fatal("cannot reset training data, since new training data "
                      "has different bin mappers")
        self.config = config
        self.early_stopping_round = config.early_stopping_round
        self.shrinkage_rate = config.learning_rate
        self.objective = objective
        self.sigmoid = -1.0
        if objective is not None and objective.name == "binary":
            self.sigmoid = config.sigmoid
        self.apply_predict_config(config)
        self._bag_rows = self._bag_window = None
        self._row_query = None
        self._fused_cache = {}
        if self.tree_learner is None:
            self.tree_learner = create_tree_learner(config.tree_learner,
                                                    config, self.device)
        else:
            self.tree_learner.config = config
        self.tree_learner.init(train_data)
        if data_changed:
            self.training_metrics = list(training_metrics)
            self.train_score_updater = ScoreUpdater(
                train_data, self.num_class, self.device)
            first = self.num_init_iteration * self.num_class
            self.train_score_updater.add_score_by_trees(
                self.models[first:first + self.iter * self.num_class],
                self.num_class)
            self.num_data = train_data.num_data
            self.max_feature_idx = train_data.num_total_features - 1
            self.label_idx = train_data.label_idx
            self.feature_names = list(train_data.feature_names)
            self.train_data = train_data
        # the out-of-core learner feeds the prefetcher's counters in
        self.tree_learner.metrics = self.metrics
        self._setup_telemetry(config)

    def add_valid_dataset(self, valid_data, valid_metrics):
        """gbdt.cpp:117-147."""
        if not self.train_data.check_align(valid_data):
            Log.fatal("cannot add validation data, since it has different "
                      "bin mappers with training data")
        updater = ScoreUpdater(valid_data, self.num_class, self.device)
        first = self.num_init_iteration * self.num_class
        updater.add_score_by_trees(
            self.models[first:first + self.iter * self.num_class],
            self.num_class)
        self.valid_score_updaters.append(updater)
        self.valid_metrics.append(list(valid_metrics))
        if self.early_stopping_round > 0:
            self.best_iter.append([0] * len(valid_metrics))
            self.best_score.append([K_MIN_SCORE] * len(valid_metrics))
            self.best_msg.append([""] * len(valid_metrics))

    def reset_config(self, config, objective):
        """A new config and objective on the same training data
        (gbdt.py:390-441 with the data unchanged)."""
        self.reset_training_data(config, self.train_data, objective,
                                 self.training_metrics)

    def merge_from(self, other):
        """Continued training (gbdt.h:44-61): the other booster's trees go
        first, and count as this booster's init iterations."""
        self.models = list(other.models) + self.models
        self.num_init_iteration += len(other.models) // max(self.num_class, 1)
        self._device_model_cache = None

    # ------------------------------------------------------------- telemetry
    def _setup_telemetry(self, config):
        """The `telemetry*` knobs (gbdt.py:463-605): the tracer's
        torch.profiler ranges, the split-ledger tracker, the run journal
        (rank-suffixed JSONL in telemetry_dir), the collective timing
        sink and the comm profiler, the crash flight recorder, the
        kernels' roofline table and the opt-in /trainz endpoint.
        Idempotent per booster: a reset_config rebuild opens no second
        journal."""
        self.tracer.profiler_annotations = bool(
            getattr(config, "telemetry_jax_annotations", False))
        self._telemetry_trace = bool(getattr(config, "telemetry_trace",
                                             False))
        self._roofline_warn_fraction = float(
            getattr(config, "roofline_warn_fraction", 0.0) or 0.0)
        if (getattr(config, "quality_telemetry", False)
                and self.quality is None and self.train_data is not None):
            from ..telemetry.quality import QualityTracker
            self.quality = QualityTracker(self.max_feature_idx + 1,
                                          self.feature_names)
        if not getattr(config, "telemetry", False):
            return
        import weakref
        from ..telemetry import roofline
        roofline.TABLE.enabled = True
        ref = weakref.ref(self)   # process-wide hooks must not pin us
        if (self.comm_profile is None
                and getattr(config, "comm_telemetry", True)):
            from ..telemetry.comm_profile import CommProfiler
            self.comm_profile = CommProfiler(rank=faults.current_rank())

        def timing_sink(name, seconds):
            gbdt = ref()
            if gbdt is None:
                heartbeat.bind_timing_sink(None)
                return
            gbdt.metrics.observe("sync_wait_s", seconds)
            if gbdt.comm_profile is not None:
                gbdt.comm_profile.record(name, seconds)

        heartbeat.bind_timing_sink(timing_sink)
        self._timing_sink_fn = timing_sink
        if self.comm_profile is not None:
            prof = self.comm_profile

            def beat_extra():
                return {"comm_wait_s": round(prof.cum_wait_s, 6)}

            heartbeat.bind_beat_extra(beat_extra)
            self._beat_extra_fn = beat_extra
        if self.journal is None:
            directory = (getattr(config, "telemetry_dir", "")
                         or getattr(config, "snapshot_dir", ""))
            if not directory:
                Log.warning("telemetry=true but neither telemetry_dir "
                            "nor snapshot_dir is set; run journal "
                            "disabled")
            else:
                rank = faults.current_rank()
                self.journal = run_journal.RunJournal(
                    directory, rank=rank,
                    meta={"num_ranks": int(getattr(config, "num_machines",
                                                   1) or 1)})
                run_journal.set_current(self.journal)
                self.tracer.rank = rank
                self._trace_recorder = disttrace.configure(
                    journal=self.journal, rank=rank, service="train",
                    sample_rate=float(getattr(config, "trace_sample_rate",
                                              0.01) or 0.0),
                    slow_ms=float(getattr(config, "slow_request_ms",
                                          0.0) or 0.0),
                    slow_only=bool(getattr(config, "trace_slow_only",
                                           False)))
                if getattr(config, "blackbox", True):
                    flight = disttrace.FLIGHT.configure(directory,
                                                        rank=rank)
                    self._flight_armed = flight.enabled
                    tracer, metrics = self.tracer, self.metrics
                    jpath = self.journal.path
                    flight.add_source("spans", lambda: tracer.recent(None))
                    flight.add_source("metrics", metrics.snapshot)
                    flight.add_source(
                        "journal_tail", lambda: run_journal.tail(jpath,
                                                                 n=20))
                    flight.install_sigquit()
        port = int(getattr(config, "telemetry_port", 0) or 0)
        if port > 0 and self._trainz_server is None:
            from ..telemetry import trainz

            def iteration_fn():
                gbdt = ref()
                return gbdt.iter if gbdt is not None else -1

            def quality_fn():
                gbdt = ref()
                if gbdt is None or gbdt.quality is None:
                    return None
                return gbdt.quality.snapshot()

            def comm_fn():
                gbdt = ref()
                if gbdt is None or gbdt.comm_profile is None:
                    return None
                return gbdt.comm_profile.snapshot()

            self._trainz_server = trainz.start_trainz(
                trainz.build_sources(
                    iteration_fn=iteration_fn, tracer=self.tracer,
                    registry=self.metrics, journal=self.journal,
                    roofline_warn_fraction=self._roofline_warn_fraction,
                    quality_fn=(quality_fn if self.quality is not None
                                else None),
                    comm_fn=(comm_fn if self.comm_profile is not None
                             else None)),
                port=port)

    def _account_collectives(self):
        """The meshed learner's collective_bytes{_kind} counters of the
        tree just built (parallel/mesh.py CommPlan) into the registry:
        each counter advances by its growth since the last tree."""
        learner = self.tree_learner
        if learner is None or not getattr(learner, "collective_bytes", None):
            return
        for key, total in learner.collective_bytes.items():
            grown = int(total) - self._collectives_seen.get(key, 0)
            if grown:
                self.metrics.inc(key, grown)
                self._collectives_seen[key] = int(total)

    def _journal_iteration(self, **fields):
        """One journal record a completed iteration (or fused block:
        `block` is the iteration count it covers); the phase seconds ride
        as deltas, so the records sum back to the run's totals."""
        if self.journal is None:
            return
        self.journal.iteration(self.iter,
                               phases=self.tracer.delta_snapshot(),
                               **fields)
        self._journal_comm()
        self._journal_introspection()

    def _journal_comm(self):
        """One `comm` record an iteration or block (comm_telemetry): the
        collective waits since the last record, and the overlap."""
        if self.comm_profile is None:
            return
        rec = self.comm_profile.flush(self.iter)
        if rec is None:
            return
        self.metrics.set("comm_overlap_pct", rec["overlap_pct"])
        self.metrics.set("comm_wait_s", rec["wait_s"])
        if self.journal is not None:
            self.journal.event("comm", **rec)

    def _journal_introspection(self):
        """Memory watermarks (the allocator's counters and the host RSS:
        no device sync) and the set-up ledger's new entries, at every
        iteration or block boundary."""
        from ..telemetry import ledger
        mem = ledger.sample_memory()
        if mem:
            self.journal.event("memory", iteration=int(self.iter), **mem)
            for key, val in mem.items():
                self.metrics.set(key, val)
        for entry in ledger.LEDGER.drain():
            self.journal.event("compile", label=entry["label"]
                               or entry["event"],
                               seconds=round(entry["seconds"], 6),
                               cache_hit=bool(entry["cache_hit"]))

    def _journal_quality(self):
        """One `quality` record a completed iteration or block
        (quality_telemetry; gbdt.py:688-715); the registry's quality_*
        gauges move even without a journal."""
        if self.quality is None:
            return
        delta = self.quality.sync(self.models)
        ledger = self.quality.ledger
        self.metrics.set("quality_trees_total", int(ledger.n_trees))
        self.metrics.set("quality_splits_total", int(ledger.n_splits))
        self.metrics.set("quality_gain_total", float(ledger.gain_sums.sum()))
        top = self.quality.snapshot()["top_features"]
        if top:
            self.metrics.set("quality_top_feature_gain",
                             float(top[0]["gain"]))
        if delta is not None and self.journal is not None:
            if self._last_metric_values:
                delta["values"] = dict(self._last_metric_values)
            self.journal.event("quality", iteration=int(self.iter), **delta)

    def finalize_introspection(self):
        """The last memory and set-up records, the `telemetry_trace`
        span-ring dump and the roofline warning; the CLI calls it before
        `run_end`, close_telemetry as a fallback. Once only."""
        if self.journal is None or getattr(self, "_introspection_done",
                                           False):
            return
        self._introspection_done = True
        self._journal_introspection()
        if getattr(self, "_telemetry_trace", False):
            self.journal.event("spans", epoch_ts=self.tracer.epoch_wall,
                               spans=self.tracer.recent(n=None))
        self._warn_roofline()

    def close_telemetry(self, merge=False):
        """End of run: drain the introspection, close the journal (after
        an optional rank-0 merge), stop /trainz and drop this booster's
        process-wide hooks. Safe to call twice."""
        if self.journal is not None:
            self.finalize_introspection()
            rec = getattr(self, "_trace_recorder", None)
            if rec is not None:
                rec.flush_pending()
                if disttrace.get_recorder() is rec:
                    disttrace.set_recorder(None)
                self._trace_recorder = None
            if getattr(self, "_flight_armed", False):
                disttrace.FLIGHT.disarm()
                self._flight_armed = False
            if merge:
                run_journal.merge_journals(self.journal.directory)
            self.journal.close()
            if run_journal.current() is self.journal:
                run_journal.set_current(None)
            self.journal = None
        if self._trainz_server is not None:
            from ..telemetry import trainz
            trainz.stop_trainz(self._trainz_server)
            self._trainz_server = None
        if (getattr(self, "_timing_sink_fn", None) is not None
                and heartbeat._TIMING_SINK is self._timing_sink_fn):
            heartbeat.bind_timing_sink(None)
        self._timing_sink_fn = None
        if (getattr(self, "_beat_extra_fn", None) is not None
                and heartbeat._BEAT_EXTRA is self._beat_extra_fn):
            heartbeat.bind_beat_extra(None)
        self._beat_extra_fn = None

    def _warn_roofline(self):
        """roofline_warn_fraction: name every kernel whose achieved
        bytes/s fell below that fraction of the measured copy peak."""
        frac = getattr(self, "_roofline_warn_fraction", 0.0)
        if frac <= 0:
            return
        from ..telemetry import roofline
        snap = roofline.TABLE.snapshot(warn_fraction=frac)
        for name, k in (snap.get("kernels") or {}).items():
            if k.get("below_peak_fraction"):
                Log.warning(
                    "roofline: kernel [%s] achieved %.2f GB/s = %.1f%% "
                    "of the %.2f GB/s copy peak (< %.0f%% warn fraction; "
                    "%d calls, %.3fs)", name, k["bytes_per_s"] / 1e9,
                    k.get("pct_of_peak", 0.0),
                    snap["peak_bytes_per_s"] / 1e9, 100.0 * frac,
                    k["calls"], k["seconds"])

    # -------------------------------------------------------- checkpointing
    def _rng_registry(self):
        """The named host RNG streams a resume must continue: the
        feature sampler and DART's drop sampler (numpy RandomStates, the
        JAX package's, so their states are interchangeable). Bagging and
        GOSS are stateless, keyed on the iteration."""
        regs = {}
        learner = self.tree_learner
        if learner is not None and getattr(learner, "random", None) is not None:
            regs["feature_sampler"] = learner.random
        if getattr(self, "_random_for_drop", None) is not None:
            regs["drop_sampler"] = self._random_for_drop
        return regs

    def _multihost_row_sharded(self):
        """True when the training rows are partitioned across processes:
        each rank's train score covers its row block only."""
        learner = self.tree_learner
        return (learner is not None
                and getattr(learner, "n_proc", 1) > 1
                and getattr(learner, "shard_rows", False))

    def _allgather_row_counts(self):
        """(P,) local row counts in rank order. Collective: every rank
        calls it at the same point (watchdog-armed)."""
        from ..parallel.distributed import host_allgather
        n_local = int(self.train_score_updater.score.shape[-1])
        with heartbeat.collective_guard("snapshot_counts_gather"):
            return host_allgather(np.asarray([n_local],
                                             np.int64)).reshape(-1)

    def _gather_global_train_score(self):
        """The global (num_class, N) train score from every rank's block
        (contiguous row ranges in rank order, distributed.partition_rows).
        Collective, so every rank captures at a snapshot point even
        though only rank 0 writes the file."""
        from ..parallel.distributed import host_allgather
        counts = self._allgather_row_counts()
        with heartbeat.collective_guard("snapshot_score_gather"):
            # the score's copy waits on the device work the last
            # collectives queued
            local = self.train_score_updater.score.cpu().numpy().astype(
                np.float32, copy=False)
            padded = np.zeros((local.shape[0], int(counts.max())),
                              np.float32)
            padded[:, :local.shape[1]] = local
            blocks = host_allgather(padded)
        return np.concatenate([blocks[r][:, :int(c)]
                               for r, c in enumerate(counts)], axis=1)

    def capture_training_state(self):
        """The full mid-training state for utils/checkpoint.py
        (gbdt.py:2025-2100), the JAX package's keys: what
        restore_training_state needs to continue on the same config and
        data to the model text of an uninterrupted run. The scores are
        saved as their float32 bits, one device -> host copy each
        (recomputing them from the trees would change the summation
        order); under a process group the global score (see the module
        doc). The model text keeps real-valued thresholds only, so the
        bin-space split encoding rides along: each tree's
        threshold_in_bin and inner split features, and the inner
        coefficient ids of its linear leaves."""
        if self._multihost_row_sharded():
            train_score = self._gather_global_train_score()
            score_layout = "global_rows"
        else:
            train_score = self.train_score_updater.score.cpu().numpy()
            score_layout = "local"
        state = {
            "state_version": 1,
            "model_str": self.save_model_to_string(-1),
            "iter": int(self.iter),
            "num_init_iteration": int(self.num_init_iteration),
            "num_class": int(self.num_class),
            "train_score": train_score,
            "train_score_layout": score_layout,
            "valid_scores": [u.score.cpu().numpy()
                             for u in self.valid_score_updaters],
            "best_iter": [list(map(int, x)) for x in self.best_iter],
            "best_score": [list(map(float, x)) for x in self.best_score],
            "best_msg": [list(x) for x in self.best_msg],
        }
        for name, rng in self._rng_registry().items():
            algo, keys, pos, has_gauss, cached = rng._rng.get_state()
            state[f"rng_{name}"] = {"algo": algo, "pos": int(pos),
                                    "has_gauss": int(has_gauss),
                                    "cached": float(cached)}
            state[f"rng_{name}_keys"] = np.asarray(keys)
        n_splits, tib, sfi, lin_counts, lin_feats = [], [], [], [], []
        for tree in self.models:
            ns = tree.num_leaves - 1
            n_splits.append(ns)
            if ns > 0:
                tib.append(np.asarray(tree.threshold_in_bin[:ns], np.int32))
                sfi.append(np.asarray(tree.split_feature[:ns], np.int32))
            if tree.is_linear:
                cnts = np.asarray(tree.leaf_coeff_count, np.int32)
                lin_counts.append(cnts)
                lin_feats.append(np.concatenate(
                    [tree.leaf_coeff_feat_inner[leaf, :cnts[leaf]]
                     for leaf in range(tree.num_leaves)]
                    or [np.zeros(0, np.int32)]).astype(np.int32))
            else:
                lin_counts.append(np.zeros(ns + 1, np.int32))
                lin_feats.append(np.zeros(0, np.int32))

        def cat(parts):
            return np.concatenate(parts) if parts else np.zeros(0, np.int32)

        state["tree_n_splits"] = np.asarray(n_splits, np.int32)
        state["tree_threshold_in_bin"] = cat(tib)
        state["tree_split_feature_inner"] = cat(sfi)
        state["tree_leaf_coeff_counts"] = cat(lin_counts)
        state["tree_leaf_feat_inner"] = cat(lin_feats)
        return state

    def restore_training_state(self, state):
        """Inverse of capture_training_state on a freshly initialized
        booster bound to the same config and datasets
        (gbdt.py:2102-2195). The scores are written into the existing
        device tensors (copy_), so a captured fused graph keeps updating
        the score this booster reads. The bagging window, the prediction
        caches and the stacked-tree caches describe the pre-restore state
        and go; bagging and GOSS need nothing else (their draws are
        functions of the iteration)."""
        if int(state.get("state_version", 0)) != 1:
            Log.fatal("Unsupported checkpoint state version %s",
                      state.get("state_version"))
        if int(state["num_class"]) != self.num_class:
            Log.fatal("Checkpoint num_class %d does not match booster "
                      "num_class %d", int(state["num_class"]), self.num_class)
        n_valid = len(state.get("valid_scores", []))
        if n_valid != len(self.valid_score_updaters):
            Log.fatal("Checkpoint has %d valid-set scores but booster has "
                      "%d valid sets bound", n_valid,
                      len(self.valid_score_updaters))
        self.load_model_from_string(state["model_str"])
        n_splits = np.asarray(state.get("tree_n_splits", []), np.int32)
        if len(n_splits) == len(self.models):
            offsets = np.concatenate([[0], np.cumsum(n_splits)])
            tib = np.asarray(state["tree_threshold_in_bin"], np.int32)
            sfi = np.asarray(state["tree_split_feature_inner"], np.int32)
            lin_counts = np.asarray(
                state.get("tree_leaf_coeff_counts", []), np.int32)
            lin_feats = np.asarray(
                state.get("tree_leaf_feat_inner", []), np.int32)
            leaf_off = np.concatenate([[0], np.cumsum(n_splits + 1)])
            feat_pos = 0
            for idx, tree in enumerate(self.models):
                lo, hi = offsets[idx], offsets[idx + 1]
                if hi > lo:
                    tree.threshold_in_bin = tib[lo:hi].copy()
                    tree.split_feature = sfi[lo:hi].copy()
                if len(lin_counts) != leaf_off[-1]:
                    continue  # a checkpoint without linear-leaf ids
                cnts = lin_counts[leaf_off[idx]:leaf_off[idx + 1]]
                if tree.is_linear:
                    for leaf in range(tree.num_leaves):
                        k = int(cnts[leaf])
                        tree.leaf_coeff_feat_inner[leaf, :k] = \
                            lin_feats[feat_pos:feat_pos + k]
                        feat_pos += k
                else:
                    feat_pos += int(cnts.sum())
        # load_model_from_string readies the trees for prediction (all
        # init trees); a resume continues training
        self.num_init_iteration = int(state["num_init_iteration"])
        self.num_iteration_for_pred = 0
        self.iter = int(state["iter"])
        train_score = np.asarray(state["train_score"], dtype=np.float32)
        if (state.get("train_score_layout") == "global_rows"
                and self._multihost_row_sharded()):
            # the global capture -> this rank's block: contiguous
            # rank-order slices
            from ..parallel.distributed import process_rank
            counts = self._allgather_row_counts()
            if int(counts.sum()) != train_score.shape[-1]:
                Log.fatal("Checkpoint global train score has %d rows but "
                          "the ranks hold %d (different training data?)",
                          train_score.shape[-1], int(counts.sum()))
            rank = process_rank()
            offset = int(counts[:rank].sum())
            train_score = train_score[:, offset:offset + int(counts[rank])]
        score = self.train_score_updater.score
        if train_score.shape != tuple(score.shape):
            Log.fatal("Checkpoint train-score shape %s does not match "
                      "dataset shape %s (different training data?)",
                      train_score.shape, tuple(score.shape))
        score.copy_(torch.from_numpy(train_score))
        for updater, vs in zip(self.valid_score_updaters,
                               state["valid_scores"]):
            vs = np.asarray(vs, dtype=np.float32)
            if vs.shape != tuple(updater.score.shape):
                Log.fatal("Checkpoint valid-score shape %s does not match "
                          "the valid set's %s", vs.shape,
                          tuple(updater.score.shape))
            updater.score.copy_(torch.from_numpy(vs))
        self.best_iter = [list(x) for x in state.get("best_iter", [])]
        self.best_score = [list(x) for x in state.get("best_score", [])]
        self.best_msg = [list(x) for x in state.get("best_msg", [])]
        for name, rng in self._rng_registry().items():
            meta = state.get(f"rng_{name}")
            keys = state.get(f"rng_{name}_keys")
            if meta is None or keys is None:
                continue
            rng._rng.set_state((meta["algo"],
                                np.asarray(keys, dtype=np.uint32),
                                int(meta["pos"]), int(meta["has_gauss"]),
                                float(meta["cached"])))
        self._bag_rows = None
        self._bag_window = None
        self._device_model_cache = None
        Log.info("Restored training state at iteration %d (%d trees)",
                 self.iter, len(self.models))

    # --------------------------------------------------------------- bagging
    def _bagging(self, it, gradients=None, hessians=None):
        """gbdt.cpp:150-201: the (N,) float32 in-bag mask on the device,
        or None when bagging is off. Cached per re-bag window. The
        gradients are for gradient-based sampling (models/goss.py);
        plain bagging ignores them. With
        query boundaries whole queries go in or out of the bag
        (int(num_queries * bagging_fraction) of them), spread to their
        rows through the row -> query map (gbdt.py:798-812)."""
        cfg = self.config
        if not (cfg.bagging_fraction < 1.0 and cfg.bagging_freq > 0):
            return None
        window = it // int(cfg.bagging_freq)
        if window == self._bag_window and self._bag_rows is not None:
            return self._bag_rows
        gen = torch.Generator(device=self.device)
        # one 32-bit seed mixed from (bagging_seed, window): the CPU
        # generator keeps only 32 bits of its seed
        gen.manual_seed(int(np.random.SeedSequence(
            [int(cfg.bagging_seed) & 0xFFFFFFFF, window]).generate_state(1)[0]))
        qb = self.train_data.metadata.query_boundaries
        if qb is None:
            perm = torch.randperm(self.num_data, generator=gen,
                                  device=self.device)
            bag_cnt = int(cfg.bagging_fraction * self.num_data)
            self._bag_rows = (perm < bag_cnt).to(torch.float32)
        else:
            nq = len(qb) - 1
            if self._row_query is None:
                self._row_query = torch.from_numpy(np.searchsorted(
                    np.asarray(qb), np.arange(self.num_data),
                    side="right") - 1).to(self.device)
            perm = torch.randperm(nq, generator=gen, device=self.device)
            qmask = (perm < int(nq * cfg.bagging_fraction)).to(torch.float32)
            self._bag_rows = qmask[self._row_query]
        self._bag_window = window
        return self._bag_rows

    # -------------------------------------------------------------- training
    def train_one_iter(self, gradients=None, hessians=None, is_eval=True):
        """gbdt.cpp:210-245. Returns True if training should stop."""
        faults.crash_if_reached(self.iter)
        faults.rank_crash_if_reached(self.iter)
        faults.rank_hang_if_reached(self.iter)
        heartbeat.WATCHDOG.set_iteration(self.iter)
        if gradients is None or hessians is None:
            if self.objective is None:
                Log.fatal("No object function provided")
            with self.tracer.phase("gradients"):
                gradients, hessians = self.objective.get_gradients(
                    self._score_for_boosting())
        else:
            gradients = torch.as_tensor(
                np.asarray(gradients, dtype=np.float32)).reshape(
                    self.num_class, self.num_data).to(self.device)
            hessians = torch.as_tensor(
                np.asarray(hessians, dtype=np.float32)).reshape(
                    self.num_class, self.num_data).to(self.device)
        policy = getattr(self.config, "nonfinite_guard", "raise")
        if policy in ("warn_skip", "clamp"):
            gradients, hessians, skip = self._guard_gradients(
                gradients, hessians, policy)
            if skip:
                # no tree and no iteration: the model list stays
                # iter * num_class long
                return False
        with self.tracer.phase("bagging"):
            inbag = self._bagging(self.iter, gradients, hessians)
        learner = self.tree_learner
        n = self.num_data
        linear = bool(getattr(self.config, "linear_tree", False))
        norms = None
        new_leaves = 0
        for k in range(self.num_class):
            with self.tracer.phase("build"):
                out = learner.train_device(gradients[k], hessians[k], inbag)
            self.metrics.inc("tree_build_dispatches")
            extra = ()
            if policy == "raise":
                # the guard's flag rides on the tree's one transfer
                extra = ((torch.isfinite(gradients[k]).all()
                          & torch.isfinite(hessians[k]).all()),)
            if self.journal is not None and k == 0:
                # the iteration record's gradient and hessian RMS ride on
                # the first tree's transfer (no sync of their own)
                extra += tuple(torch.sqrt(torch.mean(
                    torch.square(t.double()))).float().reshape(())
                    for t in (gradients, hessians))
            with self.tracer.phase("host_sync"), \
                    heartbeat.collective_guard("leaf_count_sync"):
                host, extras = learner.fetch(out, extra)  # the one sync
            if self.journal is not None and k == 0:
                norms = extras[-2:]
                extras = extras[:-2]
            if hasattr(learner, "account_tree_collectives"):
                # the wire bytes of this tree (parallel/mesh.py CommPlan),
                # a 0-split tree's root exchange included
                learner.account_tree_collectives()
                self._account_collectives()
            if policy == "raise" and not extras[0]:
                guardrails.guard_gradients(gradients.cpu().numpy(),
                                           hessians.cpu().numpy(),
                                           self.iter, policy)
            if linear:
                # the split search fixed the structure; each leaf is
                # refit on the host, so this tree syncs more than once
                tree, values = self._fit_linear_tree(
                    host, out, gradients[k], hessians[k], inbag)
            else:
                tree = learner.host_out_to_tree(host,
                                                shrink=self.shrinkage_rate)
            if tree.num_leaves <= 1:
                Log.info("Stopped training because there are no more leafs "
                         "that meet the split requirements.")
                return True
            with self.tracer.phase("score_upd"):
                if linear:
                    self.train_score_updater.add_score_by_values(
                        values * self.shrinkage_rate, k)
                    for updater in self.valid_score_updaters:
                        updater.add_score_by_tree(tree, k)
                else:
                    self.train_score_updater.add_score_by_partition(
                        out["leaf_value"] * self.shrinkage_rate,
                        out["row_leaf"][:n], k)
                    for updater in self.valid_score_updaters:
                        updater.add_score_by_device_tree(
                            out, tree.max_depth, self.shrinkage_rate, k)
            new_leaves += tree.num_leaves
            self.models.append(tree)
        self.iter += 1
        self._device_model_cache = None
        self.metrics.inc("leaves_total", new_leaves)
        self.metrics.set("iteration", self.iter)
        if self.journal is not None:
            # learners with per-iteration IO counters (the out-of-core
            # learner's prefetch deltas) add theirs (journal_fields)
            fields_fn = getattr(learner, "journal_fields", None)
            extra_fields = fields_fn() if callable(fields_fn) else {}
            if norms is not None:
                extra_fields.update(grad_norm=float(norms[0]),
                                    hess_norm=float(norms[1]))
            self._journal_iteration(leaf_count=int(new_leaves),
                                    **extra_fields)
        self._journal_quality()
        if is_eval:
            with self.tracer.phase("eval"):
                return self.eval_and_check_early_stopping()
        return False

    def _score_for_boosting(self):
        """The train score the gradients are taken from: the hook of
        DART's tree dropping (dart.hpp GetTrainingScore)."""
        return self.train_score_updater.score

    def _fit_linear_tree(self, host, out, grad, hess, inbag):
        """The fetched tree with its leaves refit as ridge models
        (models/linear_leaves.py; gbdt.py:961-994). Returns (tree,
        values): the shrunk tree and the unshrunk (N,) float64 per-row
        outputs (the caller applies the learning rate, as the constant
        path's leaf_value * shrinkage_rate). The fit pulls the row ->
        leaf partition, the gradients and the bag to the host."""
        from .linear_leaves import fit_linear_leaves, leaf_path_features
        learner = self.tree_learner
        n = self.num_data
        tree = learner.host_out_to_tree(host, shrink=1.0)
        values = np.zeros(n, np.float64)
        if tree.num_leaves > 1:
            feats = leaf_path_features(
                tree.split_feature, tree.left_child, tree.right_child,
                tree.leaf_parent, tree.num_leaves,
                self.config.linear_max_features)
            chunks, bin_values, fit_chunk = learner.linear_fit_context()
            const, coeffs, is_lin, values = fit_linear_leaves(
                feats, tree.leaf_value, tree.leaf_count, bin_values,
                out["row_leaf"][:n].cpu().numpy(), grad[:n].cpu().numpy(),
                hess[:n].cpu().numpy(),
                None if inbag is None else inbag[:n].cpu().numpy(),
                chunks, fit_chunk, self.config.linear_lambda)
            if is_lin.any():
                tree.set_linear(const, coeffs, is_lin, feats,
                                learner.train_set.real_feature_idx)
        tree.shrinkage(self.shrinkage_rate)
        return tree, values

    def _guard_gradients(self, gradients, hessians, policy):
        """warn_skip / clamp (utils/guardrails.py) on device gradients:
        one device flag read, and the host copies only when it trips.
        Returns (gradients, hessians, skip)."""
        if bool(torch.isfinite(gradients).all()
                & torch.isfinite(hessians).all()):
            return gradients, hessians, False
        g, h, skip = guardrails.guard_gradients(
            gradients.cpu().numpy(), hessians.cpu().numpy(), self.iter,
            policy)
        return (torch.from_numpy(np.asarray(g, np.float32)).to(self.device),
                torch.from_numpy(np.asarray(h, np.float32)).to(self.device),
                skip)

    # ------------------------------------------------- fused multi-iteration
    # A block of iterations with one host sync: the host draws the
    # block's feature-fraction masks (the per-iteration loop's RNG
    # stream and order) and writes each re-bag window's mask into a
    # static buffer; the device runs T captured iterations; one
    # transfer brings every tree back (the JAX package's scan, whose
    # graph is one XLA program, gbdt.py:1000-1260).

    def _fused_boosting_ok(self):
        """Whether this boosting type's per-iteration logic is pure
        device work: DART's tree dropping rescales earlier trees on the
        host; GOSS overrides this (its sample is drawn in the step)."""
        return type(self).__name__ == "GBDT"

    def _fused_weights_fn(self):
        """The in-graph in-bag hook of the fused step, (iteration int64
        device tensor, (K, N) gradients, hessians) -> (N,) weights that
        multiply the in-bag buffer, or None (GOSS overrides it)."""
        return None

    def _fused_inbag_fn(self):
        """The host bag hook of the fused block, (iteration) -> (N,)
        in-bag mask, None when bagging is off: the bag is drawn outside
        the graph and copied into its static buffer when the window
        changes."""
        cfg = self.config
        if cfg.bagging_fraction < 1.0 and cfg.bagging_freq > 0:
            return self._bagging
        return None

    def _fused_eligible(self, ignore_train_metrics=False):
        """gbdt.py:1020-1039. ignore_train_metrics=True answers "could
        this train fused in blocks with the metrics replayed between
        them?" (engine._train_blockwise)."""
        cfg = self.config
        if cfg is None or self.objective is None:
            return False
        return (self._fused_boosting_ok()
                and (not self.valid_score_updaters or ignore_train_metrics)
                and (cfg.metric_freq <= 0 or not self.training_metrics
                     or ignore_train_metrics)
                and self.early_stopping_round <= 0
                and not bool(getattr(cfg, "linear_tree", False))
                and isinstance(self.tree_learner, SerialTreeLearner)
                and not self.tree_learner.streams_blocks
                and not self.tree_learner.meshed)

    def _get_fused_fn(self, num_iters):
        """The block runner for this booster's learner, objective and
        shrinkage (the JAX package's _fused_cache key), made at first use:
        on the card that captures the graph. A runner whose train score
        tensor was rebound, or whose stack is shorter than the block, is
        dropped and made again."""
        learner = self.tree_learner
        key = (float(self.shrinkage_rate), id(learner),
               (learner.num_data, learner.n_pad, learner.f_pad),
               id(self.objective))
        runner = self._fused_cache.get(key)
        if (runner is None or runner.capacity < num_iters
                or runner.score is not self.train_score_updater.score):
            self._fused_cache.pop(key, None)  # its graph's pool goes too
            runner = FusedRunner(self, num_iters)
            self._fused_cache[key] = runner
        return runner

    def warm_up_fused(self, num_iters):
        """Capture the fused trainer's graph ahead of training (capture
        is not training time, as the JAX package's compile is not).
        False when the booster is not eligible."""
        if self._fused_eligible():
            self._get_fused_fn(num_iters)
            return True
        return False

    def _run_fused_block(self, num_iters):
        """Run ONE fused block of `num_iters` iterations, guard the
        scores at its boundary, bring the stacked trees back in one
        transfer and append the kept ones (gbdt.py:1184-1260). The
        train score is left at the block's final value (at a natural
        stop it still holds the discarded trees: callers fix that)."""
        # a block is one device program: a preemption anywhere inside it
        # loses the whole block, which crashing at its start models
        faults.crash_if_reached(self.iter, num_iters)
        faults.rank_crash_if_reached(self.iter, num_iters)
        faults.rank_hang_if_reached(self.iter, num_iters)
        heartbeat.WATCHDOG.set_iteration(self.iter)
        runner = self._get_fused_fn(num_iters)
        learner = self.tree_learner
        k = self.num_class
        rng = copy.deepcopy(learner.random)
        # one mask per (iteration, class) tree, in the per-iteration
        # loop's order
        fmasks = np.stack([[learner._sample_features() for _ in range(k)]
                           for _ in range(num_iters)])
        base = self.train_score_updater.score.clone()
        with self.tracer.phase("fused_block", iterations=num_iters), \
                heartbeat.collective_guard("fused_block"):
            stacked = runner.run(num_iters, fmasks, self._fused_inbag_fn(),
                                 self.iter)
            policy = getattr(self.config, "nonfinite_guard", "raise")
            parts = [stacked.reshape(-1)]
            if policy != "off":
                parts.append(torch.isfinite(runner.score).all().reshape(1)
                             .to(torch.int32))
            flat = torch.cat(parts).cpu().numpy()  # ONE transfer a block
        if policy != "off" and not flat[-1]:
            # the iterations inside the graph cannot be guarded one by
            # one; the block boundary is where divergence shows
            guardrails.guard_scores(runner.score.cpu().numpy(),
                                    self.iter + num_iters, policy)
        rows = flat[:stacked.numel()].reshape(num_iters, k, -1)
        hosts = [[unpack_tree(rows[t, c], self.config.num_leaves)
                  for c in range(k)] for t in range(num_iters)]
        nsp = np.array([[h["n_splits"] for h in row] for row in hosts])
        empty = (nsp == 0).any(axis=1)
        t_eff = int(np.argmax(empty)) if bool(empty.any()) else num_iters
        # classes before the first empty one in the stopping iteration
        # are kept, as the per-iteration loop appends them
        k_stop = int(np.argmax(nsp[t_eff] == 0)) if t_eff < num_iters else 0
        n_before = len(self.models)
        kept = [(t, c) for t in range(t_eff) for c in range(k)]
        kept += [(t_eff, c) for c in range(k_stop)]
        for t, c in kept:
            self.models.append(learner.host_out_to_tree(
                hosts[t][c], shrink=self.shrinkage_rate))
        self.iter += t_eff
        self._device_model_cache = None
        self.metrics.inc("tree_build_dispatches", len(kept))
        self.metrics.inc("transfer_bytes", int(flat.nbytes))
        self.metrics.set("iteration", self.iter)
        if self.journal is not None and t_eff > 0:
            # one record a block: the iterations inside the captured
            # graph have no host phases of their own
            self._journal_iteration(block=int(t_eff), fused=True)
        self._journal_quality()
        return FusedBlock(stacked, t_eff, k_stop, n_before, base, rng)

    def _block_trees(self, block, i0, i1):
        """The block's kept trees i0..i1 (class-major) as a stacked-tree
        dict on the device (score_updater.stacked_deltas)."""
        rows = block.stacked.reshape(-1, block.stacked.shape[-1])[i0:i1]
        stk = tree_views(rows, self.config.num_leaves)
        stk["depth"] = max([t.max_depth for t in
                            self.models[block.n_before + i0:
                                        block.n_before + i1]] + [0])
        return stk

    def _rebuild_train_score_from_models(self, block):
        """The train score of the kept trees after a natural stop: the
        block's base score with its kept trees added again, one at a
        time from their device arrays (the per-iteration loop's adds,
        bit for bit), copied into the tensor the fused graph updates."""
        updater = self.train_score_updater
        updater.score.copy_(block.base)
        kept = len(self.models) - block.n_before
        if kept:
            updater.add_score_by_stacked_trees(
                self._block_trees(block, 0, kept), self.num_class,
                self.shrinkage_rate)

    def _natural_stop(self, block):
        """Leave the state the per-iteration loop would have after the
        stop iteration: the train score of the kept trees, and the
        feature sampler drawn for the iterations up to the stop only."""
        Log.info("Stopped training because there are no more leafs "
                 "that meet the split requirements.")
        self._rebuild_train_score_from_models(block)
        learner = self.tree_learner
        learner.random = block.rng
        for _ in range((block.t_eff + 1) * self.num_class):
            learner._sample_features()

    def train_many(self, num_iters, ignore_train_metrics=False):
        """Train `num_iters` boosting iterations: one fused block when
        eligible, else the per-iteration loop. Returns True if training
        stopped early (gbdt.py:1277-1319)."""
        if num_iters <= 0:
            return False
        if not self._fused_eligible(ignore_train_metrics):
            for _ in range(num_iters):
                if self.train_one_iter():
                    return True
            return False
        block = self._run_fused_block(num_iters)
        # valid scores follow the model list whoever called: the block's
        # kept trees traversed in one batch per valid set
        kept = len(self.models) - block.n_before
        if self.valid_score_updaters and kept:
            stk = self._block_trees(block, 0, kept)
            for updater in self.valid_score_updaters:
                updater.add_score_by_stacked_trees(stk, self.num_class,
                                                   self.shrinkage_rate)
        if block.t_eff < num_iters:
            self._natural_stop(block)
            return True
        return False

    def train_many_eval(self, num_iters):
        """A fused block plus per-iteration score snapshots, for the
        engine's replay of the per-iteration callbacks
        (gbdt.py:1321-1343). Returns (t_eff, snapshots). Caller contract
        (engine._train_blockwise):
        - walk t = 0..t_eff-1 forward, calling
          snapshots.set_scores_at(t) before evaluating metrics;
        - on an early-stop break at t: snapshots.set_scores_at(t,
          with_train=True) then snapshots.drop_tail_to(t);
        - on a completed walk: snapshots.finalize(), True at a natural
          stop (an empty tree ended the block early).
        Requires _fused_eligible(ignore_train_metrics=True)."""
        base_valids = [u.score for u in self.valid_score_updaters]
        block = self._run_fused_block(num_iters)
        return block.t_eff, _BlockSnapshots(self, block, base_valids,
                                            block.t_eff < num_iters)

    def rollback_one_iter(self):
        """gbdt.cpp:247-264: drop the last iteration's trees and their
        scores (one batched traversal a dataset)."""
        if self.iter == 0 or len(self.models) < self.num_class:
            return
        dropped = self.models[-self.num_class:]
        for updater in [self.train_score_updater] + self.valid_score_updaters:
            updater.sub_score_by_trees(dropped, self.num_class)
        del self.models[-self.num_class:]
        self.iter -= 1
        self._device_model_cache = None
        if self.quality is not None:
            # the split ledger follows the surviving trees now: a
            # retrained iteration restores the list's length
            self.quality.sync(self.models)

    # ------------------------------------------------------------ evaluation
    def eval_and_check_early_stopping(self):
        """gbdt.cpp:266-281; the dropped trees' score contributions are
        subtracted too (the JAX package's _truncate_iters)."""
        best_msg = self.output_metric(self.iter)
        if best_msg:
            Log.info("Early stopping at iteration %d, the best iteration "
                     "round is %d", self.iter,
                     self.iter - self.early_stopping_round)
            Log.info("Output of best iteration round:\n%s", best_msg)
            self._truncate_iters(self.early_stopping_round)
            return True
        return False

    def _truncate_iters(self, k):
        """Drop the last k iterations, subtracting their scores in one
        batched traversal per dataset (gbdt.py:1363-1378)."""
        k = min(k, self.iter)
        if k <= 0:
            return
        dropped = self.models[-k * self.num_class:]
        del self.models[-k * self.num_class:]
        self.iter -= k
        for updater in [self.train_score_updater] + self.valid_score_updaters:
            updater.sub_score_by_trees(dropped, self.num_class)
        self._device_model_cache = None
        if self.journal is not None:
            self.journal.event("truncate", iteration=int(self.iter),
                               dropped_iters=int(k), reason="early_stop")
        self._journal_quality()

    def output_metric(self, it):
        """gbdt.cpp:292-349: print metrics, track early stopping."""
        need_output = self.config is not None and self.config.metric_freq > 0 \
            and (it % self.config.metric_freq) == 0
        ret = ""
        msg_lines = []
        met_pairs = []
        met_values = {}
        if need_output:
            for metric in self.training_metrics:
                scores = metric.eval(self.train_score_updater.host_score())
                for name, sc in zip(metric.names, scores):
                    line = f"Iteration:{it}, training {name} : {sc:g}"
                    Log.info("%s", line)
                    met_values[f"training {name}"] = float(sc)
                    if self.early_stopping_round > 0:
                        msg_lines.append(line)
        if need_output or self.early_stopping_round > 0:
            for i, metrics in enumerate(self.valid_metrics):
                for j, metric in enumerate(metrics):
                    scores = metric.eval(
                        self.valid_score_updaters[i].host_score())
                    for name, sc in zip(metric.names, scores):
                        line = f"Iteration:{it}, valid_{i + 1} {name} : {sc:g}"
                        met_values[f"valid_{i + 1} {name}"] = float(sc)
                        if need_output:
                            Log.info("%s", line)
                        if self.early_stopping_round > 0:
                            msg_lines.append(line)
                    if not ret and self.early_stopping_round > 0:
                        cur = metric.factor_to_bigger_better * scores[-1]
                        if cur > self.best_score[i][j]:
                            self.best_score[i][j] = cur
                            self.best_iter[i][j] = it
                            met_pairs.append((i, j))
                        elif it - self.best_iter[i][j] >= \
                                self.early_stopping_round:
                            ret = self.best_msg[i][j]
        msg = "\n".join(msg_lines)
        for i, j in met_pairs:
            self.best_msg[i][j] = msg
        if met_values:
            # the latest values ride the next `quality` record too
            self._last_metric_values = met_values
        if self.journal is not None and met_values:
            self.journal.event("metrics", iteration=int(it),
                               values=met_values)
        return ret

    def _updater(self, data_idx):
        return (self.train_score_updater if data_idx == 0
                else self.valid_score_updaters[data_idx - 1])

    def get_eval_at(self, data_idx):
        """gbdt.cpp:352-373. 0 = train, i+1 = valid i."""
        metrics = (self.training_metrics if data_idx == 0
                   else self.valid_metrics[data_idx - 1])
        out = []
        if metrics:
            score = self._updater(data_idx).host_score()
            for metric in metrics:
                out.extend(metric.eval(score))
        if out:
            # the latest values ride the next `quality` record (the
            # Python API's evaluation path)
            prefix = "training" if data_idx == 0 else f"valid_{data_idx}"
            self._last_metric_values.update(
                {f"{prefix} {n}": float(v)
                 for n, v in zip(self.get_eval_names(data_idx), out)})
        return out

    def get_eval_names(self, data_idx):
        metrics = (self.training_metrics if data_idx == 0
                   else self.valid_metrics[data_idx - 1])
        return [name for m in metrics for name in m.names]

    def get_predict_at(self, data_idx):
        """gbdt.cpp:381-419: transformed per-row predictions of a bound
        dataset."""
        updater = self._updater(data_idx)
        raw = updater.host_score()
        if self.num_class > 1:
            mat = raw.reshape(self.num_class, updater.num_data).T
            return common.softmax(mat, axis=1).T.reshape(-1)
        if self.sigmoid > 0:
            return 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * raw))
        return raw

    def get_training_score(self):
        return self.train_score_updater.host_score()

    # ------------------------------------------------------------ prediction
    def _num_used_models(self, num_iteration=-1):
        total = len(self.models)
        if num_iteration > 0:
            return min(num_iteration * self.num_class, total)
        if self.num_iteration_for_pred > 0 and not self.train_data:
            return min(self.num_iteration_for_pred * self.num_class, total)
        return total

    def _model_cache(self, n_used):
        """Per-model-list-state cache of the stacked arrays (host) and
        the frozen device model; every change to self.models sets
        _device_model_cache to None."""
        key = (n_used, len(self.models))
        if self._device_model_cache is None \
                or self._device_model_cache[0] != key:
            self._device_model_cache = (key, {})
        return self._device_model_cache[1]

    def _stacked_model_arrays(self, n_used):
        """All trees' arrays padded to one (T, ...) set so prediction
        traverses every tree at once."""
        cache = self._model_cache(n_used)
        if "stack" in cache:
            return cache["stack"]
        trees = self.models[:n_used]
        max_l = max(t.num_leaves for t in trees)
        t_cnt = len(trees)
        sf = np.zeros((t_cnt, max(max_l - 1, 1)), np.int32)
        thr = np.zeros_like(sf, dtype=np.float64)
        dt = np.zeros_like(sf, dtype=np.int8)
        lc = np.full_like(sf, ~0)
        rc = np.full_like(sf, ~0)
        lv = np.zeros((t_cnt, max_l), np.float64)
        has_split = np.zeros(t_cnt, bool)
        depth = 1
        for i, t in enumerate(trees):
            ns = t.num_leaves - 1
            if ns > 0:
                sf[i, :ns] = t.split_feature_real
                thr[i, :ns] = t.threshold
                dt[i, :ns] = t.decision_type
                lc[i, :ns] = t.left_child
                rc[i, :ns] = t.right_child
                has_split[i] = True
                depth = max(depth, t.max_depth)
            lv[i, :t.num_leaves] = t.leaf_value
        cache["stack"] = (sf, thr, dt, lc, rc, lv, has_split, depth)
        return cache["stack"]

    def _linear_model_indices(self, n_used):
        """Model-list indices of the linear-leaf trees among the first
        n_used."""
        return [i for i in range(n_used) if self.models[i].is_linear]

    def _stacked_linear_arrays(self, n_used):
        """The per-leaf linear models of the first n_used trees, stacked
        (gbdt.py:1539-1570), or None when none is linear: const (T, L)
        f64, coeff (T, L, C) f64, feat (T, L, C) int32 real column ids,
        cnt (T, L) int32, with L the leaf axis of _stacked_model_arrays
        and C the widest leaf model. Constant leaves and trees carry cnt
        0 and zero rows."""
        lin_idx = set(self._linear_model_indices(n_used))
        if not lin_idx:
            return None
        trees = self.models[:n_used]
        max_l = max(t.num_leaves for t in trees)
        width = max(t.leaf_coeff.shape[1] for i, t in enumerate(trees)
                    if i in lin_idx)
        const = np.zeros((n_used, max_l), np.float64)
        coeff = np.zeros((n_used, max_l, width), np.float64)
        feat = np.zeros((n_used, max_l, width), np.int32)
        cnt = np.zeros((n_used, max_l), np.int32)
        for i, t in enumerate(trees):
            if i not in lin_idx:
                continue
            nl, c = t.num_leaves, t.leaf_coeff.shape[1]
            const[i, :nl] = t.leaf_const
            coeff[i, :nl, :c] = t.leaf_coeff
            feat[i, :nl, :c] = t.leaf_coeff_feat
            cnt[i, :nl] = t.leaf_coeff_count
        return const, coeff, feat, cnt

    def _device_model(self, n_used):
        """The frozen trees on the device (traverse_kernels.Forest,
        float32 thresholds rounded toward -inf) and their (T, L) float32
        leaf values, cached per model-list state."""
        cache = self._model_cache(n_used)
        if "device" not in cache:
            sf, thr, dt, lc, rc, lv, has_split, depth = \
                self._stacked_model_arrays(n_used)
            forest = traverse_kernels.freeze(
                sf, f32_safe_thresholds(thr, dt), dt == Tree.CATEGORICAL,
                lc, rc, np.where(has_split, 0, ~0).astype(np.int32), depth,
                self.device)
            lv32 = torch.from_numpy(lv.astype(np.float32)).to(self.device)
            cache["device"] = (forest, lv32)
        return cache["device"]

    def _predict_raw_device(self, x, n_used):
        """(N, K) raw scores on the device in PREDICT_BLOCK-row blocks:
        the traversal and the per-class float32 sum in one tree_raw
        launch (on a CPU booster its plain version)."""
        forest, lv32 = self._device_model(n_used)
        outs = []
        for s in range(0, x.shape[0], PREDICT_BLOCK):
            xb = torch.from_numpy(np.ascontiguousarray(
                x[s:s + PREDICT_BLOCK], dtype=np.float32)).to(self.device)
            outs.append(traverse_kernels.tree_raw(
                xb, forest, lv32, self.num_class).cpu().numpy())
        return np.concatenate(outs, axis=0).astype(np.float64)

    def predict_raw(self, x, num_iteration=-1):
        """Raw scores for (N, num_total_features) raw values -> (N, K).

        The JAX package's routing (lightgbm_tpu/models/gbdt.py
        predict_raw): below DEVICE_PREDICT_CELLS rows x trees the host
        float64 traversal and per-class sums, above it (or when the
        `device_predict` knob says so) the device traversal with float32
        sums. A linear tree's gathered constant is its leaves'
        missing-value fallback, replaced by Tree._linear_values on the
        row block (host f64)."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        n_used = self._num_used_models(num_iteration)
        n = x.shape[0]
        out = np.zeros((n, self.num_class))
        if n_used == 0 or n == 0:
            return out
        if self._use_device_predict(n, n_used):
            return self._predict_raw_device(x, n_used)
        lv = self._stacked_model_arrays(n_used)[5]
        lin_idx = self._linear_model_indices(n_used)
        t_cnt = lv.shape[0]
        t_idx = np.arange(t_cnt)
        cls = t_idx % self.num_class       # class-major model list
        block = max(1, min(n, self._HOST_TRAVERSE_CELLS // max(t_cnt, 1)))
        for s in range(0, n, block):
            xb = x[s:s + block]
            node = self._traverse_host(xb, n_used)               # (b, T)
            vals = lv[t_idx[None, :], ~node]                     # (b, T)
            for i in lin_idx:
                vals[:, i] = self.models[i]._linear_values(
                    xb, (~node[:, i]).astype(np.int32), vals[:, i])
            for k in range(self.num_class):
                out[s:s + block, k] = vals[:, cls == k].sum(axis=1)
        return out

    def apply_predict_config(self, config):
        """The predict-routing knobs of a Config onto this booster
        (init calls it; a booster loaded from a model file keeps the
        class defaults)."""
        self.DEVICE_PREDICT_CELLS = int(getattr(
            config, "device_predict_cells", self.DEVICE_PREDICT_CELLS))
        self._HOST_TRAVERSE_CELLS = int(getattr(
            config, "host_traverse_cells", self._HOST_TRAVERSE_CELLS))
        self.device_predict = str(getattr(config, "device_predict", "auto"))

    def _use_device_predict(self, n, n_used):
        """Route a predict_raw call host vs device. `force_host_predict`
        wins (a booster serving as a precision reference, serving/drift.py
        host_reference_scorer), then the LIGHTGBM_TPU_DEVICE_PREDICT
        environment flag ("0"/"false" forces the host, "force"/"true"
        the device), then the `device_predict` knob, else rows x trees
        >= DEVICE_PREDICT_CELLS. A model with linear leaves stays on the
        host whatever the knobs say (its device route is serving's)."""
        if self.force_host_predict or self._linear_model_indices(n_used):
            return False
        knob = os.environ.get("LIGHTGBM_TPU_DEVICE_PREDICT")
        if knob in (None, "", "1"):  # "1" was the legacy auto default
            knob = str(self.device_predict)
        knob = knob.lower()
        if knob in ("0", "false", "off", "-"):
            return False
        if knob in ("force", "true", "+"):
            return True
        return n * n_used >= self.DEVICE_PREDICT_CELLS

    def _traverse_host(self, xb, n_used):
        """Host float64 traversal of one row block through all stacked
        trees: the final (b, T) node states (~leaf encoded). NaN goes
        right on numeric and on categorical nodes."""
        sf, thr, dt, lc, rc, lv, has_split, depth = \
            self._stacked_model_arrays(n_used)
        t_cnt = sf.shape[0]
        t_idx = np.arange(t_cnt)
        xbs = np.nan_to_num(xb)  # the int cast below needs a finite input
        node = np.where(has_split[None, :], 0, ~0).astype(np.int32)
        node = np.broadcast_to(node, (len(xb), t_cnt)).copy()
        for _ in range(depth):
            active = node >= 0
            if not active.any():
                break
            nd = np.maximum(node, 0)
            feat = sf[t_idx[None, :], nd]
            th = thr[t_idx[None, :], nd]
            d = dt[t_idx[None, :], nd]
            fval = xb[np.arange(len(xb))[:, None], feat]
            fcat = xbs[np.arange(len(xb))[:, None], feat]
            go_left = np.where(d == Tree.CATEGORICAL,
                               (fcat.astype(np.int64) == th.astype(np.int64))
                               & ~np.isnan(fval),
                               fval <= th)
            nxt = np.where(go_left, lc[t_idx[None, :], nd],
                           rc[t_idx[None, :], nd])
            node = np.where(active, nxt, node)
        return node

    def predict(self, x, num_iteration=-1):
        """gbdt.cpp:622-636: sigmoid-transformed predictions."""
        raw = self.predict_raw(x, num_iteration)
        if self.sigmoid > 0 and self.num_class == 1:
            return 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * raw))
        if self.num_class > 1:
            return common.softmax(raw, axis=1)
        return raw

    def predict_leaf_index(self, x, num_iteration=-1):
        """(N, T) leaf indices from the host traversal, in blocks of
        _HOST_TRAVERSE_CELLS cells (the JAX package's route)."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        n_used = self._num_used_models(num_iteration)
        n = x.shape[0]
        if n_used == 0 or n == 0:
            return np.zeros((n, n_used), dtype=np.int32)
        block = max(1, min(n, self._HOST_TRAVERSE_CELLS // n_used))
        outs = []
        for s in range(0, n, block):
            node = self._traverse_host(x[s:s + block], n_used)
            outs.append((~node).astype(np.int32))
        return np.concatenate(outs, axis=0)

    # --------------------------------------------------------- serialization
    def feature_importance_values(self, importance_type="split"):
        """int64 split counts, or float64 gain sums or linear-leaf
        coefficient importances (telemetry/quality.py
        tree_coeff_importance), per total feature."""
        out = np.zeros(self.max_feature_idx + 1,
                       np.int64 if importance_type == "split" else np.float64)
        for t in self.models:
            ns = t.num_leaves - 1
            feat = np.asarray(t.split_feature_real[:ns], np.int64)
            if importance_type == "split":
                np.add.at(out, feat, 1)
            elif importance_type == "gain":
                np.add.at(out, feat, np.asarray(t.split_gain[:ns],
                                                np.float64))
            elif importance_type == "coeff":
                if t.is_linear:
                    out += tree_coeff_importance(t, len(out))
            else:
                raise LightGBMError(
                    f"Unknown importance type {importance_type!r}")
        return out

    def feature_importance(self):
        """Split-count importance pairs for the model file's
        "feature importances:" block (gbdt.cpp:585-610)."""
        imp = self.feature_importance_values("split")
        pairs = [(int(imp[i]), self.feature_names[i]
                  if i < len(self.feature_names) else f"Column_{i}")
                 for i in range(len(imp)) if imp[i] > 0]
        pairs.sort(key=lambda p: -p[0])
        return pairs

    def save_model_to_string(self, num_iteration=-1):
        """gbdt.cpp:468-513 text format. A model with linear leaves
        declares format_version=2 after the name line; a constant-leaf
        model omits the line (version 1)."""
        n_used = len(self.models) if num_iteration <= 0 else min(
            num_iteration * self.num_class, len(self.models))
        lines = [self.name]
        if self._linear_model_indices(n_used):
            lines.append(f"format_version={MODEL_FORMAT_VERSION}")
        lines += [f"num_class={self.num_class}",
                 f"label_index={self.label_idx}",
                 f"max_feature_idx={self.max_feature_idx}"]
        if self.objective is not None:
            lines.append(f"objective={self.objective.name}")
        elif getattr(self, "_loaded_objective_name", ""):
            lines.append(f"objective={self._loaded_objective_name}")
        lines.append(f"sigmoid={self.sigmoid:g}")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("")
        for i in range(n_used):
            lines.append(f"Tree={i}")
            lines.append(self.models[i].to_string())
        lines.append("")
        lines.append("feature importances:")
        for cnt, fname in self.feature_importance():
            lines.append(f"{fname}={cnt}")
        return "\n".join(lines) + "\n"

    def save_model_to_file(self, num_iteration, filename):
        # crash-atomic: a kill mid-save never leaves a truncated model
        # where a valid one stood (utils/checkpoint.py)
        from ..utils.checkpoint import atomic_write_text
        atomic_write_text(filename, self.save_model_to_string(num_iteration))
        profile = self._training_profile()
        if profile is not None:
            # the training-time baseline distribution travels with the
            # model: <model>.profile.json is what the serving drift
            # monitor loads (io/profile.py, serving/drift.py)
            from ..io.profile import model_profile_path
            try:
                profile.save(model_profile_path(filename))
            except OSError as e:
                Log.warning("could not write dataset profile next to %s: "
                            "%s", filename, e)

    def _training_profile(self):
        """The training set's baseline distribution (io/profile.py), made
        at the first save from its host bins and kept. None for a rank's
        row block (it would profile one shard's slice, as the JAX
        package skips it) or a dataset whose bins stay on disk."""
        data = self.train_data
        if (self.dataset_profile is None and data is not None
                and getattr(data, "bins", None) is not None
                and getattr(data, "global_num_data", None) is None):
            from ..io.profile import DatasetProfile
            self.dataset_profile = DatasetProfile.from_dataset(data)
        return self.dataset_profile

    def dump_model(self):
        """JSON dump (gbdt.cpp:431-466)."""
        out = ["{"]
        out.append(f'"name":"{self.name}",')
        out.append(f'"num_class":{self.num_class},')
        out.append(f'"label_index":{self.label_idx},')
        out.append(f'"max_feature_idx":{self.max_feature_idx},')
        out.append(f'"sigmoid":{self.sigmoid:g},')
        names = '","'.join(self.feature_names)
        out.append(f'"feature_names":["{names}"],')
        tree_parts = []
        for i, tree in enumerate(self.models):
            tree_parts.append('{' + f'"tree_index":{i},' + tree.to_json() + '}')
        out.append('"tree_info":[' + ",".join(tree_parts) + "]")
        out.append("}")
        return "\n".join(out) + "\n"

    def load_model_from_string(self, model_str):
        """gbdt.cpp:515-583."""
        self.models = []
        self._device_model_cache = None
        lines = model_str.split("\n")

        def find_line(prefix):
            for ln in lines:
                if prefix in ln:
                    return ln
            return ""

        line = find_line("format_version=")
        fmt = int(line.split("=")[1]) if line else 1
        if fmt > MODEL_FORMAT_VERSION:
            Log.fatal("model declares format_version=%d but this reader "
                      "supports versions <= %d", fmt, MODEL_FORMAT_VERSION)
        line = find_line("num_class=")
        if not line:
            Log.fatal("Model file doesn't specify the number of classes")
        self.num_class = int(line.split("=")[1])
        line = find_line("label_index=")
        if not line:
            Log.fatal("Model file doesn't specify the label index")
        self.label_idx = int(line.split("=")[1])
        line = find_line("max_feature_idx=")
        if not line:
            Log.fatal("Model file doesn't specify max_feature_idx")
        self.max_feature_idx = int(line.split("=")[1])
        line = find_line("objective=")
        self._loaded_objective_name = (line.split("=", 1)[1].strip()
                                       if line else "")
        line = find_line("sigmoid=")
        self.sigmoid = float(line.split("=")[1]) if line else -1.0
        line = find_line("feature_names=")
        if not line:
            Log.fatal("Model file doesn't contain feature names")
        self.feature_names = line.split("=", 1)[1].split(" ")
        if len(self.feature_names) != self.max_feature_idx + 1:
            Log.fatal("Wrong size of feature_names")
        i = 0
        while i < len(lines):
            if lines[i].startswith("Tree="):
                i += 1
                start = i
                while i < len(lines) and not lines[i].startswith("Tree="):
                    if lines[i].startswith("feature importances:"):
                        break
                    i += 1
                self.models.append(Tree.from_string(
                    "\n".join(lines[start:i]), format_version=fmt))
            else:
                i += 1
        Log.info("Finished loading %d models", len(self.models))
        self.num_iteration_for_pred = len(self.models) // max(
            self.num_class, 1)
        self.num_init_iteration = self.num_iteration_for_pred


BOOSTING_TYPES = ("gbdt", "dart", "goss")


def create_boosting(boosting_type, device=None, input_model=""):
    """Factory and model-file type sniffing (src/boosting/boosting.cpp:7-66,
    gbdt.py:2199-2215): a model file's first line names its class."""
    from .dart import DART
    from .goss import GOSS
    if input_model:
        with open(input_model) as f:
            first = f.readline().strip()
        if first in BOOSTING_TYPES:
            boosting_type = first
    if boosting_type == "gbdt":
        return GBDT(device)
    if boosting_type == "dart":
        return DART(device)
    if boosting_type == "goss":
        return GOSS(device)
    Log.fatal("Unknown boosting type %s", boosting_type)
