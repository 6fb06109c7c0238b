"""CLI application: train / predict lifecycle (port of
lightgbm_tpu/application.py).

Reference: include/LightGBM/application.h:25-87,
src/application/application.cpp, src/application/predictor.hpp,
src/main.cpp. Same parameter layering (command line overrides config
file, application.cpp:46-104), same data-loading order (train set with
its metrics, then aligned valid sets, application.cpp:106-184), the same
training loop (application.cpp:222-238: one fused block when the booster
is eligible, fused blocks of metric_freq iterations when only metric
output stands in the way, else the per-iteration loop) and the same
predict-to-TSV output (predictor.hpp:82-130).

With `snapshot_freq` > 0 the full training state is checkpointed every
`snapshot_freq` iterations into `snapshot_dir` (default
`<output_model>.snapshots`; atomic and rotated, utils/checkpoint.py),
and a rerun of the same command resumes from the newest valid snapshot
(`snapshot_resume`) to the model file of an uninterrupted run
(application.py:203-360). The fused paths cut their blocks at the
snapshot cadence.

`Application(argv, device=None)` runs on the CUDA card; the tests pass
device="cpu". The command line has no device switch, so
`python -m lightgbm_tpu_torch` always runs on the card.

Parallel training (application.py:138-144, :178, :219-275): with
num_machines > 1 and a machine list, each process is one rank of a
torch.distributed process group (parallel/distributed.py; the rank from
LIGHTGBM_TPU_RANK or the list), loads its row block, and trains on the
process mesh; without a machine list the parallel learners run on the
in-process mesh. `heartbeat_timeout_s` and `collective_timeout_s`
configure the heartbeats and the collective watchdog
(parallel/heartbeat.py, beats in the snapshot directory). The ranks agree
on the resume point before and after a restore, every rank captures at a
snapshot point (the global train score is a gather), only rank 0
writes snapshots and the model, and at the end the ranks check that they
hold the same model (a digest of its text on every rank) and log the
kernel launches of their process.

Telemetry (application.py:132-152, :326-441): `telemetry=true` opens the
booster's run journal in `telemetry_dir` (default: the shared run
directory), with `resume`, `checkpoint` and `run_end` records from here;
rank 0 merges the ranks' journals at the end. Under a process group
rank r serves /trainz on `telemetry_port + r`. `profile=<dir>` writes a
torch.profiler Chrome trace of the training loop into that directory
(where the JAX package wrote a jax.profiler trace); `run_history=<file>`
appends one `run_summary` record on rank 0 (telemetry/history.py).
"""

import hashlib
import os
import time

import numpy as np

from .config import Config, load_config_file, str2map
from .io.dataset import DatasetLoader
from .io.parser import iter_text_file_chunks
from .metrics import create_metric
from .models.gbdt import create_boosting
from .objectives import create_objective
from .parallel import distributed, heartbeat
from .utils.log import Log


class Predictor:
    """Batch prediction from a parsed data file (predictor.hpp:24-155).
    Also provides the init-score hook used for continued training
    (application.cpp:108-115)."""

    def __init__(self, boosting, is_raw_score=False,
                 is_predict_leaf_index=False, num_iteration=-1):
        self.boosting = boosting
        self.is_raw_score = is_raw_score
        self.is_predict_leaf_index = is_predict_leaf_index
        self.num_iteration = num_iteration

    def predict_matrix(self, feats):
        if self.is_predict_leaf_index:
            return self.boosting.predict_leaf_index(feats, self.num_iteration)
        if self.is_raw_score:
            return self.boosting.predict_raw(feats, self.num_iteration)
        return self.boosting.predict(feats, self.num_iteration)

    def predict_file(self, data_filename, result_filename, has_header=False,
                     label_column="", max_bad_rows=0, chunk_rows=65536):
        """Stream the input in `chunk_rows`-row chunks and append each
        chunk's predictions to the TSV as it lands: the one-shot parse's
        output in O(chunk) memory. NA cells stay NaN, so a missing value
        takes the model's default direction, as at the serving
        endpoint."""
        n_feat = self.boosting.max_feature_idx + 1
        n_done = 0
        with open(result_filename, "w") as fout:
            for _, feats in iter_text_file_chunks(
                    data_filename, chunk_rows, has_header=has_header,
                    label_column=label_column, max_bad_rows=max_bad_rows,
                    keep_nan=True):
                if feats.shape[1] < n_feat:
                    # a LibSVM chunk's width is its own (trailing absent
                    # features); the model defines the true width
                    feats = np.pad(feats,
                                   ((0, 0), (0, n_feat - feats.shape[1])))
                out = np.atleast_2d(self.predict_matrix(feats))
                for row in out:
                    fout.write("\t".join(f"{v:g}"
                                         for v in np.atleast_1d(row)) + "\n")
                n_done += len(out)
        Log.info("Finished prediction of %d rows and saved result to %s",
                 n_done, str(result_filename))

    def init_score_fun(self):
        """The DatasetLoader hook that seeds init scores from a loaded
        model during continued training."""

        def predict_fun(ds):
            if ds.raw_data is None:
                Log.fatal("Cannot compute init scores without raw data")
            raw = self.boosting.predict_raw(ds.raw_data, self.num_iteration)
            return raw.T.reshape(-1)  # class-major flat
        return predict_fun


DEFAULT_PROFILE_DIR = "lightgbm_torch_trace"


def profile_dir(value):
    """The `profile` knob's trace directory: a path, or "1"/"true" for
    the default directory under the working directory."""
    value = str(value or "")
    if value.lower() in ("1", "true", "+"):
        return DEFAULT_PROFILE_DIR
    return value


class profiled:
    """Context manager writing a torch.profiler Chrome trace of its body
    into `directory` (trace.rank<r>.json; nothing when `directory` is
    empty). CUDA activity is recorded when a card is initialised."""

    def __init__(self, directory, rank=0):
        self.directory = profile_dir(directory)
        self.rank = int(rank)
        self._prof = None

    def __enter__(self):
        if not self.directory:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._prof is None:
            return False
        self._prof.__exit__(exc_type, exc, tb)
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f"trace.rank{self.rank:04d}.json")
        self._prof.export_chrome_trace(path)
        Log.info("Wrote torch.profiler trace to %s", path)
        return False


class Application:
    """CLI lifecycle (application.h:25-87) on `device` (None: the CUDA
    card)."""

    def __init__(self, argv, device=None):
        params = self._load_parameters(argv)
        self.config = Config.from_params(params)
        self.device = device
        self.boosting = None
        self.objective = None
        self.train_data = None
        self.valid_datas = []
        self.train_metrics = []
        self.valid_metrics = []

    @staticmethod
    def _load_parameters(argv):
        """Command line `k=v` tokens override config-file entries
        (application.cpp:46-104)."""
        cmd_params = str2map(" ".join(argv))
        params = {}
        config_path = cmd_params.get("config_file", "")
        if config_path:
            params.update(load_config_file(config_path))
        params.update(cmd_params)
        params.pop("config_file", None)
        return params

    def run(self):
        start = time.time()
        if self.config.task == "train":
            self.init_train()
            self.train()
        elif self.config.task == "predict":
            self.init_predict()
            self.predict()
        else:
            Log.fatal("Unknown task: %s", self.config.task)
        Log.info("Finished, elapsed: %f seconds", time.time() - start)

    # -------------------------------------------------------------- training
    def init_train(self):
        cfg = self.config
        if cfg.telemetry and not cfg.telemetry_dir:
            # the journal beside the other shared run state (heartbeats,
            # snapshots, the restart barrier): one timeline a run
            cfg.telemetry_dir = (cfg.snapshot_dir
                                 or cfg.output_model + ".snapshots")
        if cfg.is_parallel:
            # multi-process membership (the reference's Network::Init,
            # application.cpp:189); a no-op without a machine list
            distributed.init_from_config(cfg, self.device)
            Log.info("Parallel training over %d shards (tree_learner=%s, "
                     "%d process(es))", cfg.num_machines, cfg.tree_learner,
                     distributed.num_processes())
            if cfg.telemetry_port > 0:
                # every rank of a one-host gang binds its own /trainz:
                # rank r serves on telemetry_port + r
                cfg.telemetry_port += distributed.process_rank()
        self.boosting = create_boosting(cfg.boosting_type, self.device,
                                        cfg.input_model)
        self.objective = create_objective(cfg.objective, cfg)
        self._load_data()
        if self.objective is not None:
            self.objective.init(self.train_data.metadata,
                                self.train_data.num_data,
                                self.boosting.device)
        self.boosting.init(cfg, self.train_data, self.objective,
                           self.train_metrics)
        for vd, vm in zip(self.valid_datas, self.valid_metrics):
            self.boosting.add_valid_dataset(vd, vm)
        Log.info("Finished initializing training")

    def _metrics(self, ds):
        out = []
        for name in self.config.metric:
            m = create_metric(name, self.config)
            if m is not None:
                m.init(ds.metadata, ds.num_data)
                out.append(m)
        return out

    def _load_data(self):
        """application.cpp:106-184."""
        cfg = self.config
        start = time.time()
        predict_fun = None
        if cfg.input_model:
            with open(cfg.input_model) as f:
                self.boosting.load_model_from_string(f.read())
            predict_fun = Predictor(self.boosting,
                                    is_raw_score=True).init_score_fun()
        loader = DatasetLoader(cfg, predict_fun=predict_fun,
                               device=self.boosting.device)
        self.train_data = loader.load_from_file(
            cfg.data, rank=distributed.process_rank(),
            num_machines=cfg.num_machines)
        if cfg.is_training_metric:
            self.train_metrics = self._metrics(self.train_data)
        self.valid_datas = []
        self.valid_metrics = []
        for vfile in cfg.valid_data:
            vd = loader.load_from_file_align_with_other_dataset(
                vfile, self.train_data)
            self.valid_datas.append(vd)
            self.valid_metrics.append(self._metrics(vd))
        Log.info("Finished loading data in %f seconds", time.time() - start)

    def _agree(self, what, value, snap_dir):
        """Every rank's `value` (an iteration) must be the same: a rank
        that cannot see the snapshot directory would desync the
        exchanged histograms (application.py:233-275)."""
        with heartbeat.collective_guard(f"resume_{what}_agreement"):
            found = distributed.host_allgather(
                np.asarray([value], np.int64)).reshape(-1)
        if len({int(v) for v in found}) != 1:
            Log.fatal("snapshot resume desync: ranks %s different "
                      "snapshots (iterations %s); snapshot_dir (%s) must "
                      "be shared storage visible to every rank", what,
                      sorted(int(v) for v in found), snap_dir)

    def _snapshots(self, snap_dir):
        """The snapshot manager (None with snapshot_freq 0; every rank
        reads through it, rank 0 alone writes), after the resume from
        the newest valid snapshot when snapshot_resume is on and the
        directory exists. Under a process group the ranks agree on the
        resume point before the restore (the restore itself gathers) and
        on the restored iteration after."""
        cfg = self.config
        if cfg.snapshot_freq <= 0:
            return None
        from .utils.checkpoint import CheckpointManager
        manager = CheckpointManager(snap_dir, keep_last_k=cfg.snapshot_keep)
        state = None
        if cfg.snapshot_resume and os.path.isdir(snap_dir):
            state, _ = manager.load_latest()
        multi = distributed.is_multi_host()
        if multi:
            self._agree("found", -1 if state is None else state["iter"],
                        snap_dir)
        if state is not None:
            self.boosting.restore_training_state(state)
            if self.boosting.journal is not None:
                self.boosting.journal.event(
                    "resume", iteration=int(self.boosting.iter))
        if multi:
            self._agree("restored", self.boosting.iter, snap_dir)
        return manager

    def train(self):
        """application.cpp:222-238, with snapshots every snapshot_freq
        iterations when it is set (application.py:203-360)."""
        cfg = self.config
        b = self.boosting
        rank = distributed.process_rank()
        multi = distributed.is_multi_host()
        # the shared run directory: snapshots, heartbeats, watchdog
        # markers
        snap_dir = cfg.snapshot_dir or cfg.output_model + ".snapshots"
        if cfg.heartbeat_timeout_s > 0 or cfg.collective_timeout_s > 0:
            heartbeat.configure(cfg, snap_dir, rank,
                                distributed.num_processes(),
                                iteration_fn=lambda: b.iter)
        manager = self._snapshots(snap_dir)

        def maybe_snapshot():
            """A snapshot at each cadence point: every rank captures (the
            global train score is a gather), rank 0 writes, and the ranks
            wait for the write under a guard that names it."""
            if manager is None or b.iter <= 0 \
                    or b.iter % cfg.snapshot_freq:
                return
            # timed from the capture (device -> host copies) through the
            # atomic write, as callback._Checkpoint.save_now times it
            t0 = time.time()
            state = b.capture_training_state()
            if rank == 0:
                path = manager.save(state, b.iter)
                write_s = time.time() - t0
                heartbeat.notify_checkpoint(b.iter, path)
                b.metrics.observe("checkpoint_write_s", write_s)
                if b.journal is not None:
                    b.journal.event("checkpoint", iteration=int(b.iter),
                                    path=str(path),
                                    write_s=round(write_s, 6))
            if multi:
                with heartbeat.collective_guard("snapshot_write_barrier"):
                    distributed.host_allgather(np.asarray([b.iter],
                                                          np.int64))

        def snap_clamp(step):
            """A fused block cut so the next snapshot point is a block
            boundary."""
            if manager is None:
                return step
            boundary = (b.iter // cfg.snapshot_freq + 1) * cfg.snapshot_freq
            return min(step, max(1, boundary - b.iter))

        b.tracer.reset()
        start = time.time()
        with profiled(cfg.profile, rank):
            self._train_loop(b, manager, maybe_snapshot, snap_clamp, start)
        if b.tracer.acc:
            Log.debug("Per-phase timers:\n%s", b.tracer.report())
        if multi:
            self._agree_on_model()
        if rank == 0:   # every rank holds the same model
            b.save_model_to_file(-1, cfg.output_model)
        if b.journal is not None:
            # the last memory and set-up records before run_end, so that
            # record stays the timeline's last
            b.finalize_introspection()
            b.journal.event("run_end", iterations=int(b.iter),
                            train_s=round(time.time() - start, 3))
            if multi:
                # every rank's run_end on shared storage before rank 0
                # merges
                with heartbeat.collective_guard("journal_merge_barrier"):
                    distributed.host_allgather(np.asarray([b.iter],
                                                          np.int64))
        if cfg.run_history and rank == 0:
            from .telemetry import history
            history.append_run_summary(
                cfg.run_history, "train",
                **history.booster_summary(
                    b, train_s=round(time.time() - start, 3)))
        heartbeat.shutdown()
        b.close_telemetry(merge=rank == 0)
        Log.info("Finished training")

    def _train_loop(self, b, manager, maybe_snapshot, snap_clamp, start):
        """application.cpp:222-238: one fused block (cut at the snapshot
        cadence), fused blocks of metric_freq iterations, or the
        per-iteration loop."""
        cfg = self.config
        if b._fused_eligible():
            # the whole run as fused blocks (gbdt.train_many), cut at the
            # snapshot cadence when snapshots are on
            if manager is None:
                b.train_many(cfg.num_iterations - b.iter)
            else:
                stopped = False
                while b.iter < cfg.num_iterations and not stopped:
                    stopped = b.train_many(
                        snap_clamp(cfg.num_iterations - b.iter))
                    maybe_snapshot()
            Log.info("%f seconds elapsed, finished iteration %d (fused)",
                     time.time() - start, b.iter)
        elif cfg.metric_freq > 0 and b._fused_eligible(
                ignore_train_metrics=True):
            # metric output is the only blocker: fused blocks of
            # metric_freq iterations, the metrics printed between them;
            # each block also ends on the snapshot cadence
            done = b.iter
            while done < cfg.num_iterations:
                nxt = min((done // cfg.metric_freq + 1) * cfg.metric_freq,
                          cfg.num_iterations)
                step = snap_clamp(nxt - done)
                if step == cfg.metric_freq or manager is not None:
                    stopped = b.train_many(step, ignore_train_metrics=True)
                else:
                    # a tail shorter than a block: the per-iteration loop
                    stopped = False
                    for _ in range(step):
                        if b.train_one_iter(is_eval=False):
                            stopped = True
                            break
                if b.iter > done:
                    done = b.iter
                    b.output_metric(done)
                    Log.info("%f seconds elapsed, finished iteration %d "
                             "(fused block)", time.time() - start, done)
                elif not stopped:
                    Log.warning("no training progress at iteration %d; "
                                "stopping", done)
                    break
                if stopped:
                    break
                maybe_snapshot()
        else:
            for it in range(b.iter + 1, cfg.num_iterations + 1):
                is_finished = b.train_one_iter(is_eval=True)
                Log.info("%f seconds elapsed, finished iteration %d",
                         time.time() - start, it)
                if is_finished:
                    break
                maybe_snapshot()

    def _agree_on_model(self):
        """Every rank must hold the same trees: a rank out of step would
        otherwise go unseen, since only rank 0 writes the model. Logs
        the digest and this process's kernel launches."""
        from .ops import hist_kernels
        text = self.boosting.save_model_to_string(-1).encode()
        digest = np.frombuffer(hashlib.sha256(text).digest()[:8], np.int64)
        with heartbeat.collective_guard("model_agreement"):
            every = distributed.host_allgather(digest).reshape(-1)
        if len(set(every.tolist())) != 1:
            Log.fatal("ranks hold different models (digests %s)",
                      [f"{int(d) & (2**64 - 1):016x}" for d in every])
        Log.info("all %d ranks hold the same model (digest %016x); kernel "
                 "launches in this process: %s", len(every),
                 int(every[0]) & (2**64 - 1), hist_kernels.launch_counts())

    # ------------------------------------------------------------ prediction
    def init_predict(self):
        cfg = self.config
        if not cfg.input_model:
            Log.fatal("Please specify the model file for prediction")
        self.boosting = create_boosting("gbdt", self.device, cfg.input_model)
        with open(cfg.input_model) as f:
            self.boosting.load_model_from_string(f.read())
        # a predict-only booster never runs init, so the routing knobs
        # are applied here
        self.boosting.apply_predict_config(cfg)
        Log.info("Finished initializing prediction")

    def predict(self):
        cfg = self.config
        predictor = Predictor(
            self.boosting,
            is_raw_score=cfg.is_predict_raw_score,
            is_predict_leaf_index=cfg.is_predict_leaf_index,
            num_iteration=cfg.num_iteration_predict)
        predictor.predict_file(cfg.data, cfg.output_result,
                               has_header=cfg.has_header,
                               label_column=cfg.label_column,
                               max_bad_rows=cfg.max_bad_rows,
                               chunk_rows=cfg.predict_chunk_rows)
        Log.info("Finished prediction")


def main(argv=None):
    """src/main.cpp:4-23, on the CUDA card: exit code 1 after any
    exception, reported."""
    import sys
    if argv is None:
        argv = sys.argv[1:]
    try:
        Application(argv).run()
    except Exception as ex:  # main.cpp catches and reports all exceptions
        Log.warning("Met Exceptions:")
        Log.warning("%s", str(ex))
        raise SystemExit(1)
