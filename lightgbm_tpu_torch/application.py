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
`python -m lightgbm_tpu_torch` always runs on the card. Settings whose
code paths are later slices raise NotImplementedError naming their
ROADMAP item: heartbeats, collective timeouts and more than one machine
(queue 1 item 6), and the training telemetry, the profiler trace and the
run history (item 7).
"""

import os
import time

import numpy as np

from .config import Config, load_config_file, str2map
from .io.dataset import DatasetLoader
from .io.parser import iter_text_file_chunks
from .metrics import create_metric
from .models.gbdt import create_boosting
from .objectives import create_objective
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


def _check_slice(cfg):
    """Refuse the CLI settings whose code paths are later slices."""
    later = []
    if (cfg.heartbeat_timeout_s > 0 or cfg.collective_timeout_s > 0
            or cfg.num_machines > 1):
        later.append("heartbeat_timeout_s, collective_timeout_s and "
                     "num_machines > 1 (parallel learners, item 6)")
    if cfg.telemetry or cfg.profile or cfg.run_history:
        later.append("telemetry, profile and run_history (training "
                     "telemetry, item 7)")
    if later:
        raise NotImplementedError(
            "lightgbm_tpu_torch's CLI does not run " + "; ".join(later)
            + " yet: a later slice of the port adds it (ROADMAP.md queue 1)")


class Application:
    """CLI lifecycle (application.h:25-87) on `device` (None: the CUDA
    card)."""

    def __init__(self, argv, device=None):
        params = self._load_parameters(argv)
        self.config = Config.from_params(params)
        _check_slice(self.config)
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
        self.train_data = loader.load_from_file(cfg.data)
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

    def _snapshots(self):
        """The snapshot manager (None with snapshot_freq 0), after the
        resume from the newest valid snapshot when snapshot_resume is on
        and the directory exists."""
        cfg = self.config
        if cfg.snapshot_freq <= 0:
            return None
        from .utils.checkpoint import CheckpointManager
        snap_dir = cfg.snapshot_dir or cfg.output_model + ".snapshots"
        resume = cfg.snapshot_resume and os.path.isdir(snap_dir)
        manager = CheckpointManager(snap_dir, keep_last_k=cfg.snapshot_keep)
        if resume:
            state, _ = manager.load_latest()
            if state is not None:
                self.boosting.restore_training_state(state)
        return manager

    def train(self):
        """application.cpp:222-238, with snapshots every snapshot_freq
        iterations when it is set (application.py:203-360)."""
        cfg = self.config
        b = self.boosting
        manager = self._snapshots()

        def maybe_snapshot():
            """A snapshot at each cadence point."""
            if manager is not None and b.iter > 0 \
                    and b.iter % cfg.snapshot_freq == 0:
                manager.save(b.capture_training_state(), b.iter)

        def snap_clamp(step):
            """A fused block cut so the next snapshot point is a block
            boundary."""
            if manager is None:
                return step
            boundary = (b.iter // cfg.snapshot_freq + 1) * cfg.snapshot_freq
            return min(step, max(1, boundary - b.iter))

        start = time.time()
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
        b.save_model_to_file(-1, cfg.output_model)
        Log.info("Finished training")

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
