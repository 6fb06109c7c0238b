"""Training entry points `train` and `cv` (port of
lightgbm_tpu/engine.py :130 and :405).

Reference: python-package/lightgbm/engine.py:12-395. Three routes, as
in the JAX package (engine.py:250-330):
- nothing needs the round boundary (no callbacks but the default print,
  no valid sets, no custom objective): the whole run is one fused
  block, GBDT.train_many;
- valid sets and/or early stopping with only the callbacks train()
  itself made (print, early stopping, record): fused blocks with the
  per-iteration callbacks replayed from score snapshots
  (_train_blockwise);
- any user callback, a before-iteration callback (reset_parameter) or
  a custom objective: the per-iteration loop.
`init_model` (a model file or a Booster) continues training from its
trees. `resume_from` (a directory written by callback.checkpoint)
restores the newest valid snapshot and trains the remaining rounds
(engine.py:225-310): the fused paths then run in blocks cut at the
snapshot cadence, with a snapshot at each block boundary.
"""

import collections
import time
from operator import attrgetter

import numpy as np

from . import callback
from .basic import Booster, Dataset, load_model_file


def _split_callbacks(callbacks):
    """(before-iteration, after-iteration) callbacks, each sorted by
    `.order` (engine.py:124-150)."""
    before = [cb for cb in callbacks if getattr(cb, "before_iteration", False)]
    after = [cb for cb in callbacks if cb not in before]
    return (sorted(before, key=attrgetter("order")),
            sorted(after, key=attrgetter("order")))


def _init_predictor(init_model, device):
    """The GBDT of a model file or of a Booster to continue from, or
    None."""
    if isinstance(init_model, str):
        return load_model_file(init_model, device)
    if isinstance(init_model, Booster):
        return init_model.gbdt
    return None


def _train_blockwise(booster, callbacks_after_iter, init_iteration,
                     num_boost_round, is_valid_contain_train, feval,
                     early_stopping_rounds, ckpt_cbs=(), start_offset=0):
    """Fused blocks with the per-iteration callbacks replayed
    (engine.py:37-127). Each block is one gbdt.train_many_eval; the
    metrics of every iteration inside it come from device score
    snapshots. An early-stop break mid-block drops the overshoot trees
    without touching the scores: the snapshot already is the kept
    state.

    Checkpoint callbacks (`ckpt_cbs`) fire at block boundaries only
    (mid-block the model list already holds the block's trees); the
    block is cut to the snapshot period and its boundaries aligned to
    the cadence, so every cadence point is a boundary. `start_offset`
    rounds were trained before a resume."""
    gbdt = booster.gbdt
    end = init_iteration + num_boost_round
    # the overshoot past the true stopping round costs at most block-1
    # iterations, so the block follows the early-stop patience
    if early_stopping_rounds is None:
        block_full = num_boost_round
    else:
        block_full = min(num_boost_round,
                         max(5, min(int(early_stopping_rounds), 25)))
    snap_period = min((cb.period for cb in ckpt_cbs if cb.period > 0),
                      default=0)
    if snap_period:
        block_full = max(1, min(block_full, snap_period))

    def fire_checkpoints(i):
        for cb in ckpt_cbs:
            cb(callback.CallbackEnv(
                model=booster, cvfolds=None, iteration=i,
                begin_iteration=init_iteration, end_iteration=end,
                evaluation_result_list=[]))

    def run_callbacks(i):
        """One iteration's eval and after-iteration callbacks against the
        current scores. True on EarlyStopException."""
        evaluation_result_list = []
        if is_valid_contain_train:
            evaluation_result_list.extend(booster.eval_train(feval))
        evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in callbacks_after_iter:
                cb(callback.CallbackEnv(
                    model=booster, cvfolds=None, iteration=i,
                    begin_iteration=init_iteration, end_iteration=end,
                    evaluation_result_list=evaluation_result_list))
        except callback.EarlyStopException:
            return True
        return False

    i = init_iteration + start_offset
    while i < end:
        step = min(block_full, end - i)
        if snap_period:
            # boundaries on the cadence (a resume starts off-cadence
            # only where the newest snapshot did)
            boundary = ((gbdt.iter // snap_period) + 1) * snap_period
            step = min(step, max(1, boundary - gbdt.iter))
        t_eff, snap = gbdt.train_many_eval(step)
        for t in range(t_eff):
            snap.set_scores_at(t, with_train=is_valid_contain_train)
            if run_callbacks(i + t):
                snap.set_scores_at(t, with_train=True)
                snap.drop_tail_to(t)
                return
        if snap.finalize():
            # natural stop (an empty tree mid-block). The per-iteration
            # loop this replay matches does not end there: it keeps
            # calling update(), evals repeat, and per-iteration sampling
            # can split again. Replay the stop iteration's callbacks,
            # then hand the remaining rounds to that loop.
            i += t_eff
            if i < end and run_callbacks(i):
                return
            i += 1
            while i < end:
                booster.update()
                if run_callbacks(i):
                    return
                i += 1
            return
        i += t_eff
        fire_checkpoints(i - 1)


def train(params, train_set, num_boost_round=100, valid_sets=None,
          valid_names=None, fobj=None, feval=None, init_model=None,
          feature_name=None, categorical_feature=None,
          early_stopping_rounds=None, evals_result=None, verbose_eval=True,
          learning_rates=None, callbacks=None, resume_from=None,
          device=None):
    """Train one booster on `device` (CUDA unless device="cpu"; with no
    card and no device it raises). Returns the Booster with
    `best_iteration` set.

    resume_from: a checkpoint directory (or CheckpointManager) written by
    `callback.checkpoint(...)`. When it holds a valid snapshot, the full
    training state (trees, scores, sampling RNG, early-stop trackers,
    eval history) is restored and training continues from the
    snapshot's iteration, to the model text of an uninterrupted run with
    the same params and data. Without one it is a cold start.

    Telemetry: `telemetry=true` opens the booster's run journal
    (models/gbdt.py), as the CLI's does; `profile=<dir>` writes a
    torch.profiler Chrome trace of the training into that directory and
    `run_history=<file>` appends one `run_summary` record at the end, as
    the CLI does (application.py)."""
    from .application import profiled
    knobs = dict(params or {})
    start = time.time()
    with profiled(knobs.get("profile", "")):
        booster = _train(params, train_set, num_boost_round, valid_sets,
                         valid_names, fobj, feval, init_model, feature_name,
                         categorical_feature, early_stopping_rounds,
                         evals_result, verbose_eval, learning_rates,
                         callbacks, resume_from, device)
    path = booster.config.run_history
    if path:
        from .telemetry import history
        history.append_run_summary(
            path, "train", **history.booster_summary(
                booster.gbdt, train_s=round(time.time() - start, 3)))
    return booster


def _train(params, train_set, num_boost_round, valid_sets, valid_names,
           fobj, feval, init_model, feature_name, categorical_feature,
           early_stopping_rounds, evals_result, verbose_eval, learning_rates,
           callbacks, resume_from, device):
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    predictor = _init_predictor(init_model, device)
    init_iteration = (len(predictor.models) // predictor.num_class
                      if predictor is not None else 0)
    train_set._set_predictor(predictor)
    train_set.set_feature_name(feature_name)
    train_set.set_categorical_feature(categorical_feature)

    is_valid_contain_train = False
    train_data_name = "training"
    reduced_valid_sets, name_valid_sets = [], []
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if isinstance(valid_names, str):
            valid_names = [valid_names]
        for i, valid_data in enumerate(valid_sets):
            if valid_data is train_set:
                is_valid_contain_train = True
                if valid_names is not None and len(valid_names) > i:
                    train_data_name = valid_names[i]
                continue
            if not isinstance(valid_data, Dataset):
                raise TypeError("Training only accepts Dataset object")
            valid_data.set_reference(train_set)
            reduced_valid_sets.append(valid_data)
            if valid_names is not None and len(valid_names) > i:
                name_valid_sets.append(valid_names[i])
            else:
                name_valid_sets.append("valid_" + str(i))

    callbacks = list(callbacks or [])
    for i, cb in enumerate(callbacks):
        cb.__dict__.setdefault("order", i - len(callbacks))
    default_print_cb = early_stop_cb = record_cb = None
    if verbose_eval is True:
        default_print_cb = callback.print_evaluation()
    elif isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool):
        default_print_cb = callback.print_evaluation(verbose_eval)
    if early_stopping_rounds is not None:
        early_stop_cb = callback.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval))
    if learning_rates is not None:
        callbacks.append(callback.reset_parameter(
            learning_rate=learning_rates))
    if evals_result is not None:
        record_cb = callback.record_evaluation(evals_result)
    engine_created = [cb for cb in (default_print_cb, early_stop_cb,
                                    record_cb) if cb is not None]
    callbacks_before_iter, callbacks_after_iter = _split_callbacks(
        callbacks + engine_created)

    booster = Booster(params=params, train_set=train_set, device=device)
    if is_valid_contain_train:
        booster.set_train_data_name(train_data_name)
    for valid_set, name in zip(reduced_valid_sets, name_valid_sets):
        booster.add_valid(valid_set, name)
    gbdt = booster.gbdt
    end = init_iteration + num_boost_round

    all_cbs = callbacks_before_iter + callbacks_after_iter
    ckpt_cbs = [cb for cb in callbacks_after_iter
                if getattr(cb, "is_checkpoint", False)]
    for cb in ckpt_cbs:
        cb.bind_peers(all_cbs)
    # resume: the newest valid snapshot (trees, scores, RNG streams,
    # callback state) restored, the rounds it holds skipped
    start_offset = 0
    if resume_from is not None:
        from .utils.checkpoint import CheckpointManager
        manager = (resume_from if isinstance(resume_from, CheckpointManager)
                   else CheckpointManager(resume_from))
        state, _ = manager.load_latest()
        if state is not None:
            restorer = (ckpt_cbs[0] if ckpt_cbs
                        else callback._Checkpoint(manager, 0))
            restorer.restore_into(booster, state, all_cbs)
            start_offset = min(gbdt.iter, num_boost_round)

    # fast path: nothing needs the round boundary. The default print
    # callback is exempt (with no valid sets its evaluation list is
    # empty and it prints nothing), and so are checkpoint callbacks:
    # the run is cut into blocks at their cadence, a snapshot between
    # blocks (the same trees: a block's length only moves the host
    # syncs).
    if (not callbacks_before_iter and valid_sets is None and fobj is None
            and all(cb is default_print_cb or cb in ckpt_cbs
                    for cb in callbacks_after_iter)
            and gbdt._fused_eligible()):
        periods = [cb.period for cb in ckpt_cbs if cb.period > 0]
        if periods:
            block = min(periods)
            stopped = False
            while gbdt.iter < num_boost_round and not stopped:
                # boundaries on the cadence (a resume may start off it)
                boundary = ((gbdt.iter // block) + 1) * block
                stopped = gbdt.train_many(
                    min(boundary, num_boost_round) - gbdt.iter)
                for cb in ckpt_cbs:
                    cb(callback.CallbackEnv(
                        model=booster, cvfolds=None,
                        iteration=init_iteration + gbdt.iter - 1,
                        begin_iteration=init_iteration, end_iteration=end,
                        evaluation_result_list=[]))
        elif num_boost_round > start_offset:
            gbdt.train_many(num_boost_round - start_offset)
        booster.best_iteration = num_boost_round
        return booster

    # blockwise: every callback is one train() made (or a checkpoint),
    # so the per-iteration protocol can be replayed after each fused
    # block; user callbacks may change the booster mid-run and keep the
    # per-iteration loop
    if (valid_sets is not None and fobj is None and not callbacks_before_iter
            and all(cb in engine_created or cb in ckpt_cbs
                    for cb in callbacks_after_iter)
            and gbdt._fused_eligible(ignore_train_metrics=True)):
        _train_blockwise(booster, [cb for cb in callbacks_after_iter
                                   if cb not in ckpt_cbs],
                         init_iteration, num_boost_round,
                         is_valid_contain_train, feval,
                         early_stopping_rounds, ckpt_cbs=ckpt_cbs,
                         start_offset=start_offset)
    else:
        for i in range(init_iteration + start_offset, end):
            for cb in callbacks_before_iter:
                cb(callback.CallbackEnv(
                    model=booster, cvfolds=None, iteration=i,
                    begin_iteration=init_iteration, end_iteration=end,
                    evaluation_result_list=None))
            booster.update(fobj=fobj)
            evaluation_result_list = []
            if valid_sets is not None:
                if is_valid_contain_train:
                    evaluation_result_list.extend(booster.eval_train(feval))
                evaluation_result_list.extend(booster.eval_valid(feval))
            try:
                for cb in callbacks_after_iter:
                    cb(callback.CallbackEnv(
                        model=booster, cvfolds=None, iteration=i,
                        begin_iteration=init_iteration, end_iteration=end,
                        evaluation_result_list=evaluation_result_list))
            except callback.EarlyStopException:
                break
    if booster.attr("best_iteration") is not None:
        booster.best_iteration = int(booster.attr("best_iteration")) + 1
    else:
        # reference quirk kept (engine.py:190): num_boost_round, not
        # init_iteration + num_boost_round
        booster.best_iteration = num_boost_round
    return booster


class CVBooster:
    """One fold of cv (engine.py:194-209)."""

    def __init__(self, train_set, valid_test, params, device):
        self.train_set = train_set
        self.valid_test = valid_test
        self.booster = Booster(params=params, train_set=train_set,
                               device=device)
        self.booster.add_valid(valid_test, "valid")

    def update(self, fobj):
        self.booster.update(fobj=fobj)

    def eval(self, feval):
        return self.booster.eval_valid(feval)


def _stratified_folds(label, nfold, shuffle, seed):
    """Test-row sets of sklearn's StratifiedKFold(nfold, shuffle,
    random_state=seed), which the JAX package calls: classes encoded in
    order of first appearance, each class's fold ids allotted round
    robin over the sorted labels and shuffled by one RandomState."""
    rng = np.random.RandomState(seed)
    y = np.asarray(label).reshape(-1)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(nfold > np.bincount(y_encoded)):
        raise ValueError("n_splits=%d cannot be greater than the number of "
                         "members in each class." % nfold)
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::nfold], minlength=n_classes)
         for i in range(nfold)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(nfold).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return [np.nonzero(test_folds == i)[0] for i in range(nfold)]


def _make_n_folds(full_data, nfold, params, seed, fpreproc=None,
                  stratified=False, shuffle=True, device=None):
    """engine.py:221-249: the same numpy permutation (or stratified
    folds) as the JAX package, so both train on the same folds."""
    if stratified:
        idset = _stratified_folds(full_data.get_label(), nfold, shuffle,
                                  seed)
    else:
        full_data.construct()
        n = full_data.num_data()
        randidx = (np.random.RandomState(seed).permutation(n) if shuffle
                   else np.arange(n))
        # reference quirk kept (engine.py:236-237): the last n % nfold
        # rows of the permutation appear in no fold
        kstep = int(len(randidx) / nfold)
        idset = [randidx[(i * kstep): min(len(randidx), (i + 1) * kstep)]
                 for i in range(nfold)]
    ret = []
    for k in range(nfold):
        train_set = full_data.subset(
            np.concatenate([idset[i] for i in range(nfold) if k != i]))
        valid_set = full_data.subset(idset[k])
        if fpreproc is not None:
            train_set, valid_set, tparam = fpreproc(train_set, valid_set,
                                                    params.copy())
        else:
            tparam = params
        ret.append(CVBooster(train_set, valid_set, tparam, device))
    return ret


def _agg_cv_result(raw_results):
    """engine.py:251-261: (cv_agg, metric, mean, bigger_better, stdv)."""
    cvmap = collections.defaultdict(list)
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            metric_type[one_line[1]] = one_line[3]
            cvmap[one_line[1]].append(one_line[2])
    return [("cv_agg", k, np.mean(v), metric_type[k], np.std(v))
            for k, v in cvmap.items()]


def cv(params, train_set, num_boost_round=10, nfold=5, stratified=False,
       shuffle=True, metrics=None, fobj=None, feval=None, init_model=None,
       feature_name=None, categorical_feature=None,
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv=True, seed=0, callbacks=None, device=None):
    """Cross-validation (engine.py:263-395): `nfold` boosters on `device`
    trained in lockstep. Returns {metric-mean: [...], metric-stdv:
    [...]}."""
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    train_set._set_predictor(_init_predictor(init_model, device))
    train_set.set_feature_name(feature_name)
    train_set.set_categorical_feature(categorical_feature)

    params = dict(params)
    if metrics:
        existing = params.get("metric", []) or []
        metric_list = (existing.split(",") if isinstance(existing, str)
                       else list(existing))
        if isinstance(metrics, str):
            metric_list.append(metrics)
        else:
            metric_list.extend(metrics)
        params["metric"] = metric_list

    results = collections.defaultdict(list)
    cvfolds = _make_n_folds(train_set, nfold, params, seed, fpreproc,
                            stratified, shuffle, device)

    callbacks = list(callbacks or [])
    for i, cb in enumerate(callbacks):
        cb.__dict__.setdefault("order", i - len(callbacks))
    if early_stopping_rounds is not None:
        callbacks.append(callback.early_stopping(early_stopping_rounds,
                                                 verbose=False))
    if verbose_eval is True:
        callbacks.append(callback.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool):
        callbacks.append(callback.print_evaluation(verbose_eval,
                                                   show_stdv=show_stdv))
    callbacks_before_iter, callbacks_after_iter = _split_callbacks(callbacks)

    for i in range(num_boost_round):
        for cb in callbacks_before_iter:
            cb(callback.CallbackEnv(model=None, cvfolds=cvfolds, iteration=i,
                                    begin_iteration=0,
                                    end_iteration=num_boost_round,
                                    evaluation_result_list=None))
        for fold in cvfolds:
            fold.update(fobj)
        res = _agg_cv_result([f.eval(feval) for f in cvfolds])
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in callbacks_after_iter:
                cb(callback.CallbackEnv(model=None, cvfolds=cvfolds,
                                        iteration=i, begin_iteration=0,
                                        end_iteration=num_boost_round,
                                        evaluation_result_list=res))
        except callback.EarlyStopException as e:
            for k in results:
                results[k] = results[k][:e.best_iteration + 1]
            break
    return dict(results)
