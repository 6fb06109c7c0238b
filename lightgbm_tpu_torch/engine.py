"""Training entry point `train` (port of lightgbm_tpu/engine.py :130).

Reference: python-package/lightgbm/engine.py:12-191. Three routes, as
in the JAX package (engine.py:250-330):
- nothing needs the round boundary (no callbacks but the default print,
  no valid sets): the whole run is one fused block, GBDT.train_many;
- valid sets and/or early stopping with only the callbacks train()
  itself made (print, early stopping, record): fused blocks with the
  per-iteration callbacks replayed from score snapshots
  (_train_blockwise);
- any user callback: the per-iteration loop.
cv, custom objectives and metrics, init_model chaining and resume are
later slices.
"""

from operator import attrgetter

from . import callback
from .basic import Booster, Dataset


def _split_callbacks(callbacks):
    """(before-iteration, after-iteration) callbacks, each sorted by
    `.order` (engine.py:124-150)."""
    before = [cb for cb in callbacks if getattr(cb, "before_iteration", False)]
    after = [cb for cb in callbacks if cb not in before]
    return (sorted(before, key=attrgetter("order")),
            sorted(after, key=attrgetter("order")))


def _train_blockwise(booster, callbacks_after_iter, num_boost_round,
                     is_valid_contain_train, early_stopping_rounds):
    """Fused blocks with the per-iteration callbacks replayed
    (engine.py:37-127). Each block is one gbdt.train_many_eval; the
    metrics of every iteration inside it come from device score
    snapshots. An early-stop break mid-block drops the overshoot trees
    without touching the scores: the snapshot already is the kept
    state."""
    gbdt = booster.gbdt
    # the overshoot past the true stopping round costs at most block-1
    # iterations, so the block follows the early-stop patience
    if early_stopping_rounds is None:
        block_full = num_boost_round
    else:
        block_full = min(num_boost_round,
                         max(5, min(int(early_stopping_rounds), 25)))

    def run_callbacks(i):
        """One iteration's eval and after-iteration callbacks against the
        current scores. True on EarlyStopException."""
        evaluation_result_list = []
        if is_valid_contain_train:
            evaluation_result_list.extend(booster.eval_train())
        evaluation_result_list.extend(booster.eval_valid())
        try:
            for cb in callbacks_after_iter:
                cb(callback.CallbackEnv(
                    model=booster, cvfolds=None, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evaluation_result_list))
        except callback.EarlyStopException:
            return True
        return False

    i = 0
    while i < num_boost_round:
        t_eff, snap = gbdt.train_many_eval(min(block_full,
                                               num_boost_round - i))
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
            if i < num_boost_round and run_callbacks(i):
                return
            i += 1
            while i < num_boost_round:
                booster.update()
                if run_callbacks(i):
                    return
                i += 1
            return
        i += t_eff


def train(params, train_set, num_boost_round=100, valid_sets=None,
          valid_names=None, fobj=None, feval=None, init_model=None,
          feature_name=None, categorical_feature=None,
          early_stopping_rounds=None, evals_result=None, verbose_eval=True,
          callbacks=None, resume_from=None, device=None):
    """Train one booster on `device` (CUDA unless device="cpu"; with no
    card and no device it raises). Returns the Booster with
    `best_iteration` set."""
    for name, value in (("fobj", fobj), ("feval", feval),
                        ("init_model", init_model),
                        ("resume_from", resume_from)):
        if value is not None:
            raise NotImplementedError(
                f"train({name}=...) is a later slice of lightgbm_tpu_torch "
                "(custom objectives and metrics, model chaining, "
                "checkpoint resume)")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
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
            valid_data.reference = train_set
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

    # fast path: nothing needs the round boundary. The default print
    # callback is exempt: with no valid sets its evaluation list is
    # empty and it prints nothing.
    if (not callbacks_before_iter and valid_sets is None
            and all(cb is default_print_cb for cb in callbacks_after_iter)
            and gbdt._fused_eligible()):
        gbdt.train_many(num_boost_round)
        booster.best_iteration = num_boost_round
        return booster

    # blockwise: every callback is one train() made, so the
    # per-iteration protocol can be replayed after each fused block;
    # user callbacks may change the booster mid-run and keep the
    # per-iteration loop
    if (valid_sets is not None and not callbacks_before_iter
            and all(cb in engine_created for cb in callbacks_after_iter)
            and gbdt._fused_eligible(ignore_train_metrics=True)):
        _train_blockwise(booster, callbacks_after_iter, num_boost_round,
                         is_valid_contain_train, early_stopping_rounds)
    else:
        for i in range(num_boost_round):
            for cb in callbacks_before_iter:
                cb(callback.CallbackEnv(
                    model=booster, cvfolds=None, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=None))
            booster.update()
            evaluation_result_list = []
            if valid_sets is not None:
                if is_valid_contain_train:
                    evaluation_result_list.extend(booster.eval_train())
                evaluation_result_list.extend(booster.eval_valid())
            try:
                for cb in callbacks_after_iter:
                    cb(callback.CallbackEnv(
                        model=booster, cvfolds=None, iteration=i,
                        begin_iteration=0, end_iteration=num_boost_round,
                        evaluation_result_list=evaluation_result_list))
            except callback.EarlyStopException:
                break
    if booster.attr("best_iteration") is not None:
        booster.best_iteration = int(booster.attr("best_iteration")) + 1
    else:
        booster.best_iteration = num_boost_round
    return booster
