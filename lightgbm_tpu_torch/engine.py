"""Training entry point `train` (port of lightgbm_tpu/engine.py :130).

Reference: python-package/lightgbm/engine.py:12-191. The per-iteration
loop with valid-set evaluation and after-iteration callbacks (print,
early stopping). The JAX package's fused multi-iteration trainer
(_train_blockwise / train_many) becomes CUDA-graph capture in a later
slice; cv, init_model chaining and resume are later slices too.
"""

from operator import attrgetter

from . import callback
from .basic import Booster, Dataset


def train(params, train_set, num_boost_round=100, valid_sets=None,
          valid_names=None, feature_name=None, categorical_feature=None,
          early_stopping_rounds=None, verbose_eval=True, callbacks=None,
          device=None):
    """Train one booster on `device` (CUDA unless device="cpu"; with no
    card and no device it raises). Returns the Booster with
    `best_iteration` set."""
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
    if verbose_eval is True:
        callbacks.append(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool):
        callbacks.append(callback.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None:
        callbacks.append(callback.early_stopping(
            early_stopping_rounds, verbose=bool(verbose_eval)))
    if any(getattr(cb, "before_iteration", False) for cb in callbacks):
        raise NotImplementedError("before-iteration callbacks are a later "
                                  "slice of lightgbm_tpu_torch")
    callbacks.sort(key=attrgetter("order"))

    booster = Booster(params=params, train_set=train_set, device=device)
    if is_valid_contain_train:
        booster.set_train_data_name(train_data_name)
    for valid_set, name in zip(reduced_valid_sets, name_valid_sets):
        booster.add_valid(valid_set, name)

    for i in range(num_boost_round):
        booster.update()
        evaluation_result_list = []
        if valid_sets is not None:
            if is_valid_contain_train:
                evaluation_result_list.extend(booster.eval_train())
            evaluation_result_list.extend(booster.eval_valid())
        try:
            for cb in callbacks:
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
