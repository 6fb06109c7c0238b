"""Training callbacks: print_evaluation, record_evaluation,
reset_parameter and early_stopping (port of lightgbm_tpu/callback.py).

Reference contract (python-package/lightgbm/callback.py:6-192):
callables taking a `CallbackEnv` namedtuple with these exact fields,
ordered by `.order` (print=10, record=20, early-stop=30), run after
each iteration (reset_parameter, with `before_iteration`, before it);
`early_stopping` signals by raising `EarlyStopException(best_iteration)`;
console lines keep LightGBM's `[n]\\tdata's metric:value` shape. The
checkpoint callback is ROADMAP queue 1 item 4.
"""

import collections


class EarlyStopException(Exception):
    """Raised by the early_stopping callback (callback.py:6-15)."""

    def __init__(self, best_iteration):
        super().__init__()
        self.best_iteration = best_iteration


CallbackEnv = collections.namedtuple(
    "LightGBMCallbackEnv",
    ["model", "cvfolds", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _entry_to_text(entry, with_stdv=True):
    """One evaluation entry -> console text. Entries are 4-tuples
    (data, metric, value, bigger_better) from train() and 5-tuples
    (+stdv) from cv()."""
    if len(entry) == 4:
        data_name, metric_name, value = entry[0], entry[1], entry[2]
        return f"{data_name}'s {metric_name}:{value:g}"
    if len(entry) == 5:
        data_name, metric_name, value, _, stdv = entry
        if with_stdv:
            return f"{data_name}'s {metric_name}:{value:g}+{stdv:g}"
        return f"{data_name}'s {metric_name}:{value:g}"
    raise ValueError(
        f"evaluation entries must be 4- or 5-tuples, got {len(entry)}")


class _PrintEvaluation:
    def __init__(self, period, show_stdv):
        # instance attrs, not class attrs: engine._configure_callbacks
        # setdefaults 'order' into user callbacks' __dict__
        self.order = 10
        self.period = period
        self.show_stdv = show_stdv

    def __call__(self, env):
        if self.period <= 0 or not env.evaluation_result_list:
            return
        done = env.iteration + 1
        if done % self.period:
            return
        line = "\t".join(_entry_to_text(e, self.show_stdv)
                         for e in env.evaluation_result_list)
        print(f"[{done}]\t{line}")


def print_evaluation(period=1, show_stdv=True):
    """Print evaluation results every `period` iterations
    (callback.py:40-65)."""
    return _PrintEvaluation(period, show_stdv)


class _RecordEvaluation:
    def __init__(self, target):
        self.order = 20
        self.target = target

    def __call__(self, env):
        for data_name, metric_name, value, *_ in env.evaluation_result_list:
            history = self.target.setdefault(
                data_name, collections.defaultdict(list))
            history[metric_name].append(value)


def record_evaluation(eval_result):
    """Record the evaluation history into the dict `eval_result`
    (callback.py:68-97)."""
    if not isinstance(eval_result, dict):
        raise TypeError(
            "record_evaluation needs a dict to write history into, got "
            + type(eval_result).__name__)
    eval_result.clear()
    return _RecordEvaluation(eval_result)


class _ResetParameter:
    def __init__(self, schedules):
        self.order = 10
        self.before_iteration = True
        self.schedules = schedules

    def __call__(self, env):
        round_idx = env.iteration - env.begin_iteration
        n_rounds = env.end_iteration - env.begin_iteration
        new_params = {}
        for name, schedule in self.schedules.items():
            if isinstance(schedule, list):
                if len(schedule) != n_rounds:
                    raise ValueError(
                        f"the {name!r} schedule list must have exactly "
                        f"num_boost_round (= {n_rounds}) entries")
                new_params[name] = schedule[round_idx]
            else:
                new_params[name] = schedule(round_idx)
        for name, value in new_params.items():
            env.model.reset_parameter({name: value})


def reset_parameter(**kwargs):
    """Per-round parameter schedules (e.g. learning_rate decay), applied
    before each iteration (callback.py:100-129). Values are lists
    (indexed by round) or callables of the round index."""
    return _ResetParameter(kwargs)


class _EarlyStopping:
    def __init__(self, patience, verbose):
        self.order = 30
        self.patience = patience
        self.verbose = verbose
        self.trackers = None  # per-metric [sign, best_score, best_it, msg]

    def _start(self, env):
        if not env.evaluation_result_list:
            raise ValueError("early stopping needs at least one validation "
                             "dataset and metric to watch")
        if self.verbose:
            print("Train until valid scores didn't improve in "
                  f"{self.patience} rounds.")
        self.trackers = [
            [1.0 if entry[3] else -1.0, float("-inf"), 0, ""]
            for entry in env.evaluation_result_list]

    def __call__(self, env):
        if self.trackers is None:
            self._start(env)
        for tracker, entry in zip(self.trackers, env.evaluation_result_list):
            sign, best, best_it, _ = tracker
            score = sign * entry[2]
            if score > best:
                tracker[1] = score
                tracker[2] = env.iteration
                if self.verbose:
                    line = "\t".join(_entry_to_text(e)
                                     for e in env.evaluation_result_list)
                    tracker[3] = f"[{env.iteration + 1}]\t{line}"
            elif env.iteration - best_it >= self.patience:
                if env.model is not None:
                    env.model.set_attr(best_iteration=str(best_it))
                if self.verbose:
                    print("Early stopping, best iteration is:")
                    print(tracker[3])
                raise EarlyStopException(best_it)


def early_stopping(stopping_rounds, verbose=True):
    """Stop when no validation metric improved in `stopping_rounds`
    rounds; checks ALL metrics of all valid sets (callback.py:132-192)."""
    return _EarlyStopping(stopping_rounds, verbose)
