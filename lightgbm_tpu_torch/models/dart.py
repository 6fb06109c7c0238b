"""DART boosting (Dropouts meet Multiple Additive Regression Trees); port
of lightgbm_tpu/models/dart.py.

Reference: src/boosting/dart.hpp:17-142. Per iteration: select dropped
trees (binomial by drop_rate, plus-one fallback), subtract them from the
training score, train the new tree against the dropped score with
shrinkage lr/(k+lr), then re-normalize dropped trees to weight k/(k+lr).

Dropping and normalizing rescale earlier trees in place (Tree.shrinkage)
without changing the model count, so both drop the booster's cached
stacked arrays and frozen device model (GBDT._model_cache). The dropped
trees' scores are added and removed one tree at a time
(ScoreUpdater.add_score_by_tree), as in the JAX package.
"""

from ..utils.random import Random
from .gbdt import GBDT


class DART(GBDT):
    name = "dart"

    def __init__(self, device=None):
        super().__init__(device)
        self.drop_index = []
        self._random_for_drop = Random(4)
        self._dropped_this_iter = False

    def init(self, config, train_data, objective, training_metrics=()):
        super().init(config, train_data, objective, training_metrics)
        self._random_for_drop = Random(config.drop_seed)

    def train_one_iter(self, gradients=None, hessians=None, is_eval=True):
        if gradients is not None:
            # a custom-gradient iteration never calls the dropping hook:
            # the drop set is cleared so that _normalize does nothing
            # (the reference keeps the previous iteration's drop_index_
            # here and re-normalizes stale trees; the JAX package departs
            # from it on purpose, and so does the port)
            self.drop_index = []
        self._dropped_this_iter = False
        stop = super().train_one_iter(gradients, hessians, is_eval=False)
        self._normalize()
        if stop:
            return True
        if is_eval:
            return self.eval_and_check_early_stopping()
        return False

    def _score_for_boosting(self):
        if not self._dropped_this_iter:
            self._dropping_trees()
            self._dropped_this_iter = True
        return self.train_score_updater.score

    def _dropping_trees(self):
        """dart.hpp:85-110."""
        cfg = self.config
        self.drop_index = []
        if cfg.drop_rate > 1e-15:
            for i in range(self.iter):
                if self._random_for_drop.next_double() < cfg.drop_rate:
                    self.drop_index.append(i)
        if not self.drop_index:
            self.drop_index = [int(i) for i in
                               self._random_for_drop.sample(self.iter, 1)]
        for i in self.drop_index:
            for k in range(self.num_class):
                tree = self.models[i * self.num_class + k]
                tree.shrinkage(-1.0)
                self.train_score_updater.add_score_by_tree(tree, k)
        self.shrinkage_rate = cfg.learning_rate / (
            cfg.learning_rate + float(len(self.drop_index)))
        self._device_model_cache = None

    def _normalize(self):
        """dart.hpp:111-135."""
        k_drop = float(len(self.drop_index))
        for i in self.drop_index:
            for k in range(self.num_class):
                tree = self.models[i * self.num_class + k]
                tree.shrinkage(self.shrinkage_rate)
                for updater in self.valid_score_updaters:
                    updater.add_score_by_tree(tree, k)
                tree.shrinkage(-k_drop / self.config.learning_rate)
                self.train_score_updater.add_score_by_tree(tree, k)
        if self.drop_index:
            self._device_model_cache = None
