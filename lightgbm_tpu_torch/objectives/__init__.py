"""Objective functions: gradients/hessians from scores."""

from .objectives import (BinaryLogloss, LambdarankNDCG, MulticlassLogloss,
                         ObjectiveFunction, RegressionL2loss,
                         create_objective)

__all__ = ["ObjectiveFunction", "RegressionL2loss", "BinaryLogloss",
           "MulticlassLogloss", "LambdarankNDCG", "create_objective"]
