"""Optimization drivers."""

from .driver import run_gradient_descent, GDRunResult
from .ensemble import run_ensemble, stack_controls, EnsembleResult

__all__ = ["run_gradient_descent", "GDRunResult", "run_ensemble",
           "stack_controls", "EnsembleResult"]
