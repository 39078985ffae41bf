"""Optimization drivers."""

from .driver import run_gradient_descent, GDRunResult
from .ensemble import run_ensemble, stack_controls, EnsembleResult
from . import grad_check

__all__ = ["run_gradient_descent", "GDRunResult", "grad_check",
           "run_ensemble", "stack_controls", "EnsembleResult"]
