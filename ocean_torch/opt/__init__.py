"""Optimization drivers."""

from .driver import run_gradient_descent, GDRunResult

__all__ = ["run_gradient_descent", "GDRunResult"]
