"""``solve_s`` of the window (``harness.window_times``), read per layer in
the cells where the host's pace spreads it too widely for a bound."""

from benchmark import harness


def read(ctx):
    return harness.window_times(ctx.window)["solve_s"]
