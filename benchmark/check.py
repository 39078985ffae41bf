"""The comparison that decides ``correct``.

During the window's first job, probes around three stage functions of
``ocean_torch.system`` keep what the timed path produced: the reduced
gradient of every iteration, and at the iterations drawn for the check
the ∇u projection, the costate μ and the point-source right-hand side.
The GD loop's own per-iteration hook gives the forward state, the adjoint
state z, the new control and J. Every number is compared at every drawn
iteration: one that the run did not produce there (a stage that the
timed path no longer calls under its name, so its probe never fires, or a
drawn iteration whose start the probes cannot give the reference) reads
an infinite gap, and the run is not correct.

After the window the plain reference (``reference/``) recomputes each
drawn iteration: iteration 0 from the configuration's own initial
control and learning rate, a later one from the program's control and
learning rate at its start (the reference follows the program's state
there). Each number is the largest relative gap max|a − b| / max|b| over
the drawn iterations. An escape flag that differs moves a trajectory to
the domain's center, and a learning rate that differs moves the new
control by a whole step, so x and f_new carry the masks and the accepted
step.
"""

from __future__ import annotations

import math
import sys
import numpy as np
import torch

NUMBERS = ("u", "p", "x", "u_values", "J", "grad_u", "mu", "b", "z", "g",
           "f_new")
PROBED = ("_adjoint_mu", "_adjoint_sources", "reduced_gradient")


def draw_iterations(seed: int, traffic: dict) -> list:
    """Iteration 0 and ``drawn`` others from ``drawn_from`` (inclusive),
    chosen by the seed."""
    lo, hi = traffic["check"]["drawn_from"]
    rng = np.random.default_rng([seed, 1])
    picks = rng.choice(np.arange(lo, hi + 1), size=traffic["check"]["drawn"],
                       replace=False)
    return [0] + sorted(int(i) for i in picks)


class Capture:
    """Probes on the stage functions of ``system``; record while
    ``active``, for the iteration counted by the GD loop's hook."""

    def __init__(self, system, sample: list):
        self.system = system
        self.sample = set(sample)
        self.active = False
        self.it = 0
        self.rec = {}             # iteration → dict of tensors
        self.g = {}               # iteration → g.quad (every iteration)
        self.f = {}               # iteration → control at its start
        self.j = []               # the GD loop's J records of the job
        self._orig = {}
        for name in PROBED:
            fn = getattr(system, name, None)
            if fn is None:
                continue
            self._orig[name] = fn
            setattr(system, name, self._wrap(name, fn))

    def _slot(self):
        return self.rec.setdefault(self.it, {})

    def _wrap(self, name, fn):
        def probe(*args, **kw):
            out = fn(*args, **kw)
            if not self.active:
                return out
            if name == "reduced_gradient":
                self.g[self.it] = out.quad.detach().clone()
            elif self.it in self.sample and name == "_adjoint_mu":
                self._slot().update(grad_u=args[1].detach().clone(),
                                    mu=out.detach().clone())
            elif self.it in self.sample and name == "_adjoint_sources":
                self._slot()["b"] = out.detach().clone()
            return out
        return probe

    def start(self, f0_quad):
        self.active, self.it = True, 0
        self.f[0] = f0_quad.detach().clone()

    def on_iteration(self, i, f, fwd, z, j_array):
        """The GD loop's hook of iteration i: f is the new control."""
        if not self.active:
            return
        self.f[i + 1] = f.quad.detach().clone()
        self.j = list(j_array)
        if i in self.sample:
            s = self._slot()
            s.update(w=fwd.w.detach().clone(), x=fwd.x.detach().clone(),
                     u_values=fwd.u_values.detach().clone(),
                     z=z.detach().clone(),
                     J=float(j_array[i]))
        self.it = i + 1

    def stop(self):
        self.active = False

    def restore(self):
        for name, fn in self._orig.items():
            setattr(self.system, name, fn)


def step_lr(f_a, f_b, g, lr0: float, tau: float, lr_min: float) -> float:
    """The learning rate of the update f_b = f_a − lr g, snapped to the
    GD loop's ladder lr0, τ·lr0, … (floored at lr_min)."""
    d = (f_a - f_b).double().reshape(-1)
    gg = g.double().reshape(-1)
    lr = float(d @ gg / (gg @ gg))
    if not lr > 0:
        return float("nan")
    k = max(0, int(round(math.log(lr0 / lr) / math.log(1 / tau))))
    out = lr0
    for _ in range(k):
        out = max(tau * out, lr_min)
    return out


def gap(a, b) -> float:
    a = torch.as_tensor(a, dtype=torch.float64, device="cpu")
    b = torch.as_tensor(b, dtype=torch.float64, device="cpu")
    if a.shape != b.shape:
        return float("inf")
    scale = float(b.abs().max()) if b.numel() else 0.0
    d = float((a - b).abs().max()) if b.numel() else 0.0
    if not math.isfinite(d):
        return float("inf")
    return d / scale if scale > 0 else d


def program_readings(cap: Capture, cfg: dict) -> dict:
    """What the program produced at each drawn iteration that the
    reference can follow, as the comparison reads it: iteration → dict.
    A later iteration's learning rate comes from the last gradient."""
    out = {}
    for i in sorted(cap.sample):
        s = cap.rec.get(i, {})
        if "w" not in s or i + 1 not in cap.f or (i and i - 1 not in cap.g):
            continue
        r = dict(s)
        r["f_start"] = cap.f[i]
        r["f_new"] = cap.f[i + 1]
        if i in cap.g:
            r["g"] = cap.g[i]
        r["lr_in"] = (cfg["LR"] if i == 0 else
                      step_lr(cap.f[i - 1], cap.f[i], cap.g[i - 1],
                              cfg["LR"], cfg["tau"], cfg["LR_MIN"]))
        out[i] = r
    return out


def reference_readings(ref, prog: dict) -> dict:
    """The reference's iteration at each drawn iteration of ``prog``."""
    out = {}
    for i, r in sorted(prog.items()):
        f = ref.initial_control() if i == 0 else ref.tensor(r["f_start"])
        out[i] = ref.iteration(f, float(r["lr_in"]))
    return out


def compare(prog: dict, ref: dict, n_p2: int, sample: list) -> dict:
    """The gaps of each drawn iteration: iteration → number → gap. A
    drawn iteration or a number that the program did not produce reads
    an infinite gap."""
    out = {}
    for i in sample:
        r, e = prog.get(i), ref.get(i)
        if r is None or e is None:
            out[i] = dict.fromkeys(NUMBERS, math.inf)
            continue
        got = {"u": gap(r["w"][: 2 * n_p2], e["w"][: 2 * n_p2]),
               "p": gap(r["w"][2 * n_p2:], e["w"][2 * n_p2:])}
        for k in NUMBERS[2:]:
            got[k] = gap(r[k], e[k]) if k in r else math.inf
        out[i] = got
    return out


def worst(gaps: dict) -> dict:
    """Each number's largest gap over the drawn iterations."""
    return {k: max(g[k] for g in gaps.values()) for k in NUMBERS}


def failed_iterations(gaps: dict, limits: dict) -> int:
    return sum(any(not g[k] <= limits[k] for k in NUMBERS)
               for g in gaps.values())


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, lines): every number beside its limit."""
    ok = True
    table = {}
    for k in NUMBERS:
        v, lim = numbers[k], limits[k]
        table[k] = [v if math.isfinite(v) else sys.float_info.max, lim]
        ok = ok and v <= lim
    return ok, table


def print_table(table: dict, correct: bool, file=sys.stderr):
    for k, (v, lim) in table.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=file)
    print(f"check correct: {correct}", file=file, flush=True)


def lower_precision(ref_cls, cfg, x0, u_d, device, prog: dict,
                    dtype=torch.float32) -> dict:
    """The control: the reference in ``dtype`` put in the program's
    place, from the same starts as the program's drawn iterations."""
    low = ref_cls(cfg, x0, u_d, device, dtype=dtype)
    got = {}
    for i, r in sorted(prog.items()):
        f = low.initial_control() if i == 0 else low.tensor(r["f_start"])
        e = low.iteration(f, float(r["lr_in"]))
        got[i] = dict(w=e["w"], x=e["x"], u_values=e["u_values"],
                      z=e["z"], J=e["J"], grad_u=e["grad_u"],
                      mu=e["mu"], b=e["b"], g=e["g"], f_new=e["f_new"])
    return got
