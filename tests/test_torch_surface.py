"""The port's API surface against the JAX package's, read from both
source trees with ``ast`` (neither package is imported; well under a
second):

* every module of ``ocean_jax/`` has a counterpart file in
  ``ocean_torch/`` (``FILE_RENAMES`` for the kernel and checkpoint
  files);
* every public top-level function and class, every public method,
  property and field of a class, and every name a JAX jit binds to a
  private function (``solve_ns = jax.jit(_solve_ns)``) has a counterpart
  of the same name (``NAME_RENAMES`` for the kernel entry points);
* each counterpart accepts every argument name the JAX one accepts;
* every name that an ``ocean_jax/**/__init__.py`` exports (``__all__``,
  else its relative imports) is bound by the port's ``__init__.py``.

What fails these checks stands in ``EXCEPTIONS`` with its reason: it is
the record of what the port leaves out on purpose. A public JAX name or
argument that appears without a counterpart or an entry fails the test,
and so does an entry that no longer matches anything.

Run it alone: ``python -m pytest tests/test_torch_surface.py -q``.
"""

import ast
import functools
from fnmatch import fnmatchcase
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "ocean_jax", ROOT / "ocean_torch"

# JAX file → the port's file under another name
FILE_RENAMES = {
    "ode/pallas_ode.py": "ode/cuda_ode.py",
    "ode/pallas_adjoint.py": "ode/cuda_adjoint.py",
    "ode/pallas_eval.py": "ode/cuda_eval.py",
    "adjoint/pallas_psrc.py": "adjoint/cuda_psrc.py",
    "ops/psum_pallas.py": "ops/psum_cuda.py",
    "io/orbax_ckpt.py": "io/torch_ckpt.py",
}

# the Pallas entry points → their CUDA wrappers in the renamed files; the
# wrappers take the port's GridEval as ``ge`` where JAX's take ``grid``
NAME_RENAMES = {
    "ode/pallas_ode.py::solve_primal_ode_pallas": "solve_primal_ode_cuda",
    "ode/pallas_adjoint.py::solve_adjoint_ode_pallas":
        "solve_adjoint_ode_cuda",
    "ode/pallas_eval.py::eval_p1_tensor_pallas": "eval_p1_tensor_cuda",
    "adjoint/pallas_psrc.py::point_source_image_pallas": "point_source_image",
    "ops/psum_pallas.py::ozaki_segment_sum_pallas": "ozaki_slice_sums",
}
ARG_RENAMES = {"grid": "ge"}

# gap keys: "file" (no counterpart file), "file::name" or
# "file::Class.member" (no counterpart name), "file::qualname(arg)" (an
# argument the counterpart does not accept); fnmatch patterns
EXCEPTIONS = [
    ("JAX pytree registration; the port's classes are plain dataclasses",
     ["*::*.tree_flatten", "*::*.tree_unflatten"]),
    ("jits with the TPU's raised scoped-VMEM compiler option "
     "(LARGE_SOLVE_COMPILER_OPTIONS) and the stage_fns pair that picks "
     "between them and the plain solve_adjoint jit; the port's stages are "
     "plain functions (system.forward, _solve_adjoint_flagged)",
     ["system.py::" + n for n in (
         "forward_hires", "solve_adjoint_hires", "needs_raised_vmem",
         "stage_fns", "make_high_resolution_step", "solve_adjoint")]),
    ("the C++ mesh-topology builder: mesh/structured.py keeps its numpy "
     "copy, which numbers the mesh the same way",
     ["native/__init__.py"]),
    ("double-single float32 pairs stand in for float64 on the TPU; the "
     "card has float64",
     ["ops/doublesingle.py"]),
    ("ELL tables of the opt-in use_ell matvec, which build_mg_hierarchy "
     "never sets; bc_dofs_f is read only with use_ell "
     "(ocean_jax/solve/mg.py:198), so JAX's context does not depend on it",
     ["ops/ell.py", "solve/mg.py::build_mg_context(use_ell)",
      "solve/mg.py::build_mg_context(bc_dofs_f)",
      "solve/mg.py::MGContext.ell_*"]),
    ("host-orchestrated float32 inverse built in memory-bounded TPU "
     "programs; the port's invert32 builds it in one",
     ["ops/linalg.py::explicit_inverse_host"]),
    ("named differently: the factor classes' solve / solve_t are float64 "
     "results of the same float32 applies (solve32_raw keeps float32)",
     ["ops/linalg.py::LUSolver.solve32",
      "ops/linalg.py::LUSolver.solve32_t",
      "ops/linalg.py::InvSolver.solve32",
      "ops/linalg.py::InvSolver.solve32_t"]),
    ("XLA tuning knobs (scan unrolling, exact-sum and Ozaki tiling, "
     "refinement of float32 solves); the port solves in float64",
     ["*(unroll)", "*(exact)", "*(chunk)", "*(slices)", "*(s_tile)",
      "*(refine_iters)"]),
    ("JAX-only idiom: PyTorch's scatter, index_add_ and float64 cumsum "
     "serve",
     ["fem/assemble.py::map_cells", "fem/assemble.py::scatter_vector",
      "fem/assemble.py::scatter_matrix_dense",
      "ops/scatter.py::spread_scatter_add", "ops/scatter.py::exact_cumsum"]),
    ("the port's dense operator is float64",
     ["fem/assemble.py::Operator.dense(dtype)"]),
    ("JAX's body does not read it (ocean_jax/fem/forms.py:80-105)",
     ["fem/forms.py::ns_facet_residual(space)"]),
    ("process groups instead of device meshes: make_buoy_group and "
     "make_2d_groups, and a group argument",
     ["parallel/*::make_buoy_mesh", "parallel/*::make_2d_mesh",
      "parallel/*(mesh)"]),
    ("the port's stencil tables are another layout (segment lengths and "
     "a gather window, not sorted slots and an image map)",
     ["ops/stencil.py::StencilTables.seg",
      "ops/stencil.py::StencilTables.img_map",
      "ops/stencil.py::StencilTables.n_cell_vals"]),
    ("the kernel wrappers have no interpret mode (a CPU tensor runs the "
     "plain version), and the primal ODE's GridEval holds the space",
     ["*pallas*::*(interpret)", "ode/pallas_ode.py::*(space)"]),
]


def _args(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")], a.kwarg is not None


def _wrapped(value):
    """The function name a binding wraps: ``f`` of ``x = f``, of
    ``x = jax.jit(f, ...)`` and of ``x = partial(jax.jit, ...)(f)``."""
    if isinstance(value, ast.Name):
        return value.id
    if isinstance(value, ast.Call) and value.args \
            and isinstance(value.args[0], ast.Name):
        return value.args[0].id
    return None


def _class(node):
    members = {}
    for m in node.body:
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                not m.name.startswith("_")
                or m.name in ("__init__", "__call__")):
            members[m.name] = ("def",) + _args(m)
        elif isinstance(m, ast.AnnAssign) and isinstance(m.target, ast.Name):
            members[m.target.id] = ("field",)
    return members


@functools.lru_cache(maxsize=None)
def _bindings(path: Path):
    """Top-level names of a source file: name → ("def", args, **kw),
    ("class", members), ("import", module, name) or ("name",)."""
    tree = ast.parse(path.read_text(), str(path))
    defs = {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out = {}
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[n.name] = ("def",) + _args(n)
        elif isinstance(n, ast.ClassDef):
            out[n.name] = ("class", _class(n))
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    w = _wrapped(n.value)
                    out[t.id] = (("def",) + _args(defs[w]) if w in defs
                                 else ("name",))
        elif isinstance(n, ast.ImportFrom):
            for a in n.names:
                out[a.asname or a.name] = ("import", n.level, n.module,
                                           a.name)
        elif isinstance(n, ast.Import):
            for a in n.names:
                out[(a.asname or a.name).split(".")[0]] = ("name",)
    return out


def _resolve(path: Path, name: str, depth: int = 0):
    """The binding of ``name`` in ``path``, following relative imports."""
    b = _bindings(path).get(name)
    if b is None or b[0] != "import" or depth > 8:
        return b
    _, level, module, orig = b
    if level == 0:
        return ("name",)
    base = path.parent
    for _ in range(level - 1):
        base = base.parent
    target = base.joinpath(*module.split(".")) if module else base
    if target.with_suffix(".py").is_file():
        return _resolve(target.with_suffix(".py"), orig, depth + 1)
    if (target / "__init__.py").is_file():
        if (target / orig).is_dir() or (target / f"{orig}.py").is_file():
            return ("name",)                    # a submodule
        return _resolve(target / "__init__.py", orig, depth + 1)
    return None


def _exports(path: Path):
    """Names an ``__init__.py`` exports: ``__all__``, else the names of
    its relative imports."""
    tree = ast.parse(path.read_text(), str(path))
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets):
            return [ast.literal_eval(e) for e in n.value.elts]
    return [a.asname or a.name for n in tree.body
            if isinstance(n, ast.ImportFrom) and n.level > 0
            for a in n.names]


def _arg_gaps(key, jax_sig, port_sig, renames=None):
    if port_sig is None or port_sig[0] != "def":
        return []
    names, kwargs = port_sig[1], port_sig[2]
    return [f"{key}({a})" for a in jax_sig[1]
            if not kwargs and (renames or {}).get(a, a) not in names]


def _counterpart(rel: str) -> Path:
    return PORT / FILE_RENAMES.get(rel, rel)


@functools.lru_cache(maxsize=None)
def _gaps():
    """Every gap of the port against the JAX package: kind → keys."""
    gaps = {"file": [], "name": [], "arg": [], "export": []}
    for jp in sorted(JAX.rglob("*.py")):
        rel = jp.relative_to(JAX).as_posix()
        tp = _counterpart(rel)
        if not tp.is_file():
            gaps["file"].append(rel)
            continue
        for name, jb in _bindings(jp).items():
            if name.startswith("_") or jb[0] not in ("def", "class"):
                continue
            key = f"{rel}::{name}"
            renamed = NAME_RENAMES.get(key)
            tb = _resolve(tp, renamed or name)
            if tb is None:
                gaps["name"].append(key)
                continue
            if jb[0] == "def":
                gaps["arg"] += _arg_gaps(key, jb, tb,
                                         ARG_RENAMES if renamed else None)
                continue
            members = tb[1] if tb[0] == "class" else {}
            for m, jm in jb[1].items():
                mkey = f"{key}.{m}"
                if m not in members:
                    gaps["name"].append(mkey)
                elif jm[0] == "def":
                    gaps["arg"] += _arg_gaps(mkey, jm, members[m])
        if jp.name == "__init__.py":
            for name in _exports(jp):
                if _resolve(tp, name) is None:
                    gaps["export"].append(f"{rel}::{name}")
    return gaps


def _reason(key: str):
    for reason, patterns in EXCEPTIONS:
        if any(fnmatchcase(key, p) for p in patterns):
            return reason
    return None


def _unexplained(kind):
    return [k for k in _gaps()[kind] if _reason(k) is None]


def test_the_trees_are_read():
    assert len(list(JAX.rglob("*.py"))) >= 67
    assert "gd_multi_step" in _bindings(JAX / "system.py")
    assert _resolve(PORT / "__init__.py", "OCPConfig")[0] == "class"


@pytest.mark.parametrize("kind", ["file", "name", "arg", "export"])
def test_every_jax_name_has_a_counterpart_or_a_reason(kind):
    missing = _unexplained(kind)
    assert not missing, "no counterpart and no reason:\n" + "\n".join(missing)


def test_every_exception_is_still_needed():
    keys = [k for kind in _gaps().values() for k in kind]
    for reason, patterns in EXCEPTIONS:
        assert reason
        for p in patterns:
            assert any(fnmatchcase(k, p) for k in keys), p
