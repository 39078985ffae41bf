"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``; pointers and
the stream are passed as Python ints. Libraries are built at first use
into ``ocean_torch/_build/`` (gitignored), named by a hash of the source
and flags so an edited source rebuilds. All missing libraries are
compiled at once, one ``nvcc`` process per source, in parallel.
``csrc/warp_groups.cuh`` holds the warp grouping that the two scatter
kernels (point sources, segment sum) share.

``--fmad=false`` is deliberate: no multiply-add is contracted into an
FMA, so every double operation rounds as PyTorch's elementwise kernels
do and each kernel agrees with its plain version bit for bit (escape
flags included; see ``csrc/grid.cuh``).

Launch counts: each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCES = {
    "primal_ode": "primal_ode.cu",
    "adjoint_ode": "adjoint_ode.cu",
    "point_sources": "point_sources.cu",
    "p1_eval": "p1_eval.cu",
    "segment_sum": "segment_sum.cu",
}
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

WARP = 32                        # threads of a warp

LAUNCHES = {name: 0 for name in SOURCES}
_LIBS = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


class Geom(ctypes.Structure):
    """ctypes mirror of ``struct Geom`` in ``csrc/grid.cuh``."""

    _fields_ = [(n, ctypes.c_double) for n in (
        "ox", "oy", "hx", "hy", "xmin", "ymin", "xmax", "ymax",
        "xmin_e", "ymin_e", "xmax_e", "ymax_e")] + [
        ("nx", ctypes.c_int), ("ny", ctypes.c_int)]


def geom(loc, eps: float) -> Geom:
    """Kernel geometry of a uniform ``mesh.locate.Locator``; the slack
    thresholds are computed here in Python floats exactly as the plain
    ``in_domain`` computes them."""
    if loc.domain != "rect" or loc.diagonal != "right":
        raise NotImplementedError(
            "the CUDA kernels support uniform rectangles with the 'right' "
            "diagonal only")
    xmin, ymin, xmax, ymax = loc.extent
    return Geom(loc.origin[0], loc.origin[1], loc.spacing[0],
                loc.spacing[1], xmin, ymin, xmax, ymax,
                xmin - eps, ymin - eps, xmax + eps, ymax + eps,
                loc.grid_shape[0], loc.grid_shape[1])


def nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        p = Path(root) / "bin" / "nvcc"
        if root and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str, extra_flags=()) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(extra_flags)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named kernels (default: all) that are not built yet,
    all nvcc processes in parallel. Returns {name: compiler output} for
    the ones compiled (with ``verbose``, ptxas register/spill reports).
    Raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    extra = ["-Xptxas=-v"] if verbose else []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc()] + NVCC_FLAGS + extra + [
            "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, building all missing
    kernels first."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


VOIDP, INT, LONG, DOUBLE = (ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_double)


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A launch function of a kernel library with its C signature set
    (every launch function returns cudaGetLastError() as an int)."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, status: int) -> None:
    """Raise on a refused launch (cudaGetLastError after the launch)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check the wrapper's inputs: CUDA, contiguous, one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
