"""Reader for legacy-dolfin HDF5 velocity checkpoints (port of
``ocean_jax/io/dolfin_h5.py``).

The reference writes its converged velocity fields with dolfin's
``XDMFFile.write_checkpoint`` and reloads one as the comparison flow ū.
This module maps such a checkpoint onto the port's dof numbering.

Legacy dolfin checkpoint layout (velocity, P2 vector on triangles), under
the group ``<name>/<name>_0``:
  * ``mesh/geometry`` (nv, 2), ``mesh/topology`` (nc, 3),
  * ``cell_dofs`` (nc*12, 1): per cell, component-blocked local dofs —
    x-components at (v0, v1, v2, e0, e1, e2) then y-components — where
    edge i is the edge opposite local vertex i (dolfin's UFC ordering,
    the port's too),
  * ``vector``: the dof values indexed by ``cell_dofs``.

h5py is imported when a file is read: without it the read raises
``ImportError``.
"""

from __future__ import annotations

import numpy as np

from ..mesh.structured import Mesh2D
from ..fem.spaces import TaylorHoodSpace


def read_checkpoint_velocity(path: str, mesh: Mesh2D,
                             space: TaylorHoodSpace,
                             name: str = "u") -> np.ndarray:
    """Read a dolfin velocity checkpoint and return its (n_p2, 2) dof
    values in the port's numbering. The dolfin mesh must be the port's
    mesh: vertices may be permuted and cells renumbered (vertices are
    matched by coordinates rounded to 1e-10, cells by their sorted vertex
    triples). A checkpoint of another mesh raises ``ValueError``."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading the dolfin checkpoint {path} needs h5py, which is "
            "not installed") from e

    with h5py.File(path, "r") as fh:
        grp = fh[name][f"{name}_0"]
        geom = np.asarray(grp["mesh"]["geometry"])
        topo = np.asarray(grp["mesh"]["topology"]).astype(np.int64)
        cell_dofs = np.asarray(grp["cell_dofs"]).reshape(-1)
        vec = np.asarray(grp["vector"]).reshape(-1)

    nc = topo.shape[0]
    if cell_dofs.shape[0] != 12 * nc:
        raise ValueError(f"{path}: {cell_dofs.shape[0]} cell dofs for {nc} "
                         "cells, expected a P2 vector checkpoint (12 a cell)")
    cell_dofs = cell_dofs.reshape(nc, 12)

    def key(arr):
        return np.round(arr * 1e10).astype(np.int64)

    if geom.shape[0] != mesh.num_vertices:
        raise ValueError(
            f"checkpoint mesh has {geom.shape[0]} vertices but ours has "
            f"{mesh.num_vertices} — resolutions must match")
    ours = {tuple(k): i for i, k in enumerate(key(mesh.vertices))}
    try:
        theirs_to_ours = np.array([ours[tuple(k)] for k in key(geom)],
                                  dtype=np.int64)
    except KeyError as e:
        raise ValueError("checkpoint mesh geometry does not match ours "
                         f"(vertex {e} not found)") from None

    our_cells_sorted = {tuple(sorted(c)): i
                        for i, c in enumerate(mesh.cells.tolist())}
    u = np.zeros((space.n_p2, 2))
    cell_dofs_p2 = space.cell_dofs_p2.cpu().numpy()
    for c in range(nc):
        tri = theirs_to_ours[topo[c]]
        oc = our_cells_sorted.get(tuple(sorted(tri.tolist())))
        if oc is None:
            raise ValueError(f"checkpoint cell {c} is not a cell of ours")
        # dolfin local vertex a ↔ our local vertex with the same global
        # id; dolfin local edge i is opposite local vertex i, as ours
        perm = np.array([np.nonzero(mesh.cells[oc] == gv)[0][0]
                         for gv in tri])
        for comp in range(2):
            u[cell_dofs_p2[oc, perm], comp] = vec[cell_dofs[c, comp * 6:
                                                            comp * 6 + 3]]
            u[cell_dofs_p2[oc, 3 + perm], comp] = vec[
                cell_dofs[c, comp * 6 + 3:comp * 6 + 6]]
    return u
