"""Legacy-dolfin HDF5 velocity checkpoints written for the tests, in the
layout ``ocean_torch/io/dolfin_h5.py`` reads: the mesh's vertices
permuted, its cells renumbered and each cell's local vertices rotated,
the dofs scattered by a random permutation, all from a numpy seed. Needs
h5py (imported inside the function).
"""

from __future__ import annotations

import numpy as np


def write_dolfin_velocity(path: str, mesh, cell_dofs_p2: np.ndarray,
                          u: np.ndarray, name: str = "u",
                          seed: int = 0) -> None:
    """Write the P2 velocity ``u`` (n_p2, 2), numbered by ``cell_dofs_p2``
    (nc, 6) on ``mesh``, as a dolfin checkpoint under ``name/name_0``."""
    import h5py

    rng = np.random.default_rng(seed)
    nv, nc = mesh.num_vertices, mesh.num_cells
    n_p2 = u.shape[0]
    pv = rng.permutation(nv)                  # dolfin vertex j = ours pv[j]
    ours_to_theirs = np.argsort(pv)
    pc = rng.permutation(nc)                  # dolfin cell c = ours pc[c]
    dperm = rng.permutation(2 * n_p2)         # our dof 2s+comp → dolfin's
    vector = np.empty(2 * n_p2)
    vector[dperm] = u.reshape(-1)
    topo = np.empty((nc, 3), dtype=np.int64)
    cell_dofs = np.empty((nc, 12), dtype=np.int64)
    for c, oc in enumerate(pc):
        loc = np.roll(np.arange(3), rng.integers(3))   # dolfin local a ↔ ours
        topo[c] = ours_to_theirs[mesh.cells[oc][loc]]
        for comp in range(2):
            cell_dofs[c, comp * 6:comp * 6 + 3] = \
                dperm[2 * cell_dofs_p2[oc, loc] + comp]
            cell_dofs[c, comp * 6 + 3:comp * 6 + 6] = \
                dperm[2 * cell_dofs_p2[oc, 3 + loc] + comp]
    with h5py.File(path, "w") as fh:
        grp = fh.create_group(f"{name}/{name}_0")
        grp["mesh/geometry"] = mesh.vertices[pv]
        grp["mesh/topology"] = topo
        grp["cell_dofs"] = cell_dofs.reshape(-1, 1)
        grp["vector"] = vector
