"""ASCII XDMF export for ParaView (own copy of ``ocean_jax/io/xdmf.py``).

A self-contained .xdmf (XML with inline data, no HDF5 dependency) holding
the triangle mesh and vertex-valued vector/scalar attributes. P2 fields
are exported at their vertex values (ParaView renders linear
interpolation; the ``.npz`` checkpoints of ``io.checkpoint`` reload at
full precision). Inputs are numpy arrays; the text equals what the JAX
package writes for the same arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..mesh.structured import Mesh2D


def _fmt(arr: np.ndarray, per_line: int = 6) -> str:
    flat = np.asarray(arr).reshape(-1)
    lines = []
    for i in range(0, len(flat), per_line):
        lines.append(" ".join(repr(float(v)) if flat.dtype.kind == "f"
                              else str(int(v))
                              for v in flat[i:i + per_line]))
    return "\n".join(lines)


def write_xdmf(path: str, mesh: Mesh2D,
               vector_fields: Optional[Dict[str, np.ndarray]] = None,
               scalar_fields: Optional[Dict[str, np.ndarray]] = None,
               name: str = "mesh") -> None:
    """vector_fields: {name: (nv, 2)} vertex values;
    scalar_fields: {name: (nv,)}."""
    nv = mesh.num_vertices
    nc = mesh.num_cells
    geo = np.concatenate(
        [mesh.vertices, np.zeros((nv, 1))], axis=1)     # XY -> XYZ
    parts = [
        '<?xml version="1.0"?>',
        '<Xdmf Version="3.0">',
        '  <Domain>',
        f'    <Grid Name="{name}" GridType="Uniform">',
        f'      <Topology TopologyType="Triangle" '
        f'NumberOfElements="{nc}">',
        f'        <DataItem Dimensions="{nc} 3" NumberType="Int" '
        'Format="XML">',
        _fmt(mesh.cells),
        '        </DataItem>',
        '      </Topology>',
        '      <Geometry GeometryType="XYZ">',
        f'        <DataItem Dimensions="{nv} 3" Format="XML">',
        _fmt(geo),
        '        </DataItem>',
        '      </Geometry>',
    ]
    for fname, vals in (vector_fields or {}).items():
        v3 = np.concatenate([np.asarray(vals)[:nv],
                             np.zeros((nv, 1))], axis=1)
        parts += [
            f'      <Attribute Name="{fname}" AttributeType="Vector" '
            'Center="Node">',
            f'        <DataItem Dimensions="{nv} 3" Format="XML">',
            _fmt(v3),
            '        </DataItem>',
            '      </Attribute>',
        ]
    for fname, vals in (scalar_fields or {}).items():
        parts += [
            f'      <Attribute Name="{fname}" AttributeType="Scalar" '
            'Center="Node">',
            f'        <DataItem Dimensions="{nv}" Format="XML">',
            _fmt(np.asarray(vals)[:nv]),
            '        </DataItem>',
            '      </Attribute>',
        ]
    parts += ['    </Grid>', '  </Domain>', '</Xdmf>', '']
    with open(path, "w") as fh:
        fh.write("\n".join(parts))


def write_velocity_pressure(path_u: str, path_p: str, mesh: Mesh2D,
                            w: np.ndarray, n_p2: int) -> None:
    """Export the mixed state (numpy) like the reference's velocity.xdmf /
    pressure.xdmf pair."""
    u = np.asarray(w[: 2 * n_p2]).reshape(n_p2, 2)[: mesh.num_vertices]
    p = np.asarray(w[2 * n_p2:])[: mesh.num_vertices]
    write_xdmf(path_u, mesh, vector_fields={"u": u})
    write_xdmf(path_p, mesh, scalar_fields={"p": p})
