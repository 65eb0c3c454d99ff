"""Minimal VTK (.vtu legacy XML) writers.

Rebuild of [R] pyamg/vis/vtk_writer.py (SURVEY.md §2.3, (M)):
serialize point/cell meshes with attached data for ParaView/VisIt.
Pure-python XML emission, no external dependencies.
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_vtu", "write_basic_mesh"]

# VTK cell type ids
_VTK_CELL_TYPES = {
    "vertex": 1,
    "line": 3,
    "tri": 5,
    "quad": 9,
    "tet": 10,
    "hex": 12,
}
_CELL_NODES = {1: 1, 3: 2, 5: 3, 9: 4, 10: 4, 12: 8}


def write_vtu(fname, V, cells, pdata=None, cdata=None):
    """Write an unstructured grid .vtu file.

    Parameters
    ----------
    fname : str or file-like
    V : (n, 2 or 3) vertex coordinates
    cells : dict {vtk_cell_id: (ncells, nodes_per_cell) int array}
    pdata : dict name -> (n,) or (n, k) point data
    cdata : dict name -> per-cell data (concatenated in cell-dict order)
    """
    V = np.asarray(V, dtype=float)
    if V.shape[1] == 2:
        V = np.hstack([V, np.zeros((V.shape[0], 1))])
    n_points = V.shape[0]

    conn, offsets, types = [], [], []
    off = 0
    for ctype, arr in cells.items():
        arr = np.asarray(arr, dtype=np.int64).reshape(-1, _CELL_NODES[ctype])
        for row in arr:
            conn.extend(row.tolist())
            off += len(row)
            offsets.append(off)
            types.append(ctype)
    n_cells = len(types)

    def ascii_block(a, fmt="{:.8g}"):
        a = np.asarray(a)
        return " ".join(fmt.format(float(x)) if a.dtype.kind == "f"
                        else str(int(x)) for x in a.ravel())

    out = []
    out.append('<?xml version="1.0"?>')
    out.append('<VTKFile type="UnstructuredGrid" version="0.1" '
               'byte_order="LittleEndian">')
    out.append("  <UnstructuredGrid>")
    out.append(f'    <Piece NumberOfPoints="{n_points}" '
               f'NumberOfCells="{n_cells}">')
    out.append("      <Points>")
    out.append('        <DataArray type="Float64" NumberOfComponents="3" '
               'format="ascii">')
    out.append("          " + ascii_block(V))
    out.append("        </DataArray>")
    out.append("      </Points>")
    out.append("      <Cells>")
    out.append('        <DataArray type="Int64" Name="connectivity" '
               'format="ascii">')
    out.append("          " + ascii_block(np.asarray(conn)))
    out.append("        </DataArray>")
    out.append('        <DataArray type="Int64" Name="offsets" '
               'format="ascii">')
    out.append("          " + ascii_block(np.asarray(offsets)))
    out.append("        </DataArray>")
    out.append('        <DataArray type="UInt8" Name="types" '
               'format="ascii">')
    out.append("          " + ascii_block(np.asarray(types)))
    out.append("        </DataArray>")
    out.append("      </Cells>")
    if pdata:
        out.append("      <PointData>")
        for name, arr in pdata.items():
            arr = np.asarray(arr)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            out.append(f'        <DataArray type="Float64" Name="{name}" '
                       f'NumberOfComponents="{ncomp}" format="ascii">')
            out.append("          " + ascii_block(arr.astype(float)))
            out.append("        </DataArray>")
        out.append("      </PointData>")
    if cdata:
        out.append("      <CellData>")
        for name, arr in cdata.items():
            arr = np.asarray(arr)
            out.append(f'        <DataArray type="Float64" Name="{name}" '
                       'NumberOfComponents="1" format="ascii">')
            out.append("          " + ascii_block(arr.astype(float)))
            out.append("        </DataArray>")
        out.append("      </CellData>")
    out.append("    </Piece>")
    out.append("  </UnstructuredGrid>")
    out.append("</VTKFile>")

    text = "\n".join(out)
    if hasattr(fname, "write"):
        fname.write(text)
    else:
        with open(fname, "w") as f:
            f.write(text)


def write_basic_mesh(fname, V, E2V, mesh_type="tri", pdata=None, cdata=None):
    """Write a single-cell-type mesh ([R] vtk_writer.py::write_basic_mesh)."""
    ctype = _VTK_CELL_TYPES[mesh_type]
    write_vtu(fname, V, {ctype: np.asarray(E2V)}, pdata=pdata, cdata=cdata)
