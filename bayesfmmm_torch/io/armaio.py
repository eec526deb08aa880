"""Readers/writers for Armadillo on-disk formats.

The reference persists MCMC traces as Armadillo files — ascii matrices/cubes
(``arma_ascii``) for most parameters and binary fields-of-cubes for Phi/Gamma
etc. (BFMMM.h:1720-1730).  Post-processing reloads them by file-name
convention (PostProcessing.cpp:144-162).  We speak the same formats so that

  * traces written by this framework can be consumed by the reference's
    post-processing (and vice versa), and
  * the shipped fixture directories ``inst/test-data/{Functional_trace,
    Multivariate_trace, HDFunctional_trace}`` can be used as
    cross-implementation parity tests.

Formats (see Armadillo diskio sources; headers observed in the fixtures):
  ARMA_MAT_TXT_FN008  — "rows cols" + ascii float64 rows
  ARMA_CUB_TXT_FN008  — "rows cols slices" + slices stacked row-wise
  ARMA_FLD_BIN        — "n_rows [n_cols]" + concatenated element payloads
  ARMA_MAT_BIN_FN008 / ARMA_CUB_BIN_FN008 — little-endian float64 payloads,
    column-major (Fortran) order.

The port's own copy of ``bayesfmmm_tpu/io/armaio.py`` (NumPy only);
``tests/test_torch_api.py`` holds the files the two write equal byte for
byte.
"""

from __future__ import annotations

import io
import os

import numpy as np

__all__ = [
    "load_arma", "save_arma_matrix", "save_arma_cube", "save_arma_vector",
    "save_arma_field_of_cubes", "load_trace_dir", "save_trace_dir",
]


def _load_ascii(lines_iter, header):
    if header.startswith("ARMA_MAT_TXT"):
        dims = next(lines_iter).split()
        rows, cols = int(dims[0]), int(dims[1])
        data = np.loadtxt(lines_iter, dtype=np.float64, max_rows=rows)
        return np.atleast_2d(data).reshape(rows, cols)
    if header.startswith("ARMA_CUB_TXT"):
        dims = next(lines_iter).split()
        rows, cols, slices = int(dims[0]), int(dims[1]), int(dims[2])
        data = np.loadtxt(lines_iter, dtype=np.float64, max_rows=rows * slices)
        # cube text: slices stacked vertically, each slice row-major printed
        return data.reshape(slices, rows, cols)
    raise ValueError(f"unsupported ascii header {header!r}")


def _read_bin_payload(f, header):
    if header.startswith("ARMA_MAT_BIN"):
        rows, cols = (int(x) for x in f.readline().split())
        data = np.frombuffer(f.read(rows * cols * 8), dtype="<f8")
        return data.reshape(cols, rows).T  # column-major on disk
    if header.startswith("ARMA_CUB_BIN"):
        rows, cols, slices = (int(x) for x in f.readline().split())
        data = np.frombuffer(f.read(rows * cols * slices * 8), dtype="<f8")
        # each slice stored column-major; slices consecutive
        return data.reshape(slices, cols, rows).transpose(0, 2, 1)
    raise ValueError(f"unsupported binary element header {header!r}")


def load_arma(path: str, prefer_native: bool = True) -> np.ndarray:
    """Load an Armadillo mat/cube (ascii or binary) or field of mats/cubes.

    Cubes are returned with shape (slices, rows, cols) — iteration-major for
    trace files, matching the reference's trace layout where the MCMC
    iteration indexes the slice.  Fields of cubes come back stacked as
    (n_elem, slices, rows, cols) when homogeneous, else a list.

    Ascii files route through the native C++ parser when the shared library
    is built (io/native.py; ~3x faster than the Python path).
    """
    if prefer_native:
        with open(path, "rb") as f:
            head = f.read(12)
        if head.startswith((b"ARMA_MAT_TXT", b"ARMA_CUB_TXT")):
            from bayesfmmm_torch.io import native
            if native.available():
                return native.read_arma_ascii(path)
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        if header.startswith(("ARMA_MAT_TXT", "ARMA_CUB_TXT")):
            rest = io.TextIOWrapper(f, encoding="ascii")
            return _load_ascii(iter(rest), header)
        if header.startswith("ARMA_FLD_BIN"):
            first = f.readline().split()
            n_rows = int(first[0])
            second_pos = f.tell()
            second = f.readline().split()
            if len(second) == 1 and not second[0].startswith(b"ARMA"):
                n_cols = int(second[0])
            else:
                n_cols = 1
                f.seek(second_pos)
            elems = []
            for _ in range(n_rows * n_cols):
                eheader = f.readline().decode().strip()
                elems.append(_read_bin_payload(f, eheader))
            try:
                return np.stack(elems)
            except ValueError:
                return elems
        if header.startswith(("ARMA_MAT_BIN", "ARMA_CUB_BIN")):
            # header line already consumed; dims next
            return _read_bin_payload(f, header)
    raise ValueError(f"unrecognized Armadillo file {path}")


def load_arma_field_info(path: str):
    """Load a binary field returning (stacked_elements, n_rows, n_cols)."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        if not header.startswith("ARMA_FLD_BIN"):
            raise ValueError(f"{path} is not a field file")
        n_rows = int(f.readline().split()[0])
        second_pos = f.tell()
        second = f.readline().split()
        if len(second) == 1 and not second[0].startswith(b"ARMA"):
            n_cols = int(second[0])
        else:
            n_cols = 1
            f.seek(second_pos)
        elems = []
        for _ in range(n_rows * n_cols):
            eheader = f.readline().decode().strip()
            elems.append(_read_bin_payload(f, eheader))
    return np.stack(elems), n_rows, n_cols


def _fmt_row(row) -> str:
    return "".join(f" {v: .16e}" for v in row)


def save_arma_matrix(path: str, mat: np.ndarray) -> None:
    mat = np.atleast_2d(np.asarray(mat, dtype=np.float64))
    with open(path, "w") as f:
        f.write("ARMA_MAT_TXT_FN008\n")
        f.write(f"{mat.shape[0]} {mat.shape[1]}\n")
        for row in mat:
            f.write(_fmt_row(row) + "\n")


def save_arma_vector(path: str, vec: np.ndarray) -> None:
    """Column vector — Armadillo stores vecs as n x 1 matrices in ascii."""
    vec = np.asarray(vec, dtype=np.float64).ravel()
    with open(path, "w") as f:
        f.write("ARMA_MAT_TXT_FN008\n")
        f.write(f"{vec.shape[0]} 1\n")
        for v in vec:
            f.write(f" {v: .16e}\n")


def save_arma_cube(path: str, cube: np.ndarray) -> None:
    """Save (slices, rows, cols) as ARMA_CUB_TXT (slice-major text)."""
    cube = np.asarray(cube, dtype=np.float64)
    assert cube.ndim == 3
    s, r, c = cube.shape
    with open(path, "w") as f:
        f.write("ARMA_CUB_TXT_FN008\n")
        f.write(f"{r} {c} {s}\n")
        for sl in range(s):
            for row in cube[sl]:
                f.write(_fmt_row(row) + "\n")


def save_arma_field_of_cubes(path: str, cubes: np.ndarray,
                             n_cols: int = 1) -> None:
    """Save cubes as ARMA_FLD_BIN of ARMA_CUB_BIN.

    cubes: (n_elem, slices, rows, cols) in Armadillo element order
    (column-major over the field when n_cols > 1, i.e. all of field column
    0 first).
    """
    cubes = np.asarray(cubes, dtype=np.float64)
    assert cubes.ndim == 4
    n_rows = cubes.shape[0] // n_cols
    with open(path, "wb") as f:
        f.write(b"ARMA_FLD_BIN\n")
        f.write(f"{n_rows}\n{n_cols}\n".encode())
        for cube in cubes:
            s, r, c = cube.shape
            f.write(b"ARMA_CUB_BIN_FN008\n")
            f.write(f"{r} {c} {s}\n".encode())
            f.write(cube.transpose(0, 2, 1).astype("<f8").tobytes())


# ---------------------------------------------------------------------------
# Trace-directory contract (BFMMM.h:245-255, 1720-1730; CovAdj additions at
# BFMMM.h:4522-4523 and :5163-5166).  File -> (saver, layout) table.
# Internal trace layout in this framework is iteration-major numpy arrays.
# ---------------------------------------------------------------------------

_PLAIN_FILES = {
    # name: kind — internal shapes given in comments; disk layouts follow
    # the reference trace contract (BFMMM.h:1720-1730, :4522-4523, :5163-5166)
    "Nu": "cube_iter_last",      # (iters, K, P)   -> cube (K, P, iters)
    "Chi": "cube_iter_last",     # (iters, N, M)   -> cube (N, M, iters)
    "Pi": "mat_iter_cols",       # (iters, K)      -> mat  (K, iters)
    "alpha_3": "vec",            # (iters,)
    "A": "cube_iter_last",       # (iters, K, 2)
    "Delta": "cube_iter_last",   # (iters, K, M)
    "Sigma": "vec",              # (iters,)
    "Tau": "mat",                # (iters, K)      -> mat (iters, K)
    "Gamma": "field_cubes",      # (iters, K, P, M) -> [iters](K,P,M) cubes
    "Phi": "field_cubes",        # (iters, K, P, M)
    "Z": "cube_iter_last",       # (iters, N, K)
    # Covariate-adjusted additions
    "Eta": "field_eta",          # (iters, K, P, D) -> [iters](P,D,K) cubes
    "Tau_Eta": "cube_iter_last",  # (iters, K, D)   -> cube (K, D, iters)
    "Xi": "field2d_xi",          # (iters, K, P, D, M) -> [iters,K](P,D,M)
    "Gamma_Xi": "field2d_xi",    # (iters, K, P, D, M)
    "Delta_Xi": "field_dkm",     # (iters, K, M, D) -> [iters](K,M,D) cubes
    "A_Xi": "field_dkm",         # (iters, K, 2, D) -> [iters](K,2,D) cubes
}


def save_trace_dir(directory: str, traces: dict, batch: int = 0) -> None:
    """Write one batch of traces using the reference's file contract.

    ``traces`` maps reference file stems (``Nu``, ``Chi``, ..., optionally
    ``Eta``, ``Tau_Eta``, ``Xi``, ``Gamma_Xi``, ``Delta_Xi``, ``A_Xi``) to
    iteration-major numpy arrays.
    """
    os.makedirs(directory, exist_ok=True)
    q = str(batch)
    for name, arr in traces.items():
        arr = np.asarray(arr, dtype=np.float64)
        path = os.path.join(directory, f"{name}{q}.txt")
        kind = _PLAIN_FILES.get(name)
        if kind == "vec" or (kind is None and arr.ndim == 1):
            save_arma_vector(path, arr)
        elif kind == "mat_iter_cols":
            save_arma_matrix(path, arr.T)
        elif kind == "mat" or (kind is None and arr.ndim == 2):
            save_arma_matrix(path, arr)
        elif kind == "cube_iter_last" or (kind is None and arr.ndim == 3):
            save_arma_cube(path, arr)
        elif kind == "field_cubes" or (kind is None and arr.ndim == 4):
            # internal (iters, K, P, M) -> per-iter arma cube (K rows, P cols,
            # M slices); our cube writer takes slices-first.
            save_arma_field_of_cubes(path, arr.transpose(0, 3, 1, 2))
        elif kind == "field_eta":
            # internal (iters, K, P, D): per-iter cube (P, D, K) — element
            # slices-first layout is already (K, P, D).
            save_arma_field_of_cubes(path, arr)
        elif kind == "field_dkm":
            # internal (iters, K, X, D): per-iter cube (K, X, D) — element
            # slices-first (D, K, X).
            save_arma_field_of_cubes(path, arr.transpose(0, 3, 1, 2))
        elif kind == "field2d_xi":
            # internal (iters, K, P, D, M): 2D field [iters rows, K cols] of
            # (P, D, M) cubes; Armadillo element order is field-column-major
            # (all iters of k=0 first), element layout slices-first (M, P, D).
            it, K = arr.shape[0], arr.shape[1]
            elems = arr.transpose(1, 0, 4, 2, 3).reshape(
                K * it, arr.shape[4], arr.shape[2], arr.shape[3])
            save_arma_field_of_cubes(path, elems, n_cols=K)
        else:
            raise ValueError(f"cannot infer format for {name} ndim={arr.ndim}")


def load_trace_dir(directory: str, names=None, n_files: int | None = None) -> dict:
    """Load and concatenate trace batches ``{name}{q}.txt`` along iterations.

    Mirrors PostProcessing.cpp:144-162: batches q = 0..n_files-1 are loaded
    and concatenated along the iteration axis.  Returns iteration-major
    arrays keyed by file stem.
    """
    if names is None:
        import re
        known = set(_PLAIN_FILES) | {"Eta", "Tau_Eta", "Xi", "Gamma_Xi",
                                     "Delta_Xi", "A_Xi"}
        stems = set()
        for fn in os.listdir(directory):
            if not fn.endswith(".txt"):
                continue
            base = fn[:-4]
            hit = next((s for s in known
                        if base.startswith(s) and base[len(s):].isdigit()), None)
            if hit is not None:
                stems.add(hit)
            else:
                m = re.match(r"^(.*?)(\d+)$", base)
                if m:
                    stems.add(m.group(1))
        names = sorted(stems)
    out = {}
    for name in names:
        kind0 = _PLAIN_FILES.get(name)
        batches = []
        q = 0
        while os.path.exists(os.path.join(directory, f"{name}{q}.txt")):
            fp = os.path.join(directory, f"{name}{q}.txt")
            if kind0 == "field2d_xi":
                arr, n_r, n_c = load_arma_field_info(fp)
                # disk flat (K*iters, M, P, D) field-column-major ->
                # internal (iters, K, P, D, M)
                arr = arr.reshape(n_c, n_r, *arr.shape[1:])                          .transpose(1, 0, 3, 4, 2)
            else:
                arr = load_arma(fp)
            batches.append(arr)
            q += 1
            if n_files is not None and q >= n_files:
                break
        if not batches:
            continue
        kind = _PLAIN_FILES.get(name)
        if kind == "mat_iter_cols":
            batches = [b.T for b in batches]  # (K, iters) -> (iters, K)
        elif kind == "vec":
            batches = [b.ravel() for b in batches]
        elif kind == "field_cubes":
            # disk elements are slices-first (M, K, P); internal is
            # (iters, K, P, M)
            batches = [b.transpose(0, 2, 3, 1) for b in batches]
        elif kind == "field_eta":
            pass  # (iters, K, P, D) both on disk (slices-first) and internal
        elif kind == "field_dkm":
            # disk (iters, D, K, X) -> internal (iters, K, X, D)
            batches = [b.transpose(0, 2, 3, 1) for b in batches]
        elif kind == "field2d_xi":
            pass  # already converted at load time via load_arma_field_info
        out[name] = np.concatenate(batches, axis=0)
    return out
