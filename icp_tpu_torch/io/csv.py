"""CSV point-cloud I/O with the reference loader's exact contract.

Reference semantics (``src/load.cc:3-97``):
  * point count = line count - 1 (exactly one header row is skipped);
  * each data line contributes the first 3 comma-separated floats; extra
    columns are ignored (``cow_tr2.txt`` has ``Points_Magnitude,Point ID``);
  * unparsable fields default to 0.0 (C ``sscanf`` leaves them untouched);
  * unopenable file -> stderr message + exit code 2 (``src/load.cc:13``);
  * writer emits header ``Points_0,Points_1,Points_2`` then one
    ``x,y,z`` row per point with C++ ostream default formatting
    (6 significant digits, ``%g``), to ``output.txt`` by default
    (``src/load.cc:68-97``).

Layout note: the reference stores clouds 3xN (column = point,
``src/load.cc:31``).  This package stores N x 3 (row = point), as
``icp_tpu`` does.  The module is a copy of ``icp_tpu/io/csv.py`` (numpy only:
importing ``icp_tpu`` would pull in JAX).

A native C++ fast parser (``native/fast_csv.cc``) is used for large clouds when
available; the NumPy path is the always-available fallback and the semantics
oracle.
"""

from __future__ import annotations

import re
import sys
import numpy as np

# strtod-style numeric prefix: optional whitespace, then a float literal
# (hex/decimal/exponent/inf/nan).  Used to mirror sscanf("%lf,%lf,%lf")
# exactly — C99 %lf accepts hex floats (0x1A -> 26.0), so the hex branch
# comes FIRST or "0x1A" would parse as just "0"; a bare "0x" with no hex
# digit falls through to the decimal branch as "0" (strtod behavior).
_NUM_PREFIX = re.compile(
    r"[ \t\r\n\f\v]*("
    r"[+-]?0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
    r"(?:[pP][+-]?\d+)?"
    r"|[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|[+-]?inf(?:inity)?|[+-]?nan(?:\([0-9a-zA-Z_]*\))?)",
    re.IGNORECASE,
)


def _strtod(tok: str) -> float:
    if tok.lstrip("+-")[:2].lower() == "0x":
        return float.fromhex(tok)
    # C99 strtod consumes an optional nan(n-char-seq) payload; Python's
    # float() does not, so strip it (the payload never affects the value
    # for doubles in practice).
    if "(" in tok:
        tok = tok[: tok.index("(")]
    return float(tok)


def _parse_lines_exact(lines: list[str]) -> np.ndarray:
    """Slow-but-exact parser mirroring sscanf('%lf,%lf,%lf') per line.

    scanf semantics (reference ``src/load.cc:26``): each ``%lf`` parses the
    longest numeric prefix (leading whitespace skipped); the literal ``,`` in
    the format must match the very next character.  So ``1.5abc,2,3`` yields
    ``[1.5, 0, 0]`` — the prefix is KEPT, then the comma match fails and the
    rest of the line is ignored (fields default to 0).
    """
    out = np.zeros((len(lines), 3), dtype=np.float64)
    for i, line in enumerate(lines):
        pos = 0
        for d in range(3):
            m = _NUM_PREFIX.match(line, pos)
            if not m:
                break
            out[i, d] = _strtod(m.group(1))
            pos = m.end()
            if d < 2:
                if pos >= len(line) or line[pos] != ",":
                    break  # sscanf: literal ',' must immediately follow
                pos += 1
    return out


def load_matrices(
    paths: list[str], *, dtype=np.float64, use_native: bool = True
) -> list[np.ndarray]:
    """Load several clouds; the native path parses all files in parallel
    (one C++ thread per file — the SLAM chain ingest).  Per-file semantics
    identical to ``load_matrix`` (which is also the fallback)."""
    if use_native and len(paths) > 1:
        from icp_tpu_torch.io import native

        arrays = native.try_load_batch(list(paths))
        if arrays is not None:
            for p in paths:
                print(f"[load] opening {p}", file=sys.stderr)
                print("[load] loading file into matrix", file=sys.stderr)
            return [a.astype(dtype, copy=False) for a in arrays]
    return [load_matrix(p, dtype=dtype, use_native=use_native)
            for p in paths]


def load_matrix(
    path: str, *, dtype=np.float64, use_native: bool = True
) -> np.ndarray:
    """Load a point cloud CSV as an (N, 3) float array.

    Mirrors reference ``load_matrix`` / ``cpu_load_matrix``
    (``src/load.cc:3-66``) including the `[load]` stderr progress lines and
    exit(2) on an unopenable file.
    """
    print(f"[load] opening {path}", file=sys.stderr)
    if use_native:
        from icp_tpu_torch.io import native

        arr = native.try_load(path)
        if arr is not None:
            print("[load] loading file into matrix", file=sys.stderr)
            return arr.astype(dtype, copy=False)
    try:
        with open(path, "r") as f:
            lines = f.read().splitlines()
    except OSError:
        print(f"[load] {path} could not be opened", file=sys.stderr)
        sys.exit(2)
    print("[load] loading file into matrix", file=sys.stderr)
    data_lines = lines[1:]  # skip exactly one header row
    try:
        # Fast path: clean numeric CSV (possibly with extra columns).  Any
        # whitespace inside a line defeats the fast path: genfromtxt strips
        # padding around fields while the scanf contract treats a space
        # before the separator as a match failure (``1.5 ,2,3`` -> [1.5,0,0]).
        if any((" " in ln) or ("\t" in ln) for ln in data_lines):
            raise ValueError("whitespace in fields; use exact parser")
        arr = np.genfromtxt(
            data_lines, delimiter=",", usecols=(0, 1, 2), dtype=np.float64
        )
        if arr.ndim == 1:
            arr = arr.reshape(1, 3)
        if np.isnan(arr).any():
            raise ValueError("non-numeric fields; fall back to exact parser")
    except Exception:
        arr = _parse_lines_exact(data_lines)
    return arr.astype(dtype, copy=False)


def write_matrix(points: np.ndarray, path: str = "output.txt") -> None:
    """Write an (N, 3) cloud in the reference's output format.

    Mirrors reference ``write_matrix`` (``src/load.cc:68-97``): header row,
    ``%g`` formatting (C++ ostream default 6 significant digits), trailing
    newline, and the `[output]` stderr notice.
    """
    points = np.asarray(points, dtype=np.float64)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"expected (N, 3) cloud, got {points.shape}")
    with open(path, "w") as f:
        f.write("Points_0,Points_1,Points_2\n")
        for row in points:
            f.write(f"{row[0]:g},{row[1]:g},{row[2]:g}\n")
    print(f'[output] output file "{path}" was generated.', file=sys.stderr)
