"""ctypes bindings for the native columnar loader (loader.cpp).

Builds the shared library on first use with the toolchain g++ (cached next
to the source); if no compiler is available the pure-Python fallback in
`parse_table_py` keeps every caller working with identical semantics.

Reference contract being accelerated: the line-loop readers of
`util/io/reader/` (LockFileReader.java:69-103 and subclasses) — comment
skip, BOM strip, skip-line-on-parse-failure.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cpp")
_SO = os.path.join(_HERE, "_libbaloader.so")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _load_library():
    """Compile (if needed) and load the native loader; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.ba_parse_table.restype = ctypes.c_void_p
        lib.ba_parse_table.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char,
            ctypes.POINTER(ctypes.c_char_p)]
        lib.ba_rows.restype = ctypes.c_int64
        lib.ba_rows.argtypes = [ctypes.c_void_p]
        lib.ba_nfloat.restype = ctypes.c_int
        lib.ba_nfloat.argtypes = [ctypes.c_void_p]
        lib.ba_nkeys.restype = ctypes.c_int
        lib.ba_nkeys.argtypes = [ctypes.c_void_p]
        lib.ba_copy_floats.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ba_copy_keys.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ba_copy_ncols.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ba_num_unique.restype = ctypes.c_int64
        lib.ba_num_unique.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ba_unique_blob_size.restype = ctypes.c_int64
        lib.ba_unique_blob_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ba_copy_unique.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.ba_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


@dataclass
class ParsedTable:
    """Columnar parse result.

    floats: [rows, nf] float64, NaN where the row had no such column.
    keys:   per 's' column, (ids [rows] int32 with -1 missing, list of
            unique strings in first-seen order).
    ncols:  [rows] int32 token count per kept row.
    """

    floats: np.ndarray
    keys: list[tuple[np.ndarray, list[str]]]
    ncols: np.ndarray

    @property
    def rows(self) -> int:
        return int(self.ncols.shape[0])


def parse_table(path, colspec: str, comment: str = "#") -> ParsedTable:
    """Parse a whitespace-column table; native if possible, else Python."""
    lib = _load_library()
    if lib is None:
        return parse_table_py(path, colspec, comment)
    err = ctypes.c_char_p()
    h = lib.ba_parse_table(
        os.fspath(path).encode(), colspec.encode(),
        comment.encode()[0] if comment else 0, ctypes.byref(err))
    if not h:
        raise OSError(err.value.decode() if err.value else "parse failed")
    try:
        rows = lib.ba_rows(h)
        nf = lib.ba_nfloat(h)
        nk = lib.ba_nkeys(h)
        floats = np.empty((rows, nf), np.float64)
        if floats.size:
            lib.ba_copy_floats(h, floats.ctypes.data_as(ctypes.c_void_p))
        ncols = np.empty(rows, np.int32)
        if rows:
            lib.ba_copy_ncols(h, ncols.ctypes.data_as(ctypes.c_void_p))
        keys = []
        if nk:
            all_ids = np.empty((rows, nk), np.int32)
            if all_ids.size:
                lib.ba_copy_keys(h, all_ids.ctypes.data_as(ctypes.c_void_p))
            for k in range(nk):
                n_u = lib.ba_num_unique(h, k)
                blob_size = lib.ba_unique_blob_size(h, k)
                blob = ctypes.create_string_buffer(max(1, int(blob_size)))
                offsets = np.empty(n_u + 1, np.int64)
                lib.ba_copy_unique(h, k, blob,
                                   offsets.ctypes.data_as(ctypes.c_void_p))
                raw = blob.raw[:blob_size]
                uniq = [raw[offsets[i]:offsets[i + 1]].decode("utf-8")
                        for i in range(n_u)]
                keys.append((np.ascontiguousarray(all_ids[:, k]), uniq))
        return ParsedTable(floats=floats, keys=keys, ncols=ncols)
    finally:
        lib.ba_free(h)


def parse_table_py(path, colspec: str, comment: str = "#") -> ParsedTable:
    """Pure-Python reference implementation (identical semantics)."""
    nf = sum(c in "fi" for c in colspec)
    nk = colspec.count("s")
    float_slot, key_slot = {}, {}
    fi = ki = 0
    for c, ch in enumerate(colspec):
        if ch in "fi":
            float_slot[c] = fi
            fi += 1
        elif ch == "s":
            key_slot[c] = ki
            ki += 1
        elif ch != "x":
            raise ValueError(f"bad colspec char {ch!r}")

    frows: list[list[float]] = []
    krows: list[list[int]] = []
    ncols: list[int] = []
    intern: list[dict[str, int]] = [{} for _ in range(nk)]
    uniq: list[list[str]] = [[] for _ in range(nk)]

    with open(path, "r", encoding="utf-8-sig") as fh:
        for line in fh:
            line = line.strip()
            if not line or (comment and line.startswith(comment)):
                continue
            toks = line.split()
            rf = [math.nan] * nf
            rk = [-1] * nk
            bad = False
            for c, tok in enumerate(toks):
                if c >= len(colspec):
                    continue
                ch = colspec[c]
                if ch == "f":
                    try:
                        rf[float_slot[c]] = float(tok)
                    except ValueError:
                        bad = True
                        break
                elif ch == "i":
                    try:
                        rf[float_slot[c]] = float(int(tok))
                    except ValueError:
                        bad = True
                        break
                elif ch == "x":
                    continue
                else:
                    k = key_slot[c]
                    idx = intern[k].get(tok)
                    if idx is None:
                        idx = len(uniq[k])
                        intern[k][tok] = idx
                        uniq[k].append(tok)
                    rk[k] = idx
            if bad:
                continue
            frows.append(rf)
            krows.append(rk)
            ncols.append(len(toks))

    floats = np.asarray(frows, np.float64).reshape(len(frows), nf)
    ids = np.asarray(krows, np.int32).reshape(len(krows), nk)
    keys = [(np.ascontiguousarray(ids[:, k]), uniq[k]) for k in range(nk)]
    return ParsedTable(floats=floats, keys=keys,
                       ncols=np.asarray(ncols, np.int32))
