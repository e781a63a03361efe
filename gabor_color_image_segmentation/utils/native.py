"""Lazy build + ctypes loading of the C++ native components.

The native pieces are host-side hot loops that are inherently sequential
(no device mapping): the BSDS one-to-one boundary matcher. They compile once
with g++ into the package's build cache and load via ctypes — no pip, no
pybind11 (neither is available in the build image; SURVEY.md §2.1).
Every native function has a pure-Python fallback at its call site.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "_build")
_LOCK = threading.Lock()
_LIB = None
_LOAD_FAILED = False


def _build_and_load():
    src = os.path.join(_NATIVE_DIR, "boundary_match.cpp")
    out = os.path.join(_BUILD_DIR, "libboundary_match.so")
    if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", out],
            check=True,
            capture_output=True,
        )
    lib = ctypes.CDLL(out)
    lib.greedy_match.restype = ctypes.c_int64
    lib.greedy_match.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


def get_lib():
    """Native library handle, or None if the toolchain is unavailable."""
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _LOAD_FAILED:
            try:
                _LIB = _build_and_load()
            except (OSError, subprocess.CalledProcessError):
                _LOAD_FAILED = True
    return _LIB


def greedy_match_native(pred_pts: np.ndarray, gt_pts: np.ndarray, tol: float):
    """One-to-one greedy boundary matching via the C++ extension.

    pred_pts/gt_pts: (n, 2) int (y, x). Returns (pred_matched, gt_matched)
    bool arrays, or None if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    pred = np.ascontiguousarray(pred_pts, np.int32)
    gt = np.ascontiguousarray(gt_pts, np.int32)
    pm = np.zeros(len(pred), np.uint8)
    gm = np.zeros(len(gt), np.uint8)
    if len(pred) and len(gt):
        lib.greedy_match(
            pred.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(pred),
            gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(gt),
            float(tol),
            pm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            gm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
    return pm.astype(bool), gm.astype(bool)
