"""Native (C++) host kernels with pure-Python fallbacks.

The reference's native surface is its C++/Eigen core plus the glmgen
``tf_dp`` C kernel; here the device compute path is JAX/XLA, and the native
layer covers the *host-side* work the reference also did natively:

- ``tv1d_prox``      exact taut-string TV prox (tf_dp equivalent)
- ``min_fill_order`` block-Cholesky symbolic elimination ordering

The library is built from ``*.cc`` at first use (or ahead of time with
``python -m epsilon_tpu.native.build``); it is never committed.  All callers
fall back to the numpy implementations when it cannot be built.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

from .build import OUT as _LIB_PATH, build as _build

_lib: Optional[ctypes.CDLL] = None
_checked = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    if not os.path.exists(_LIB_PATH):
        try:
            _build(verbose=False)
        except (OSError, subprocess.CalledProcessError) as e:
            logging.getLogger("epsilon_tpu").warning(
                "native library build failed (%s); using numpy fallbacks", e)
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.tv1d_prox.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_double]
        lib.tv1d_prox_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
        lib.min_fill_order.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def tv1d_prox(y: np.ndarray, lam: float) -> np.ndarray:
    """Exact TV prox; native if built, else the numpy taut string."""
    lib = _load()
    y = np.ascontiguousarray(y, dtype=np.float64)
    if lib is None:
        from ..ops.prox.tv1d import tv1d_exact_numpy
        return tv1d_exact_numpy(y, lam)
    x = np.empty_like(y)
    lib.tv1d_prox(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.size, float(lam))
    return x


def tv1d_prox_batch(Y: np.ndarray, lams: np.ndarray) -> np.ndarray:
    lib = _load()
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    lams = np.ascontiguousarray(np.broadcast_to(lams, (Y.shape[0],)),
                                dtype=np.float64)
    if lib is None:
        from ..ops.prox.tv1d import tv1d_exact_numpy
        return np.stack([tv1d_exact_numpy(Y[i], lams[i])
                         for i in range(Y.shape[0])])
    X = np.empty_like(Y)
    lib.tv1d_prox_batch(
        Y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        Y.shape[0], Y.shape[1],
        lams.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return X


def min_fill_order(nnz: np.ndarray, dims: np.ndarray) -> Optional[np.ndarray]:
    """Native min-fill ordering; None if library unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = dims.size
    nnz = np.ascontiguousarray(nnz, dtype=np.int64)
    dims = np.ascontiguousarray(dims, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    lib.min_fill_order(
        n, nnz.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return order
