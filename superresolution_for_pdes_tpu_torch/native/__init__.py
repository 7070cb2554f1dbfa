"""ctypes bindings for the native (C++) float64 Poisson oracle (port of
``native/``).

``poisson_oracle.cpp`` (this package's copy of the JAX package's source) is
built with ``g++`` at the first call into ``build/native/`` at the repository
root, with the JAX package's ``Makefile`` flags but one (:data:`CXX_FLAGS`),
and cached by a hash of the source, the flags and the host. It exposes, with the JAX package's signatures:

* :func:`apply_operator` -- ``diag(theta) @ L @ u``, batched;
* :func:`solve_cg` -- batched CG solve of the reference system.

A host-side, scipy-free parity oracle for the port's solvers; not a GPU
kernel. numpy in, numpy out.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "poisson_oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# The JAX package's Makefile flags without -fopenmp: its pragma only spreads
# the batch's independent samples over threads, so the bits are the same, and
# OpenMP's runtime is missing where some compilers are installed.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wno-unknown-pragmas",
             "-shared")


def library_path() -> Path:
    """The library's path, by a hash of the source, the flags and the host:
    ``-march=native`` makes the binary the building machine's own."""
    key = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + platform.node().encode()
    return BUILD_DIR / f"libpoisson_oracle-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """The oracle's shared library, compiled if it is not built yet."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{done.stdout}{done.stderr}")
        os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.poisson_apply_operator.argtypes = [dp, dp, dp, ctypes.c_int64, ctypes.c_int64]
    lib.poisson_apply_operator.restype = None
    lib.poisson_solve_cg.argtypes = [
        dp, dp, dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
    ]
    lib.poisson_solve_cg.restype = ctypes.c_int64
    return lib


def _as_batches(a, b) -> tuple[np.ndarray, np.ndarray]:
    """Both fields as contiguous float64 ``(batch, n, n)`` arrays of one shape
    (the native code reads ``batch * n * n`` values of each)."""
    out = []
    for x in (a, b):
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
        out.append(x[None] if x.ndim == 2 else x)
    if out[0].shape != out[1].shape or out[0].ndim != 3 or out[0].shape[-1] != out[0].shape[-2]:
        raise ValueError(f"the oracle takes two (n, n) or (batch, n, n) fields of one shape, "
                         f"got {np.shape(a)} and {np.shape(b)}")
    return out[0], out[1]


def _ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def apply_operator(theta, u) -> np.ndarray:
    """Native ``diag(theta) @ L @ u`` over the last two axes (float64)."""
    lib = _lib()
    squeeze = np.asarray(u).ndim == 2
    theta_b, u_b = _as_batches(theta, u)
    out = np.empty_like(u_b)
    lib.poisson_apply_operator(_ptr(theta_b), _ptr(u_b), _ptr(out),
                               u_b.shape[0], u_b.shape[-1])
    return out[0] if squeeze else out


def solve_cg(f, theta, tol: float = 1e-12, max_iters: int = 100_000) -> np.ndarray:
    """Native batched CG solve of ``diag(theta) L u = f`` (float64)."""
    lib = _lib()
    squeeze = np.asarray(f).ndim == 2
    f_b, theta_b = _as_batches(f, theta)
    u = np.empty_like(f_b)
    iters = lib.poisson_solve_cg(_ptr(f_b), _ptr(theta_b), _ptr(u),
                                 f_b.shape[0], f_b.shape[-1], tol, max_iters)
    if iters < 0:
        raise RuntimeError("native CG failed to converge")
    return u[0] if squeeze else u
