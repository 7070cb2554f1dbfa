"""Hand-written CUDA stencil kernels K1, K2 and K3 with their plain twins (port
of ``ops/pallas_stencil.py``).

* :func:`kernel_apply_operator` (K1) -- ``theta * (S(u) - 4u) / h^2``,
  replacing ``pallas_apply_operator``; ``theta`` may be a scalar. The physics
  loss runs it forward and, with ``theta = 1``, backward.
* :func:`kernel_residual` (K2) -- ``f - theta * (S(u) - 4u) / h^2``, replacing
  ``pallas_residual``; ``theta`` may be a scalar, so the V-cycle's
  ``theta == -1`` call reads no theta field.
* :func:`kernel_jacobi_smooth` (K3) -- ``iters`` weighted-Jacobi sweeps for
  ``(-L) u = b``, replacing ``pallas_jacobi_smooth``.

The CUDA source is ``csrc/stencil.cu`` (design and bound noted there). On a
CUDA tensor a wrapper launches its kernel on the current stream or raises; on
a CPU tensor it runs the plain twin (:func:`plain_apply_operator`,
:func:`plain_residual`, :func:`plain_jacobi_smooth`), which computes the same
arithmetic in the same
order with the port's ``ops/stencil.py``. Each wrapper counts its kernel
launches in ``.launches``; the twins count nothing.

Leading axes are flattened into one batch axis, as the Pallas wrappers do.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from superresolution_for_pdes_tpu_torch.ops.grid import grid_spacing
from superresolution_for_pdes_tpu_torch.ops.stencil import shift_sum


def _h2(n: int, h: float | None) -> np.float32:
    """``h^2`` rounded to float32 as the Pallas kernels receive it."""
    if h is None:
        h = grid_spacing(n)
    return np.float32(h * h)


def _jacobi_scale(h2: np.float32, omega: float) -> np.float32:
    """``omega h^2 / 4`` in float32, as ``_jacobi_kernel`` forms it."""
    return np.float32(np.float32(omega) * h2 / np.float32(4.0))


def _check_slabs(name: str, u: torch.Tensor, **others) -> None:
    if u.ndim < 2 or u.shape[-1] != u.shape[-2]:
        raise ValueError(f"{name}: u must have shape (..., n, n), got {tuple(u.shape)}")
    for key, t in others.items():
        if t.shape != u.shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, u {tuple(u.shape)}")
        if t.device != u.device:
            raise ValueError(f"{name}: {key} is on {t.device}, u on {u.device}")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def _batch(u: torch.Tensor) -> int:
    batch = u.numel() // (u.shape[-1] * u.shape[-1])
    if not 1 <= batch <= 65535:
        raise ValueError(f"batch of {batch} slabs is outside the grid's z range 1..65535")
    return batch


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {code}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/stencil.cu``'s library (built at the first call) with its C
    signatures declared."""
    from superresolution_for_pdes_tpu_torch.ops._build import load_library

    lib = load_library("stencil")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.srpde_apply_operator.argtypes = [ptr, f, ptr, ptr, i, i, f, ptr]
    lib.srpde_apply_operator.restype = i
    lib.srpde_residual.argtypes = [ptr, f, ptr, ptr, ptr, i, i, f, ptr]
    lib.srpde_residual.restype = i
    lib.srpde_jacobi.argtypes = [ptr, ptr, ptr, i, i, f, f, i, ptr]
    lib.srpde_jacobi.restype = i
    lib.srpde_max_fused_iters.argtypes = []
    lib.srpde_max_fused_iters.restype = i
    return lib


# ----------------------------------------------------------------- plain twins
def plain_apply_operator(theta, u: torch.Tensor, h: float | None = None) -> torch.Tensor:
    """Plain PyTorch ``theta * (S(u) - 4u) / h^2`` (the Pallas body's
    arithmetic, ``/ h^2`` included)."""
    h2 = torch.tensor(_h2(u.shape[-1], h), dtype=u.dtype, device=u.device)
    return theta * ((shift_sum(u) - 4.0 * u) / h2)


def plain_residual(theta, u: torch.Tensor, f: torch.Tensor,
                   h: float | None = None) -> torch.Tensor:
    """Plain PyTorch ``f - theta * (S(u) - 4u) / h^2`` (the Pallas body's
    arithmetic, ``/ h^2`` included)."""
    h2 = torch.tensor(_h2(u.shape[-1], h), dtype=u.dtype, device=u.device)
    lap = (shift_sum(u) - 4.0 * u) / h2
    return f - theta * lap


def plain_jacobi_smooth(u: torch.Tensor, b: torch.Tensor, h: float | None = None,
                        omega: float = 0.8, iters: int = 2) -> torch.Tensor:
    """Plain PyTorch ``iters`` weighted-Jacobi sweeps for ``(-L) u = b``."""
    h2_np = _h2(u.shape[-1], h)
    h2 = torch.tensor(h2_np, dtype=u.dtype, device=u.device)
    scale = torch.tensor(_jacobi_scale(h2_np, omega), dtype=u.dtype, device=u.device)
    for _ in range(iters):
        lap = (shift_sum(u) - 4.0 * u) / h2
        u = u + scale * (b + lap)
    return u


# -------------------------------------------------------------------- wrappers
def _is_scalar(theta) -> bool:
    return not isinstance(theta, torch.Tensor) or theta.ndim == 0


def kernel_apply_operator(theta, u: torch.Tensor, h: float | None = None) -> torch.Tensor:
    """K1: ``theta * (S(u) - 4u) / h^2`` on the last two axes.

    ``theta`` is a Python number, a 0-d tensor, or a tensor of ``u``'s shape.
    """
    scalar = _is_scalar(theta)
    fields = {} if scalar else {"theta": theta}
    _check_slabs("kernel_apply_operator", u, **fields)
    if u.device.type == "cpu":
        return plain_apply_operator(theta, u, h)
    if u.device.type != "cuda":
        raise ValueError(f"kernel_apply_operator: unsupported device {u.device}")
    _check_cuda("kernel_apply_operator", u, *fields.values())
    n = u.shape[-1]
    out = torch.empty_like(u)
    theta_scalar = float(theta) if scalar else 0.0
    with torch.cuda.device(u.device):
        code = _lib().srpde_apply_operator(
            _ptr(None if scalar else theta), theta_scalar, _ptr(u), _ptr(out),
            _batch(u), n, float(_h2(n, h)), _stream(u))
    _raise_on("kernel_apply_operator", code)
    kernel_apply_operator.launches += 1
    return out


def kernel_residual(theta, u: torch.Tensor, f: torch.Tensor,
                    h: float | None = None) -> torch.Tensor:
    """K2: ``f - theta * (S(u) - 4u) / h^2`` on the last two axes.

    ``theta`` is a Python number, a 0-d tensor, or a tensor of ``u``'s shape.
    """
    scalar = _is_scalar(theta)
    fields = {"f": f} if scalar else {"f": f, "theta": theta}
    _check_slabs("kernel_residual", u, **fields)
    if u.device.type == "cpu":
        return plain_residual(theta, u, f, h)
    if u.device.type != "cuda":
        raise ValueError(f"kernel_residual: unsupported device {u.device}")
    _check_cuda("kernel_residual", u, *fields.values())
    n = u.shape[-1]
    out = torch.empty_like(u)
    theta_scalar = float(theta) if scalar else 0.0
    with torch.cuda.device(u.device):
        code = _lib().srpde_residual(
            _ptr(None if scalar else theta), theta_scalar, _ptr(u), _ptr(f), _ptr(out),
            _batch(u), n, float(_h2(n, h)), _stream(u))
    _raise_on("kernel_residual", code)
    kernel_residual.launches += 1
    return out


def kernel_jacobi_smooth(u: torch.Tensor, b: torch.Tensor, h: float | None = None,
                         omega: float = 0.8, iters: int = 2) -> torch.Tensor:
    """K3: ``iters`` weighted-Jacobi sweeps ``u <- u + (omega h^2/4)(b + L u)``.

    One launch runs up to the kernel's fused-sweep limit (4); more sweeps chain
    launches."""
    _check_slabs("kernel_jacobi_smooth", u, b=b)
    if iters < 0:
        raise ValueError(f"kernel_jacobi_smooth: iters must be >= 0, got {iters}")
    if u.device.type == "cpu":
        return plain_jacobi_smooth(u, b, h, omega, iters)
    if u.device.type != "cuda":
        raise ValueError(f"kernel_jacobi_smooth: unsupported device {u.device}")
    _check_cuda("kernel_jacobi_smooth", u, b)
    n = u.shape[-1]
    h2 = _h2(n, h)
    scale = float(_jacobi_scale(h2, omega))
    with torch.cuda.device(u.device):
        lib = _lib()
        fused = lib.srpde_max_fused_iters()
        done = 0
        while done < iters:
            k = min(fused, iters - done)
            out = torch.empty_like(u)
            code = lib.srpde_jacobi(_ptr(u), _ptr(b), _ptr(out), _batch(u), n,
                                    float(h2), scale, k, _stream(u))
            _raise_on("kernel_jacobi_smooth", code)
            kernel_jacobi_smooth.launches += 1
            u = out
            done += k
    return u if iters else u.clone()


kernel_apply_operator.launches = 0
kernel_residual.launches = 0
kernel_jacobi_smooth.launches = 0

KERNELS = (kernel_apply_operator, kernel_residual, kernel_jacobi_smooth)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
