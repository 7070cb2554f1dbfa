"""Hand-written CUDA stencil kernels K1, K2 and K3 with their plain twins (port
of ``ops/pallas_stencil.py``).

* :func:`kernel_apply_operator` (K1) -- ``theta * (S(u) - 4u) / h^2``,
  replacing ``pallas_apply_operator``; ``theta`` may be a scalar.
* :func:`kernel_pde_loss_forward` and :func:`kernel_pde_loss_backward` (K1
  with the physics loss fused in) -- the loss
  ``mean(((theta * L(pred * u_std + u_mean) - f) / f_std)^2)`` with the
  backward's seed ``theta * r / f_std`` in one call (the fused kernel and a
  one-block launch that sums its partials), and its gradient
  ``u_std * L((2 g / N) * seed)`` in one launch. These two take ``pred``,
  ``theta`` and ``f`` in float32 or bfloat16 (training with ``--dtype
  bfloat16``): the values are widened to float32 as they are read, the
  statistics, the arithmetic, the loss and the seed are float32, and the
  gradient is written in ``pred``'s dtype. Every other kernel takes float32.
* :func:`kernel_residual` (K2) -- ``f - theta * (S(u) - 4u) / h^2``, replacing
  ``pallas_residual``; ``theta`` may be a scalar, so the V-cycle's
  ``theta == -1`` call reads no theta field.
* :func:`kernel_jacobi_smooth` (K3) -- ``iters`` weighted-Jacobi sweeps for
  ``(-L) u = b``, replacing ``pallas_jacobi_smooth``.
* :func:`kernel_smooth_residual` (K3 then K2 in one launch) -- the V-cycle's
  pre-smooth and its residual ``b - (-L) u``, replacing
  ``pallas_jacobi_smooth`` followed by ``pallas_residual(-1, ...)``.

The CUDA source is ``csrc/stencil.cu`` (design and bound noted there). On a
CUDA tensor a wrapper launches its kernel on the current stream or raises; on
a CPU tensor it runs the plain twin (:func:`plain_apply_operator`,
:func:`plain_pde_residual_loss`, :func:`plain_pde_residual_loss_backward`,
:func:`plain_residual`, :func:`plain_jacobi_smooth`,
:func:`plain_smooth_residual`), which computes the same
arithmetic in the same order with the port's ``ops/stencil.py``. Each wrapper
counts its float32 kernel launches in ``.launches`` and its bfloat16 ones in
``.launches_bf16`` (:func:`launch_counts` reads either); the twins count
nothing.

Leading axes are flattened into one batch axis, as the Pallas wrappers do.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, NamedTuple

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


def _check_cuda(name: str, *tensors: torch.Tensor,
                dtypes: tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the CUDA kernel takes {', '.join(map(str, dtypes))}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


LOSS_DTYPES = (torch.float32, torch.bfloat16)


def _loss_dtype(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of the loss kernels' fields (float32 or bfloat16)."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= set(LOSS_DTYPES):
        raise TypeError(f"{name}: pred, theta and f must share one dtype of float32 and "
                        f"bfloat16, got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def _count_launch(fn, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _check_device(name: str, u: torch.Tensor) -> None:
    if u.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {u.device}")


def _batch(u: torch.Tensor) -> int:
    batch = u.numel() // (u.shape[-1] * u.shape[-1])
    if not 1 <= batch <= 65535:
        raise ValueError(f"batch of {batch} slabs is outside the grid's z range 1..65535")
    return batch


def _vec(n: int, *tensors: torch.Tensor) -> int:
    """1 when the kernels may move float4: rows of 4k floats, 16-byte aligned."""
    return int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _on(t: torch.Tensor):
    """``t``'s device made current for a launch, unless it already is."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _raise_on(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {code}")


class _Lib(NamedTuple):
    apply_operator: Callable
    pde_loss_forward: Callable
    pde_loss_backward: Callable
    residual: Callable
    jacobi: Callable
    max_fused_iters: int


@functools.lru_cache(maxsize=None)
def _lib() -> _Lib:
    """``csrc/stencil.cu``'s entry points (built at the first call), resolved
    once with their C signatures declared."""
    from superresolution_for_pdes_tpu_torch.ops._build import load_library

    lib = load_library("stencil")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "srpde_apply_operator": [ptr, f, ptr, ptr, i, i, f, i, ptr],
        "srpde_pde_loss_forward": [ptr, ptr, ptr, ptr, i, ptr, i, ptr, i, ptr, ptr, ptr,
                                   i, i, f, i, i, ptr],
        "srpde_pde_loss_backward": [ptr, ptr, i, ptr, ptr, i, i, f, i, i, ptr],
        "srpde_residual": [ptr, f, ptr, ptr, ptr, ptr, i, i, f, f, i, i, ptr],
        "srpde_jacobi": [ptr, ptr, ptr, i, i, f, f, i, i, ptr],
        "srpde_max_fused_iters": [],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, i
    return _Lib(lib.srpde_apply_operator, lib.srpde_pde_loss_forward,
                lib.srpde_pde_loss_backward, lib.srpde_residual, lib.srpde_jacobi,
                int(lib.srpde_max_fused_iters()))


def load_kernels() -> None:
    """Build ``csrc/stencil.cu`` (at the first call) and load it, so that a
    later launch does not pay for the build."""
    _lib()


def _per_slab(name: str, stat: torch.Tensor, batch: int) -> torch.Tensor:
    """A statistic as one value (0-d) or one per slab (``(batch, 1, 1)``)."""
    if stat.numel() == 1:
        return stat.reshape(())
    if stat.numel() == batch:
        return stat.reshape(batch, 1, 1)
    raise ValueError(f"{name} has {stat.numel()} values; it takes 1 or one per slab ({batch})")


def _count(t: torch.Tensor) -> torch.Tensor:
    """``t.numel()`` as a float32 0-d tensor on ``t``'s device."""
    return torch.tensor(np.float32(t.numel()), dtype=t.dtype, device=t.device)


# ----------------------------------------------------------------- plain twins
def plain_apply_operator(theta, u: torch.Tensor, h: float | None = None) -> torch.Tensor:
    """Plain PyTorch ``theta * (S(u) - 4u) / h^2`` (the Pallas body's
    arithmetic, ``/ h^2`` included)."""
    h2 = torch.tensor(_h2(u.shape[-1], h), dtype=u.dtype, device=u.device)
    return theta * ((shift_sum(u) - 4.0 * u) / h2)


def plain_pde_residual_loss(pred: torch.Tensor, theta: torch.Tensor, f: torch.Tensor,
                            u_mean: torch.Tensor, u_std: torch.Tensor, f_std: torch.Tensor,
                            h: float | None = None, seed: bool = True):
    """Plain PyTorch physics loss ``mean(r^2)``,
    ``r = (theta * L(pred * u_std + u_mean) - f) / f_std``, and (with
    ``seed``) the backward's seed ``theta * r / f_std`` in ``theta``'s shape.

    ``pred`` holds ``theta.numel()`` values in slabs of ``theta``'s last two
    axes (``(B, 1, H, W)`` against ``(B, H, W)``); each statistic is one value
    or one per slab. Returns ``(loss, seed or None)``; differentiable. A
    bfloat16 input or statistic is widened to float32 first, as the kernel
    reads it: the loss and the seed are float32.
    """
    pred, theta, f, u_mean, u_std, f_std = (
        t.float() if t.dtype == torch.bfloat16 else t
        for t in (pred, theta, f, u_mean, u_std, f_std))
    n = theta.shape[-1]
    theta3 = theta.reshape(-1, n, n)
    batch = theta3.shape[0]
    u = pred.reshape(theta3.shape) * _per_slab("u_std", u_std, batch) \
        + _per_slab("u_mean", u_mean, batch)
    fs = _per_slab("f_std", f_std, batch)
    r = (plain_apply_operator(theta3, u, h) - f.reshape(theta3.shape)) / fs
    loss = torch.mean(r ** 2)
    return loss, (((theta3 * r) / fs).reshape(theta.shape) if seed else None)


def plain_pde_residual_loss_backward(seed: torch.Tensor, u_std: torch.Tensor,
                                     g_out: torch.Tensor, h: float | None = None,
                                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch gradient of the physics loss with respect to ``pred``:
    ``u_std * L((2 g_out / N) * seed)`` in ``seed``'s shape (the truncated
    ``L`` is symmetric), computed in ``seed``'s dtype (float32 for a bfloat16
    ``pred``: ``u_std`` is widened) and rounded once to ``dtype`` (``pred``'s,
    default ``seed``'s)."""
    if u_std.dtype == torch.bfloat16:
        u_std = u_std.float()
    n = seed.shape[-1]
    s3 = seed.reshape(-1, n, n)
    c = (2.0 * g_out.reshape(())) / _count(seed)
    grad = _per_slab("u_std", u_std, s3.shape[0]) * plain_apply_operator(1.0, c * s3, h)
    return grad.reshape(seed.shape).to(dtype or seed.dtype)


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


def plain_smooth_residual(u: torch.Tensor, b: torch.Tensor, h: float | None = None,
                          omega: float = 0.8, iters: int = 2):
    """Plain PyTorch V-cycle pre-smooth and residual: ``iters`` sweeps of
    :func:`plain_jacobi_smooth`, then ``b - (-L) u`` as
    ``plain_residual(-1, u, b)``. Returns ``(u, r)``."""
    u = plain_jacobi_smooth(u, b, h, omega, iters)
    return u, plain_residual(-1.0, u, b, h)


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
    _check_device("kernel_apply_operator", u)
    _check_cuda("kernel_apply_operator", u, *fields.values())
    n = u.shape[-1]
    out = torch.empty_like(u)
    with _on(u):
        code = _lib().apply_operator(
            _ptr(None if scalar else theta), float(theta) if scalar else 0.0, _ptr(u), _ptr(out),
            _batch(u), n, float(_h2(n, h)), _vec(n, u, out, *fields.values()), _stream(u))
    _raise_on("kernel_apply_operator", code)
    kernel_apply_operator.launches += 1
    return out


def _stats_for_kernel(name: str, theta: torch.Tensor, batch: int, **stats: torch.Tensor):
    """[(stat, stride)] for the kernel: stride 0 for one value, 1 per slab; a
    bfloat16 statistic is widened to float32 (exactly)."""
    out = []
    for key, stat in stats.items():
        if stat.device != theta.device:
            raise ValueError(f"{name}: {key} is on {stat.device}, theta on {theta.device}")
        if stat.dtype == torch.bfloat16:
            stat = stat.float().contiguous()
        _check_cuda(name, stat)
        out.append((stat, 0 if _per_slab(key, stat, batch).ndim == 0 else 1))
    return out


def kernel_pde_loss_forward(pred: torch.Tensor, theta: torch.Tensor, f: torch.Tensor,
                            u_mean: torch.Tensor, u_std: torch.Tensor, f_std: torch.Tensor,
                            h: float | None = None, seed: bool = True):
    """K1 with the physics loss fused in: ``(loss, seed or None)`` as
    :func:`plain_pde_residual_loss` gives them. One call launches the fused
    kernel, which writes a partial sum per block into this call's scratch,
    and a one-block kernel that adds them in a fixed order: the same inputs
    give the same bits, and no state is shared between calls or streams.
    ``pred``, ``theta`` and ``f`` share one dtype, float32 or bfloat16 (the
    bf16 instantiation); the loss and the seed are float32."""
    name = "kernel_pde_loss_forward"
    _check_slabs(name, theta, f=f)
    if pred.numel() != theta.numel() or pred.shape[-2:] != theta.shape[-2:]:
        raise ValueError(f"{name}: pred {tuple(pred.shape)} does not hold theta's "
                         f"{tuple(theta.shape)} slabs")
    if pred.device != theta.device:
        raise ValueError(f"{name}: pred is on {pred.device}, theta on {theta.device}")
    if theta.device.type == "cpu":
        return plain_pde_residual_loss(pred, theta, f, u_mean, u_std, f_std, h, seed)
    dtype = _loss_dtype(name, pred, theta, f)
    _check_device(name, theta)
    _check_cuda(name, pred, theta, f, dtypes=LOSS_DTYPES)
    n, batch = theta.shape[-1], _batch(theta)
    (um, um_s), (us, us_s), (fs, fs_s) = _stats_for_kernel(
        name, theta, batch, u_mean=u_mean, u_std=u_std, f_std=f_std)
    f32 = dict(dtype=torch.float32, device=theta.device)
    loss = torch.empty((), **f32)
    partial = torch.empty(batch * n, **f32)  # >= blocks
    s = torch.empty(theta.shape, **f32) if seed else None
    vec = _vec(n, pred, theta, f, *([s] if seed else []))
    with _on(theta):
        code = _lib().pde_loss_forward(
            _ptr(pred), _ptr(theta), _ptr(f), _ptr(um), um_s, _ptr(us), us_s, _ptr(fs), fs_s,
            _ptr(s), _ptr(partial), _ptr(loss), batch, n, float(_h2(n, h)), vec,
            int(dtype == torch.bfloat16), _stream(theta))
    _raise_on(name, code)
    _count_launch(kernel_pde_loss_forward, dtype)
    return loss, s


def kernel_pde_loss_backward(seed: torch.Tensor, u_std: torch.Tensor, g_out: torch.Tensor,
                             h: float | None = None,
                             dtype: torch.dtype | None = None) -> torch.Tensor:
    """K1's physics-loss backward: ``u_std * L((2 g_out / N) * seed)`` in one
    launch, as :func:`plain_pde_residual_loss_backward` gives it. The seed is
    float32; the gradient is written in ``dtype`` (``pred``'s: float32, the
    default, or bfloat16, the bf16 instantiation)."""
    name = "kernel_pde_loss_backward"
    dtype = dtype or seed.dtype
    _check_slabs(name, seed)
    if g_out.numel() != 1 or g_out.device != seed.device:
        raise ValueError(f"{name}: g_out must be one value on {seed.device}")
    if seed.device.type == "cpu":
        return plain_pde_residual_loss_backward(seed, u_std, g_out, h, dtype)
    if dtype not in LOSS_DTYPES:
        raise TypeError(f"{name}: the gradient is float32 or bfloat16, not {dtype}")
    _check_device(name, seed)
    _check_cuda(name, seed, g_out)
    n, batch = seed.shape[-1], _batch(seed)
    ((us, us_s),) = _stats_for_kernel(name, seed, batch, u_std=u_std)
    grad = torch.empty(seed.shape, dtype=dtype, device=seed.device)
    with _on(seed):
        code = _lib().pde_loss_backward(
            _ptr(seed), _ptr(us), us_s, _ptr(g_out), _ptr(grad), batch, n, float(_h2(n, h)),
            _vec(n, seed, grad), int(dtype == torch.bfloat16), _stream(seed))
    _raise_on(name, code)
    _count_launch(kernel_pde_loss_backward, dtype)
    return grad


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
    _check_device("kernel_residual", u)
    _check_cuda("kernel_residual", u, *fields.values())
    n = u.shape[-1]
    r = torch.empty_like(u)
    with _on(u):
        code = _lib().residual(
            _ptr(None if scalar else theta), float(theta) if scalar else 0.0, _ptr(u), _ptr(f),
            _ptr(None), _ptr(r), _batch(u), n, float(_h2(n, h)), 0.0, 0,
            _vec(n, u, r, *fields.values()), _stream(u))
    _raise_on("kernel_residual", code)
    kernel_residual.launches += 1
    return r


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
    _check_device("kernel_jacobi_smooth", u)
    _check_cuda("kernel_jacobi_smooth", u, b)
    n, batch = u.shape[-1], _batch(u)
    h2 = _h2(n, h)
    scale = float(_jacobi_scale(h2, omega))
    lib = _lib()
    with _on(u):
        stream = _stream(u)
        done = 0
        while done < iters:
            k = min(lib.max_fused_iters, iters - done)
            out = torch.empty_like(u)
            code = lib.jacobi(_ptr(u), _ptr(b), _ptr(out), batch, n, float(h2), scale, k,
                              _vec(n, u, b, out), stream)
            _raise_on("kernel_jacobi_smooth", code)
            kernel_jacobi_smooth.launches += 1
            u = out
            done += k
    return u if iters else u.clone()


def kernel_smooth_residual(u: torch.Tensor, b: torch.Tensor, h: float | None = None,
                           omega: float = 0.8, iters: int = 2):
    """The V-cycle's pre-smooth and residual: ``iters`` weighted-Jacobi sweeps
    for ``(-L) u = b`` (as :func:`kernel_jacobi_smooth`), then
    ``r = b - (-L) u`` of the result. Returns ``(u, r)``; with ``iters = 0``
    the first is ``u`` itself.

    One launch does up to 3 sweeps and the residual; more sweeps first run
    :func:`kernel_jacobi_smooth` launches for the rest."""
    name = "kernel_smooth_residual"
    _check_slabs(name, u, b=b)
    if iters < 0:
        raise ValueError(f"{name}: iters must be >= 0, got {iters}")
    if u.device.type == "cpu":
        return plain_smooth_residual(u, b, h, omega, iters)
    _check_device(name, u)
    _check_cuda(name, u, b)
    lib = _lib()
    fused = min(iters, lib.max_fused_iters - 1)  # the residual's halo is one ring wider
    if iters > fused:
        u = kernel_jacobi_smooth(u, b, h, omega, iters - fused)
    n = u.shape[-1]
    h2 = _h2(n, h)
    u_out = torch.empty_like(u) if fused else None
    r = torch.empty_like(u)
    with _on(u):
        code = lib.residual(
            _ptr(None), -1.0, _ptr(u), _ptr(b), _ptr(u_out), _ptr(r), _batch(u), n, float(h2),
            float(_jacobi_scale(h2, omega)), fused,
            _vec(n, u, b, r, *([u_out] if fused else [])), _stream(u))
    _raise_on(name, code)
    kernel_smooth_residual.launches += 1
    return (u_out if fused else u), r


KERNELS = (kernel_apply_operator, kernel_pde_loss_forward, kernel_pde_loss_backward,
           kernel_residual, kernel_jacobi_smooth, kernel_smooth_residual)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.launches_bf16 = 0  # only the loss kernels have a bfloat16 instantiation


def launch_counts(dtype: torch.dtype = torch.float32) -> dict[str, int]:
    """Launches per wrapper since the last reset, of the float32 kernels or
    (``dtype=torch.bfloat16``) of the bfloat16 instantiations."""
    if dtype not in LOSS_DTYPES:
        raise ValueError(f"launch_counts: float32 or bfloat16, not {dtype}")
    bf16 = dtype == torch.bfloat16
    return {fn.__name__: fn.launches_bf16 if bf16 else fn.launches for fn in KERNELS}


def launch_tally() -> tuple[int, ...]:
    """Every wrapper's float32 and bfloat16 launch counts, flat, in
    :data:`KERNELS`' order (two tallies' difference is the launches between)."""
    return tuple(n for fn in KERNELS for n in (fn.launches, fn.launches_bf16))


def add_launches(delta: tuple[int, ...]) -> None:
    """Advance the counts by a difference of two :func:`launch_tally` s: a
    captured CUDA graph's replay runs the launches its capture counted."""
    for fn, n, n_bf16 in zip(KERNELS, delta[::2], delta[1::2]):
        fn.launches += n
        fn.launches_bf16 += n_bf16


reset_launch_counts()
