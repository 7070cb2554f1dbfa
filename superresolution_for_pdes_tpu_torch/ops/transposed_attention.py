"""Restormer's transposed attention (MDTA's core): three hand-written CUDA
kernels (``csrc/transposed_attention.cu``) and their plain twin.

:func:`transposed_attention` takes the depthwise convolution's output
``(B, 3C, H, W)`` (q, k and v of ``heads`` heads of ``d = C / heads``
channels each) and returns ``(B, C, H, W)`` for the projection: per head
``softmax(temperature_h q^ k^T) v``, where ``q^`` and ``k^`` are each
channel's row of ``H W`` tokens L2-normalised as ``F.normalize`` does, so the
logits are ``d x d`` and the product ``q^ k^T`` contracts over the tokens.

On CUDA, where no gradient is taken (serving, evaluation), it runs
:func:`kernel_transposed_attention` inside a ``restormer.attention.kernel``
span: :func:`kernel_gram` (each slab of tokens' partial ``q k^T`` and squared
norms), :func:`kernel_softmax` (the slabs added in a fixed order, the Gram
normalised with ``F.normalize``'s clamp, scaled by the temperature, the row
softmax) and :func:`kernel_apply` (``A v``), one device launch each, counted
in the kernels' one registry (``ops/_build.py``; :func:`launch_counts`). The
kernels are built for heads of 48 and 96 channels (Restormer's published
widths) in float32 (bfloat16 and float16 inputs are widened to them and the
output rounded back); any other width or dtype on CUDA raises. Under autograd
on CUDA, and on the CPU, it runs the plain twin
:func:`plain_transposed_attention`, upstream's operations, differentiated by
autograd (there is no backward kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from superresolution_for_pdes_tpu_torch.ops import _build
from superresolution_for_pdes_tpu_torch.ops._build import launch, ptr
from superresolution_for_pdes_tpu_torch.utils.profiling import span

HEAD_SIZES = frozenset({48, 96})  # channels a head, as the kernels are built
WIDENED = (torch.bfloat16, torch.float16)  # dtypes the kernels take widened to float32
CHUNK = 32            # tokens a Gram block stages at a time
MIN_SLAB_CHUNKS = 8   # a slab's fewest chunks: its partial stays small beside its inputs
BLOCKS_PER_SM = 4     # Gram blocks aimed at, a streaming multiprocessor


# ----------------------------------------------------------------- plain twin
def plain_transposed_attention(qkv: torch.Tensor, temperature: torch.Tensor,
                               heads: int) -> torch.Tensor:
    """Plain PyTorch :func:`transposed_attention`, as upstream's MDTA writes
    it: ``(B, 3C, H, W) -> (B, C, H, W)``."""
    b, c3, h, w = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b, 3, heads, c // heads, h * w).unbind(1)
    q = F.normalize(q, dim=-1)
    k = F.normalize(k, dim=-1)
    attn = ((q @ k.transpose(-2, -1)) * temperature).softmax(-1)
    return (attn @ v).reshape(b, c, h, w)


# -------------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/transposed_attention.cu``'s library (built at the first call),
    its entry points' C signatures declared."""
    lib = _build.load_library("transposed_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.srpde_transposed_attention_gram.argtypes = [p, i, i, i, ll, i, i, p, p]
    lib.srpde_transposed_attention_softmax.argtypes = [p, p, i, i, i, i, p, p]
    lib.srpde_transposed_attention_apply.argtypes = [p, p, i, i, i, ll, p, p]
    for fn in (lib.srpde_transposed_attention_gram, lib.srpde_transposed_attention_softmax,
               lib.srpde_transposed_attention_apply):
        fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def slabs(pairs: int, tokens: int, multiprocessors: int) -> tuple[int, int]:
    """``(slabs, chunks a slab)`` of a Gram call over ``pairs`` (sample, head)
    pairs of ``tokens`` tokens: about :data:`BLOCKS_PER_SM` blocks a
    multiprocessor, at least :data:`MIN_SLAB_CHUNKS` chunks of :data:`CHUNK`
    tokens a slab. A function of the shape and the card alone, so a call's
    sums are in the same order every time."""
    chunks = -(-tokens // CHUNK)
    want = max(1, -(-BLOCKS_PER_SM * multiprocessors // pairs))
    per_slab = max(MIN_SLAB_CHUNKS, -(-chunks // want))
    return -(-chunks // per_slab), per_slab


def _dims(qkv: torch.Tensor, heads: int):
    b, c3, h, w = qkv.shape
    return b, c3 // (3 * heads), h * w


def kernel_gram(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """One launch: ``(B heads slabs, d^2 + 2 d)``, each slab's ``q k^T`` and
    the squared norms of its q and k rows."""
    b, d, tokens = _dims(qkv, heads)
    n, per_slab = slabs(b * heads, tokens, _multiprocessors(qkv.device.index))
    partial = qkv.new_empty(b * heads * n, d * d + 2 * d)
    launch(kernel_gram, _lib().srpde_transposed_attention_gram, qkv, ptr(qkv), b, heads, d,
           tokens, n, per_slab, ptr(partial))
    return partial


def kernel_softmax(partial: torch.Tensor, temperature: torch.Tensor, batch: int, heads: int,
                   d: int) -> torch.Tensor:
    """One launch: ``(B heads, d, d)``, each head's attention ``A``
    transposed (``A^T[j][i]``), from :func:`kernel_gram`'s partials."""
    n = partial.shape[0] // (batch * heads)
    attn = partial.new_empty(batch * heads, d, d)
    launch(kernel_softmax, _lib().srpde_transposed_attention_softmax, partial, ptr(partial),
           ptr(temperature), batch, heads, d, n, ptr(attn))
    return attn


def kernel_apply(qkv: torch.Tensor, attn: torch.Tensor, heads: int) -> torch.Tensor:
    """One launch: ``(B, C, H, W)``, each head's ``A v``."""
    b, d, tokens = _dims(qkv, heads)
    out = qkv.new_empty(b, heads * d, *qkv.shape[2:])
    launch(kernel_apply, _lib().srpde_transposed_attention_apply, qkv, ptr(qkv), ptr(attn), b,
           heads, d, tokens, ptr(out))
    return out


def kernel_transposed_attention(qkv: torch.Tensor, temperature: torch.Tensor,
                                heads: int) -> torch.Tensor:
    """The three launches: ``(B, 3C, H, W) -> (B, C, H, W)``, float32."""
    check_kernel_widths(qkv, temperature, heads)
    b, d, _ = _dims(qkv, heads)
    attn = kernel_softmax(kernel_gram(qkv, heads), temperature, b, heads, d)
    return kernel_apply(qkv, attn, heads)


KERNELS = (kernel_gram, kernel_softmax, kernel_apply)
reset_launch_counts = functools.partial(_build.reset_launch_counts, KERNELS)
launch_counts = functools.partial(_build.launch_counts, KERNELS)


# ------------------------------------------------------------------ dispatch
def check_kernel_widths(qkv: torch.Tensor, temperature: torch.Tensor, heads: int) -> None:
    """Raise unless the kernels take these inputs: ``qkv`` a contiguous,
    16-byte aligned ``(B, 3 heads d, H, W)`` float32 tensor with ``d`` in
    :data:`HEAD_SIZES` and ``temperature`` ``heads`` contiguous float32
    values on its device."""
    name = "transposed_attention"
    if qkv.ndim != 4 or qkv.shape[1] % (3 * heads):
        raise ValueError(f"{name}: qkv must be (B, 3 heads d, H, W), got {tuple(qkv.shape)} "
                         f"for {heads} heads")
    d = qkv.shape[1] // (3 * heads)
    if d not in HEAD_SIZES:
        raise ValueError(f"{name}: no CUDA kernel for heads of {d} channels (built for "
                         f"{sorted(HEAD_SIZES)})")
    if qkv.dtype != torch.float32 or temperature.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernels take float32, not {qkv.dtype} and "
                        f"{temperature.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16 or temperature.numel() != heads \
            or not temperature.is_contiguous() or temperature.device != qkv.device:
        raise ValueError(f"{name}: the kernels take a contiguous, 16-byte aligned qkv and "
                         f"{heads} contiguous temperatures on {qkv.device}")


def transposed_attention(qkv: torch.Tensor, temperature: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """``(B, 3C, H, W) -> (B, C, H, W)``: each head's channels attended across
    the tokens (module docstring); ``temperature`` holds ``heads`` values."""
    if qkv.device.type == "cpu" or (torch.is_grad_enabled() and (qkv.requires_grad
                                                                 or temperature.requires_grad)):
        return plain_transposed_attention(qkv, temperature, heads)
    if qkv.dtype != torch.float32 and qkv.dtype not in WIDENED:
        raise TypeError(f"transposed_attention: the CUDA kernels take float32, bfloat16 or "
                        f"float16, not {qkv.dtype}")
    with span("restormer.attention.kernel", qkv.shape[0] * heads):
        out = kernel_transposed_attention(qkv.float().contiguous(),
                                          temperature.detach().float().contiguous(), heads)
    return out.to(qkv.dtype)
