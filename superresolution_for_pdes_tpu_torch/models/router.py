"""Regime expert routing (port of ``models/router.py``).

Each sample goes to one of up to four experts, chosen from its known inputs
only (never the fine solution):

* the theta regime: constant where ``std(theta) < 1e-6``, the population
  standard deviation (``correction=0``, as ``jnp.std``; the normalization
  layer's statistics use ``correction=1``);
* the wavenumber regime (optional): the dominant frequency of the forcing
  ``f`` from the peak of its 2-D FFT, refined to fractional bins, against
  ``k_threshold`` (constant theta) or ``k_threshold_varying`` (varying).

An expert is a ``(model, weights, normalization)`` triple, as
:func:`~superresolution_for_pdes_tpu_torch.cli.resolve_expert` returns it:
the weights as for the cascade (None, a state_dict or a module), the
normalization ``"dataset"`` or ``"per_sample"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from superresolution_for_pdes_tpu_torch.data.normalization import THETA_CONSTANT_TOL

Expert = Tuple[Any, Any, str]


def _subbin_offset(slice_mag: torch.Tensor, m: torch.Tensor, periodic: bool) -> torch.Tensor:
    """Fractional-bin offset of a spectral peak at integer bin ``m`` along the
    last axis: with the larger neighbour ``|X(m±1)|``, ``|X(m±1)| / (|X(m)| +
    |X(m±1)|)`` toward it (exact where leakage falls off as 1/offset).
    Neighbours wrap around a ``periodic`` axis and are clamped at the ends of
    any other."""
    n = slice_mag.shape[-1]

    def at(i):
        return torch.gather(slice_mag, -1, i[..., None])[..., 0]

    if periodic:
        left, right = at((m - 1) % n), at((m + 1) % n)
    else:
        left, right = at((m - 1).clamp(min=0)), at((m + 1).clamp(max=n - 1))
    cent = at(m)
    use_right = right >= left
    nb = torch.where(use_right, right, left)
    delta = nb / torch.clamp(cent + nb, min=1e-30)
    return torch.where(use_right, delta, -delta)


def estimate_wavenumbers(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(k1, k2)`` per sample (float32) from the dominant peak of
    ``|rfft2(f)|`` of ``f (..., h, w)``, refined to fractional bins.

    The DC row and column are zeroed first; the peak is the first maximum in
    row-major order; rows above Nyquist alias to negative frequencies (their
    offset flips sign); bins are scaled by ``(h - 1) / h``, since the
    generators sample on ``linspace(0, 1, n)``.

    The row axis is the full (periodic) FFT axis, so a peak in row ``h - 1``
    reads its neighbour in row 0, as row 1 does: for the generators'
    separable forcings rows ``r`` and ``h - r`` are equal in magnitude and
    rounding picks the peak's row, which must not change the estimate. The
    JAX package clamps there (row ``h - 1`` then reads itself, and a
    ``k2`` near 1 comes out near 0.49); no routing threshold is near either.
    """
    spec = torch.fft.rfft2(f).abs()
    spec[..., 0, :] = 0.0
    spec[..., :, 0] = 0.0
    h, w = spec.shape[-2:]
    idx = torch.argmax(spec.flatten(-2), dim=-1)
    row, col = idx // w, idx % w
    col_slice = torch.gather(spec, -1, col[..., None, None].expand(*spec.shape[:-1], 1))[..., 0]
    row_slice = torch.gather(spec, -2, row[..., None, None].expand(*spec.shape[:-2], 1, w))[..., 0, :]
    d_col = _subbin_offset(row_slice, col, periodic=False)
    d_row = _subbin_offset(col_slice, row, periodic=True)
    k2 = torch.where(row > h // 2, (h - row) - d_row, row + d_row)
    k1 = col + d_col
    scale = (h - 1) / h
    return (k1 * scale).float(), (k2 * scale).float()


@dataclasses.dataclass
class RegimeRouter:
    """Routes each sample to the constant-theta or the varying-theta expert,
    each optionally split by wavenumber into a high-k expert.

    Every expert runs on the whole batch and a per-sample mask selects, so
    the batch keeps one shape (the model work is one call per expert).
    """

    const: Expert
    varying: Expert
    const_high: Optional[Expert] = None
    varying_high: Optional[Expert] = None
    k_threshold: float = 6.0
    k_threshold_varying: float = 6.0
    tol: float = THETA_CONSTANT_TOL

    def regime_mask(self, theta_fine: torch.Tensor) -> torch.Tensor:
        """True where the sample's coefficient field is constant."""
        return theta_fine.std(dim=(-2, -1), correction=0) < self.tol

    def highk_mask(self, f_fine: torch.Tensor, threshold: Optional[float] = None) -> torch.Tensor:
        """True where the forcing's dominant wavenumber reaches the threshold
        (``k_threshold`` by default)."""
        k1, k2 = estimate_wavenumbers(f_fine)
        return torch.maximum(k1, k2) >= (self.k_threshold if threshold is None else threshold)

    def predict(self, data: Dict, stats=None, symmetrize: bool = False) -> torch.Tensor:
        """Denormalized predictions ``(B, 40, 40)``, each sample from its
        expert (``predict_dataset`` per expert, then ``torch.where``)."""
        from superresolution_for_pdes_tpu_torch.eval.single_level import predict_dataset

        def run(expert: Expert) -> torch.Tensor:
            model, weights, normalization = expert
            return predict_dataset(model, weights, data, stats, normalization=normalization,
                                   symmetrize=symmetrize)

        pred_const, pred_var = run(self.const), run(self.varying)
        if self.const_high is not None:
            hi = self.highk_mask(data["f_fine"])[..., None, None]
            pred_const = torch.where(hi, run(self.const_high), pred_const)
        if self.varying_high is not None:
            hi_v = self.highk_mask(data["f_fine"], self.k_threshold_varying)[..., None, None]
            pred_var = torch.where(hi_v, run(self.varying_high), pred_var)
        const = self.regime_mask(data["theta_fine"])[..., None, None]
        return torch.where(const, pred_const, pred_var)
