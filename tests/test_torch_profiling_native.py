"""PyTorch port, ``utils/profiling.py`` (a ``torch.profiler`` trace on the
CPU; the spans are ``tests/test_torch_tracing.py``'s) and ``native/`` (the
float64 C++ oracle, built with ``g++`` at first use) against the JAX
package's oracle, which is built from the same source with the same flags,
and against the port's float64 DST solve."""

import json

import numpy as np
import pytest
import torch

from superresolution_for_pdes_tpu_torch import native
from superresolution_for_pdes_tpu_torch.ops.grid import forcing_term
from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst
from superresolution_for_pdes_tpu_torch.utils.profiling import device_trace

jax_native = pytest.importorskip("superresolution_for_pdes_tpu.native")


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(4, 3, 16, 16)
    conv = torch.nn.Conv2d(3, 4, 3, padding=1)
    with device_trace(tmp_path / "trace", device="cpu") as path:
        conv(x).sum()
    assert path.parent == tmp_path / "trace" and path.suffix == ".json"
    names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]}
    assert any("conv" in n for n in names)


def test_native_oracle_matches_jax_bit_for_bit():
    rng = np.random.default_rng(11)
    n, b = 24, 3
    u = rng.standard_normal((b, n, n))
    theta = rng.uniform(0.5, 2.0, size=(b, n, n))
    assert np.array_equal(native.apply_operator(theta, u), jax_native.apply_operator(theta, u))
    assert np.array_equal(native.apply_operator(theta[0], u[0]),
                          jax_native.apply_operator(theta[0], u[0]))
    f = rng.standard_normal((b, n, n))
    assert np.array_equal(native.solve_cg(f, theta), jax_native.solve_cg(f, theta))
    assert native.library_path().parent == native.BUILD_DIR
    with pytest.raises(ValueError, match="of one shape"):
        native.apply_operator(theta, u[:, :-1])


def test_native_cg_matches_the_float64_dst_solve():
    """At 160^2, as the card's smoke test holds it: within 1e-8 of max|u|."""
    n = 160
    f = forcing_term(torch.tensor(3.3), torch.tensor(7.1), n, dtype=torch.float64,
                     device="cpu").numpy()
    theta = np.random.default_rng(12).uniform(0.5, 2.0, size=(n, n))
    u = native.solve_cg(f, theta)
    ref = solve_poisson_dst(torch.from_numpy(f), torch.from_numpy(theta), refine_iters=1)
    assert np.max(np.abs(u - ref.numpy())) <= 1e-8 * np.max(np.abs(ref.numpy()))
    resid = native.apply_operator(theta, u) - f
    assert np.max(np.abs(resid)) <= 1e-6 * np.max(np.abs(f))
