"""PyTorch port on an NVIDIA card: the hand-written stencil kernels against
their plain twins, K1's autograd path in the physics loss, and the V-cycle
with and without the kernels. Skipped without a
card; on one, run ``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(the suite's conftest imports JAX, which the card's machine need not have)."""

import pytest
import torch

from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
from superresolution_for_pdes_tpu_torch.physics.loss import apply_operator
from superresolution_for_pdes_tpu_torch.solver.multigrid import vcycle

import torch_port_helpers  # noqa: F401  (thread limit)

pytestmark = pytest.mark.cuda
TOL = 4e-6  # kernel and twin may round the five-term sum differently


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(out, ref):
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


@pytest.mark.parametrize("shape", [(1, 160, 160), (8, 161, 161), (2, 3, 41, 41)])
def test_kernels_match_twins(shape, gen):
    u, f = (torch.randn(shape, device="cuda", generator=gen) for _ in range(2))
    theta = torch.rand(shape, device="cuda", generator=gen) + 0.5
    sk.reset_launch_counts()
    for th in (-1.0, theta):
        _close(sk.kernel_residual(th, u, f), sk.plain_residual(th, u, f))
        _close(sk.kernel_apply_operator(th, u), sk.plain_apply_operator(th, u))
    for iters in (0, 1, 2, 3, 6):
        _close(sk.kernel_jacobi_smooth(u, f, iters=iters),
               sk.plain_jacobi_smooth(u, f, iters=iters))
    # K3 runs up to 4 sweeps per launch: 0 + 1 + 1 + 1 + 2 launches
    assert sk.launch_counts() == {"kernel_apply_operator": 2, "kernel_residual": 2,
                                  "kernel_jacobi_smooth": 5}


def test_kernels_reject_what_they_cannot_take(gen):
    u = torch.randn(2, 40, 40, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        sk.kernel_residual(-1.0, u.double(), u.double())
    with pytest.raises(ValueError):
        sk.kernel_jacobi_smooth(u.transpose(-1, -2), u)
    with pytest.raises(TypeError):
        sk.kernel_apply_operator(u.double(), u.double())


@pytest.mark.parametrize("shape", [(32, 40, 40), (3, 41, 41)])
def test_apply_operator_backward_runs_k1(shape, gen):
    theta = torch.rand(shape, device="cuda", generator=gen) + 0.5
    u = torch.randn(shape, device="cuda", generator=gen)
    g = torch.randn(shape, device="cuda", generator=gen)
    grads = {}
    for use_kernel in (True, False):
        x = u.clone().requires_grad_(True)
        sk.reset_launch_counts()
        apply_operator(theta, x, use_kernel).backward(g)
        grads[use_kernel] = x.grad
        # forward and backward each launch K1 once; the twin path none
        assert sk.launch_counts()["kernel_apply_operator"] == (2 if use_kernel else 0)
    _close(grads[True], grads[False])


def test_vcycle_with_kernels_matches_dense_path(gen):
    b = torch.randn(2, 160, 160, device="cuda", generator=gen)
    u0 = torch.zeros_like(b)
    sk.reset_launch_counts()
    fused = vcycle(u0, b)  # None -> kernels for CUDA tensors at n >= 160
    assert sk.launch_counts() == {"kernel_apply_operator": 0, "kernel_residual": 1,
                                  "kernel_jacobi_smooth": 2}
    dense = vcycle(u0, b, use_kernels=False)
    torch.cuda.synchronize()
    assert torch.allclose(fused, dense, rtol=1e-5, atol=1e-7 * float(dense.abs().max()))
