"""PyTorch port on an NVIDIA card: the hand-written stencil kernels against
their plain twins (K2 and the fused pre-smooth and residual at every sweep
count, aligned and misaligned), K1's adjoint, the fused physics-loss kernels (forward,
backward, determinism, concurrent streams, launch counts) in float32 and in
bfloat16, and the V-cycle with and without the kernels, and CG with K1 as its
matvec; and the champion's cascade levels replayed as CUDA graphs against the
eager levels, bit for bit. Skipped without a card; on one, run
``python -m pytest --noconftest -q tests/test_torch_cuda.py`` (the suite's
conftest imports JAX, which the card's machine need not have)."""

import pytest
import torch

from superresolution_for_pdes_tpu_torch.cascade.graphs import LEVEL_GRAPHS
from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.physics.loss import pde_residual_loss
from superresolution_for_pdes_tpu_torch.solver import cg
from superresolution_for_pdes_tpu_torch.solver.multigrid import mg_preconditioner, vcycle

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
    assert sk.launch_counts() == {"kernel_apply_operator": 2, "kernel_pde_loss_forward": 0,
                                  "kernel_pde_loss_backward": 0, "kernel_residual": 2,
                                  "kernel_jacobi_smooth": 5, "kernel_smooth_residual": 0}


def test_kernels_reject_what_they_cannot_take(gen):
    u = torch.randn(2, 40, 40, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        sk.kernel_residual(-1.0, u.double(), u.double())
    with pytest.raises(ValueError):
        sk.kernel_jacobi_smooth(u.transpose(-1, -2), u)
    with pytest.raises(TypeError):
        sk.kernel_apply_operator(u.double(), u.double())
    one = torch.ones((), device="cuda")
    with pytest.raises(TypeError):
        sk.kernel_pde_loss_forward(u.double()[:, None], u.double(), u.double(), one, one, one)
    with pytest.raises(ValueError):
        sk.kernel_pde_loss_forward(u[:, None], u, u, one, torch.ones(3, device="cuda"), one)
    with pytest.raises(ValueError):
        sk.kernel_pde_loss_backward(u, one, torch.ones(2, device="cuda"))


@pytest.mark.parametrize("shape", [(32, 40, 40), (3, 41, 41)])
def test_apply_operator_backward_runs_k1(shape, gen):
    theta = torch.rand(shape, device="cuda", generator=gen) + 0.5
    u = torch.randn(shape, device="cuda", generator=gen)
    g = torch.randn(shape, device="cuda", generator=gen)
    x = u.clone().requires_grad_(True)
    ref_out = sk.plain_apply_operator(theta, x)
    ref_out.backward(g)
    sk.reset_launch_counts()
    # the gradient of theta * L u is L(theta * g): L is symmetric
    out = sk.kernel_apply_operator(theta, u)
    grad = sk.kernel_apply_operator(1.0, theta * g)
    assert sk.launch_counts()["kernel_apply_operator"] == 2
    _close(out, ref_out.detach())
    _close(grad, x.grad)


def test_vcycle_with_kernels_matches_dense_path(gen):
    b = torch.randn(2, 160, 160, device="cuda", generator=gen)
    u0 = torch.zeros_like(b)
    sk.reset_launch_counts()
    fused = vcycle(u0, b)  # None -> kernels for CUDA tensors at n >= 160
    assert sk.launch_counts() == {"kernel_apply_operator": 0, "kernel_pde_loss_forward": 0,
                                  "kernel_pde_loss_backward": 0, "kernel_residual": 0,
                                  "kernel_jacobi_smooth": 1, "kernel_smooth_residual": 1}
    dense = vcycle(u0, b, use_kernels=False)
    torch.cuda.synchronize()
    assert torch.allclose(fused, dense, rtol=1e-5, atol=1e-7 * float(dense.abs().max()))


@pytest.mark.parametrize("n,precond", [(160, False), (161, False), (640, True)])
def test_cg_matvec_on_k1_matches_its_twin(n, precond, gen):
    """CG with K1 as its matvec gives its twin's iterates bit for bit over a
    whole solve, with one K1 launch per loop iteration plus one."""
    b = torch.randn(2, n, n, device="cuda", generator=gen)
    pre = mg_preconditioner if precond else None
    kw = dict(tol=1e-6, max_iters=300, precond=pre)
    sk.reset_launch_counts()
    u, iters = cg.cg_solve(lambda p: sk.kernel_apply_operator(-1.0, p), b, **kw)
    counts = sk.launch_counts()
    ref, ref_iters = cg.cg_solve(lambda p: sk.plain_apply_operator(-1.0, p), b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(u, ref) and int(iters) == int(ref_iters) > 1
    ran = cg.iterations_run(int(iters), 300, cg.convergence_chunk(pre))
    assert counts["kernel_apply_operator"] == 1 + ran
    assert counts["kernel_smooth_residual"] == counts["kernel_jacobi_smooth"] == (
        1 + ran if precond else 0)


def _misaligned(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary (the
    kernels' scalar path)."""
    buf = torch.empty(t.numel() + 1, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


SHAPES = [(1, 160, 160), (1, 640, 640), (4, 640, 640), (8, 161, 161), (2, 3, 41, 41),
          (1, 1023, 1023)]


@pytest.mark.parametrize("shape", SHAPES)
def test_jacobi_matches_twin_at_every_sweep_count(shape, gen):
    u, b = (torch.randn(shape, device="cuda", generator=gen) for _ in range(2))
    for iters in (0, 1, 2, 3, 4, 6, 9):
        ref = sk.plain_jacobi_smooth(u, b, iters=iters)
        _close(sk.kernel_jacobi_smooth(u, b, iters=iters), ref)
        if shape[-1] % 4 == 0 and iters == 2:
            _close(sk.kernel_jacobi_smooth(_misaligned(u), _misaligned(b), iters=iters), ref)


def _loss_data(shape, per_sample, gen):
    b = shape[0]
    pred = torch.randn(b, 1, *shape[1:], device="cuda", generator=gen)
    theta = torch.rand(shape, device="cuda", generator=gen) * 1.5 + 0.5
    f = torch.randn(shape, device="cuda", generator=gen)
    size = (b, 1, 1) if per_sample else ()
    u_mean = torch.randn(size, device="cuda", generator=gen)
    u_std, f_std = (torch.rand(size, device="cuda", generator=gen) + 0.5 for _ in range(2))
    return pred, theta, f, (u_mean, u_std, f_std)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("shape", [(32, 40, 40), (1024, 40, 40), (32, 80, 80), (32, 160, 160),
                                   (3, 41, 41)])
def test_fused_loss_matches_twin(shape, per_sample, gen):
    pred, theta, f, stats = _loss_data(shape, per_sample, gen)
    g = torch.tensor(0.7, device="cuda")
    ref_loss, ref_seed = sk.plain_pde_residual_loss(pred, theta, f, *stats)
    ref_grad = sk.plain_pde_residual_loss_backward(ref_seed, stats[1], g)
    for p in (pred, _misaligned(pred)):
        loss, seed = sk.kernel_pde_loss_forward(p, theta, f, *stats)
        torch.cuda.synchronize()
        assert abs(float(loss) - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
        _close(seed, ref_seed)
        _close(sk.kernel_pde_loss_backward(seed, stats[1], g), ref_grad)


def test_fused_loss_is_deterministic(gen):
    pred, theta, f, stats = _loss_data((1024, 40, 40), True, gen)
    g = torch.tensor(1.0, device="cuda")
    runs = []
    for _ in range(2):
        loss, seed = sk.kernel_pde_loss_forward(pred, theta, f, *stats)
        runs.append((loss.clone(), sk.kernel_pde_loss_backward(seed, stats[1], g)))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_fused_loss_on_concurrent_streams(gen):
    """Forwards enqueued on two streams at once share no state: each loss is
    its twin's."""
    data = [_loss_data(shape, True, gen) for shape in ((1024, 40, 40), (32, 160, 160))]
    refs = [float(sk.plain_pde_residual_loss(p, th, f, *st)[0]) for p, th, f, st in data]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    losses = [[], []]
    for _ in range(20):
        for i, (stream, (p, th, f, st)) in enumerate(zip(streams, data)):
            with torch.cuda.stream(stream):
                losses[i].append(sk.kernel_pde_loss_forward(p, th, f, *st, seed=False)[0])
    torch.cuda.synchronize()
    for ref, got in zip(refs, losses):
        assert all(abs(float(loss) - ref) <= 1e-6 * abs(ref) for loss in got)


def test_pde_residual_loss_launches_one_kernel_each_way(gen):
    pred, theta, f, (u_mean, u_std, f_std) = _loss_data((32, 40, 40), True, gen)
    stats = NormStats(u_mean=u_mean, u_std=u_std, f_mean=u_mean, f_std=f_std,
                      theta_mean=torch.zeros_like(u_mean), theta_std=torch.ones_like(u_std),
                      theta_is_constant=torch.ones_like(u_std, dtype=torch.bool))
    sk.reset_launch_counts()
    with torch.no_grad():
        pde_residual_loss(pred, theta, f, stats)
    assert sk.launch_counts()["kernel_pde_loss_forward"] == 1
    x = pred.clone().requires_grad_(True)
    loss = pde_residual_loss(x, theta, f, stats)
    loss.backward()
    ref = pred.clone().requires_grad_(True)
    ref_loss = pde_residual_loss(ref, theta, f, stats, use_kernel=False)
    ref_loss.backward()
    assert sk.launch_counts() == {"kernel_apply_operator": 0, "kernel_pde_loss_forward": 2,
                                  "kernel_pde_loss_backward": 1, "kernel_residual": 0,
                                  "kernel_jacobi_smooth": 0, "kernel_smooth_residual": 0}
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    _close(x.grad, ref.grad)


BF16_STEP = 2.0 ** -8  # one bf16 step, relative to max|x|


def _misaligned_like(t):
    """A copy of ``t`` whose data starts one element past an aligned address
    (the kernels' scalar path, for any dtype)."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("shape", [(256, 40, 40), (32, 160, 160), (3, 41, 41)])
def test_bf16_fused_loss_matches_twin(shape, per_sample, gen):
    """The bf16 instantiations (bf16 pred, theta, f and, per sample, bf16
    statistics): the float32 loss within 1e-6 relative and the float32 seed
    within TOL of the twins', the bf16 gradient within one bf16 step; bf16
    launches are counted apart from float32 ones."""
    pred, theta, f, stats = _loss_data(shape, per_sample, gen)
    pred, theta, f = (t.bfloat16() for t in (pred, theta, f))
    if per_sample:
        stats = tuple(t.bfloat16() for t in stats)
    g = torch.tensor(0.7, device="cuda")
    ref_loss, ref_seed = sk.plain_pde_residual_loss(pred, theta, f, *stats)
    ref_grad = sk.plain_pde_residual_loss_backward(ref_seed, stats[1], g, dtype=torch.bfloat16)
    assert ref_loss.dtype == ref_seed.dtype == torch.float32 and ref_grad.dtype == torch.bfloat16
    sk.reset_launch_counts()
    for p in (pred, _misaligned_like(pred)):
        loss, seed = sk.kernel_pde_loss_forward(p, theta, f, *stats)
        grad = sk.kernel_pde_loss_backward(seed, stats[1], g, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert loss.dtype == seed.dtype == torch.float32 and grad.dtype == torch.bfloat16
        assert abs(float(loss) - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
        _close(seed, ref_seed)
        err = float((grad.float() - ref_grad.float()).abs().max())
        assert err <= BF16_STEP * float(ref_grad.float().abs().max())
    assert sk.launch_counts(torch.bfloat16)["kernel_pde_loss_forward"] == 2
    assert sk.launch_counts(torch.bfloat16)["kernel_pde_loss_backward"] == 2
    assert sum(sk.launch_counts().values()) == 0  # no float32 launch


def test_bf16_loss_through_autograd_and_mixed_dtypes(gen):
    pred, theta, f, (u_mean, u_std, f_std) = _loss_data((32, 40, 40), True, gen)
    stats = NormStats(u_mean=u_mean.bfloat16(), u_std=u_std.bfloat16(),
                      f_mean=u_mean.bfloat16(), f_std=f_std.bfloat16(),
                      theta_mean=torch.zeros_like(u_mean), theta_std=torch.ones_like(u_std),
                      theta_is_constant=torch.ones_like(u_std, dtype=torch.bool))
    theta, f = theta.bfloat16(), f.bfloat16()
    grads = []
    for use_kernel in (True, False):
        x = pred.bfloat16().requires_grad_(True)
        pde_residual_loss(x, theta, f, stats, use_kernel=use_kernel).backward()
        grads.append(x.grad.float())
    assert x.grad.dtype == torch.bfloat16
    torch.cuda.synchronize()
    assert float((grads[0] - grads[1]).abs().max()) <= BF16_STEP * float(grads[1].abs().max())
    with pytest.raises(TypeError, match="share one dtype"):
        sk.kernel_pde_loss_forward(pred, theta, f, u_mean, u_std, f_std)


@pytest.mark.parametrize("shape", SHAPES)
def test_residual_matches_twin(shape, gen):
    """K2 with theta scalar and a field, aligned and (where n % 4 == 0) not."""
    u, f = (torch.randn(shape, device="cuda", generator=gen) for _ in range(2))
    theta = torch.rand(shape, device="cuda", generator=gen) + 0.5
    sk.reset_launch_counts()
    for th in (-1.0, theta):
        ref = sk.plain_residual(th, u, f)
        _close(sk.kernel_residual(th, u, f), ref)
        if shape[-1] % 4 == 0:
            th_m = th if isinstance(th, float) else _misaligned(th)
            _close(sk.kernel_residual(th_m, _misaligned(u), _misaligned(f)), ref)
    assert sk.launch_counts()["kernel_residual"] == (4 if shape[-1] % 4 == 0 else 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_smooth_residual_matches_twin_at_every_sweep_count(shape, gen):
    """The fused pre-smooth and residual: one launch up to 3 sweeps, K3
    launches before it beyond."""
    u, b = (torch.randn(shape, device="cuda", generator=gen) for _ in range(2))
    for iters in (0, 1, 2, 3, 5):
        ref_u, ref_r = sk.plain_smooth_residual(u, b, iters=iters)
        sk.reset_launch_counts()
        got_u, got_r = sk.kernel_smooth_residual(u, b, iters=iters)
        assert sk.launch_counts()["kernel_smooth_residual"] == 1
        assert sk.launch_counts()["kernel_jacobi_smooth"] == (1 if iters > 3 else 0)
        _close(got_u, ref_u)
        _close(got_r, ref_r)
        if shape[-1] % 4 == 0 and iters == 2:
            got_u, got_r = sk.kernel_smooth_residual(_misaligned(u), _misaligned(b), iters=iters)
            _close(got_u, ref_u)
            _close(got_r, ref_r)


# ------------------------------------------- the cascade's levels as CUDA graphs
CHAMPION = dict(stats_mode="tile", coarse_tile=(40, 80, 80), overlap=False)
RESOLUTIONS = (80, 160, 320, 640)


@pytest.fixture
def champion(gen):
    """The champion's full-width U-Net with four random per-level experts
    and random (48, 48) grid gains on the card; the graph cache emptied
    before and after."""
    LEVEL_GRAPHS.clear()
    model = AttentionUNet(in_channels=5).cuda().eval()
    sds = [{k: v.cuda() for k, v in AttentionUNet(
        in_channels=5, generator=torch.Generator().manual_seed(i)).state_dict().items()}
        for i in range(4)]
    gains = tuple(0.8 + 0.4 * torch.rand(48, 48, device="cuda", generator=gen)
                  for _ in RESOLUTIONS)
    yield model, sds, gains
    LEVEL_GRAPHS.clear()


def _scene(seed, lead=()):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"u": {40: torch.randn(*lead, 40, 40, device="cuda", generator=g)},
            "f": {r: torch.randn(*lead, r, r, device="cuda", generator=g) for r in RESOLUTIONS},
            "theta": {r: 0.5 + torch.rand(*lead, r, r, device="cuda", generator=g)
                      for r in RESOLUTIONS}}


def _serve(champion, scene, refine_cycles=0, sds=None):
    model, own, gains = champion
    return ml_cascade(model, own if sds is None else sds, scene, 640, amp_levels=gains,
                      refine_cycles=refine_cycles, **CHAMPION)


def _copy(sds):
    return [{k: v.clone() for k, v in sd.items()} for sd in sds]


def _equal(a, b):
    torch.cuda.synchronize()
    return sorted(a) == sorted(b) and all(torch.equal(a[r], b[r]) for r in a)


@pytest.mark.parametrize("refine_cycles", [0, 2])
def test_replayed_levels_equal_the_eager_ones_bit_for_bit(refine_cycles, champion):
    """One scene three times: eager, eager and captured, replayed; every
    level's field of each call equals the first's bit for bit. A second
    scene replayed equals it run on a fresh copy of the weights (another
    key, so eager)."""
    scene = _scene(1)
    eager = _serve(champion, scene, refine_cycles)
    assert (LEVEL_GRAPHS.captures, LEVEL_GRAPHS.replays) == (0, 0)
    captured = _serve(champion, scene, refine_cycles)
    assert (LEVEL_GRAPHS.captures, LEVEL_GRAPHS.replays) == (4, 0)
    replayed = _serve(champion, scene, refine_cycles)
    assert (LEVEL_GRAPHS.captures, LEVEL_GRAPHS.replays) == (4, 4)
    assert all(bool(torch.isfinite(v).all()) for v in eager.values())
    assert _equal(captured, eager) and _equal(replayed, eager)
    other = _scene(2)
    replayed = _serve(champion, other, refine_cycles)
    assert LEVEL_GRAPHS.replays == 8
    fresh = _serve(champion, other, refine_cycles, sds=_copy(champion[1]))
    assert (LEVEL_GRAPHS.captures, LEVEL_GRAPHS.replays) == (4, 8)
    assert _equal(replayed, fresh) and not torch.equal(replayed[640], eager[640])


def test_a_replay_reads_weights_updated_in_place(champion):
    scene = _scene(3)
    before = [_serve(champion, scene) for _ in range(3)][-1]
    sds = champion[1]
    name = next(k for k, v in sds[1].items() if v.ndim == 4)
    sds[1][name].mul_(1.5)
    replays = LEVEL_GRAPHS.replays
    after = _serve(champion, scene)
    assert LEVEL_GRAPHS.replays == replays + 4
    assert _equal(after, _serve(champion, scene, sds=_copy(sds)))
    assert torch.equal(after[80], before[80]) and not torch.equal(after[160], before[160])


def test_a_replaced_state_dict_misses(champion):
    """New weights for level 2 (another state_dict): that level runs eagerly,
    the others replay, and the fields are those of the new weights."""
    scene = _scene(4)
    for _ in range(3):
        _serve(champion, scene)
    sds = list(champion[1])
    sds[2] = _copy([sds[2]])[0]
    sds[2][next(k for k, v in sds[2].items() if v.ndim == 4)].mul_(1.5)
    captures, replays = LEVEL_GRAPHS.captures, LEVEL_GRAPHS.replays
    got = _serve(champion, scene, sds=sds)
    assert (LEVEL_GRAPHS.captures, LEVEL_GRAPHS.replays) == (captures, replays + 3)
    assert _equal(got, _serve(champion, scene, sds=_copy(sds)))


def test_a_batch_of_two_scenes_never_captures(champion):
    scene = _scene(5, lead=(2,))
    first = _serve(champion, scene)
    for _ in range(2):
        again = _serve(champion, scene)
    assert (LEVEL_GRAPHS.captures, LEVEL_GRAPHS.replays) == (0, 0)
    assert _equal(first, again)


def test_a_replay_advances_the_launch_counters_as_an_eager_call(champion):
    """The refined cascade's stencil launches (2 V-cycles at 160, 320 and
    640: 6 fused, 6 K3), counted on an eager call and on a replay."""
    scene = _scene(6)
    sk.reset_launch_counts()
    _serve(champion, scene, refine_cycles=2)
    eager = sk.launch_counts()
    assert eager["kernel_smooth_residual"] == eager["kernel_jacobi_smooth"] == 6
    for calls in (1, 2):  # captured, then replayed
        sk.reset_launch_counts()
        _serve(champion, scene, refine_cycles=2)
        assert sk.launch_counts() == eager
    assert LEVEL_GRAPHS.replays == 4


SCHEDULES = {
    "overlap_symmetrize_tile": dict(overlap=True, symmetrize=True, stats_mode="tile"),
    "scene_radial_gains": dict(overlap=(False, True), stats_mode="scene", gains="radial"),
    "train_scalar_gains": dict(stats_mode="train", gains="scalar", refine_cycles=1),
    "oracle": dict(stats_mode="oracle", coarse_tile=(40, 80)),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_every_schedule_replays_bit_for_bit(schedule, gen):
    """A TINY cascade to 160^2 on one scene under each stats mode, overlap,
    symmetrize and gain kind: the replayed fields are the eager ones."""
    LEVEL_GRAPHS.clear()
    kw = dict(SCHEDULES[schedule])
    model = AttentionUNet(in_channels=5, generator=torch.Generator().manual_seed(7),
                          **torch_port_helpers.TINY).cuda()
    scene = _scene(8)
    scene["u"].update({r: torch.randn(r, r, device="cuda", generator=gen) for r in (80, 160)})
    gains = kw.pop("gains", None)
    if gains == "radial":
        kw["amp_levels"] = [0.8 + 0.4 * torch.rand(48, device="cuda", generator=gen)
                            for _ in range(2)]
    elif gains == "scalar":
        kw["amp_levels"] = [torch.tensor(1.1, device="cuda"), torch.tensor(0.9, device="cuda")]
    if kw["stats_mode"] == "train":
        kw["train_stats"] = NormStats.from_fields(scene["u"][80], scene["f"][80],
                                                  scene["theta"][80])
    outs = [ml_cascade(model, None, scene, 160, **kw) for _ in range(3)]
    assert (LEVEL_GRAPHS.captures, LEVEL_GRAPHS.replays) == (2, 2)
    assert _equal(outs[1], outs[0]) and _equal(outs[2], outs[0])
    LEVEL_GRAPHS.clear()
