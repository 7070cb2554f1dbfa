"""PyTorch port, ``ops/token_reduce.py``: SwinIR's backward column sums over
tokens (the linears' bias gradients, the LayerNorms' weight and bias
gradients) and the ``Linear`` and ``LayerNorm`` of ``models/swinir.py`` that
take them.

On the CPU: the plain twins against ``torch.sum`` and ATen's
``native_layer_norm_backward`` at TINY and published widths and ragged token
counts; ``gradcheck`` of the linear and LayerNorm; a TINY SwinIR's gradients
through the new modules against the same model built from ``nn.Linear`` and
``nn.LayerNorm`` (in float32 and under bfloat16 autocast), and its
state_dict; the widths, dtypes and layouts the kernel refuses. On a card
(tests marked ``cuda``, skipped without one): the kernel against a float64
sum at every published width, in float32 and bfloat16; the same bits twice;
the modules' input and weight gradients bit for bit against ATen's, the sums
within their tolerance, in float32 and under bfloat16 autocast; a
published-width SwinIR step against the ATen path under the cell's
``grad_gap`` limit; the operators' names in the profiler and the benchmark's
readers on them. On a card run
``python -m pytest --noconftest -q tests/test_torch_token_reduce.py``."""

import copy

import pytest
import torch
from torch import nn

from superresolution_for_pdes_tpu_torch.models import SwinIR
from superresolution_for_pdes_tpu_torch.models import swinir
from superresolution_for_pdes_tpu_torch.ops import token_reduce as tr

import torch_port_helpers  # noqa: F401  (thread limit)

# the TINY SwinIR's widths (embed 12, qkv 36, MLP 24) and the published ones
WIDTHS = [12, 24, 36, 180, 360, 540]
ROWS = [1, 37, 1003]  # ragged token counts
TINY = dict(in_channels=5, embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4,
            mlp_ratio=2.0)
PUBLISHED = dict(in_channels=5)
# the cell's limit on the widest leaf's gradient gap (portbench/workloads/swinir_train_b32.json)
GRAD_GAP = 3e-5


def _rows(m, c, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(m, c, generator=gen, device=device, dtype=torch.float32)
    x = 1.5 * torch.randn(m, c, generator=gen, device=device, dtype=torch.float32) + 0.3
    return g.to(dtype), x.to(dtype)


def _stats(x):
    """A LayerNorm's forward statistics of ``x``'s rows, as ATen gives them."""
    c = x.shape[1]
    _, mean, rstd = torch.native_layer_norm(x.float(), (c,), None, None, 1e-5)
    return mean.view(-1), rstd.view(-1)


def _aten_affine(g, x, mean, rstd):
    c = x.shape[1]
    w = torch.ones(c, dtype=x.dtype, device=x.device)
    _, dw, db = torch.ops.aten.native_layer_norm_backward(
        g, x, (c,), mean.view(-1, 1), rstd.view(-1, 1), w, torch.zeros_like(w),
        [False, True, True])
    return dw, db


def _plain(model):
    """A copy of ``model`` with ``nn.Linear`` and ``nn.LayerNorm`` in place of
    its ``Linear`` and ``LayerNorm``, holding copies of the same tensors."""
    plain = copy.deepcopy(model)
    for module in list(plain.modules()):
        for name, child in list(module.named_children()):
            if isinstance(child, (swinir.Linear, swinir.LayerNorm)):
                child.__class__ = child.__class__.__mro__[1]
    return plain


def _randomise(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))


def _grads(model, x, target, autocast=False):
    """The output and every parameter's gradient of a squared error; with
    ``autocast`` the forward runs under the CPU's bfloat16 autocast and the
    backward after it, as ``train/loop.py::train_step`` runs them."""
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        out = model(x)
        loss = ((out.float() - target) ** 2).mean()
    loss.backward()
    return out.detach(), {k: p.grad for k, p in model.named_parameters()}


def _summed(key):
    """A parameter whose gradient is a column sum over the tokens."""
    return key.endswith(".bias") and "conv" not in key or ("norm" in key and key.endswith("weight"))


# ------------------------------------------------------------------- the CPU
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("m", ROWS)
def test_twins_equal_aten(c, m):
    """The bias twin is ``torch.sum`` over the tokens; the LayerNorm twin is
    ATen's weight and bias gradients (float64: to rounding)."""
    g, x = _rows(m, c, torch.float64)
    assert torch.equal(tr.plain_bias_grad(g), g.sum(0))
    mean, rstd = _stats(x)
    mean, rstd = mean.double(), rstd.double()
    for got, want in zip(tr.plain_layer_norm_affine_grad(g, x, mean, rstd),
                         _aten_affine(g, x, mean, rstd)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_bfloat16_twins_accumulate_in_float32():
    g, x = _rows(1003, 180, torch.bfloat16)
    mean, rstd = _stats(x)
    assert tr.plain_bias_grad(g).dtype == torch.float32
    torch.testing.assert_close(tr.plain_bias_grad(g), g.double().sum(0).float())
    dw, db = tr.plain_layer_norm_affine_grad(g, x, mean, rstd)
    assert dw.dtype == db.dtype == torch.float32
    want = _aten_affine(g.double(), x.double(), mean.double(), rstd.double())
    torch.testing.assert_close(dw, want[0].float(), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(db, want[1].float(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("module", ["linear", "layer_norm"])
def test_gradcheck(module):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 12, dtype=torch.float64, generator=gen).requires_grad_(True)
    if module == "linear":
        w = torch.randn(8, 12, dtype=torch.float64, generator=gen).requires_grad_(True)
        b = torch.randn(8, dtype=torch.float64, generator=gen).requires_grad_(True)
        assert torch.autograd.gradcheck(tr.linear, (x, w, b))
    else:
        w = torch.randn(12, dtype=torch.float64, generator=gen).requires_grad_(True)
        b = torch.randn(12, dtype=torch.float64, generator=gen).requires_grad_(True)
        assert torch.autograd.gradcheck(lambda x, w, b: tr.layer_norm(x, w, b, 1e-5), (x, w, b))


def test_without_a_gradient_the_plain_ops_run():
    """Under ``torch.no_grad()`` the modules call ``F.linear`` and
    ``F.layer_norm``: the same bits and no graph."""
    lin, norm = swinir.Linear(12, 8), swinir.LayerNorm(12)
    x = torch.randn(3, 4, 12, requires_grad=True)
    with torch.no_grad():
        assert lin(x).grad_fn is None and norm(x).grad_fn is None
        assert torch.equal(lin(x), nn.functional.linear(x, lin.weight, lin.bias))
        assert torch.equal(norm(x), nn.functional.layer_norm(x, (12,), norm.weight, norm.bias))


def _exact_sums(model):
    """Forward hooks on ``model``'s ``Linear`` and ``LayerNorm`` that keep, by
    parameter key, the float64 column sums of what each one saw: the bias
    gradient's and the LayerNorm's weight gradient's."""
    sums = {}

    def hook(module, inputs, out, name):
        x = inputs[0].detach().double()
        x = x.reshape(-1, x.shape[-1])

        def keep(g):
            g = g.double().reshape(-1, g.shape[-1])
            sums[f"{name}.bias"] = g.sum(0)
            if isinstance(module, swinir.LayerNorm):
                xhat = (x - x.mean(1, keepdim=True)) / torch.sqrt(
                    x.var(1, unbiased=False, keepdim=True) + module.eps)
                sums[f"{name}.weight"] = (g * xhat).sum(0)

        out.register_hook(keep)

    for name, module in model.named_modules():
        if isinstance(module, (swinir.Linear, swinir.LayerNorm)):
            module.register_forward_hook(lambda m, i, o, name=name: hook(m, i, o, name))
    return sums


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("autocast", [False, True], ids=["float32", "bf16-autocast"])
def test_swinir_gradients_equal_the_plain_modules(autocast):
    """A TINY SwinIR through the new modules and the same model built from
    ``nn.Linear`` and ``nn.LayerNorm``: the same output and the same bits of
    every gradient that is not a column sum over the tokens. The sums: in
    float32 the linears' bias gradients are ``torch.sum``'s bits and the
    LayerNorms' agree with ATen's to float32 rounding (1e-5 of each one's
    largest). On the CPU, autocast casts the linears to bfloat16 and leaves
    LayerNorm as it comes, and ATen's mixed-dtype LayerNorm backward rounds
    its sums to bfloat16 (3.5e-2 of the largest from the float64 sums here),
    so under autocast each sum is held to the float64 sum of the gradient it
    saw: LayerNorm's to 1e-5, the linears' to a bfloat16 rounding (4e-3;
    autocast takes their bias gradient in bfloat16)."""
    model = SwinIR(**TINY)
    _randomise(model, 5)
    plain = _plain(model)
    assert sum(isinstance(m, swinir.Linear) for m in model.modules()) == 16
    assert sum(isinstance(m, swinir.LayerNorm) for m in model.modules()) == 10
    assert not any(isinstance(m, (swinir.Linear, swinir.LayerNorm)) for m in plain.modules())
    exact = _exact_sums(model)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 5, 16, 16, generator=gen)
    target = torch.randn(2, 1, 16, 16, generator=gen)
    out, got = _grads(model, x, target, autocast)
    want_out, want = _grads(plain, x, target, autocast)
    assert torch.equal(out, want_out)
    assert sorted(exact) == sorted(k for k in got if _summed(k))
    for key, g in got.items():
        assert g.dtype == want[key].dtype, key
        if not _summed(key) or (not autocast and "norm" not in key):
            assert torch.equal(g, want[key]), key
        elif not autocast:
            assert _rel(g, want[key].double()) <= 1e-5, key
        else:
            assert _rel(g, exact[key]) <= (1e-5 if "norm" in key else 4e-3), key


def test_state_dict_and_types_are_unchanged():
    """The new modules are ``nn.Linear`` and ``nn.LayerNorm`` to
    ``isinstance`` and hold the same state under the same keys."""
    model = SwinIR(**TINY)
    plain = _plain(model)
    assert list(model.state_dict()) == list(plain.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 plain.state_dict().values()))
    assert isinstance(model.layers[0].residual_group.blocks[0].attn.qkv, nn.Linear)
    assert isinstance(model.norm, nn.LayerNorm)
    plain.load_state_dict(model.state_dict())


def test_the_cpu_runs_the_twins():
    g, x = _rows(37, 12)
    mean, rstd = _stats(x)
    tr.reset_launch_counts()
    assert torch.equal(tr.bias_grad(g), tr.plain_bias_grad(g))
    for a, b in zip(tr.layer_norm_affine_grad(g, x, mean, rstd),
                    tr.plain_layer_norm_affine_grad(g, x, mean, rstd)):
        assert torch.equal(a, b)
    assert tr.launch_counts() == {"kernel_bias_grad": 0, "kernel_layer_norm_affine_grad": 0}


@pytest.mark.parametrize("c,dtype", [(180, torch.float32), (540, torch.bfloat16),
                                     (12, torch.float32), (4096, torch.bfloat16)])
def test_kernel_widths_are_accepted(c, dtype):
    g, x = _rows(5, c, dtype)
    mean, rstd = _stats(x)
    tr.check_kernel_widths(g)
    tr.check_kernel_widths(g, x, mean, rstd)


def _refused(case, device="cpu"):
    """Arguments of ``check_kernel_widths`` that the kernel does not take, on ``device``."""
    g, x = _rows(8, 180, device=device)
    mean, rstd = _stats(x)
    if case == "float16":
        return (g.half(),)
    if case == "float64":
        return (g.double(),)
    if case == "width":
        return (_rows(8, 18, device=device)[0],)
    if case == "too-wide":
        return (_rows(2, 4100, device=device)[0],)
    if case == "one-dim":
        return (g.flatten(),)
    if case == "strided":
        return (_rows(8, 360, device=device)[0][:, ::2],)
    if case == "misaligned":  # contiguous, 4 bytes past a 16-byte boundary
        return (torch.randn(8 * 180 + 1, device=device)[1:].view(8, 180),)
    if case == "input-shape":
        return g, x[:4], mean, rstd
    if case == "input-dtype":
        return g, x.bfloat16(), mean, rstd
    if case == "stats":
        return g, x, mean.double(), rstd


REFUSED = {"float16": TypeError, "float64": TypeError, "width": ValueError,
           "too-wide": ValueError, "one-dim": ValueError, "strided": ValueError,
           "misaligned": ValueError, "input-shape": ValueError, "input-dtype": ValueError,
           "stats": ValueError}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_the_kernel_does_not_take_is_refused(case):
    """What the CUDA path refuses, rather than run the twin on the card."""
    with pytest.raises(REFUSED[case]):
        tr.check_kernel_widths(*_refused(case))


# ------------------------------------------------------------------- on a card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gap(got, exact, g):
    """The widest gap to the float64 sum, over the column's sum of |terms|."""
    return float(((got.double() - exact) / g.double().abs().sum(0).clamp_min(1e-30)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("m", [51_200, 1003, 1])
def test_kernel_against_a_float64_sum(card, m, c, dtype):
    """Each column's sum within 1e-6 of its sum of |terms| of the float64
    sum of the same (widened) values: a float32 sum of a few dozen rows a
    thread, then trees, is within ~20 float32 roundings of it."""
    g, x = _rows(m, c, dtype, card, seed=c + m)
    mean, rstd = _stats(x)
    tr.reset_launch_counts()
    got = tr.kernel_bias_grad(g)
    dw, db = tr.kernel_layer_norm_affine_grad(g, x, mean, rstd)
    assert tr.launch_counts(dtype) == {"kernel_bias_grad": 1, "kernel_layer_norm_affine_grad": 1}
    g64 = g.double()
    xhat = (x.double() - mean.double()[:, None]) * rstd.double()[:, None]
    assert got.dtype == dw.dtype == db.dtype == torch.float32
    assert _gap(got, g64.sum(0), g64) <= 1e-6
    assert _gap(db, g64.sum(0), g64) <= 1e-6
    assert _gap(dw, (g64 * xhat).sum(0), g64 * xhat) <= 1e-6


@pytest.mark.cuda
def test_the_same_bits_twice(card):
    g, x = _rows(51_200, 540, torch.float32, card, seed=2)
    mean, rstd = _stats(x)
    first = [tr.kernel_bias_grad(g), *tr.kernel_layer_norm_affine_grad(g, x, mean, rstd)]
    second = [tr.kernel_bias_grad(g), *tr.kernel_layer_norm_affine_grad(g, x, mean, rstd)]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_no_rows_sum_to_zero(card):
    g, x = _rows(0, 180, torch.float32, card)
    mean, rstd = _stats(x)
    assert torch.equal(tr.kernel_bias_grad(g), torch.zeros(180, device=card))
    assert all(torch.equal(t, torch.zeros(180, device=card))
               for t in tr.kernel_layer_norm_affine_grad(g, x, mean, rstd))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float16", "width", "strided", "misaligned"])
def test_a_card_raises_for_what_the_kernel_does_not_take(card, case):
    g = _refused(case, card)[0]
    tr.reset_launch_counts()
    with pytest.raises(REFUSED[case]):
        tr.bias_grad(g)
    assert sum(tr.launch_counts(g.dtype).values()) == 0


def _block_modules(device, c=180, hidden=360):
    gen = torch.Generator().manual_seed(7)
    lin, norm = swinir.Linear(c, hidden), swinir.LayerNorm(c)
    with torch.no_grad():
        for p in [*lin.parameters(), *norm.parameters()]:
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return lin.to(device), norm.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("autocast", [False, True], ids=["float32", "bf16-autocast"])
def test_modules_against_aten_on_the_card(card, autocast):
    """LayerNorm then a linear at (32 maps of 40^2, 180 -> 360): the same
    output; the LayerNorm's input gradient and the linear's input and weight
    gradients bit for bit; the sums within 1e-5 of each one's largest
    (float32), a bfloat16 step under autocast. Each call of the modules'
    backward is one call of the kernel."""
    lin, norm = _block_modules(card)
    plain_lin, plain_norm = _plain(lin), _plain(norm)
    gen = torch.Generator(device=card).manual_seed(8)
    x = torch.randn(32, 1600, 180, device=card, generator=gen)
    g = torch.randn(32, 1600, 360, device=card, generator=gen)

    def run(n, l):
        t = x.clone().requires_grad_(True)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = l(n(t))
        out.backward(g.to(out.dtype))
        return out.detach(), t.grad, n.weight.grad, n.bias.grad, l.weight.grad, l.bias.grad

    tr.reset_launch_counts()
    got = run(norm, lin)
    counts = {k: tr.launch_counts(torch.float32)[k] + tr.launch_counts(torch.bfloat16)[k]
              for k in tr.launch_counts()}
    assert counts == {"kernel_bias_grad": 1, "kernel_layer_norm_affine_grad": 1}
    want = run(plain_norm, plain_lin)
    names = ("output", "input", "norm weight", "norm bias", "linear weight", "linear bias")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, name
        if name in ("output", "input", "linear weight"):
            assert torch.equal(a, b), name
        else:
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= (1e-2 if autocast else 1e-5), (name, err)


@pytest.mark.cuda
def test_a_published_step_against_the_aten_path(card):
    """A published-width SwinIR at (32, 40^2): the forward bit for bit, every
    gradient that is not a column sum bit for bit, and the widest leaf's gap
    of all (``grad_gap``) under the cell's limit; 144 bias and 74 LayerNorm
    reductions. cuDNN is held to its deterministic algorithms here: some of
    its convolutions' weight-gradient algorithms give other bits from run to
    run, with or without this change."""
    model = SwinIR(**PUBLISHED, generator=torch.Generator().manual_seed(9))
    _randomise(model, 10)
    plain = _plain(model).to(card)
    model = model.to(card)
    gen = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(32, 5, 40, 40, device=card, generator=gen)
    target = torch.randn(32, 1, 40, 40, device=card, generator=gen)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tr.reset_launch_counts()
        out, got = _grads(model, x, target)
        assert tr.launch_counts() == {"kernel_bias_grad": 144,
                                      "kernel_layer_norm_affine_grad": 74}
        want_out, want = _grads(plain, x, target)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert torch.equal(out, want_out)
    assert [k for k, g in got.items() if not _summed(k) and not torch.equal(g, want[k])] == []
    gap = max(float((g - want[k]).abs().max() / want[k].abs().max()) for k, g in got.items())
    assert gap <= GRAD_GAP, gap


@pytest.mark.cuda
def test_the_profiler_sees_the_operators(card):
    """Under a profiler with host operations each kernel call is two
    launches under a ``swinir::token_`` operation, and the benchmark's
    readers read them: every column sum on the kernel, and a positive time."""
    from portbench import harness, trace

    lin, norm = _block_modules(card)
    x = torch.randn(4, 1600, 180, device=card, requires_grad=True)

    def run():
        lin(norm(x)).sum().backward()
        return 1

    run()
    recorded, _ = trace.record(run, host_ops=True)
    ours = [a for a in recorded.activities if "token_reduce" in a.name]
    assert len(ours) == 4, [a.name for a in ours]
    assert all(any(op.startswith("swinir::token_") for op in a.ops) for a in ours)
    cell = harness.load_cell("swinir_train_b32")
    r = harness.Reading(recorded, 1, recorded, 1, "step", cell.config, cell.traffic, cell.family)
    metrics = harness.HERE / "metrics"
    assert harness.load_module(metrics / "token_reduce_kernel_pct.py").read(r) == 100.0
    assert harness.load_module(metrics / "token_reduce_ms_per_step.py").read(r) > 0
