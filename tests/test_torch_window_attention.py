"""PyTorch port, ``ops/window_attention.py``: SwinIR's and HAT's shifted-window
attention and HAT's overlapping cross-window attention, in token layout.

On the CPU, the plain twin against the composition it replaced in the model
(roll the map by ``-shift``, cut it into windows, attend with the bias and
upstream's region mask from the 3x3 slicing, put the windows back, roll
back), written out here, in float64; ``gradcheck`` of the twin; the widths
and dtypes the kernels take and refuse. On a card (tests marked ``cuda``,
skipped without one), the kernel pair against the twin: output, qkv gradient
and bias-table gradient at the published widths and at TINY, plain and
shifted, on square and non-square maps; the bias gradient bit for bit over
two runs; bfloat16 widened to the kernels; widths without a kernel and a
refused launch raising; the launches, the span and the operators' names in
the profiler. The same for the tiled kernels: HAT's window-16 attention
(plain and shifted) and its overlapping cross-window attention (border
windows whose keys lie partly outside the map), against the twins, the same
bits twice. On a card run
``python -m pytest --noconftest -q tests/test_torch_window_attention.py``."""

import pytest
import torch

from superresolution_for_pdes_tpu_torch.ops import window_attention as wa

import torch_port_helpers  # noqa: F401  (thread limit)

# (window, heads, head size): the tests' TINY widths and SwinIR's published ones
TINY = (4, 2, 6)
PUBLISHED = (8, 6, 30)


def _inputs(window, heads, d, b, hp, wp, dtype=torch.float64, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, hp, wp, 3 * heads * d, generator=gen, dtype=dtype, device=device)
    table = 0.5 * torch.randn((2 * window - 1) ** 2, heads, generator=gen, dtype=dtype,
                              device=device)
    return qkv, table


def _composition(qkv, table, heads, window, shift, scale):
    """The block as the model composed it before the token-layout attention:
    the map rolled by ``-shift``, cut into windows, attended with the
    relative-position bias and (shifted) the region mask of upstream's 3x3
    slicing, the windows put back, the map rolled back by ``shift``."""
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, window * window
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    win = x.view(b, hp // window, window, wp // window, window, c3).permute(0, 1, 3, 2, 4, 5)
    q, k, v = win.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :] + window - 1
    bias = table[rel[0] * (2 * window - 1) + rel[1]].permute(2, 0, 1)
    attn = (q * scale) @ k.transpose(-2, -1) + bias
    if shift:
        img = torch.zeros(hp, wp)
        cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
        for i, rows in enumerate(cuts):
            for j, cols in enumerate(cuts):
                img[rows, cols] = 3 * i + j
        ids = img.view(hp // window, window, wp // window, window).permute(0, 2, 1, 3)
        ids = ids.reshape(-1, n)
        mask = (ids[:, None, :] != ids[:, :, None]).to(qkv.dtype) * -100.0
        nw = mask.shape[0]
        attn = (attn.view(b, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    o = (attn.softmax(-1) @ v).transpose(1, 2)
    o = o.reshape(b, hp // window, wp // window, window, window, c).permute(0, 1, 3, 2, 4, 5)
    o = o.reshape(b, hp, wp, c)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


@pytest.mark.parametrize("widths,b,hp,wp,shift", [
    (TINY, 2, 8, 8, 0), (TINY, 2, 8, 8, 2), (TINY, 3, 12, 8, 2), (TINY, 1, 16, 12, 2),
    (PUBLISHED, 1, 16, 24, 0), (PUBLISHED, 1, 16, 24, 4)])
def test_twin_equals_the_rolled_window_composition(widths, b, hp, wp, shift):
    window, heads, d = widths
    qkv, table = _inputs(window, heads, d, b, hp, wp)
    got = wa.plain_window_attention(qkv, table, heads, window, shift, d ** -0.5)
    want = _composition(qkv, table, heads, window, shift, d ** -0.5)
    assert got.shape == (b, hp, wp, heads * d)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("shift", [0, 2], ids=["plain", "shifted"])
def test_twin_gradcheck(shift):
    window, heads, d = TINY
    qkv, table = _inputs(window, heads, d, 1, 8, 8, seed=1)
    qkv.requires_grad_(True)
    table.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, t: wa.plain_window_attention(x, t, heads, window, shift, d ** -0.5),
        (qkv, table))


def _unfold_composition(qkv, table, heads, window, key_window, scale):
    """Upstream's OCAB attention (``hat_arch.py``): q in windows, k and v cut
    by ``nn.Unfold`` (zero padding) from the map after the linear, the
    bias of ``calculate_rpi_oca``, ``softmax(q k^T + bias) v``, windows put
    back; written out here with explicit loops over the windows."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    d, pad = c // heads, (key_window - window) // 2
    padded = torch.nn.functional.pad(qkv[..., c:], (0, 0, pad, pad, pad, pad))
    ori = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                     indexing="ij")).flatten(1)
    ext = torch.stack(torch.meshgrid(torch.arange(key_window), torch.arange(key_window),
                                     indexing="ij")).flatten(1)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0).clone()
    rel += window - key_window + 1
    rel[:, :, 0] *= window + key_window - 1
    bias = table[rel.sum(-1).view(-1)].view(window ** 2, key_window ** 2, heads).permute(2, 0, 1)
    out = torch.empty(b, hp, wp, c, dtype=qkv.dtype)
    for r in range(0, hp, window):
        for s in range(0, wp, window):
            q = qkv[:, r:r + window, s:s + window, :c].reshape(b, -1, heads, d).transpose(1, 2)
            kv = padded[:, r:r + key_window, s:s + key_window].reshape(b, -1, 2, heads, d)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
            o = ((q * scale) @ k.transpose(-2, -1) + bias).softmax(-1) @ v
            out[:, r:r + window, s:s + window] = o.transpose(1, 2).reshape(b, window, window, c)
    return out


# (window, key window, heads, head size): the tests' TINY widths and HAT's published ones
OVERLAP_TINY = (4, 6, 2, 6)
OVERLAP_PUBLISHED = (16, 24, 6, 30)


def _overlap_inputs(window, key_window, heads, d, b, hp, wp, dtype=torch.float64, device="cpu",
                    seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, hp, wp, 3 * heads * d, generator=gen, dtype=dtype, device=device)
    table = 0.5 * torch.randn((window + key_window - 1) ** 2, heads, generator=gen, dtype=dtype,
                              device=device)
    return qkv, table


@pytest.mark.parametrize("widths,b,hp,wp", [(OVERLAP_TINY, 2, 8, 8), (OVERLAP_TINY, 1, 12, 8),
                                            (OVERLAP_TINY, 2, 4, 4),
                                            (OVERLAP_PUBLISHED, 1, 32, 48)])
def test_overlap_twin_equals_the_unfold_composition(widths, b, hp, wp):
    """Border windows attend keys outside the map: zero keys and values
    whose logits are their bias alone."""
    window, key_window, heads, d = widths
    qkv, table = _overlap_inputs(window, key_window, heads, d, b, hp, wp)
    got = wa.plain_overlapping_window_attention(qkv, table, heads, window, key_window, d ** -0.5)
    want = _unfold_composition(qkv, table, heads, window, key_window, d ** -0.5)
    assert got.shape == (b, hp, wp, heads * d)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_overlap_twin_gradcheck():
    window, key_window, heads, d = OVERLAP_TINY
    qkv, table = _overlap_inputs(window, key_window, heads, d, 1, 8, 4, seed=1)
    qkv.requires_grad_(True)
    table.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, t: wa.plain_overlapping_window_attention(x, t, heads, window, key_window,
                                                           d ** -0.5), (qkv, table))


@pytest.mark.parametrize("window,key_window", [(16, 24), (4, 6), (8, 12)])
def test_overlap_index_is_a_bijection_onto_the_table(window, key_window):
    """Every row of the ``(window + key_window - 1)^2``-row table is the bias
    of exactly one key-minus-query offset."""
    index = wa.overlap_relative_index(window, key_window)
    side = window + key_window - 1
    i, j = torch.arange(window ** 2), torch.arange(key_window ** 2)
    dr = (j // key_window)[None, :] - (i // window)[:, None]
    dc = (j % key_window)[None, :] - (i % window)[:, None]
    offsets = ((dr + window - 1) * side + dc + window - 1).flatten()
    rows = index.flatten()
    assert sorted(set(offsets.tolist())) == list(range(side * side))
    pairs = set(zip(offsets.tolist(), rows.tolist()))
    assert len(pairs) == side * side and {r for _, r in pairs} == set(range(side * side))


def test_the_cpu_runs_the_twin():
    window, heads, d = TINY
    qkv, table = _inputs(window, heads, d, 2, 8, 12, dtype=torch.float32)
    wa.reset_launch_counts()
    assert torch.equal(wa.window_attention(qkv, table, heads, window, 2, 0.4),
                       wa.plain_window_attention(qkv, table, heads, window, 2, 0.4))
    assert wa.launch_counts() == {"kernel_forward": 0, "kernel_backward": 0}
    window, key_window, heads, d = OVERLAP_TINY
    qkv, table = _overlap_inputs(window, key_window, heads, d, 2, 8, 12, dtype=torch.float32)
    assert torch.equal(wa.overlapping_window_attention(qkv, table, heads, window, key_window, 0.4),
                       wa.plain_overlapping_window_attention(qkv, table, heads, window,
                                                             key_window, 0.4))
    assert wa.overlap_launch_counts() == {"overlap_kernel_forward": 0,
                                          "overlap_kernel_backward": 0}


@pytest.mark.parametrize("window,heads,d,dtype", [
    (8, 6, 30, torch.float32), (8, 6, 30, torch.bfloat16), (4, 2, 6, torch.float16),
    (4, 4, 6, torch.float32), (16, 6, 30, torch.float32), (16, 6, 30, torch.bfloat16)])
def test_kernel_widths_are_accepted(window, heads, d, dtype):
    qkv, table = _inputs(window, heads, d, 1, 8, 8, dtype=dtype)
    wa.check_kernel_widths(qkv, table.float(), heads, window)


@pytest.mark.parametrize("window,key_window,heads,d,dtype,error", [
    (16, 24, 6, 30, torch.float32, None), (4, 6, 2, 6, torch.bfloat16, None),
    (16, 24, 3, 30, torch.float32, ValueError),   # an odd number of heads
    (16, 16, 6, 30, torch.float32, ValueError),   # no overlap: window_attention's
    (8, 12, 6, 30, torch.float32, ValueError),    # a window without a kernel
    (16, 24, 6, 30, torch.float64, TypeError)],
    ids=["published", "tiny-bf16", "odd-heads", "no-overlap", "window", "float64"])
def test_overlap_widths(window, key_window, heads, d, dtype, error):
    qkv, table = _overlap_inputs(window, key_window, heads, d, 1, window, window, dtype=dtype)
    if error is None:
        wa.check_overlap_widths(qkv, table, heads, window, key_window)
    else:
        with pytest.raises(error):
            wa.check_overlap_widths(qkv, table, heads, window, key_window)


@pytest.mark.parametrize("window,heads,d,dtype,error", [
    (8, 3, 30, torch.float32, ValueError),  # an odd number of heads
    (8, 6, 32, torch.float32, ValueError),  # a head size without a kernel
    (5, 2, 6, torch.float32, ValueError),   # a window without a kernel
    (16, 2, 6, torch.float32, ValueError),  # window 16 with heads of 6
    (8, 6, 30, torch.float64, TypeError)],  # wider than the kernels
    ids=["odd-heads", "head-size", "window", "window-16-head-6", "float64"])
def test_widths_without_a_kernel_are_refused(window, heads, d, dtype, error):
    """What the CUDA path refuses, rather than run the twin on the card."""
    qkv, table = _inputs(window, heads, d, 1, 2 * window, 2 * window, dtype=dtype)
    with pytest.raises(error):
        wa.check_kernel_widths(qkv, table, heads, window)


# ------------------------------------------------------------------- on a card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(fn, qkv, table, g, heads, window, shift, scale):
    """``fn``'s output and the gradients of ``sum(out * g)`` for qkv and the table."""
    x, t = (v.detach().clone().requires_grad_(True) for v in (qkv, table))
    out = fn(x, t, heads, window, shift, scale)
    (out * g).sum().backward()
    return out.detach(), x.grad, t.grad


def _rel(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


CARD_CASES = [(PUBLISHED, 32, 40, 40), (PUBLISHED, 4, 48, 40), (TINY, 3, 40, 40),
              (TINY, 3, 48, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("widths,b,hp,wp", CARD_CASES,
                         ids=["published-40x40", "published-48x40", "tiny-40x40", "tiny-48x40"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_kernels_match_the_twin(card, widths, b, hp, wp, shifted):
    """Output, qkv gradient and bias-table gradient of the kernels and of the
    float32 twin, each against the float64 twin: the kernels' error at most
    twice the twin's, or 1e-6 of the largest value (output) and 1e-5
    (gradients, sums over every window)."""
    window, heads, d = widths
    shift = window // 2 if shifted else 0
    qkv, table = _inputs(window, heads, d, b, hp, wp, torch.float32, card)
    g = torch.randn(b, hp, wp, heads * d, device=card,
                    generator=torch.Generator(device=card).manual_seed(9))
    scale = d ** -0.5
    wa.reset_launch_counts()
    kernel = _run(wa.window_attention, qkv, table, g, heads, window, shift, scale)
    assert wa.launch_counts() == {"kernel_forward": 1, "kernel_backward": 1}
    twin = _run(wa.plain_window_attention, qkv, table, g, heads, window, shift, scale)
    exact = _run(wa.plain_window_attention, qkv.double(), table.double(), g.double(), heads,
                 window, shift, scale)
    torch.cuda.synchronize()
    for what, k, t, e, floor in zip(("output", "qkv gradient", "table gradient"), kernel, twin,
                                    exact, (1e-6, 1e-5, 1e-5)):
        assert _rel(k, e) <= max(2 * _rel(t, e), floor), (what, _rel(k, e), _rel(t, e))


@pytest.mark.cuda
def test_bias_gradient_is_the_same_bits_twice(card):
    window, heads, d = PUBLISHED
    qkv, table = _inputs(window, heads, d, 32, 40, 40, torch.float32, card, seed=3)
    g = torch.randn(32, 40, 40, heads * d, device=card,
                    generator=torch.Generator(device=card).manual_seed(4))
    first, second = (_run(wa.window_attention, qkv, table, g, heads, window, 4, d ** -0.5)
                     for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_a_refused_launch_raises(card):
    """A window the kernels are not built for (5) and a shift of a whole
    window are refused by the launch, and the wrapper raises."""
    heads, d = 2, 6
    qkv = torch.randn(1, 40, 40, 3 * heads * d, device=card)
    with pytest.raises(RuntimeError, match="cudaError"):
        wa.kernel_forward(qkv, torch.zeros(81, heads, device=card), heads, 5, 0, 0.4)
    with pytest.raises(RuntimeError, match="cudaError"):
        wa.kernel_forward(qkv, torch.zeros(49, heads, device=card), heads, 4, 4, 0.4)
    with pytest.raises(ValueError, match="float32"):
        wa.kernel_forward(qkv.double(), torch.zeros(49, heads, device=card), heads, 4, 0, 0.4)


@pytest.mark.cuda
def test_bfloat16_is_widened_to_the_kernels(card):
    """bfloat16 qkv (the qkv linear's output under autocast) runs the float32
    kernels on its widened values: the output is theirs rounded to bfloat16,
    and so is the qkv gradient; the table's gradient is float32. Under
    autocast, the qkv linear's bfloat16 output takes the same path."""
    window, heads, d = PUBLISHED
    qkv, table = _inputs(window, heads, d, 4, 48, 40, torch.float32, card, seed=5)
    qkv = qkv.bfloat16()
    g = torch.randn(4, 48, 40, heads * d, device=card,
                    generator=torch.Generator(device=card).manual_seed(6))
    wa.reset_launch_counts()
    got = _run(wa.window_attention, qkv, table, g.bfloat16(), heads, window, 4, d ** -0.5)
    assert wa.launch_counts() == {"kernel_forward": 1, "kernel_backward": 1}
    want = _run(wa.window_attention, qkv.float(), table, g.bfloat16().float(), heads, window, 4,
                d ** -0.5)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    assert torch.equal(got[0], want[0].bfloat16()) and torch.equal(got[1], want[1].bfloat16())
    assert torch.equal(got[2], want[2])
    linear = torch.nn.Linear(heads * d, 3 * heads * d, device=card)
    x = torch.randn(4, 48, 40, heads * d, device=card)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = wa.window_attention(linear(x), table, heads, window, 4, d ** -0.5)
    assert out.dtype == torch.bfloat16
    assert wa.launch_counts() == {"kernel_forward": 3, "kernel_backward": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("heads,d,dtype,error", [(3, 30, torch.float32, ValueError),
                                                 (6, 32, torch.float32, ValueError),
                                                 (6, 30, torch.float64, TypeError)],
                         ids=["odd-heads", "head-size", "float64"])
def test_a_card_raises_for_widths_without_a_kernel(card, heads, d, dtype, error):
    """On a card nothing falls back to the twin: a width or dtype the
    kernels are not built for raises before any launch."""
    qkv, table = _inputs(8, heads, d, 1, 16, 16, dtype, card)
    wa.reset_launch_counts()
    with pytest.raises(error):
        wa.window_attention(qkv, table, heads, 8, 4, d ** -0.5)
    assert wa.launch_counts() == {"kernel_forward": 0, "kernel_backward": 0}


@pytest.mark.cuda
def test_the_profiler_sees_the_operators_and_the_span(card):
    """Under a profiler with host operations, every kernel of the pair (the
    forward, the backward and the bias sum) is launched inside an operation
    whose name holds ``scaled_dot_product``, as the benchmark's attention
    reader requires, and the forward runs inside ``swinir.attention.kernel``."""
    from portbench import trace
    from superresolution_for_pdes_tpu_torch.utils.profiling import clear_spans, recorded_spans

    window, heads, d = PUBLISHED
    qkv, table = _inputs(window, heads, d, 2, 40, 40, torch.float32, card)
    g = torch.ones(2, 40, 40, heads * d, device=card)

    def run():
        _run(wa.window_attention, qkv, table, g, heads, window, 4, d ** -0.5)
        return 1

    _run(wa.window_attention, qkv, table, g, heads, window, 4, d ** -0.5)
    clear_spans()
    recorded, _ = trace.record(run, host_ops=True)
    ours = [a for a in recorded.activities if "window_attention" in a.name
            or "bias_grad_sum" in a.name]
    assert len(ours) == 3, [a.name for a in ours]
    assert all(any("scaled_dot_product" in op for op in a.ops) for a in ours)
    spans = [s for s in recorded_spans() if s.name == "swinir.attention.kernel"]
    assert [s.n for s in spans] == [2 * 25 * heads]


# ------------------------------------------------------ tiled kernels, on a card
HAT_WINDOW = (16, 6, 30)


def _run_overlap(fn, qkv, table, g, heads, window, key_window, scale):
    x, t = (v.detach().clone().requires_grad_(True) for v in (qkv, table))
    out = fn(x, t, heads, window, key_window, scale)
    (out * g).sum().backward()
    return out.detach(), x.grad, t.grad


def _against_twins(kernel, twin, exact, what):
    for name, k, t, e, floor in zip(("output", "qkv gradient", "table gradient"), kernel, twin,
                                    exact, (1e-6, 1e-5, 1e-5)):
        assert _rel(k, e) <= max(2 * _rel(t, e), floor), (what, name, _rel(k, e), _rel(t, e))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hp,wp", [(4, 48, 48), (1, 32, 64), (32, 48, 48)],
                         ids=["48x48", "32x64", "cell-32x48x48"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
def test_window_16_kernels_match_the_twin(card, b, hp, wp, shifted):
    """HAT's window attention at its published widths (window 16, heads of
    30) on the tiled kernels: output, qkv and table gradients against the
    float64 twin, as the pair's (three device launches a backward); also at
    the shape ``hat_train_b32`` steps at (32 maps of 48^2)."""
    window, heads, d = HAT_WINDOW
    shift = window // 2 if shifted else 0
    qkv, table = _inputs(window, heads, d, b, hp, wp, torch.float32, card)
    g = torch.randn(b, hp, wp, heads * d, device=card,
                    generator=torch.Generator(device=card).manual_seed(9))
    scale = d ** -0.5
    wa.reset_launch_counts()
    kernel = _run(wa.window_attention, qkv, table, g, heads, window, shift, scale)
    assert wa.launch_counts() == {"kernel_forward": 1, "kernel_backward": 1}
    twin = _run(wa.plain_window_attention, qkv, table, g, heads, window, shift, scale)
    exact = _run(wa.plain_window_attention, qkv.double(), table.double(), g.double(), heads,
                 window, shift, scale)
    torch.cuda.synchronize()
    _against_twins(kernel, twin, exact, "window 16")


@pytest.mark.cuda
@pytest.mark.parametrize("widths,b,hp,wp", [(OVERLAP_PUBLISHED, 4, 48, 48),
                                            (OVERLAP_PUBLISHED, 1, 32, 64),
                                            (OVERLAP_PUBLISHED, 32, 48, 48),
                                            (OVERLAP_TINY, 3, 40, 40), (OVERLAP_TINY, 2, 4, 8)],
                         ids=["published-48x48", "published-32x64", "published-cell-32x48x48",
                              "tiny-40x40", "tiny-4x8"])
def test_overlap_kernels_match_the_twin(card, widths, b, hp, wp):
    """HAT's overlapping attention on its kernels against the float64 twin:
    border windows whose keys lie outside the map, tokens in up to four key
    windows (the dK and dV sums); also at the shape ``hat_train_b32`` steps
    at (32 maps of 48^2)."""
    window, key_window, heads, d = widths
    qkv, table = _overlap_inputs(window, key_window, heads, d, b, hp, wp, torch.float32, card)
    g = torch.randn(b, hp, wp, heads * d, device=card,
                    generator=torch.Generator(device=card).manual_seed(9))
    scale = d ** -0.5
    wa.reset_launch_counts()
    kernel = _run_overlap(wa.overlapping_window_attention, qkv, table, g, heads, window,
                          key_window, scale)
    assert wa.overlap_launch_counts() == {"overlap_kernel_forward": 1,
                                          "overlap_kernel_backward": 1}
    assert wa.launch_counts() == {"kernel_forward": 0, "kernel_backward": 0}
    twin = _run_overlap(wa.plain_overlapping_window_attention, qkv, table, g, heads, window,
                        key_window, scale)
    exact = _run_overlap(wa.plain_overlapping_window_attention, qkv.double(), table.double(),
                         g.double(), heads, window, key_window, scale)
    torch.cuda.synchronize()
    _against_twins(kernel, twin, exact, "overlap")


@pytest.mark.cuda
def test_tiled_kernels_give_the_same_bits_twice(card):
    window, heads, d = HAT_WINDOW
    qkv, table = _inputs(window, heads, d, 8, 48, 48, torch.float32, card, seed=3)
    g = torch.randn(8, 48, 48, heads * d, device=card,
                    generator=torch.Generator(device=card).manual_seed(4))
    first, second = (_run(wa.window_attention, qkv, table, g, heads, window, 8, d ** -0.5)
                     for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    window, key_window, heads, d = OVERLAP_PUBLISHED
    qkv, table = _overlap_inputs(window, key_window, heads, d, 8, 48, 48, torch.float32, card,
                                 seed=5)
    first, second = (_run_overlap(wa.overlapping_window_attention, qkv, table, g, heads, window,
                                  key_window, d ** -0.5) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_the_profiler_sees_the_overlap_operators_and_span(card):
    """The overlapping attention's kernels launch under ``hat::`` operations
    without ``scaled_dot_product`` in their names (so the window attention's
    reader does not count them), and the forward inside ``hat.ocab.kernel``."""
    from portbench import trace
    from superresolution_for_pdes_tpu_torch.utils.profiling import clear_spans, recorded_spans

    window, key_window, heads, d = OVERLAP_PUBLISHED
    qkv, table = _overlap_inputs(window, key_window, heads, d, 2, 32, 32, torch.float32, card)
    g = torch.ones(2, 32, 32, heads * d, device=card)

    def run():
        _run_overlap(wa.overlapping_window_attention, qkv, table, g, heads, window, key_window,
                     d ** -0.5)
        return 1

    run()
    clear_spans()
    recorded, _ = trace.record(run, host_ops=True)
    ours = [a for a in recorded.activities if "tiled_attention" in a.name
            or "bias_grad_sum" in a.name or "kv_fold" in a.name]
    assert len(ours) == 5, [a.name for a in ours]
    assert all(any(op.startswith("hat::overlapping_window_attention") for op in a.ops)
               and not any("scaled_dot_product" in op for op in a.ops) for a in ours)
    spans = [s for s in recorded_spans() if s.name == "hat.ocab.kernel"]
    assert [s.n for s in spans] == [2 * 4 * heads]


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True], ids=["window-16", "overlap"])
def test_bfloat16_is_widened_to_the_tiled_kernels(card, overlap):
    """bfloat16 qkv runs the tiled float32 kernels on its widened values: the
    output and the qkv gradient are theirs rounded to bfloat16, the table's
    gradient float32."""
    if overlap:
        window, key_window, heads, d = OVERLAP_PUBLISHED
        qkv, table = _overlap_inputs(window, key_window, heads, d, 2, 32, 48, torch.float32, card,
                                     seed=5)
        run, fn, args = _run_overlap, wa.overlapping_window_attention, (window, key_window)
    else:
        window, heads, d = HAT_WINDOW
        qkv, table = _inputs(window, heads, d, 2, 32, 48, torch.float32, card, seed=5)
        run, fn, args = _run, wa.window_attention, (window, 8)
    g = torch.randn(2, 32, 48, heads * d, device=card,
                    generator=torch.Generator(device=card).manual_seed(6))
    got = run(fn, qkv.bfloat16(), table, g.bfloat16(), heads, *args, d ** -0.5)
    want = run(fn, qkv.bfloat16().float(), table, g.bfloat16().float(), heads, *args, d ** -0.5)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    assert torch.equal(got[0], want[0].bfloat16()) and torch.equal(got[1], want[1].bfloat16())
    assert torch.equal(got[2], want[2])
