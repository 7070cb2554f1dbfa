"""PyTorch port, ``models/restormer.py`` and ``ops/transposed_attention.py``:
Restormer against the benchmark's plain reference
(``portbench/families/restormer.py``, written out as upstream's
``restormer_arch.py``: its LayerNorm's mean and biased variance,
``F.normalize``, explicit ``q k^T``, ``softmax`` and ``A v``, pixel
(un)shuffle), at TINY widths (two heads at every scale) on seeded random
weights (every tensor, the LayerNorms and temperatures included): the
forward at 40^2 and 80^2 (and a size that is not a multiple of 8), one R7
train step's loss, gradients and AdamW update through the program's
``train_step``; planted faults in the attention that the comparison must
catch; its registry entry at the published widths; a bundle of it served
through the cascade. There is no JAX twin.

On a card (tests marked ``cuda``, skipped without one) the three kernels
of ``csrc/transposed_attention.cu`` against the float64 twin at heads of 48
and 96, at (1, 160^2), (16, 160^2), every scale of the cascade's 80^2 and
160^2 tiles and token counts that are not a multiple of 4, the same bits
twice, the launches counted, and widths without a kernel refused. On a card run ``python -m pytest --noconftest -q
tests/test_torch_restormer.py`` (the replayed levels:
``tests/test_torch_graphs.py -k restormer``)."""

import json

import pytest
import torch
import torch.nn.functional as F

from portbench.families import restormer as reference
from portbench.reference import train as ref_train
from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.deploy import load_bundle, save_bundle
from superresolution_for_pdes_tpu_torch.models import Restormer, build_model, count_parameters
from superresolution_for_pdes_tpu_torch.models import restormer as restormer_module
from superresolution_for_pdes_tpu_torch.ops import transposed_attention as ta
from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop

import torch_port_helpers  # noqa: F401  (thread limit)

ARCH = {"in_channels": 5, **reference.TINY}
PUBLISHED = {"in_channels": 5, "dim": 48, "num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4,
             "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66}
# float32 throughout; the two sides order their sums differently (F.layer_norm
# against the mean and biased variance written out): 5e-7 to 6e-7 of
# max|output| at these sizes, so 1e-5 leaves room for the platform's kernels
# and fails on any wrong term (the planted faults read 1e-2 and more)
OUT_REL = 1e-5
# each parameter's gradient sums over every token; the LayerNorms' cancel
GRAD_REL = 1e-4
SIZES = [(40, 40), (80, 80), (36, 44)]


def _weights(arch, seed):
    """A state_dict of ``arch`` with every tensor drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {key: 0.2 * torch.randn(shape, generator=gen)
            for key, shape, _ in reference.layout(arch)}


def _model(arch, state):
    model = build_model(**reference.program_config(arch))
    model.load_state_dict(state)
    return model


def _input(size, seed=1, batch=2):
    return torch.randn(batch, 5, *size, generator=torch.Generator().manual_seed(seed))


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _close(got, want, rel, what):
    err = _rel(got, want)
    assert err <= rel, f"{what}: {err:.3e} > {rel:g}"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_matches_the_reference(size):
    state = _weights(ARCH, 11)
    model = _model(ARCH, state).eval()
    x = _input(size)
    with torch.no_grad():
        got = model(x)
    assert got.shape == (2, 1, *size)
    _close(got, reference.forward(ARCH, state, x), OUT_REL, "output")


def _raw(n, seed):
    """A tiny R7-like set: coarse 20^2, fine 40^2 fields."""
    gen = torch.Generator().manual_seed(seed)
    return {"u_coarse": torch.randn(n, 20, 20, generator=gen),
            "u_fine": torch.randn(n, 40, 40, generator=gen),
            "f_fine": torch.randn(n, 40, 40, generator=gen),
            "theta_fine": 0.5 + torch.rand(n, 40, 40, generator=gen)}


def test_one_r7_train_step_matches_the_reference():
    """The program's ``train_step`` (R7's loss with the physics term on the
    plain twins, clip at 1, AdamW) against ``portbench/reference/train.py``:
    the loss, every parameter's clipped gradient and the norm of its change
    (AdamW's first step is about ``lr sign(g)``, so an entry whose gradient
    is near its ``eps`` moves by the rounding of that gradient: the change is
    held by its norm, as the benchmark's ``change_gap`` holds it)."""
    recipe = {"normalization": "per_sample", "scale_channels": True}
    state = _weights(ARCH, 13)
    raw = _raw(6, 14)
    rows = torch.tensor([4, 1, 3, 0])
    model = _model(ARCH, state)
    stats = NormStats.from_dataset(raw)
    arrays = loop.prepare_arrays(raw, stats, per_sample=True, scale_channels=True)
    opt = loop.make_optimizer(model, TrainConfig(learning_rate=2e-4, weight_decay=1e-4))
    batch = {k: v[rows] for k, v in arrays.items()}
    loss = float(loop.train_step(model, opt, batch, stats, physics_weight=0.3, grad_clip=1.0))

    params = {k: v.clone() for k, v in state.items()}
    ref_opt = ref_train.AdamW(params, 2e-4, 1e-4)
    ref_loss, grads = ref_train.step(lambda p, x: reference.forward(ARCH, p, x, train=True),
                                     params, {}, ref_opt, ref_train.batch_arrays(raw, rows, recipe),
                                     0.3, 1.0)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    named = dict(model.named_parameters())
    assert named.keys() == grads.keys()
    for key, g in grads.items():
        _close(named[key].grad, g, GRAD_REL, f"gradient of {key}")
        got, want = (named[key].detach() - state[key]).norm(), (params[key] - state[key]).norm()
        assert abs(got - want) <= GRAD_REL * want, f"change of {key}: {got} against {want}"


# the transposed attention with one fault planted each; the comparison with
# the reference must fail on every one
def _no_temperature(qkv, temperature, heads):
    return ta.plain_transposed_attention(qkv, torch.ones_like(temperature), heads)


def _softmax_over_rows(qkv, temperature, heads):
    b, c3, h, w = qkv.shape
    q, k, v = qkv.reshape(b, 3, heads, c3 // (3 * heads), h * w).unbind(1)
    attn = ((F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1))
            * temperature).softmax(-2)
    return (attn @ v).reshape(b, c3 // 3, h, w)


def _not_normalised(qkv, temperature, heads):
    b, c3, h, w = qkv.shape
    q, k, v = qkv.reshape(b, 3, heads, c3 // (3 * heads), h * w).unbind(1)
    attn = ((q @ k.transpose(-2, -1)) * temperature).softmax(-1)
    return (attn @ v).reshape(b, c3 // 3, h, w)


def _head_rows_swapped(qkv, temperature, heads):
    out = ta.plain_transposed_attention(qkv, temperature, heads)
    return out[:, [1, 0, *range(2, out.shape[1])]]


@pytest.mark.parametrize("fault", [_no_temperature, _softmax_over_rows, _not_normalised,
                                   _head_rows_swapped], ids=lambda f: f.__name__.strip("_"))
def test_planted_faults_fail_the_comparison(fault, monkeypatch):
    state = _weights(ARCH, 11)
    model = _model(ARCH, state).eval()
    x = _input((40, 40))
    want = reference.forward(ARCH, state, x)
    monkeypatch.setattr(restormer_module, "transposed_attention", fault)
    with torch.no_grad():
        got = model(x)
    assert _rel(got, want) > 100 * OUT_REL


def test_bfloat16_fails_the_tolerance():
    """The tolerance tells float32 from the nearest precision below it."""
    state = _weights(ARCH, 11)
    model = _model(ARCH, state).eval()
    x = _input((40, 40))
    want = reference.forward(ARCH, state, x)
    with torch.no_grad():
        low = model.bfloat16()(x.bfloat16()).float()
    assert _rel(low, want) > OUT_REL


@pytest.mark.parametrize("arch", [ARCH, PUBLISHED], ids=["tiny", "published"])
def test_state_dict_is_the_layout(arch):
    """The program's keys and shapes are the reference's layout, upstream's
    keys; at the published widths 26,125,780 parameters."""
    model = build_model(**reference.program_config(arch))
    layout = reference.layout(arch)
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == \
        [(k, tuple(s)) for k, s, _ in layout]
    assert count_parameters(model) == sum(v.numel() for v in model.state_dict().values())
    if arch is PUBLISHED:
        assert count_parameters(model) == 26_125_780
        assert isinstance(model, Restormer) and model.in_channels == 5
        assert model.encoder_level1[0].ffn.project_out.in_channels == 127
        assert model.decoder_level1[0].ffn.dwconv.out_channels == 510


def test_a_bundle_serves_the_cascade(tmp_path):
    """``save_bundle`` -> ``load_bundle`` -> ``ml_cascade`` gives the fields
    that ``ml_cascade`` gives with the modules' own weights."""
    experts = [_weights(ARCH, 20 + i) for i in range(2)]
    save_bundle(tmp_path / "b", reference.program_config(ARCH), experts, stats_mode="tile",
                coarse_tile=(20, 40))
    manifest = json.loads((tmp_path / "b" / "manifest.json").read_text())
    assert manifest["model_config"]["name"] == "restormer"
    model, variables, _, loaded = load_bundle(tmp_path / "b", device="cpu")
    assert isinstance(model, Restormer) and loaded["coarse_tile"] == (20, 40)
    gen = torch.Generator().manual_seed(4)
    scene = {"u": {40: torch.randn(40, 40, generator=gen)},
             "f": {r: torch.randn(r, r, generator=gen) for r in (80, 160)},
             "theta": {r: torch.rand(r, r, generator=gen) + 0.5 for r in (80, 160)}}
    served = ml_cascade(model, variables, scene, 160, stats_mode="tile", coarse_tile=(20, 40))
    modules = [_model(ARCH, sd).eval() for sd in experts]
    direct = ml_cascade(modules[0], modules, scene, 160, stats_mode="tile", coarse_tile=(20, 40))
    assert sorted(served) == [80, 160]
    for r in served:
        _close(served[r], direct[r], 1e-6, f"level {r}")


def test_group_norm_is_refused():
    with pytest.raises(ValueError, match="no BatchNorm"):
        build_model("restormer", in_channels=5, norm="group")


def test_twin_is_upstreams_attention():
    """The plain twin against the reference's MDTA core in float64, heads of
    48 and 96 channels."""
    gen = torch.Generator().manual_seed(3)
    for heads, d in ((2, 48), (1, 96)):
        qkv = torch.randn(2, 3 * heads * d, 12, 10, generator=gen, dtype=torch.float64)
        t = torch.rand(heads, 1, 1, generator=gen, dtype=torch.float64) + 0.5
        q, k, v = (x.reshape(2, heads, d, 120) for x in qkv.chunk(3, dim=1))
        want = reference.attention(q, k, v, t).reshape(2, heads * d, 12, 10)
        assert torch.allclose(ta.plain_transposed_attention(qkv, t, heads), want, rtol=0,
                              atol=1e-12)


def test_kernel_slabs_cover_the_tokens():
    """Every Gram slab holds at least 8 chunks of 32 tokens (or all of them),
    the slabs cover every token, and the count depends on the shape alone."""
    for pairs, tokens in ((1, 25600), (16, 25600), (64, 6400), (8, 100), (1, 25), (128, 400)):
        n, per = ta.slabs(pairs, tokens, 132)
        chunks = -(-tokens // ta.CHUNK)
        assert n * per >= chunks > (n - 1) * per
        assert per >= min(ta.MIN_SLAB_CHUNKS, chunks) or n == 1
        assert ta.slabs(pairs, tokens, 132) == (n, per)


# ---------------------------------------------------------------- on a card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (batch, channels, heads, side or (height, width)): (1, 160^2) and
# (16, 160^2) at both head sizes, then every scale of the cascade's 160^2 and
# 80^2 tiles as the published model runs them (48 channels a head, 96 at the
# first scale's decoder and refinement), then token counts that are not a
# multiple of 4 (the kernels' 4-byte staging): R7 validation's latent (a
# batch of 32 at 40^2: 5^2 tokens), a 36 x 44 input's latent (padded to
# 40 x 48: 5 x 6 tokens) and odd sides at both head sizes over several slabs
CASES = [(1, 48, 1, 160), (1, 96, 1, 160), (16, 48, 1, 160), (16, 96, 1, 160),
         (4, 96, 2, 80), (4, 192, 4, 40), (4, 384, 8, 20),
         (1, 48, 1, 80), (1, 96, 1, 80), (1, 96, 2, 40), (1, 192, 4, 20), (1, 384, 8, 10),
         (32, 384, 8, 5), (2, 384, 8, (5, 6)), (2, 192, 4, 15), (2, 48, 1, 75), (2, 96, 1, 45)]


def _case_id(case):
    side = case[3] if isinstance(case[3], int) else "{}x{}".format(*case[3])
    return "b{}_c{}_h{}_{}".format(*case[:3], side)


def _case(batch, channels, heads, side, device, seed=0):
    height, width = (side, side) if isinstance(side, int) else side
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(batch, 3 * channels, height, width, device=device, generator=gen)
    temperature = 0.5 + torch.rand(heads, 1, 1, device=device, generator=gen)
    return qkv, temperature


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernels_match_the_twin(case, card):
    """Against the float64 twin: the kernels' error at most twice the float32
    twin's, or 1e-6 of the largest value; the same bits on a second call; 3
    launches."""
    heads = case[2]
    qkv, t = _case(*case, card)
    ta.reset_launch_counts()
    with torch.no_grad():
        got = ta.transposed_attention(qkv, t, heads)
        again = ta.transposed_attention(qkv, t, heads)
        twin = ta.plain_transposed_attention(qkv, t, heads)
        exact = ta.plain_transposed_attention(qkv.double(), t.double(), heads)
    torch.cuda.synchronize()
    assert got.shape == (case[0], case[1], *qkv.shape[2:]) and got.dtype == torch.float32
    err, twin_err = _rel(got.double(), exact), _rel(twin.double(), exact)
    assert err <= max(2 * twin_err, 1e-6), (err, twin_err)
    assert torch.equal(got, again)
    assert ta.launch_counts() == {"kernel_gram": 2, "kernel_softmax": 2, "kernel_apply": 2}


@pytest.mark.cuda
def test_a_published_width_forward_launches_three_kernels_a_block(card):
    """A published-width Restormer at (2, 80^2) under ``no_grad``: 44 blocks,
    3 launches each, the output within the tolerance of the float32 twin's
    model; with gradients enabled the twin runs and nothing launches."""
    model = Restormer(in_channels=5, generator=torch.Generator().manual_seed(0)).to(card).eval()
    x = torch.randn(2, 5, 80, 80, device=card, generator=torch.Generator(card).manual_seed(1))
    ta.reset_launch_counts()
    with torch.no_grad():
        got = model(x)
    assert ta.launch_counts() == {"kernel_gram": 44, "kernel_softmax": 44, "kernel_apply": 44}
    ta.reset_launch_counts()
    want = model(x)
    assert ta.launch_counts() == {"kernel_gram": 0, "kernel_softmax": 0, "kernel_apply": 0}
    _close(got, want.detach(), OUT_REL, "output")


@pytest.mark.cuda
def test_widths_without_a_kernel_raise(card):
    qkv, t = _case(1, 3 * 32, 3, 16, card)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        with torch.no_grad():
            ta.transposed_attention(qkv, t, 3)
    qkv, t = _case(1, 48, 1, 16, card)
    with pytest.raises(TypeError, match="float32"):
        with torch.no_grad():
            ta.transposed_attention(qkv.double(), t.double(), 1)


@pytest.mark.cuda
def test_bfloat16_is_widened_to_the_kernels(card):
    """Validation under bf16 autocast runs the attention on bfloat16 qkv:
    widened to the float32 kernels, the output rounded back to bfloat16."""
    qkv, t = _case(2, 96, 2, 40, card)
    low = qkv.bfloat16()
    ta.reset_launch_counts()
    with torch.no_grad():
        got = ta.transposed_attention(low, t, 2)
        want = ta.plain_transposed_attention(low.float(), t, 2).bfloat16()
    assert got.dtype == torch.bfloat16 and ta.launch_counts()["kernel_apply"] == 1
    assert _rel(got.float(), want.float()) <= 2 ** -7
