"""PyTorch port, ``cascade/graphs.py``: which cascade levels may be replayed
as CUDA graphs, and the cache's bookkeeping. On the CPU no level is ever
captured; the cache's sightings, cascades and eviction are held here with a
stand-in for the capture, and the capture itself on the card
(``tests/test_torch_cuda.py``; SwinIR's levels here, marked ``cuda``). Also
every cascade setting reaching a level's key, the modal correction's band
index kept on the device, and the kernels' launch tally a replay advances."""

import inspect

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from superresolution_for_pdes_tpu_torch.cascade import graphs, modal
from superresolution_for_pdes_tpu_torch.cascade.upscale import ml_cascade
from superresolution_for_pdes_tpu_torch.models import AttentionUNet, SwinIR
from superresolution_for_pdes_tpu_torch.ops import stencil_kernels as sk
from superresolution_for_pdes_tpu_torch.ops import window_attention as wa
from superresolution_for_pdes_tpu_torch.ops._build import add_launches, count_launch, launch_tally
from superresolution_for_pdes_tpu_torch.utils.profiling import clear_spans, recorded_spans

from torch_port_helpers import TINY


@pytest.fixture
def level_graphs():
    graphs.LEVEL_GRAPHS.clear()
    yield graphs.LEVEL_GRAPHS
    graphs.LEVEL_GRAPHS.clear()


def _scene(lead):
    gen = torch.Generator().manual_seed(3)
    return {"u": {40: torch.randn(*lead, 40, 40, generator=gen)},
            "f": {r: torch.randn(*lead, r, r, generator=gen) for r in (80, 160)},
            "theta": {r: torch.rand(*lead, r, r, generator=gen) + 0.5 for r in (80, 160)}}


@pytest.mark.parametrize("lead", [(), (1,), (2,)], ids=["scene", "batch_of_1", "batch_of_2"])
def test_no_level_is_captured_on_the_cpu(lead, level_graphs):
    """Three calls of one cascade on CPU tensors, one scene or a batch: every
    level runs eagerly (no capture, no replay, no ``cascade.replay`` span)
    and gives the same field each time."""
    model = AttentionUNet(in_channels=5, generator=torch.Generator().manual_seed(0), **TINY)
    sds = [{k: v.clone() for k, v in model.state_dict().items()} for _ in range(2)]
    data = _scene(lead)
    run = lambda: ml_cascade(model, sds, data, 160, stats_mode="tile", refine_cycles=1,  # noqa: E731
                             amp_levels=[torch.tensor(1.1), torch.tensor(0.9)])
    first = run()
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            again = run()
    assert level_graphs.captures == level_graphs.replays == 0
    assert "cascade.replay" not in {s.name for s in recorded_spans()}
    assert all(torch.equal(first[r], again[r]) for r in first)


@pytest.mark.parametrize("kind", ["radial", "grid"])
def test_modal_correction_keeps_its_band_index_on_the_device(kind):
    """The second call of a shape hands back the index tensor the first call
    copied (one copy from the host per shape and device)."""
    index = modal.radial_band_index if kind == "radial" else modal.axis_band_index
    n, bpo = 37 if kind == "radial" else 39, 3  # shapes no other test uses
    gains = torch.rand(*((modal.N_OCTAVES * bpo,) * (1 if kind == "radial" else 2))) + 0.5
    field = torch.randn(n, n)
    before = modal._index_on.cache_info()
    first = modal.apply_level_correction(field, gains)
    held = modal._index_on(index, n, bpo, field.device)
    second = modal.apply_level_correction(field, gains)
    after = modal._index_on.cache_info()
    assert after.misses == before.misses + 1 and after.hits == before.hits + 2
    assert modal._index_on(index, n, bpo, field.device) is held
    assert torch.equal(first, second)


# One other value for each keyword of ``ml_cascade`` that sets how a level
# computes; the keywords not here are the key's apart: the module and the
# data by identity and shape, tensors by address, a split by its devices.
OTHER_VALUE = {"stats_mode": "tile", "coarse_tile": 40, "overlap": True, "symmetrize": True,
               "refine_cycles": 1, "use_kernels": False, "scene_chunk": 1}
KEYED_APART = {"model", "variables", "data", "target_resolution", "start_resolution",
               "train_stats", "amp_levels", "tile_devices"}


@pytest.mark.parametrize("name", [p for p in inspect.signature(ml_cascade).parameters
                                  if p not in KEYED_APART])
def test_every_setting_reaches_the_level_key(name, monkeypatch):
    """Changing one setting of ``ml_cascade`` changes the settings that every
    level's graph key hashes, so a replay never returns a graph captured
    under another setting. A keyword added to ``ml_cascade`` and to neither
    table above fails here."""
    seen = []

    def key(self, model, weights, level, inputs, settings, read, tile_devices=None):
        seen.append(settings)
        return None  # run eagerly

    monkeypatch.setattr(graphs.LevelGraphs, "key", key)
    model = AttentionUNet(in_channels=5, generator=torch.Generator().manual_seed(0), **TINY)
    data = _scene(())
    ml_cascade(model, None, data, 160, stats_mode="scene")
    base = seen[:]
    seen.clear()
    ml_cascade(model, None, data, 160, **{"stats_mode": "scene", name: OTHER_VALUE[name]})
    assert len(seen) == len(base) == 2
    assert all(a != b for a, b in zip(base, seen))


@pytest.mark.parametrize("module, wrapper, dtype", [
    (sk, sk.kernel_smooth_residual, torch.float32),
    (sk, sk.kernel_pde_loss_forward, torch.bfloat16),
    (wa, wa.kernel_forward, torch.float32),
], ids=["stencil", "stencil_bf16", "window_attention"])
def test_launch_tally_advances_and_restores_the_counters(module, wrapper, dtype):
    """As a capture and its replays use the tally: the launches counted while
    capturing, taken back (captured, not run), leave a kernel module's own
    counts as they were; added back (a replay), they advance them."""
    def counts():
        return module.launch_counts(dtype) if module is sk else module.launch_counts()

    before, tally = counts(), launch_tally()
    count_launch(wrapper, dtype)
    delta = launch_tally() - tally
    undo = {k: -n for k, n in delta.items()}
    add_launches(undo)
    assert counts() == before and launch_tally() == tally
    add_launches(delta)
    assert counts() == {**before, wrapper.__name__: before[wrapper.__name__] + 1}
    add_launches(undo)


class _Stand:
    """A captured level's stand-in: replays by running the program again."""

    def __init__(self, program):
        self.program = program

    def replay(self, inputs):
        return self.program(*inputs)


@pytest.fixture
def cpu_cache(level_graphs, monkeypatch):
    """The cache with the capture replaced: a capture runs the program once
    and keeps it, as the real one returns the eager result and a graph."""
    monkeypatch.setattr(graphs.torch.cuda, "graph_pool_handle", lambda: object())

    def capture(self, program, inputs, cascade):
        self.captures += 1
        return program(*inputs), _Stand(program)

    monkeypatch.setattr(graphs.LevelGraphs, "_capture", capture)
    return level_graphs


def _call(cache, key, level, calls):
    x = torch.zeros(2, 2)
    return cache.run(key, level, lambda x, *_: calls.append(key) or x + level, (x, None))


def test_sightings_eager_then_capture_then_replay(cpu_cache):
    calls = []
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [_call(cpu_cache, ("a",), 0, calls) for _ in range(4)]
    assert (cpu_cache.captures, cpu_cache.replays) == (1, 2)
    assert [s.name for s in recorded_spans()] == ["cascade.replay"] * 2
    assert all(torch.equal(o, torch.zeros(2, 2)) for o in outs)
    assert len(calls) == 4


def test_levels_in_order_share_one_cascade_and_the_oldest_goes(cpu_cache):
    calls = []
    for _ in range(2):
        for level in range(4):
            _call(cpu_cache, ("s0", level), level, calls)
    assert len(cpu_cache._cascades) == 1
    (cascade,) = cpu_cache._cascades.values()
    assert len(cascade.levels) == 4 and all(g is not None for g in cascade.levels.values())
    # a level that does not follow its predecessor starts a cascade of its own
    _call(cpu_cache, ("lone", 2), 2, calls)
    assert len(cpu_cache._cascades) == 2
    for s in range(1, graphs.MAX_CASCADES + 1):
        _call(cpu_cache, (f"s{s}", 0), 0, calls)
    assert ("s0", 0) not in cpu_cache._cascades and len(cpu_cache._cascades) == \
        graphs.MAX_CASCADES
    captures = cpu_cache.captures
    for _ in range(2):  # evicted: first and second sighting again
        _call(cpu_cache, ("s0", 0), 0, calls)
    assert cpu_cache.captures == captures + 1 and cpu_cache.replays == 0


def test_a_cascade_holds_at_most_max_levels(cpu_cache):
    calls = []
    for _ in range(3):
        _call(cpu_cache, ("root",), 0, calls)
        for level in range(1, graphs.MAX_LEVELS + 3):
            _call(cpu_cache, ("deep", level), level, calls)
    (cascade,) = cpu_cache._cascades.values()
    assert len(cascade.levels) == graphs.MAX_LEVELS
    assert cpu_cache.replays == graphs.MAX_LEVELS


@pytest.mark.cuda
def test_swinir_levels_replay_bit_for_bit(level_graphs):
    """On a card: a one-scene cascade of a published-width SwinIR with four
    random per-level experts to 320^2, three times: eager, eager and
    captured, replayed; the replayed fields equal the eager ones bit for bit
    (the shift masks, made on the device at the first sighting, are read in
    place by the graphs). Run with ``python -m pytest --noconftest -q
    tests/test_torch_graphs.py -k swinir``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a level is captured only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = SwinIR(in_channels=5).cuda().eval()
    sds = [{k: v.cuda() for k, v in SwinIR(
        in_channels=5, generator=torch.Generator().manual_seed(i)).state_dict().items()}
        for i in range(4)]
    g = torch.Generator(device="cuda").manual_seed(7)
    res = (80, 160, 320)
    scene = {"u": {40: torch.randn(40, 40, device="cuda", generator=g)},
             "f": {r: torch.randn(r, r, device="cuda", generator=g) for r in res},
             "theta": {r: 0.5 + torch.rand(r, r, device="cuda", generator=g) for r in res}}
    gains = tuple(0.8 + 0.4 * torch.rand(48, 48, device="cuda", generator=g) for _ in res)

    def serve():
        return ml_cascade(model, sds, scene, 320, amp_levels=gains, stats_mode="tile",
                          coarse_tile=(40, 80, 80), overlap=False)

    eager = serve()
    assert (level_graphs.captures, level_graphs.replays) == (0, 0)
    captured = serve()
    replayed = serve()
    torch.cuda.synchronize()
    assert (level_graphs.captures, level_graphs.replays) == (3, 3)
    assert all(torch.equal(captured[r], eager[r]) and torch.equal(replayed[r], eager[r])
               for r in res)
