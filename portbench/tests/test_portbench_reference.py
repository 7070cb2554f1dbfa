"""The frozen plain reference agrees with the program at TINY sizes on the
CPU: the models' forward passes, the stencil and DST pieces, a V-cycle, the
whole cascade and the first train steps, through the harness itself."""

import copy

import pytest
import torch

from portbench import harness, inputs, weights
from portbench.drivers import train_steps
from portbench.reference import cascade as ref

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell, size", [("champion_serve_scene", 32), ("resnet_train_b32", 24)])
@pytest.mark.parametrize("train", [False, True])
def test_model_forward_matches_the_program(cell, size, train):
    resolved = harness.load_cell(cell)
    family, arch = resolved.family, copy.deepcopy(resolved.config["architecture"])
    arch.update(family.TINY)
    state = weights.make_state_dict(family, arch, 11, CPU)
    model = train_steps.build_model(family, arch)
    model.load_state_dict(state)
    model.train(train)
    x = torch.randn(3, arch["in_channels"], size, size, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x)
    want = family.forward(arch, state, x, train=train)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_dst_solve_matches_the_program():
    from superresolution_for_pdes_tpu_torch.solver.dst import solve_poisson_dst

    gen = weights.generator(3, CPU, 0)
    f = inputs.forcing(torch.tensor([3.3]), torch.tensor([7.1]), 40)
    theta = torch.rand(1, 40, 40, generator=gen) * 1.5 + 0.5
    got = solve_poisson_dst(f.double(), theta.double())
    want = ref.solve_poisson(f.double(), theta.double())
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


def test_vcycle_and_modal_correction_match_the_program():
    from superresolution_for_pdes_tpu_torch.cascade.modal import apply_level_correction
    from superresolution_for_pdes_tpu_torch.solver.multigrid import vcycle

    gen = torch.Generator().manual_seed(5)
    u, b = torch.randn(2, 160, 160, generator=gen, dtype=torch.float64)
    got = vcycle(u, b, use_kernels=True)  # the CPU runs the kernels' plain twins
    want = ref.vcycle(u, b)
    # the program's finest level takes h^2 rounded to float32, as its kernels do
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    gains = torch.rand(48, 48, generator=gen, dtype=torch.float64) + 0.5
    got = apply_level_correction(u, gains)
    want = ref.modal_correction(u, gains)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("cell", ["champion_serve_scene", "champion_serve_refine2",
                                  "champion_train_b32", "resnet_train_b32"])
def test_a_sound_run_is_correct(cell, tiny):
    """The whole harness on the CPU at TINY sizes, the program untouched:
    every compared number inside its limit."""
    result = harness.run(tiny(cell), 2 ** 40 + 3, 0.5, False, 0.0, CPU,
                         benchmark=_benchmark())
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def _benchmark():
    import json

    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())
