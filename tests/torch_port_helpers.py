"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and cast to float32 before they reach
either package (the test configuration enables JAX x64). Torch is held to two
threads, since the suite runs several workers at once. JAX is imported only
inside the helpers that need it: the card's tests import this module too.
"""

import numpy as np
import torch

torch.set_num_threads(2)

TINY = dict(enc_features=(8, 16, 32), bridge_features=32, head_features=(4, 4))


def f32(rng, *shape, lo=None, hi=None):
    """Seeded float32 numpy array: standard normal, or uniform in [lo, hi)."""
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def np_(x):
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_rel_close(ours, ref, rel, what=""):
    """max |ours - ref| <= rel * max |ref|."""
    ours, ref = np_(ours).astype(np.float64), np_(ref).astype(np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = np.max(np.abs(ours - ref))
    scale = np.max(np.abs(ref))
    assert err <= rel * scale, f"{what}: max|diff| {err:.3e} > {rel:g} * max|ref| {scale:.3e}"


def T(a):
    """A torch tensor holding a copy of ``a`` (JAX arrays are read-only)."""
    return torch.from_numpy(np.array(a))


def use_jax_forcing(monkeypatch):
    """Make the port's generators evaluate the forcing on JAX's ``linspace``
    grid, which is 1 ulp off at some points (``tests/test_torch_ops.py`` holds
    the forcing itself), so that generated fields differ by the solves alone."""
    import jax.numpy as jnp

    from superresolution_for_pdes_tpu.data import generate as jgen
    from superresolution_for_pdes_tpu_torch.data import generate

    def forcing(k1, k2, n, dtype, device):
        f = jgen._batched_forcing(jnp.asarray(np_(k1)), jnp.asarray(np_(k2)), n, jnp.float32)
        return torch.from_numpy(np.array(f)).to(device)

    monkeypatch.setattr(generate, "forcing_term", forcing)


def tiny_flax_variables(rng):
    """Seeded 5-channel TINY Flax variables (numpy), non-trivial BatchNorm."""
    import jax

    from superresolution_for_pdes_tpu.models.torch_import import torch_state_dict_to_variables
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet

    layout = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in AttentionUNet(in_channels=5, **TINY).state_dict().items()})

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0.0, np.sqrt(1.0 / (shape[0] * shape[1] * shape[2])), shape)
        if name == "scale":
            return rng.uniform(0.9, 1.1, shape)
        if name == "var":
            return rng.uniform(0.8, 1.25, shape)
        return rng.normal(0.0, 0.02, shape)

    return jax.tree_util.tree_map_with_path(lambda p, x: draw(p, x).astype(np.float32), layout)


def tiny_experts(seed, n_levels=4):
    """Per-level TINY experts: (Flax model, JAX variables, port model, port
    state_dicts), the same weights carried by ``models/convert.py``."""
    import jax
    import jax.numpy as jnp

    from superresolution_for_pdes_tpu.models import AttentionUNet as FlaxUNet
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet
    from superresolution_for_pdes_tpu_torch.models.convert import variables_to_state_dict

    rng = np.random.default_rng(seed)
    jvars = tuple(jax.tree.map(jnp.asarray, tiny_flax_variables(rng)) for _ in range(n_levels))
    sds = tuple(variables_to_state_dict(jax.device_get(v)) for v in jvars)
    return FlaxUNet(in_channels=5, **TINY), jvars, AttentionUNet(in_channels=5, **TINY), sds
