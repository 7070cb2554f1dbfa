"""PyTorch port, ``parallel/``: data parallelism over a ``gloo`` group of two
CPU processes (``torch.multiprocessing``, spawned once for the module by
``tests/torch_dp_worker.py``) against the JAX package's batch sharding over
its 8-device CPU mesh and against one process; the topology and the meshes;
and the online train step (``calibration_stats``, ``make_online_train_step``)
against JAX's on JAX's draws."""

import queue as queue_mod
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from superresolution_for_pdes_tpu.data import generate as jgen
from superresolution_for_pdes_tpu.data.normalization import NormStats as JaxNormStats
from superresolution_for_pdes_tpu.models import AttentionUNet as FlaxUNet
from superresolution_for_pdes_tpu.models.unet import init_unet
from superresolution_for_pdes_tpu.parallel import data_mesh as jax_data_mesh
from superresolution_for_pdes_tpu.parallel import online as jonline
from superresolution_for_pdes_tpu.train import loop as jloop
from superresolution_for_pdes_tpu.train.config import TrainConfig as JaxTrainConfig
from superresolution_for_pdes_tpu_torch.data.generate import generate_standard_dataset
from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.models.convert import variables_to_state_dict
from superresolution_for_pdes_tpu_torch.parallel import online
from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop, train_model

from torch_dp_worker import job_arrays, worker
from torch_port_helpers import TINY, assert_rel_close, np_

WORLD = 2
JOIN_SECONDS = 120
TRAIN_CONFIG = dict(batch_size=8, num_epochs=2, stratify_by_subdomain=False,
                    physics_weight=0.3, checkpoint_interval=1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64) if a.dtype.kind == "f" else a, tree)


@pytest.fixture(scope="module")
def step_job():
    """One TINY step's inputs (5 channels, per-sample statistics), made by
    the JAX package, and its float64 step over JAX's 8-device mesh."""
    ds = jgen.generate_standard_dataset(jax.random.key(0), 8, constant_theta=False,
                                        dtype=jnp.float32)
    jarrays = jloop.prepare_arrays(ds, JaxNormStats.from_dataset(ds), per_sample=True,
                                   scale_channels=True)
    _, variables = init_unet(jax.random.key(1), FlaxUNet(in_channels=5, **TINY))
    mesh = jax_data_mesh()
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    tx = jloop.make_optimizer(JaxTrainConfig())
    params, batch_stats = _f64(variables["params"]), _f64(variables["batch_stats"])
    state = jloop.TrainState(params=params, batch_stats=batch_stats, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32))
    epoch, _ = jloop.make_train_fns(FlaxUNet(in_channels=5, dtype=jnp.float64, **TINY), tx,
                                    JaxNormStats.from_dataset(_f64(ds)), physics_weight=0.3,
                                    batch_sharding=sharding)
    new_state, loss = epoch(state, _f64(jarrays), jnp.arange(8, dtype=jnp.int32)[None])
    mu = new_state.opt_state[1].inner_state[0].mu
    ref = {"loss": float(loss),
           "grads": variables_to_state_dict({"params": jax.tree.map(lambda m: m / 0.1, mu)}),
           "running": variables_to_state_dict({"params": new_state.params,
                                               "batch_stats": new_state.batch_stats})}
    arrays = {k: np.moveaxis(np.asarray(v), -1, 1) if v.ndim == 4 else np.asarray(v)
              for k, v in jarrays.items()}
    job = {"arrays": job_arrays(arrays), "dataset": job_arrays(
        {k: np.asarray(v) for k, v in ds.items()}),
        "weights": {k: np_(v) for k, v in variables_to_state_dict(variables).items()}}
    return job, ref


@pytest.fixture(scope="module")
def online_job():
    """JAX's calibration draws and one online step's draws (TINY)."""
    ks, kb = jax.random.split(jax.random.key(4))
    std, sub = jgen.generate_standard_dataset(ks, 4), jgen.generate_subdomain_dataset(kb, 4)
    np_sets = [{k: np.array(v) for k, v in s.items()} for s in (std, sub)]
    stats = online.stats_from_sets(*[{k: torch.from_numpy(v) for k, v in s.items()}
                                     for s in np_sets])
    return {"sets": np_sets, "batch_size": 8,
            "stats": {k: np_(v) for k, v in vars(stats).items()}}


@pytest.fixture(scope="module")
def group_results(step_job, online_job, tmp_path_factory):
    """Every rank's results of one two-process gloo group."""
    jobs = {"step": step_job[0], "online": online_job,
            "train": {"seed": 0, "n": 32, "config": TRAIN_CONFIG}}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    run_dir = str(tmp_path_factory.mktemp("dp_run"))
    port = _free_port()
    procs = [ctx.Process(target=worker, args=(rank, WORLD, port, jobs, run_dir, results))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(WORLD):
            rank, result = results.get(timeout=JOIN_SECONDS)
            out[rank] = result
    except queue_mod.Empty:
        pytest.fail(f"the gloo group did not report within {JOIN_SECONDS} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    for rank, result in out.items():
        assert "error" not in result, f"rank {rank}:\n{result.get('error')}"
    return out


def test_topology_and_meshes(group_results):
    for rank, res in group_results.items():
        assert res["topology"] == {"process_index": rank, "process_count": 2,
                                   "local_devices": 1, "global_devices": 2,
                                   "local_rank": 0, "backend": "gloo"}
        assert res["device_count"] == 2
        assert res["data_mesh"] == ((2,), ("data",), rank)
        assert res["grid_(2, 1)"][:2] == ((2, 1), ("data", "tile"))
        assert list(res["grid_(2, 1)"][2]) == [rank, 0]
        assert res["grid_(1, 2)"][:2] == ((1, 2), ("data", "tile"))
        assert list(res["grid_(1, 2)"][2]) == [0, rank]


def test_one_process_topology_without_a_group():
    from superresolution_for_pdes_tpu_torch.parallel import device_count, initialize_multihost

    assert initialize_multihost(device="cpu") == {
        "process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1,
        "local_rank": 0, "backend": None}
    assert device_count() >= 1
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(num_processes=2, device="cpu")


def test_dp_step_matches_jax_sharded_step(group_results, step_job):
    """Two ranks of 4 samples each, global BatchNorm statistics (Flax's
    one-pass variance from all-reduced float64 sums, the backward in centered
    form) and the group-mean gradient, against JAX's step sharded over its
    8-device mesh, run in float64: loss 1e-5 relative, each gradient tensor
    1e-4 of its max, running statistics 1e-5 (the non-parallel step's
    limits, ``test_torch_train.py``; measured: loss 5.9e-7, the worst
    gradient tensor 7.3e-5)."""
    _, ref = step_job
    ours, other = group_results[0]["step"], group_results[1]["step"]
    assert ours["loss"] == other["loss"]  # every rank holds the group's numbers
    assert_rel_close(np.float64(ours["loss"]), np.float64(ref["loss"]), 1e-5, "loss")
    top = max(float(np.abs(np_(g)).max()) for g in ref["grads"].values())
    for name, g in ref["grads"].items():
        assert np.array_equal(ours["grads"][name], other["grads"][name]), name
        if float(np.abs(np_(g)).max()) >= 1e-6 * top:  # not a bias feeding BatchNorm
            assert_rel_close(ours["grads"][name], g, 1e-4, name)
    for name, value in ours["running"].items():
        assert_rel_close(value, ref["running"][name], 1e-5, name)


def test_dp_train_model_matches_one_process(group_results, tmp_path):
    """``train_model`` over the group, 2 epochs, against one process on the
    same data: losses within rtol 2e-3 (the JAX package's bound for its mesh
    against one device, ``tests/test_parallel.py``); only rank 0 writes."""
    dataset = generate_standard_dataset(0, 32, device="cpu")
    from torch_dp_worker import _tiny_unet

    one = train_model(dataset, TrainConfig(**TRAIN_CONFIG), tmp_path, model=_tiny_unet(),
                      verbose=False, device="cpu")
    two, other = group_results[0]["train"], group_results[1]["train"]
    assert two == other  # plateau and early stopping decide alike on every rank
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(two[key], one[key], rtol=2e-3, err_msg=key)
    assert two["lr"] == one["lr"]
    assert group_results[0]["files"] == sorted(
        ["best_model", "config.json", "final_model", "metrics.jsonl"] + (
            ["training_history.png"] if (tmp_path / "training_history.png").exists() else []))


def test_online_step_matches_one_process(group_results, online_job):
    """The online step over the group against one process on the same draws:
    the same global batch (8 samples; each rank steps on 4)."""
    from torch_dp_worker import _tiny_unet

    model = _tiny_unet()
    opt = torch.optim.AdamW(model.parameters(), lr=2e-4, weight_decay=1e-4)
    stats = NormStats(**{k: torch.from_numpy(v) for k, v in online_job["stats"].items()})
    step = online.make_online_train_step(model, opt, stats, 8, device="cpu")
    sets = [{k: torch.from_numpy(v) for k, v in s.items()} for s in online_job["sets"]]
    loss = float(step.on_sets(*sets))
    two = group_results[0]["online"]
    assert two["steps"] == 1 and step.steps == 1
    assert abs(two["loss"] - loss) <= 1e-5 * abs(loss)
    top = max(float(p.grad.abs().max()) for p in model.parameters())
    for name, p in model.named_parameters():
        if float(p.grad.abs().max()) >= 1e-6 * top:
            assert_rel_close(two["grads"][name], p.grad, 1e-4, name)


def test_calibration_stats_and_online_step_match_jax(online_job):
    """``calibration_stats`` (statistics 1e-5 relative) and one online step
    (the train-step limits) against JAX's on JAX's draws (TINY, float32
    both; JAX's optimizer chain: clip 1.0, AdamW)."""
    ks, kb = jax.random.split(jax.random.key(4))
    std, sub = jgen.generate_standard_dataset(ks, 4), jgen.generate_subdomain_dataset(kb, 4)
    jstats = JaxNormStats.from_fields(
        *(jnp.concatenate([std[k], sub[k]]) for k in ("u_fine", "f_fine", "theta_fine")))
    stats = NormStats(**{k: torch.from_numpy(v) for k, v in online_job["stats"].items()})
    for field in ("u", "f", "theta"):  # a mean near 0 is held on its field's scale
        scale, ref_scale = getattr(stats, f"{field}_std"), getattr(jstats, f"{field}_std")
        assert_rel_close(scale, ref_scale, 1e-5, f"{field}_std")
        mean_err = abs(float(getattr(stats, f"{field}_mean")) - float(getattr(jstats,
                                                                              f"{field}_mean")))
        assert mean_err <= 1e-5 * float(ref_scale), field

    fmodel = FlaxUNet(dtype=jnp.float64, **TINY)
    _, variables = init_unet(jax.random.key(2), FlaxUNet(**TINY))
    tx = jloop.make_optimizer(JaxTrainConfig())
    params = _f64(variables["params"])
    state = jloop.TrainState(params=params, batch_stats=_f64(variables["batch_stats"]),
                             opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    monkey = {"generate_standard_dataset": lambda key, n, k=None: _f64(std),
              "generate_subdomain_dataset": lambda key, n, k=None: _f64(sub)}
    saved = {k: getattr(jonline, k) for k in monkey}
    try:
        for k, fn in monkey.items():
            setattr(jonline, k, fn)
        jstep = jonline.make_online_train_step(fmodel, tx, _f64(jstats), 8)
        new_state, ref_loss = jstep(state, jax.random.key(9))
    finally:
        for k, fn in saved.items():
            setattr(jonline, k, fn)
    ref_grads = variables_to_state_dict({"params": jax.tree.map(
        lambda m: m / 0.1, new_state.opt_state[1].inner_state[0].mu)})

    model = AttentionUNet(**TINY)
    model.load_state_dict(variables_to_state_dict(variables))
    opt = loop.make_optimizer(model, TrainConfig())
    step = online.make_online_train_step(model, opt, stats, 8, device="cpu")
    loss = step.on_sets(*[{k: torch.from_numpy(np.array(v)) for k, v in s.items()}
                          for s in (std, sub)])
    assert_rel_close(loss, np.float64(ref_loss), 1e-5, "loss")
    top = max(float(np.abs(np_(g)).max()) for g in ref_grads.values())
    for name, p in model.named_parameters():
        ref = ref_grads[name]
        if float(np.abs(np_(ref)).max()) >= 1e-6 * top:
            assert_rel_close(p.grad, ref, 1e-4, name)

    gen = torch.Generator().manual_seed(3)
    losses = [float(step(gen)) for _ in range(2)]  # fresh draws every step
    assert step.steps == 3 and np.isfinite(losses).all() and losses[0] != losses[1]
    cal = online.calibration_stats(0, n_samples=8, device="cpu")
    assert np.isfinite([float(v) for v in (cal.u_std, cal.f_std)]).all()
