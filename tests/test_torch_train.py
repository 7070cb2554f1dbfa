"""PyTorch port, ``train/`` and the CLIs: BatchNorm's running statistics, one
TINY training step against the JAX train step (5 channels, BatchNorm,
per-sample stats, physics weight 0.3), AdamW with global-norm clipping
against the optax chain, and tiny CPU runs of ``train_model`` and of the
``generate_data`` and ``train`` CLIs, resume included."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from superresolution_for_pdes_tpu.data import generate as jgen
from superresolution_for_pdes_tpu.data.normalization import NormStats as JaxNormStats
from superresolution_for_pdes_tpu.models import AttentionUNet as FlaxUNet
from superresolution_for_pdes_tpu.models.unet import init_unet
from superresolution_for_pdes_tpu.train import loop as jloop
from superresolution_for_pdes_tpu.train.config import TrainConfig as JaxTrainConfig
from superresolution_for_pdes_tpu_torch.cli import generate_data as gen_cli
from superresolution_for_pdes_tpu_torch.cli import train as train_cli
from superresolution_for_pdes_tpu_torch.data.generate import generate_standard_dataset
from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
from superresolution_for_pdes_tpu_torch.models import AttentionUNet
from superresolution_for_pdes_tpu_torch.models.convert import variables_to_state_dict
from superresolution_for_pdes_tpu_torch.models.unet import BatchNorm2d
from superresolution_for_pdes_tpu_torch.train import TrainConfig, loop, train_model
from superresolution_for_pdes_tpu_torch.train.checkpoint import load_model_state, restore_checkpoint
from superresolution_for_pdes_tpu_torch.train.metrics import read_metrics

from torch_port_helpers import TINY, assert_rel_close, f32, np_


def test_batchnorm_running_stats_follow_flax(rng):
    x = f32(rng, 2, 6, 10, 10) * 3.0 + 1.0  # the TINY bridge sees 2 x 10 x 10 per channel
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = flax_bn.init(jax.random.key(0), jnp.zeros((1, 10, 10, 6)))
    ref, mutated = flax_bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                 mutable=["batch_stats"])
    ours = BatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    out = ours(torch.from_numpy(x))
    assert_rel_close(out, np.asarray(ref).transpose(0, 3, 1, 2), 1e-5, "normalized")
    stats = mutated["batch_stats"]
    assert_rel_close(ours.running_mean, stats["mean"], 1e-5, "running mean")
    assert_rel_close(ours.running_var, stats["var"], 1e-5, "running var")
    # the trap: nn.BatchNorm2d averages the unbiased variance (200/199 larger)
    torch_bn = torch.nn.BatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    torch_bn(torch.from_numpy(x))
    gap = np.max(np.abs(np_(torch_bn.running_var) - np.asarray(stats["var"])))
    assert gap > 1e-3 * np.max(np.asarray(stats["var"]))
    ours.eval()  # evaluation mode normalizes with the running statistics
    ref_eval = flax_bn.clone(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert_rel_close(ours(torch.from_numpy(x)), np.asarray(ref_eval).transpose(0, 3, 1, 2),
                     1e-5, "eval")


def test_tiny_train_step_matches_jax():
    """The referee is JAX's train step in float64: at this random init JAX's
    own float32 gradients sit up to 3e-2 of their max from it, with or without
    the physics term, most at the bridge's BatchNorm layers (Flax takes the
    batch variance in one pass, E[x^2] - E[x]^2); the port's float32 ones
    within 1e-4."""
    ds = jgen.generate_standard_dataset(jax.random.key(0), 8, constant_theta=False,
                                        dtype=jnp.float32)
    f64 = lambda tree: jax.tree.map(lambda a: a.astype(jnp.float64) if a.dtype.kind == "f"
                                    else a, tree)
    jstats = JaxNormStats.from_dataset(f64(ds))
    jarrays = f64(jloop.prepare_arrays(ds, JaxNormStats.from_dataset(ds), per_sample=True,
                                       scale_channels=True))
    fmodel = FlaxUNet(in_channels=5, dtype=jnp.float64, **TINY)
    _, variables = init_unet(jax.random.key(1), FlaxUNet(in_channels=5, **TINY))
    params, batch_stats = f64(variables["params"]), f64(variables["batch_stats"])
    tx = jloop.make_optimizer(JaxTrainConfig())
    state = jloop.TrainState(params=params, batch_stats=batch_stats, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32))
    train_epoch, _ = jloop.make_train_fns(fmodel, tx, jstats, physics_weight=0.3)
    new_state, ref_loss = train_epoch(state, jarrays, jnp.arange(8, dtype=jnp.int32)[None])
    # the step's clipped gradient, read back from Adam's first moment: mu = (1 - 0.9) g
    adam = new_state.opt_state[1].inner_state[0]
    assert int(adam.count) == 1
    ref_grads = variables_to_state_dict({"params": jax.tree.map(lambda m: m / 0.1, adam.mu)})

    dataset = {k: torch.from_numpy(np.array(v)) for k, v in ds.items()}
    stats = NormStats.from_dataset(dataset)
    arrays = loop.prepare_arrays(dataset, stats, per_sample=True, scale_channels=True)
    assert_rel_close(arrays["x"], np.asarray(jarrays["x"]).transpose(0, 3, 1, 2), 1e-6, "x")
    model = AttentionUNet(in_channels=5, **TINY)
    model.load_state_dict(variables_to_state_dict(variables))
    loss = loop.batch_loss(model.train(), arrays, stats, physics_weight=0.3)
    loss.backward()
    assert float(loop.clip_by_global_norm_(model.parameters(), 1.0)) > 1.0  # clipping is on
    assert_rel_close(loss.detach(), ref_loss, 1e-5, "loss")
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    top = max(float(np.abs(np_(g)).max()) for g in ref_grads.values())
    for name, ref in ref_grads.items():
        if float(np.abs(np_(ref)).max()) >= 1e-6 * top:  # not a bias feeding BatchNorm
            assert_rel_close(grads[name], ref, 1e-4, name)
    ref_stats = variables_to_state_dict({"params": new_state.params,
                                         "batch_stats": new_state.batch_stats})
    for name, value in model.state_dict().items():
        if "running" in name:
            assert_rel_close(value, ref_stats[name], 1e-5, name)


def test_optimizer_matches_optax_chain(rng):
    shapes = {"w": (4, 3), "b": (3,), "s": (2, 2, 2)}
    params0 = {k: 0.01 * f32(rng, *s) for k, s in shapes.items()}  # updates are resolved
    cfg = JaxTrainConfig()
    tx = jloop.make_optimizer(cfg)
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    opt_state = tx.init(jparams)
    holder = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params0.items()})
    opt = loop.make_optimizer(holder, TrainConfig())
    for step in range(3):
        grads = {k: 3.0 * f32(rng, *s) for k, s in shapes.items()}  # global norm > 1
        if step == 2:  # a plateau LR change
            opt_state = jloop.set_learning_rate(opt_state, 1e-4)
            loop.set_learning_rate(opt, 1e-4)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in holder.items():
            p.grad = torch.from_numpy(grads[k])
        norm = loop.clip_by_global_norm_(holder.parameters(), cfg.grad_clip)
        assert float(norm) > cfg.grad_clip  # clipping is active
        opt.step()
        for k, p in holder.items():
            assert_rel_close(p.detach(), jparams[k], 1e-6, f"{k} step {step}")
    assert loop.get_learning_rate(opt) == 1e-4


def test_clip_by_global_norm_uses_optax_formula(rng):
    g = {"a": 2.0 * f32(rng, 5, 5), "b": f32(rng, 7)}
    for scale in (1.0, 1e-2):
        grads = {k: v * scale for k, v in g.items()}
        ref, _ = optax.clip_by_global_norm(1.0).update(
            {k: jnp.asarray(v) for k, v in grads.items()}, None)
        params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in grads.values()]
        for p, v in zip(params, grads.values()):
            p.grad = torch.from_numpy(v.copy())
        loop.clip_by_global_norm_(params, 1.0)
        for p, k in zip(params, grads):
            assert_rel_close(p.grad, ref[k], 1e-6, k)


def _tiny_model():
    return AttentionUNet(**TINY, generator=torch.Generator().manual_seed(0))


def test_train_model_streams_checkpoints_and_resumes(tmp_path):
    dataset = generate_standard_dataset(0, 24, device="cpu")
    seen = []

    def stream(gen):
        seen.append(gen.initial_seed())
        return generate_standard_dataset(gen, 24)

    config = TrainConfig(batch_size=8, num_epochs=2, stratify_by_subdomain=False,
                         physics_weight=0.3, gen_every=2, checkpoint_interval=1)
    run = tmp_path / "run"
    history = train_model(dataset, config, run, model=_tiny_model(), verbose=False,
                          dataset_generator=stream, device="cpu")
    assert seen == [loop.epoch_generator(config.seed + 2, 0, "cpu").initial_seed()]
    assert history["num_epochs"] == 2 and np.isfinite(history["train_loss"]).all()
    assert history["train_steps"] == [3, 3] and history["eval_chunks"] == [1, 1]
    assert history["regen_seconds"][1] == 0.0  # gen_every 2: nothing regenerated at epoch 1
    for name in ("config.json", "metrics.jsonl", "best_model", "final_model"):
        assert (run / name).exists(), name
    final = restore_checkpoint(run / "final_model")
    assert final["epoch"] == 1 and final["val_loss"] == pytest.approx(history["val_loss"][-1])
    restored = _tiny_model()
    restored.load_state_dict(load_model_state(run, "final_model"))
    x = torch.zeros(2, 3, 40, 40)
    with torch.no_grad():
        assert torch.equal(restored.eval()(x), history["model"].eval()(x))

    config.num_epochs = 3
    resumed = train_model(dataset, config, tmp_path / "resumed", model=_tiny_model(),
                          verbose=False, resume_from=str(run / "final_model"),
                          dataset_generator=stream, device="cpu")
    assert resumed["num_epochs"] == 1  # epochs 0 and 1 were done
    assert [r["step"] for r in read_metrics(tmp_path / "resumed")] == [2]
    assert seen[-1] == loop.epoch_generator(config.seed + 2, 2, "cpu").initial_seed()


def test_train_model_refuses_an_empty_validation_split(tmp_path):
    dataset = generate_standard_dataset(0, 4, device="cpu")
    config = TrainConfig(batch_size=2, num_epochs=1, stratify_by_subdomain=False)
    with pytest.raises(ValueError, match="validation split"):
        train_model(dataset, config, tmp_path, model=_tiny_model(), device="cpu")


def test_chunked_eval_matches_single_shot():
    dataset = generate_standard_dataset(5, 10, device="cpu")
    stats = NormStats.from_dataset(dataset)
    arrays = loop.prepare_arrays(dataset, stats)
    model = _tiny_model()
    opt = loop.make_optimizer(model, TrainConfig())
    losses = {chunk: loop.make_train_fns(model, opt, stats, 0.1, eval_chunk=chunk)[1](arrays)
              for chunk in (1024, 4, 3)}
    assert losses[4] == pytest.approx(losses[1024], rel=1e-5)
    assert losses[3] == pytest.approx(losses[1024], rel=1e-5)
    assert loop.eval_chunk_size(100, 80, 80, eval_chunk=16) == 4  # area-scaled
    assert loop.eval_chunk_size(3, 40, 40) == 3


def test_coarse_noise_follows_its_generator():
    dataset = generate_standard_dataset(6, 16, device="cpu")
    stats = NormStats.from_dataset(dataset)
    arrays = loop.prepare_arrays(dataset, stats)
    idx = torch.arange(16).reshape(2, 8)
    losses = []
    for std, seed in ((0.5, 1), (0.5, 1), (0.5, 2), (0.0, 1)):
        model = _tiny_model()
        epoch, _ = loop.make_train_fns(model, loop.make_optimizer(model, TrainConfig()), stats,
                                       coarse_noise_std=std)
        losses.append(float(epoch(arrays, idx, torch.Generator().manual_seed(seed))))
    assert losses[0] == losses[1]  # the same generator draws the same noise
    assert len({losses[0], losses[2], losses[3]}) == 3
    assert torch.equal(arrays["x"], loop.prepare_arrays(dataset, stats)["x"])  # untouched


def test_clis_generate_train_and_resume(tmp_path, capsys):
    path = gen_cli.main(["--n_standard", "4", "--n_subdomain", "4", "--theta", "mixed",
                         "--n_cascade_scenes", "1", "--cascade_tiles_per_level", "2",
                         "--cascade_finest", "80", "--out", str(tmp_path / "data"),
                         "--device", "cpu"])
    with np.load(path) as z:
        assert z["u_fine"].shape == (18, 40, 40) and z["is_subdomain"].sum() == 10
    common = ["--gen_standard", "8", "--gen_subdomain", "8", "--batch_size", "8",
              "--physics_weight", "0.3", "--normalization", "per_sample", "--scale_channels",
              "--results", str(tmp_path / "results"), "--device", "cpu"]
    history = train_cli.main(["--generate", "--gen_stream", "--gen_every", "2",
                              "--epochs", "2", *common])
    assert history["num_epochs"] == 2 and history["train_steps"] == [2, 2]
    run = history["run_dir"]
    assert (run / "best_model").exists() and (run / "final_model").exists()
    resumed = train_cli.main(["--generate", "--gen_stream", "--epochs", "3", "--prefix", "r_",
                              "--resume_from", str(run / "final_model"), *common])
    assert resumed["num_epochs"] == 1
    assert restore_checkpoint(resumed["run_dir"] / "final_model")["epoch"] == 2
    loaded = train_cli.main(["--data", str(path), "--epochs", "1", "--prefix", "d_", *common])
    assert loaded["num_epochs"] == 1
    assert "best val loss" in capsys.readouterr().out


@pytest.mark.parametrize("cli,argv", [
    (train_cli, ["--fused_epochs", "2"]),
    (train_cli, ["--gen_selffeed_scenes", "4"]),
    (train_cli, ["--data_parallel"]),
    (train_cli, ["--multihost"]),
    (train_cli, ["--tensorboard"]),
    (train_cli, ["--dtype", "bfloat16"]),
    (gen_cli, ["--n_selffeed_scenes", "2"]),
])
def test_unported_flags_raise(cli, argv, capsys):
    """Each flag the port does not run raises; the self-fed counts without a
    teacher raise the JAX package's error."""
    with pytest.raises(SystemExit):
        cli.main([*argv, "--device", "cpu"])
    expected = {"--gen_selffeed_scenes": "requires --gen_selffeed_model",
                "--n_selffeed_scenes": "requires --selffeed_model"}.get(argv[0], "not yet ported")
    assert expected in capsys.readouterr().err


@pytest.mark.parametrize("model,flags", [("attention_unet", []), ("attention_unet_wide", []),
                                         ("resnet", [])])
def test_train_accepts_every_model_the_registry_builds(model, flags):
    args = SimpleNamespace(fused_epochs=0, data_parallel=False, multihost=False,
                           tensorboard=False, dtype="float32", model=model)
    assert train_cli._not_ported(args) == flags
