"""The worker of ``tests/test_torch_parallel.py``: one rank of a ``gloo``
process group on the CPU, started by ``torch.multiprocessing``. It imports
torch and the port only (no JAX), runs every data-parallel case of the test
module in one group, and puts its results on a queue."""

import traceback

import numpy as np
import torch


def _tiny_unet(in_channels=3):
    from superresolution_for_pdes_tpu_torch.models import AttentionUNet

    return AttentionUNet(in_channels=in_channels, enc_features=(8, 16, 32), bridge_features=32,
                         head_features=(4, 4), generator=torch.Generator().manual_seed(0))


def _np(t):
    return t.detach().cpu().numpy().copy()


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters() if p.grad is not None}


def _step_case(job, mesh):
    """One TINY step (5 channels, per-sample stats, physics 0.3) on the given
    global batch and weights: the group's loss, the clipped gradients and the
    running statistics."""
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.parallel import data as dpar
    from superresolution_for_pdes_tpu_torch.train import loop

    dp = dpar.data_group(mesh)
    model = _tiny_unet(5)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["weights"].items()})
    dpar.sync_batch_norm(model, dp)
    arrays = {k: torch.from_numpy(v) for k, v in job["arrays"].items()}
    stats = NormStats.from_dataset({k: torch.from_numpy(v) for k, v in job["dataset"].items()})
    batch = {k: dpar.shard_rows(v, dp) for k, v in arrays.items()}
    model.train()
    loss = loop.batch_loss(model, batch, stats, physics_weight=0.3)
    loss.backward()
    dpar.all_reduce_gradients(model.parameters(), dp)
    loop.clip_by_global_norm_(model.parameters(), 1.0)
    loss = dpar.all_reduce_sum(loss.detach(), dp) / dp.world
    running = {k: _np(v) for k, v in model.state_dict().items() if "running" in k}
    return {"loss": float(loss), "grads": _grads(model), "running": running}


def _train_case(job, mesh, run_dir):
    from superresolution_for_pdes_tpu_torch.data.generate import generate_standard_dataset
    from superresolution_for_pdes_tpu_torch.train import TrainConfig, train_model

    dataset = generate_standard_dataset(job["seed"], job["n"], device="cpu")
    config = TrainConfig(**job["config"])
    history = train_model(dataset, config, run_dir, model=_tiny_unet(), verbose=False,
                          device="cpu", mesh=mesh)
    return {k: history[k] for k in ("train_loss", "val_loss", "lr")}


def _online_case(job, mesh):
    from superresolution_for_pdes_tpu_torch.data.normalization import NormStats
    from superresolution_for_pdes_tpu_torch.parallel import make_online_train_step

    model = _tiny_unet()
    opt = torch.optim.AdamW(model.parameters(), lr=2e-4, weight_decay=1e-4)
    stats = NormStats(**{k: torch.from_numpy(v) for k, v in job["stats"].items()})
    step = make_online_train_step(model, opt, stats, job["batch_size"], mesh=mesh,
                                  device="cpu")
    sets = [{k: torch.from_numpy(v) for k, v in s.items()} for s in job["sets"]]
    loss = step.on_sets(*sets)
    return {"loss": float(loss), "grads": _grads(model), "steps": step.steps}


def _mesh_case(topo):
    from superresolution_for_pdes_tpu_torch.parallel import data_mesh, device_count, grid_mesh

    mesh = data_mesh()
    out = {"topology": topo, "device_count": device_count(),
           "data_mesh": (tuple(mesh.shape), mesh.mesh_dim_names, mesh.get_local_rank())}
    for shape in ((2, 1), (1, 2)):
        grid = grid_mesh(shape)
        out[f"grid_{shape}"] = (tuple(grid.shape), grid.mesh_dim_names, grid.get_coordinate())
    return out, mesh


def worker(rank, world, port, jobs, run_dir, queue):
    torch.set_num_threads(1)
    try:
        from superresolution_for_pdes_tpu_torch.parallel import initialize_multihost

        topo = initialize_multihost(f"localhost:{port}", world, rank, device="cpu")
        result, mesh = _mesh_case(topo)
        result["step"] = _step_case(jobs["step"], mesh)
        result["train"] = _train_case(jobs["train"], mesh, run_dir)
        result["online"] = _online_case(jobs["online"], mesh)
        result["files"] = sorted(p.name for p in __import__("pathlib").Path(run_dir).iterdir()) \
            if rank == 0 else None
        queue.put((rank, result))
    except Exception:  # the parent fails the test with the worker's traceback
        queue.put((rank, {"error": traceback.format_exc()}))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def job_arrays(arrays):
    return {k: np.ascontiguousarray(v) for k, v in arrays.items()}
