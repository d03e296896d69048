"""The multi-rank side of ``tests/test_torch_parallel.py``: one process per
rank of a gloo group on the CPU, one intra-op thread each.

    python tests/torch_parallel_worker.py steps <dir> <rank> <world> <port>
    python tests/torch_parallel_worker.py losses <dir> <rank> <world> <port>
    python tests/torch_parallel_worker.py fork <dir> <rank> <world> <port>

Each mode reads ``<dir>/inputs.pt`` (written by the test), runs its cases
over the group, and rank 0 writes ``<dir>/results.pt``: ``steps`` the sdf,
autoencoder and distillation steps and the sessions of
``tests/test_torch_parallel.py``, ``losses`` the pretraining and DDPM steps
of ``tests/test_torch_parallel_losses.py``, ``fork`` the sessions with CFG
forked inside the UNet of ``tests/test_torch_cfg_fork.py``. Torch only: a rank imports
neither JAX nor the JAX package.
"""

import os
import sys

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from polyffusion_tpu_torch.config import Params  # noqa: E402
from polyffusion_tpu_torch.inference import InferenceSession  # noqa: E402
from polyffusion_tpu_torch.parallel import (  # noqa: E402
    init_process_group,
    make_mesh,
    make_tp_mesh,
    shard_batch,
)
from polyffusion_tpu_torch.models import PianoTreeDecoder, PianoTreeEncoder  # noqa: E402
from polyffusion_tpu_torch.parallel.mesh import full, local  # noqa: E402
from polyffusion_tpu_torch.tasks import (  # noqa: E402
    AutoencoderTask,
    Chd8BarTask,
    DDPMTask,
    PnoTreeVAETask,
    SDFTask,
)
from polyffusion_tpu_torch.tasks.autoencoder import AENoise  # noqa: E402
from polyffusion_tpu_torch.tasks.chd_8bar import ChordNoise  # noqa: E402
from polyffusion_tpu_torch.tasks.ddpm import DDPMNoise  # noqa: E402
from polyffusion_tpu_torch.tasks.distill import DistillNoise, DistillTask  # noqa: E402
from polyffusion_tpu_torch.tasks.pnotree_vae import PianoTreeNoise  # noqa: E402
from polyffusion_tpu_torch.tasks.sdf import StepNoise  # noqa: E402
from polyffusion_tpu_torch.tasks.vae import VAE  # noqa: E402
from polyffusion_tpu_torch.train import create_state, make_train_step  # noqa: E402


def _rows(batch, mesh):
    """This rank's rows of a global batch (all of them in one process)."""
    return batch if mesh is None else shard_batch(batch, mesh)


def _record(metrics, state):
    """The step's metrics as floats, and the state and the step's (clipped)
    gradients whole (collectives)."""
    sd = state.state_dict()
    names = [n for n, _ in state.weights.module.named_parameters()]
    grads = {n: full(m.grad) for n, m in zip(names, state.weights.masters)}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": sd["params"],
            "ema": sd["ema"], "opt_state": sd["opt_state"], "grads": grads}


def sdf_step(inp, mesh, fsdp=False):
    """One step of the tiny sdf UNet from the JAX weights on the global
    batch's rows and the global noise."""
    cfg = Params(inp["sdf_cfg"])
    task = SDFTask(cfg, device="cpu", training=True)
    task.load_unet_state(inp["sdf_state"])
    state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm,
                         ema_decay=cfg.ema_decay, mesh=mesh, fsdp=fsdp)
    step = make_train_step(task, ema_decay=cfg.ema_decay, mesh=mesh, fsdp=fsdp)
    batch = _rows((inp["x0"], None, inp["chord"], None), mesh)
    metrics = step(state, batch, seed=0,
                   noise=StepNoise(inp["t"], inp["noise"], torch.tensor(False)))
    return _record(metrics, state), state


def shard_sizes(state):
    """Per parameter: its sharded dimension (None: replicated) and the
    elements this rank holds of it, of its Adam moments and of its EMA."""
    adam = state.optimizer.adam
    out = {}
    names = [n for n, _ in state.weights.module.named_parameters()]
    for name, m, e in zip(names, state.weights.masters, state.ema):
        st = adam.state[m]
        out[name] = dict(
            dim=m.placements[0].dim if isinstance(m, DTensor) else None, full=m.numel(),
            master=local(m).numel(), exp_avg=local(st["exp_avg"]).numel(),
            exp_avg_sq=local(st["exp_avg_sq"]).numel(), ema=local(e).numel())
    return out


def ae_step(inp, mesh):
    cfg = Params(inp["ae_cfg"])
    task = AutoencoderTask(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = create_state(task.model, cfg.learning_rate, cfg.max_grad_norm, mesh=mesh)
    step = make_train_step(task, mesh=mesh)
    batch = _rows((inp["roll"], None, None, None), mesh)
    return _record(step(state, batch, seed=0, noise=AENoise(inp["ae_eps"], 0)), state)


def distill_step(inp, mesh, fsdp=False):
    cfg = Params(inp["sdf_cfg"])
    base = SDFTask(cfg, device="cpu", training=True)
    base.load_unet_state(inp["sdf_state"])
    task = DistillTask(base, inp["teacher_state"], 5.0, "guided")
    state = create_state(task.model, cfg.learning_rate, cfg.max_grad_norm, mesh=mesh, fsdp=fsdp)
    step = make_train_step(task, mesh=mesh, fsdp=fsdp)
    batch = _rows((inp["x0"], None, inp["chord"], None), mesh)
    metrics = step(state, batch, seed=0, noise=DistillNoise(inp["d_index"], inp["noise"]))
    return _record(metrics, state)


def paint(inp, mesh, fsdp_params=False, cfg_fork=False):
    """A DDIM-3 CFG-5 inpainting request of JAX's dp paint test, batch-sharded."""
    task = SDFTask(Params(inp["paint_cfg"]), device="cpu")
    task.load_unet_state(inp["paint_state"])
    session = InferenceSession(task, use_ddim=True, ddim_steps=3, seed=0, device="cpu",
                               mesh=mesh, fsdp_params=fsdp_params, cfg_fork=cfg_fork)
    return session.predict(inp["p_cond"], uncond_scale=5.0, orig=inp["p_orig"],
                           mask=inp["p_mask"], noise=inp["p_noise"])


def _pretrain_task(inp, name):
    """A task of ``tests/test_torch_parallel_losses.py`` at its tiny widths,
    holding the JAX-initialised weights."""
    cfg = Params(inp[f"{name}_cfg"])
    if name == "pnotree_vae":
        task = PnoTreeVAETask(cfg, device="cpu")
        task.model = VAE("pnotree_enc", PianoTreeEncoder(**inp["pno_enc"]),
                         "pnotree_dec", PianoTreeDecoder(**inp["pno_dec"]))
        task.model.load_state_dict(inp[f"{name}_state"], strict=True)
    elif name == "chd_8bar":
        task = Chd8BarTask(cfg, device="cpu")
        task.model.load_state_dict(inp[f"{name}_state"], strict=True)
    else:
        task = DDPMTask(cfg, device="cpu", training=True)
        task.load_unet_state(inp[f"{name}_state"])
    return cfg, task


LOSS_NOISE = {"pnotree_vae": PianoTreeNoise, "chd_8bar": ChordNoise, "ddpm": DDPMNoise}


def pretrain_step(inp, name, mesh):
    """One step of ``name`` on this rank's rows of the global batch and the
    global noise (one process: all of them)."""
    cfg, task = _pretrain_task(inp, name)
    state = create_state(task.model, cfg.learning_rate, cfg.max_grad_norm, mesh=mesh)
    step = make_train_step(task, mesh=mesh)
    batch = _rows(inp[f"{name}_batch"], mesh)
    metrics = step(state, batch, seed=0, noise=LOSS_NOISE[name](*inp[f"{name}_noise"]))
    return _record(metrics, state)


def losses(out_dir, rank):
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    mesh = make_mesh("cpu")
    res = {name: pretrain_step(inp, name, mesh) for name in LOSS_NOISE}
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "results.pt"))


def fork(out_dir, rank):
    """``paint`` with CFG forked inside the UNet, dp and fsdp-params."""
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    mesh = make_mesh("cpu")
    res = {"dp": paint(inp, mesh, cfg_fork=True),
           "fsdp": paint(inp, mesh, fsdp_params=True, cfg_fork=True)}
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "results.pt"))


def steps(out_dir, rank):
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    mesh = make_mesh("cpu")
    res = {}
    res["dp"], _ = sdf_step(inp, mesh)
    res["fsdp"], state = sdf_step(inp, mesh, fsdp=True)
    res["fsdp_shards"] = shard_sizes(state)
    res["tp2x2"], _ = sdf_step(inp, make_tp_mesh(2, 2, "cpu"))
    res["tp1x4"], _ = sdf_step(inp, make_tp_mesh(1, 4, "cpu"))
    res["ae_dp"] = ae_step(inp, mesh)
    res["distill_dp"] = distill_step(inp, mesh)
    res["distill_fsdp"] = distill_step(inp, mesh, fsdp=True)
    res["paint_dp"] = paint(inp, mesh)
    res["paint_fsdp"] = paint(inp, mesh, fsdp_params=True)
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "results.pt"))


def main():
    mode, out_dir, rank, world, port = sys.argv[1:6]
    torch.set_num_threads(1)
    init_process_group("cpu", int(rank), int(world), f"tcp://localhost:{port}")
    {"steps": steps, "losses": losses, "fork": fork}[mode](out_dir, int(rank))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
