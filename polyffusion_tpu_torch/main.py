"""Training CLI (counterpart of ``polyffusion_tpu/main.py``, one GPU): the
diffusion presets (``sdf*``), the pretraining of their frozen encoders, the
chord VAE (``chd_8bar``) and the PianoTree VAE (``pnotree_vae``), the plain
DDPM family (``ddpm``) and the KL autoencoder (``autoencoder``):

    python -m polyffusion_tpu_torch.main --model chd_8bar --output_dir result/chd \\
        --data_dir <npz dir>
    python -m polyffusion_tpu_torch.main --model sdf_chd8bar --output_dir result/x \\
        --data_dir <npz dir> --pretrained_dir <dir with chd8bar/ (a chd_8bar run
        directory) or chd8bar.pt; polydis.pt; pnotree/ or pnotree.pt>

Model presets come from ``polyffusion_tpu_torch/params/*.yaml``; the run
directory gets a ``params.yaml`` copy, ``torch.save`` checkpoints under
``chkpts/`` and ``metrics.jsonl``. A preset's ``tfr_*`` keys ([high, low])
become teacher-forcing schedules; ``remat`` (sdf presets) recomputes the
UNet's activations in the backward, ``legacy_checkpoints`` also writes the
reference learner's ``weights.pt``. ``--profile_steps START,STOP`` traces a
window of steps. Training runs on the GPU unless ``--device cpu`` is given.

On CUDA it trains data-parallel over every visible card, dropping to the
largest count that divides the batch size, one process per card (NCCL); on
one card, or with ``--device cuda:<i>``, it runs in this process.
``--nproc N`` asks for N processes: N cards, or N gloo ranks with ``--device
cpu``. ``--fsdp`` (or the config key ``fsdp: true``) shards the train state
ZeRO-3 style over the ranks (``parallel/fsdp.py``; in one process a one-rank
group). The body of each process is ``train(argv)``, which also runs inside
a caller's process group.
"""

from __future__ import annotations

import argparse
import os
import sys
from datetime import datetime

import torch
import yaml

from .config import load_params
from .data import SegmentDataset, make_loaders
from .device import DeviceLike
from .models.encoders import build_frozen_encoders
from .parallel.mesh import data_parallel_mesh, dp_size, from_rank0, launch
from .tasks import AutoencoderTask, Chd8BarTask, DDPMTask, PnoTreeVAETask, SDFTask
from .train import Trainer
from .train.schedulers import make_param_scheduler

# the tasks without the sdf UNet's GroupNorm-SiLU-conv route
OTHER_TASKS = {"chd_8bar": Chd8BarTask, "pnotree_vae": PnoTreeVAETask, "ddpm": DDPMTask,
               "autoencoder": AutoencoderTask}


def build_task(cfg, pretrained_dir=None, device: DeviceLike = None, seed: int = 0,
               gn_conv: str = "unfused"):
    """The task of ``cfg`` for training, weights fp32 from ``seed`` (JAX
    ``build_task`` :16-37): an ``sdf*`` preset's ``SDFTask`` with the frozen
    encoders from ``pretrained_dir`` and ``gn_conv`` "unfused", "fused" or
    "s2d" (the int8 routes have no gradient); ``Chd8BarTask``; ``PnoTreeVAETask``;
    ``DDPMTask``; ``AutoencoderTask``."""
    model_name = cfg["model_name"]
    generator = torch.Generator().manual_seed(seed)
    if model_name.startswith("sdf"):
        return SDFTask(cfg, **build_frozen_encoders(cfg, pretrained_dir), device=device,
                       generator=generator, training=True, gn_conv=gn_conv)
    if model_name not in OTHER_TASKS:
        raise NotImplementedError(model_name)
    if gn_conv != "unfused":
        raise ValueError(f"gn_conv={gn_conv!r}: the GroupNorm-SiLU-conv route is the sdf UNet's; "
                         f"{model_name} has none")
    if model_name == "ddpm":
        return DDPMTask(cfg, device=device, generator=generator, training=True)
    return OTHER_TASKS[model_name](cfg, device=device, generator=generator)


def _parse(argv):
    """The arguments, the config (preset, ``--set``s, ``--batch_size``,
    ``--fsdp``) and the profile window."""
    p = argparse.ArgumentParser(description="polyffusion_tpu_torch training")
    p.add_argument("--model", required=True, help="params preset name (see params/)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--data_dir", required=True, help="directory of song .npz files")
    p.add_argument("--split_file", default=None, help="pickled (train, val) split")
    p.add_argument("--pop909_use_track", default="0,1,2", help="tracks for prmat2c")
    p.add_argument("--pretrained_dir", default=None,
                   help="frozen encoder checkpoints: chd8bar, polydis (texture) or pnotree, "
                   "each .pt or .npz, or chd8bar/ and pnotree/ as run directories of a "
                   "chd_8bar and a pnotree_vae training")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None, help="override preset batch size")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint every N epochs (final epoch always saves)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true", help="resume from output_dir/chkpts")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3 state sharding over dp (parallel/fsdp.py)")
    p.add_argument("--fresh", action="store_true", help="force a new timestamped subdir")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--nproc", type=int, default=None,
                   help="processes, one dp rank each (default: every visible card that "
                   "divides the batch on CUDA, one on the CPU; N gloo ranks with --device cpu)")
    p.add_argument("--gn_conv", default="unfused", choices=["unfused", "fused", "s2d"],
                   help="the UNet's GroupNorm-SiLU-conv3x3 sites: as three modules, through "
                   "the fused kernel (whose backward recomputes through its plain version), "
                   "or as three modules with level 0 space-to-depth folded; the int8 routes "
                   "are for sampling only")
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override any preset key (YAML-parsed value; repeatable), e.g. "
        "--set channels=32 --set 'channel_multipliers=[1,2]' — the run dir's "
        "params.yaml records the overridden config",
    )
    p.add_argument("--profile_steps", default=None, metavar="START,STOP",
                   help="trace steps START to STOP - 1 with torch.profiler (host and device) "
                   "into output_dir/profile as a Chrome trace")
    args = p.parse_args(argv)
    profile_steps = None
    if args.profile_steps:
        profile_steps = tuple(int(x) for x in args.profile_steps.split(","))
        if len(profile_steps) != 2:
            raise SystemExit(f"--profile_steps expects START,STOP, got {args.profile_steps!r}")

    cfg = load_params(args.model)
    for kv in args.set:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        cfg[key.strip()] = yaml.safe_load(val)
    if args.batch_size:
        cfg["batch_size"] = args.batch_size
    if args.fsdp:
        cfg["fsdp"] = True
    return args, cfg, profile_steps


def main(argv=None):
    """Train data-parallel over the visible cards (see the module's doc)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args, cfg, _ = _parse(argv)
    return launch(train, argv, args.device, cfg["batch_size"], args.nproc)


def train(argv):
    """One process's training: over the dp mesh of the process group when
    there is one of several ranks (or ``fsdp`` asks for one)."""
    args, cfg, profile_steps = _parse(argv)
    with data_parallel_mesh(args.device, bool(cfg.get("fsdp", False))) as mesh:
        return _train(args, cfg, profile_steps, mesh)


def _train(args, cfg, profile_steps, mesh):
    if cfg["batch_size"] % dp_size(mesh):
        raise ValueError(f"batch_size {cfg['batch_size']} does not divide over "
                         f"{dp_size(mesh)} dp ranks")
    output_dir = args.output_dir
    has_ckpt = os.path.isdir(os.path.join(output_dir, "chkpts"))
    if args.fresh or (has_ckpt and not args.resume):
        # a new timestamped dir unless --resume (the reference prompts instead)
        output_dir = os.path.join(args.output_dir, datetime.now().strftime("%y%m%d_%H%M%S"))
    output_dir = from_rank0(output_dir)  # one run directory for every rank

    use_track = [int(t) for t in args.pop909_use_track.split(",")]
    if args.split_file:
        train_ds, val_ds = SegmentDataset.train_val_from_split(
            args.data_dir, args.split_file, use_track
        )
    else:
        train_ds, val_ds = SegmentDataset.train_val_from_dir(args.data_dir, 0.9, use_track)

    task = build_task(cfg, args.pretrained_dir, device=args.device, seed=args.seed,
                      gn_conv=args.gn_conv)
    train_dl, val_dl = make_loaders(
        train_ds, val_ds, cfg["batch_size"], task.device, seed=args.seed,
        used_fields=task.used_batch_fields, mesh=mesh,
    )
    trainer = Trainer(task, cfg, output_dir, max_steps=args.max_steps,
                      log_every=args.log_every, save_every=args.save_every,
                      param_scheduler=make_param_scheduler(cfg), profile_steps=profile_steps,
                      mesh=mesh)
    if trainer.rank0:
        print(f"[train] model={args.model} device={task.device} devices={dp_size(mesh)} "
              f"batch={cfg['batch_size']} fsdp={trainer.fsdp} out={output_dir}")
    return trainer.fit(train_dl, val_dl, seed=args.seed, resume=args.resume)


if __name__ == "__main__":
    main()
