"""Training CLI (counterpart of ``polyffusion_tpu/main.py``, one GPU): the
diffusion presets (``sdf*``) and the pretraining of their frozen encoders,
the chord VAE (``chd_8bar``) and the PianoTree VAE (``pnotree_vae``):

    python -m polyffusion_tpu_torch.main --model chd_8bar --output_dir result/chd \\
        --data_dir <npz dir>
    python -m polyffusion_tpu_torch.main --model sdf_chd8bar --output_dir result/x \\
        --data_dir <npz dir> --pretrained_dir <dir with chd8bar/ (a chd_8bar run
        directory) or chd8bar.pt; polydis.pt; pnotree/ or pnotree.pt>

Model presets come from ``polyffusion_tpu_torch/params/*.yaml``; the run
directory gets a ``params.yaml`` copy, ``torch.save`` checkpoints under
``chkpts/`` and ``metrics.jsonl``. A preset's ``tfr_*`` keys ([high, low])
become teacher-forcing schedules. Training runs on the GPU unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import torch
import yaml

from .config import load_params
from .data import SegmentDataset, make_loaders
from .device import DeviceLike
from .models.encoders import build_frozen_encoders
from .tasks import Chd8BarTask, PnoTreeVAETask, SDFTask
from .tasks.sdf import refuse_unported_trainer_keys
from .train import Trainer
from .train.schedulers import make_param_scheduler

VAE_TASKS = {"chd_8bar": Chd8BarTask, "pnotree_vae": PnoTreeVAETask}
NOT_PORTED = {"ddpm": 10, "autoencoder": 11}  # model_name -> its ROADMAP.md item


def build_task(cfg, pretrained_dir=None, device: DeviceLike = None, seed: int = 0,
               gn_conv: str = "unfused"):
    """The task of ``cfg`` for training, weights fp32 from ``seed`` (JAX
    ``build_task`` :16-37): an ``sdf*`` preset's ``SDFTask`` with the frozen
    encoders from ``pretrained_dir`` and ``gn_conv`` "unfused" or "fused" (the
    int8 route has no gradient); ``Chd8BarTask``; ``PnoTreeVAETask``."""
    model_name = cfg["model_name"]
    refuse_unported_trainer_keys(cfg)
    generator = torch.Generator().manual_seed(seed)
    if model_name.startswith("sdf"):
        return SDFTask(cfg, **build_frozen_encoders(cfg, pretrained_dir), device=device,
                       generator=generator, training=True, gn_conv=gn_conv)
    if model_name in NOT_PORTED:
        raise NotImplementedError(
            f"model_name {model_name} is not ported yet (ROADMAP.md item {NOT_PORTED[model_name]})")
    if model_name not in VAE_TASKS:
        raise NotImplementedError(model_name)
    if gn_conv != "unfused":
        raise ValueError(f"gn_conv={gn_conv!r}: the GroupNorm-SiLU-conv route is the sdf UNet's; "
                         f"{model_name} has none")
    return VAE_TASKS[model_name](cfg, device=device, generator=generator)


def main(argv=None):
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
    p.add_argument("--fresh", action="store_true", help="force a new timestamped subdir")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--gn_conv", default="unfused", choices=["unfused", "fused"],
                   help="the UNet's GroupNorm-SiLU-conv3x3 sites: as three modules or through "
                   "the fused kernel (whose backward recomputes through its plain version); "
                   "the int8 route is for sampling only")
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override any preset key (YAML-parsed value; repeatable), e.g. "
        "--set channels=32 --set 'channel_multipliers=[1,2]' — the run dir's "
        "params.yaml records the overridden config",
    )
    args = p.parse_args(argv)

    cfg = load_params(args.model)
    for kv in args.set:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        cfg[key.strip()] = yaml.safe_load(val)
    if args.batch_size:
        cfg["batch_size"] = args.batch_size

    output_dir = args.output_dir
    has_ckpt = os.path.isdir(os.path.join(output_dir, "chkpts"))
    if args.fresh or (has_ckpt and not args.resume):
        # a new timestamped dir unless --resume (the reference prompts instead)
        output_dir = os.path.join(args.output_dir, datetime.now().strftime("%y%m%d_%H%M%S"))

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
        used_fields=task.used_batch_fields,
    )
    trainer = Trainer(task, cfg, output_dir, max_steps=args.max_steps,
                      log_every=args.log_every, save_every=args.save_every,
                      param_scheduler=make_param_scheduler(cfg))
    print(f"[train] model={args.model} device={task.device} batch={cfg['batch_size']} "
          f"out={output_dir}")
    return trainer.fit(train_dl, val_dl, seed=args.seed, resume=args.resume)


if __name__ == "__main__":
    main()
