"""Progressive-distillation CLI (counterpart of ``polyffusion_tpu/distill.py``,
one GPU): compress a trained guided diffusion model into a few-step
single-pass student.

::

    python -m polyffusion_tpu_torch.distill \\
        --teacher result/sdf_chd8bar/run --data_dir <npz dir> \\
        --pretrained_dir pretrained --output_dir result/distilled \\
        --guide_scale 5.0 --base_steps 64 --end_steps 4 \\
        --stage_a_steps 3000 --phase_steps 1500

Stage A (guided distillation, Meng et al. arXiv:2210.03142) folds the
classifier-free-guidance double pass at ``--guide_scale`` into a single
v-prediction student; stage B (progressive distillation, Salimans & Ho
arXiv:2202.00512) then halves the sampling grid per phase: 64 -> 32 -> 16 ->
8 -> 4 UNet evals per sample. ``diffusion/progressive.py`` has the math,
``tasks/distill.py`` the loss. The teacher is a run directory of the port's
trainer, or a reference-format ``.pt`` / ``.ckpt`` with ``--model``. Output::

    <output_dir>/params.yaml       # teacher config + v_prediction/distill_grid
    <output_dir>/chkpts -> phase_<end_steps>/chkpts   (symlink)
    <output_dir>/stage_a/, phase_<M>/  # per-stage run directories

Sample it with the inference CLI: the run directory's ``params.yaml`` routes
the UNet's output through the v->eps adapter, and the session pins the
distilled tau grid (an explicit ``--ddim_steps`` overrides it)::

    python -m polyffusion_tpu_torch.inference --chkpt_path <output_dir> \\
        --ddim --uncond_scale 1 ...

**Chain mode**: a distilled run directory can itself be the ``--teacher``: the
CLI sees ``v_prediction: true``, skips stage A (the guidance is folded in
already), inherits ``distilled_scale`` and continues halving from the
student's own stored ``distill_grid`` (halving grids are nested, ``G_next =
G[1::2]``, so a freshly computed coarse grid would not be the one the student
was trained on). Runs on the GPU unless ``--device cpu`` is given.

Data-parallel as the training CLI (``main.py``): over every visible card
that divides the batch, one process each; the config key ``fsdp: true`` (the
teacher run's) shards each stage's student ZeRO-3 style. The frozen teacher
is replicated on every rank and takes no gradient.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

V_KEYS = ("v_prediction", "distill_grid", "distilled_scale")


def _teacher_config(p, args):
    from .config import load_params

    if os.path.isdir(args.teacher):
        return load_params(os.path.join(args.teacher, "params.yaml"))
    if not args.model:
        p.error("--model preset required with a reference-checkpoint --teacher")
    return load_params(args.model)


def main(argv=None):
    """Distil data-parallel over the visible cards (see the module's doc)."""
    from .parallel.mesh import launch

    argv = sys.argv[1:] if argv is None else list(argv)
    p = _parser()
    args = p.parse_args(argv)
    batch = args.batch_size or _teacher_config(p, args)["batch_size"]
    return launch(distill, argv, args.device, batch, args.nproc)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="polyffusion_tpu_torch progressive distillation")
    p.add_argument("--teacher", required=True,
                   help="run dir of the port's trainer, or a reference .pt/.ckpt of the teacher")
    p.add_argument("--model", default=None,
                   help="params preset if --teacher is a reference checkpoint")
    p.add_argument("--data_dir", required=True, help="directory of song .npz files")
    p.add_argument("--split_file", default=None)
    p.add_argument("--pretrained_dir", default=None, help="frozen encoder checkpoints")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--guide_scale", type=float, default=5.0,
                   help="CFG scale baked into the student (sample it at scale 1)")
    p.add_argument("--base_steps", type=int, default=64,
                   help="stage-B starting grid size (end_steps * a power of 2)")
    p.add_argument("--end_steps", type=int, default=4,
                   help="final student grid size (UNet evals per sample)")
    p.add_argument("--stage_a_steps", type=int, default=3000)
    p.add_argument("--phase_steps", type=int, default=1500)
    p.add_argument("--skip_stage_a", action="store_true",
                   help="distill the CFG teacher directly inside stage B "
                   "(one-stage variant; stage-A students sample on ANY grid)")
    p.add_argument("--pad_phase_tables", type=int, default=None,
                   help="pad the per-phase coefficient tables to this many rows (default: "
                   "base grid size // 2; at least the largest phase's rows). Rows are "
                   "drawn below each phase's own count either way, so it changes no result")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=10, help="epochs between saves")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--resume", action="store_true",
                   help="resume interrupted stages from their checkpoints")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--nproc", type=int, default=None,
                   help="processes, one dp rank each (default: every visible card that "
                   "divides the batch on CUDA, one on the CPU; N gloo ranks with --device cpu)")
    return p


def distill(argv):
    """One process's distillation: over the dp mesh of the process group
    when there is one of several ranks (or ``fsdp`` asks for one)."""
    p = _parser()
    args = p.parse_args(argv)

    from .config import Params
    from .diffusion.progressive import halving_grids
    from .inference import load_unet_params
    from .main import build_task
    from .parallel.mesh import data_parallel_mesh, rank

    cfg = _teacher_config(p, args)
    # Chain mode: an already distilled v-student is the teacher. The base task
    # is the eps config (the UNet, encoders and schedule); the teacher's v
    # semantics enter through teacher_kind="v"
    chained = bool(cfg.get("v_prediction"))
    prior_grid = None
    if chained:
        prior_grid = cfg.get("distill_grid")  # None: a stage-A-only student
        if cfg.get("distilled_scale") is not None:
            # a v-teacher is already guided; the scale is inherited metadata
            args.guide_scale = float(cfg["distilled_scale"])
        cfg = Params({k: v for k, v in cfg.items() if k not in V_KEYS})

    if prior_grid is not None:
        # continue halving from the teacher's own grid
        g = np.asarray(prior_grid, np.int64)
        n, e = len(g), args.end_steps
        if e < 1 or n % e or (n // e) & (n // e - 1):
            p.error(f"teacher grid size {n} must be end_steps ({e}) * a power of 2")
        if n <= e:
            p.error(f"teacher grid is already {n} steps — nothing to train")
        grids = [g]
        while len(g) > e:
            g = g[1::2]
            grids.append(g)
    else:
        grids = halving_grids(cfg["n_steps"], args.base_steps, args.end_steps)
    if args.skip_stage_a and len(grids) == 1:
        p.error("--skip_stage_a with --base_steps == --end_steps trains nothing")
    if chained and len(grids) == 1:
        p.error("a grid-free v-teacher with --base_steps == --end_steps trains nothing")
    m_max = args.pad_phase_tables or (len(grids[0]) // 2)
    if m_max < len(grids[0]) // 2:
        p.error(f"--pad_phase_tables {m_max} is smaller than the largest phase "
                f"({len(grids[0]) // 2} rows)")

    def build_base():
        return build_task(cfg, args.pretrained_dir, device=args.device, seed=args.seed)

    base = build_base()
    teacher = load_unet_params(args.teacher)

    name = cfg.get("model_name", "sdf")
    if not name.endswith("_distill"):  # chained teachers carry it already
        name += "_distill"
    run_cfg = Params({
        **cfg,
        "model_name": name,
        "learning_rate": args.lr,
        "max_epoch": 10**9,  # the stages end at max_steps
        "cond_mode": "cond",  # no CFG dropout: the student is always guided
        "legacy_checkpoints": False,  # the reference cannot run a v-model
    })
    if args.batch_size:
        run_cfg["batch_size"] = args.batch_size
    with data_parallel_mesh(args.device, bool(run_cfg.get("fsdp", False))) as mesh:
        return _stages(args, cfg, run_cfg, grids, m_max, chained, base, build_base, teacher,
                       mesh, rank() == 0)


def _stages(args, cfg, run_cfg, grids, m_max, chained, base, build_base, teacher, mesh, rank0):
    """Stage A and the halving phases, then the run directory's metadata."""
    from .config import Params, save_params
    from .data import SegmentDataset, make_loaders
    from .diffusion.progressive import pad_tables, phase_tables
    from .parallel.mesh import barrier
    from .tasks.distill import DistillTask
    from .train import Trainer

    def say(line):
        if rank0:
            print(line)

    use_track = [0, 1, 2]
    if args.split_file:
        train_ds, val_ds = SegmentDataset.train_val_from_split(
            args.data_dir, args.split_file, use_track
        )
    else:
        train_ds, val_ds = SegmentDataset.train_val_from_dir(args.data_dir, 0.9, use_track)
    train_dl, val_dl = make_loaders(
        train_ds, val_ds, run_cfg["batch_size"], base.device, seed=args.seed,
        used_fields=base.used_batch_fields, mesh=mesh,
    )

    def run_stage(task, subdir, max_steps, init_params):
        """Train ``task``'s student from ``init_params``; returns a copy of its
        fp32 masters, whole, the next stage's teacher (not the bf16 working
        copy)."""
        trainer = Trainer(task, run_cfg, os.path.join(args.output_dir, subdir),
                          max_steps=max_steps, log_every=args.log_every,
                          save_every=args.save_every, mesh=mesh)
        state = trainer.fit(train_dl, val_dl, seed=args.seed, resume=args.resume,
                            init_params=init_params)
        return {k: v.detach().clone() for k, v in state.state_dict()["params"].items()}

    def stage_base():
        # a placed (sharded) student cannot be placed again: a new one a stage
        return base if mesh is None else build_base()

    teacher_kind = "eps_guided"
    last_subdir = None
    if chained:
        teacher_kind = "v"  # guidance already folded: stage A is inapplicable
        say("[distill] v-teacher: chaining stage-B phases "
            f"({len(grids[0])} -> {len(grids[-1])} steps)")
    elif not args.skip_stage_a:
        say(f"[distill] stage A: folding CFG scale {args.guide_scale} into one pass")
        task = DistillTask(stage_base(), teacher, args.guide_scale, "guided", teacher_kind)
        teacher = run_stage(task, "stage_a", args.stage_a_steps, teacher)
        teacher_kind, last_subdir = "v", "stage_a"

    final_grid = grids[-1]
    for fine in grids[:-1]:
        m_phase = len(fine) // 2
        say(f"[distill] halving phase: {len(fine)} -> {m_phase} steps")
        tables, m = pad_tables(phase_tables(base.schedule, fine), m_max)
        task = DistillTask(stage_base(), teacher, args.guide_scale, "halve", teacher_kind,
                           tables=tables, m=m)
        teacher = run_stage(task, f"phase_{m_phase}", args.phase_steps, teacher)
        teacher_kind, last_subdir = "v", f"phase_{m_phase}"

    # the final metadata: an inference-ready run directory at output_dir.
    # distill_grid only when halving phases ran: a stage-A-only student is
    # grid-free and samples on any grid
    final_cfg = Params({
        **cfg,
        "model_name": run_cfg["model_name"],
        "v_prediction": True,
        "distilled_scale": args.guide_scale,
        "distill_teacher": os.path.abspath(args.teacher),
        "legacy_checkpoints": False,
    })
    if len(grids) > 1:
        final_cfg["distill_grid"] = [int(t) for t in final_grid]
    if rank0:
        save_params(final_cfg, os.path.join(args.output_dir, "params.yaml"))
        link = os.path.join(args.output_dir, "chkpts")
        if os.path.islink(link):
            os.remove(link)
        if not os.path.exists(link):
            os.symlink(os.path.join(last_subdir, "chkpts"), link)
    barrier()
    grid_note = f"{len(final_grid)}-step" if len(grids) > 1 else "grid-free (stage-A)"
    say(f"[distill] done: {grid_note} single-pass student at {args.output_dir} "
        "(sample with --ddim --uncond_scale 1; the run dir pins its own grid)")
    return final_cfg


if __name__ == "__main__":
    main()
