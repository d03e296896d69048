"""Progressive distillation: the port against the JAX package on the CPU in
fp32. The halving grids and phase tables (bit for bit), the v algebra, the
v->eps adapter on a tiny UNet, ``DistillTask``'s guided and halve losses and
student gradients with both teacher kinds under JAX's own draws, one student
train step against optax, and the distill CLI end to end: a tiny teacher
trained by the training CLI, stage A and two halving phases, stage A alone,
chain mode, the CLI's refusals, and the student's session on its grid against
JAX's session on the same weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.convert.torch_import import unet_params_from_torch
from polyffusion_tpu.diffusion import progressive as JP
from polyffusion_tpu.inference import InferenceSession as JaxSession
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu.tasks.distill import DistillTask as JaxDistillTask
from polyffusion_tpu.train.state import make_optimizer as jax_make_optimizer
from polyffusion_tpu_torch.config import Params, load_params
from polyffusion_tpu_torch.convert import unet_state_from_jax
from polyffusion_tpu_torch.data import write_song_npz
from polyffusion_tpu_torch.diffusion import progressive as P
from polyffusion_tpu_torch.diffusion.schedule import make_schedule
from polyffusion_tpu_torch.distill import main as distill_main
from polyffusion_tpu_torch.inference import (
    InferenceSession,
    build_task_for_inference,
    load_unet_params,
)
from polyffusion_tpu_torch.inference import main as infer_main
from polyffusion_tpu_torch.main import main as train_main
from polyffusion_tpu_torch.tasks import SDFTask
from polyffusion_tpu_torch.tasks.distill import DistillNoise, DistillTask
from polyffusion_tpu_torch.train import create_state, make_train_step

UNET_ATOL, UNET_RTOL = 2e-4, 1e-4  # the UNet tolerance of tests/test_unet_parity.py:68
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
ATOL, RTOL = 2e-3, 1e-3  # the session tolerance of tests/test_torch_inference.py
GUIDE = 5.0
# one level with attention on 16 x 16 = 256 tokens, one head of 64; 64 channels
# put two in each of the 32 groups (with one, a GroupNorm cancels the bias
# before it and its gradient is rounding noise)
CFG = dict(load_params("sdf_chdvnl"), model_name="sdf_test", batch_size=2, max_epoch=1,
           learning_rate=1e-3, max_grad_norm=1.0, bf16=False, channels=64, attention_levels=[0],
           n_res_blocks=1, channel_multipliers=[1], n_heads=1, img_h=16, img_w=16)
HW, B = 16, 3
GRIDS = [(1000, 64, 4), (1000, 8, 2), (1000, 4, 1)]
# the CLI on the CPU: four levels put the middle block at 16 x 16 of the
# 128 x 128 roll, no attention
TINY_SET = ["channels=32", "channel_multipliers=[1,1,1,1]", "attention_levels=[]",
            "n_res_blocks=1", "bf16=false"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps test workers that share the cores from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- grids and tables ---------------------------------------------------------------------


@pytest.mark.parametrize("n_steps,base,end", GRIDS)
def test_halving_grids_and_phase_tables_equal_jax(n_steps, base, end):
    grids, want = P.halving_grids(n_steps, base, end), JP.halving_grids(n_steps, base, end)
    assert len(grids) == len(want)
    for g, w in zip(grids, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    sched = make_schedule(n_steps)
    for fine in grids[:-1]:
        got, jw = P.phase_tables(sched, fine), JP.phase_tables(sched, fine)
        for name in P.PhaseTables._fields:
            a, w = getattr(got, name), getattr(jw, name)
            assert a.dtype == w.dtype and a.tobytes() == w.tobytes(), name
        padded, m = P.pad_tables(got, got.m + 3)
        jpadded, jm = JP.pad_tables(jw, jw.m + 3)
        assert m == jm == got.m
        for a, w in zip(padded, jpadded):
            assert a.tobytes() == w.tobytes()


@pytest.mark.parametrize("base,end", [(12, 4), (10, 4), (8, 3)])
def test_halving_grids_refuse_what_jax_refuses(base, end):
    for fn in (P.halving_grids, JP.halving_grids):
        with pytest.raises(ValueError, match="power of 2"):
            fn(1000, base, end)


def test_v_algebra_round_trips_and_matches_jax():
    rng = np.random.default_rng(0)
    x0, eps = (rng.standard_normal((3, 2, 4, 4)).astype(np.float32) for _ in range(2))
    ab = rng.uniform(0.05, 0.95, (3, 1, 1, 1)).astype(np.float32)
    a, s = np.sqrt(ab), np.sqrt(1 - ab)
    t = {k: torch.from_numpy(v) for k, v in dict(x0=x0, eps=eps, a=a, s=s).items()}
    x = t["a"] * t["x0"] + t["s"] * t["eps"]
    v = P.v_from_eps_x0(t["eps"], t["x0"], t["a"], t["s"])
    torch.testing.assert_close(P.eps_from_v(x, v, t["a"], t["s"]), t["eps"], atol=1e-5, rtol=0)
    torch.testing.assert_close(P.x0_from_v(x, v, t["a"], t["s"]), t["x0"], atol=1e-5, rtol=0)
    want_v = np.asarray(JP.v_from_eps_x0(eps, x0, a, s))
    np.testing.assert_allclose(v.numpy(), want_v, atol=1e-6, rtol=0)
    # one DDIM jump to the previous level, then the x0 whose student step lands there
    ab_p = np.clip(ab + 0.03, 0, 0.99)
    a_p, s_p = np.sqrt(ab_p), np.sqrt(1 - ab_p)
    x_prev = P.ddim_jump(x, t["eps"], t["a"], t["s"], torch.from_numpy(a_p),
                         torch.from_numpy(s_p))
    want = JP.ddim_jump(x.numpy(), eps, a, s, a_p, s_p)
    np.testing.assert_allclose(x_prev.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    coef = s_p / s
    x0_t = P.solve_x0_target(x, x_prev, torch.from_numpy(coef), torch.from_numpy(a_p - coef * a))
    torch.testing.assert_close(x0_t, t["x0"], atol=1e-4, rtol=0)


# -- the v->eps adapter and the task ------------------------------------------------------


def _pair(seed, **over):
    """The JAX task and params of ``seed`` and the port's task on them."""
    cfg = dict(CFG, **over)
    jtask = JaxSDFTask(JaxParams(cfg))
    params = _np_tree(jax.jit(jtask.init_params)(jax.random.PRNGKey(seed)))
    task = SDFTask(Params(cfg), device="cpu", training=True)
    task.load_unet_state(unet_state_from_jax(params))
    return jtask, params, task


def test_v_adapter_matches_jax():
    jtask, params, task = _pair(0, v_prediction=True)
    assert task.v_prediction and jtask.v_prediction
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, HW, HW, 2)).astype(np.float32)
    t = np.array([999, 400, 3], np.int32)
    cond = rng.standard_normal((B, 1, CFG["d_cond"])).astype(np.float32)
    want = jtask.apply_eps(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    want_raw = jtask.apply_raw(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t), torch.from_numpy(cond))
    with torch.no_grad():
        got, raw = task.apply_eps(*args), task.apply_raw(*args)
    nhwc = lambda v: v.permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=UNET_ATOL, rtol=UNET_RTOL)
    np.testing.assert_allclose(nhwc(raw), np.asarray(want_raw), atol=UNET_ATOL, rtol=UNET_RTOL)
    assert np.abs(nhwc(got) - nhwc(raw)).max() > 0.1


@pytest.mark.parametrize("over", [{"distill_grid": [250, 750]}, {"distilled_scale": 5.0}])
def test_grid_or_scale_alone_builds_an_eps_task(over):
    task = SDFTask(Params(CFG, **over), device="cpu")
    assert not task.v_prediction
    assert task.apply_eps.__func__ is SDFTask.apply_eps


def test_a_v_task_refuses_the_eps_loss():
    _, _, task = _pair(0, v_prediction=True)
    batch = (torch.zeros(2, 2, HW, HW), None, torch.zeros(2, 32, 36), None)
    with pytest.raises(ValueError, match="v-prediction"):
        task.loss_fn(batch, None)


def test_concat_blurry_is_refused():
    cfg = dict(load_params("sdf_concat"), bf16=False, channels=32, attention_levels=[],
               n_res_blocks=1, channel_multipliers=[1])
    base = SDFTask(Params(cfg), device="cpu", training=True)
    with pytest.raises(NotImplementedError, match="concat_blurry"):
        DistillTask(base, base.unet.state_dict(), GUIDE, "guided")


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    x0 = (rng.random((b, 2, HW, HW)) > 0.9).astype(np.float32)
    chord = np.zeros((b, 32, 36), np.float32)
    chord[:, np.arange(32), rng.integers(0, 36, 32)] = 1.0
    placeholder = np.zeros((b, 1), np.float32)
    return x0, placeholder, chord, placeholder


def _jax_draws(rng, mode, b, n_steps, m):
    """JAX ``DistillTask.loss_fn``'s draws from ``rng`` (tasks/distill.py:103-118):
    per sample t in [0, T) or the row j in [0, m), and NCHW noise."""
    kt, kn = jax.random.split(rng)
    noise = np.array(jax.random.normal(kn, (b, HW, HW, 2), jnp.float32))
    hi = n_steps if mode == "guided" else m
    index = np.array(jax.random.randint(kt, (b,), 0, hi))
    return DistillNoise(torch.from_numpy(index),
                        torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 3, 1, 2))))


@pytest.fixture(scope="module")
def distill_pair():
    """A student (JAX seed 1) and a teacher (seed 2), the JAX base task and
    a halving phase 8 -> 4 with its tables padded to 6 rows."""
    jtask, student, task = _pair(1)
    teacher = _np_tree(jtask.init_params(jax.random.PRNGKey(2)))
    fine = P.halving_grids(1000, 8, 2)[0]
    tables, m = P.pad_tables(P.phase_tables(task.schedule, fine), 6)
    return jtask, student, teacher, tables, m


def _tasks(distill_pair, mode, kind):
    jtask, student, teacher, tables, m = distill_pair
    jd = JaxDistillTask(jtask, GUIDE, mode, kind)
    frozen = {"teacher": teacher}
    if mode == "halve":
        frozen.update(tables={k: jnp.asarray(v) for k, v in tables._asdict().items()},
                      m=np.int32(m))
    base = SDFTask(Params(CFG), device="cpu", training=True)
    base.load_unet_state(unet_state_from_jax(student))
    task = DistillTask(base, unet_state_from_jax(teacher), GUIDE, mode, kind,
                       tables=tables if mode == "halve" else None, m=m)
    return jd, frozen, task


@pytest.mark.parametrize("kind", ["eps_guided", "v"])
@pytest.mark.parametrize("mode", ["guided", "halve"])
def test_distill_loss_and_gradients_match_jax(distill_pair, mode, kind):
    _, student, _, _, m = distill_pair
    jd, frozen, task = _tasks(distill_pair, mode, kind)
    x0, ph, chord, _ = _batch(3)
    rng = jax.random.PRNGKey(11)

    def loss_of(p):
        batch = (jnp.asarray(x0), jnp.asarray(ph), jnp.asarray(chord), jnp.asarray(ph))
        return jd.loss_fn(p, frozen, batch, rng, {})[0]

    want, want_g = jax.value_and_grad(loss_of)(student)
    want_g = unet_state_from_jax(_np_tree(want_g))
    noise = _jax_draws(rng, mode, B, 1000, m)
    if mode == "halve":
        assert int(noise.index.max()) < m
    batch = tuple(torch.from_numpy(a) for a in (x0, ph, chord, ph))
    got, _ = task.loss_fn(batch, noise)
    task.model.zero_grad()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for name, p in task.model.named_parameters():
        w = want_g[name]
        err = (p.grad - w).norm().item()
        assert err <= GRAD_RTOL * w.norm().item() + 1e-9, (name, err, w.norm().item())
    assert all(q.grad is None for q in task.teacher.parameters())


def test_student_train_step_matches_optax(distill_pair):
    """One fp32 halve step of the student against JAX's value_and_grad and
    optax (clip, Adam): loss, gradient norm and the parameters after the step.
    The clip divides the gradient by its norm (some 30 here), and Adam moves an
    element by lr g / (|g| + 1e-8): where a clipped gradient lies within a few
    1e-8 of zero, its fp32 rounding decides the update anywhere in (-lr, lr).
    So every element agrees within 2 lr, and all but 0.1 % of them to fp32
    rounding (2e-6), the bound of the train-step check in chip_smoke.py."""
    _, student, _, _, m = distill_pair
    jd, frozen, task = _tasks(distill_pair, "halve", "eps_guided")
    x0, ph, chord, _ = _batch(4)
    rng = jax.random.PRNGKey(12)
    lr, clip = CFG["learning_rate"], CFG["max_grad_norm"]

    def loss_of(p):
        batch = (jnp.asarray(x0), jnp.asarray(ph), jnp.asarray(chord), jnp.asarray(ph))
        return jd.loss_fn(p, frozen, batch, rng, {})[0]

    loss, grads = jax.value_and_grad(loss_of)(student)
    opt = jax_make_optimizer(lr, clip)
    updates, _ = opt.update(grads, opt.init(student), student)
    want = unet_state_from_jax(_np_tree(optax.apply_updates(student, updates)))
    gnorm = float(optax.global_norm(grads))

    state = create_state(task.model, lr, clip)
    batch = tuple(torch.from_numpy(a) for a in (x0, ph, chord, ph))
    metrics = make_train_step(task)(state, batch, seed=0, noise=_jax_draws(rng, "halve", B,
                                                                           1000, m))
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(), gnorm, rtol=GRAD_RTOL)
    got = {k: v.detach().numpy() for k, v in state.params().items()}
    err = np.concatenate([np.abs(got[k] - w.numpy()).ravel() for k, w in want.items()])
    assert metrics["grad_norm"].item() > 10 * clip  # the clip is active
    assert err.max() <= 2 * lr, err.max()
    assert (err > 2e-6).mean() < 1e-3, (err > 2e-6).mean()


def test_draw_noise_stays_below_the_phase_rows(distill_pair):
    _, _, task = _tasks(distill_pair, "halve", "v")
    g = torch.Generator().manual_seed(0)
    rows = torch.cat([task.draw_noise((torch.zeros(64, 2, HW, HW),), g).index
                      for _ in range(4)])
    assert task.tables.tau.shape[0] == 6 and set(rows.tolist()) == set(range(task.m))


# -- the CLI end to end -----------------------------------------------------------------------


def _write_song(path, seed, n_bars=24):
    """A synthetic three-track song (the idea of tests/synth.py)."""
    rng = np.random.default_rng(seed)
    n_beats = n_bars * 4
    n_bins = n_beats * 4
    tracks = []
    for t in range(3):
        n = rng.integers(40, 80)
        onsets = np.sort(rng.integers(0, n_bins - 8, n))
        tracks.append(np.stack([onsets, rng.integers(36 + 12 * t, 72 + 12 * t, n),
                                rng.integers(1, 8, n), rng.integers(60, 100, n),
                                np.zeros(n, np.int64)], 1))
    chord = np.zeros((n_beats, 14), np.int32)
    chord[:, 0] = rng.integers(0, 12, n_beats)
    chord[:, 1:13] = rng.integers(0, 2, (n_beats, 12))
    chord[:, 13] = chord[:, 0]
    db_pos = np.arange(0, n_bins, 16)
    write_song_npz(path, tracks, chord, db_pos, db_pos + 128 <= n_bins, n_beats=n_beats)


def _distill(teacher, data, out, *extra):
    return distill_main(["--teacher", teacher, "--data_dir", data, "--output_dir", out,
                         "--device", "cpu", "--batch_size", "2", "--stage_a_steps", "1",
                         "--phase_steps", "1", "--log_every", "1", *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Songs, a tiny ``sdf_chdvnl`` teacher trained 2 steps by the training
    CLI, and its distillation: stage A, then 8 -> 4 -> 2."""
    root = tmp_path_factory.mktemp("distill")
    data = root / "songs"
    data.mkdir()
    for i in range(3):
        _write_song(str(data / f"song{i}.npz"), seed=i)
    teacher = str(root / "teacher")
    args = ["--model", "sdf_chdvnl", "--output_dir", teacher, "--data_dir", str(data),
            "--device", "cpu", "--batch_size", "2", "--max_steps", "2", "--log_every", "1"]
    for kv in TINY_SET:
        args += ["--set", kv]
    assert train_main(args).step == 2
    out = str(root / "distilled")
    _distill(teacher, str(data), out, "--base_steps", "8", "--end_steps", "2")
    return dict(root=root, data=str(data), teacher=teacher, out=out)


def _cfg(run):
    with open(os.path.join(run, "params.yaml")) as f:
        return yaml.safe_load(f)


def test_cli_distills_to_the_jax_grid(runs, capsys):
    out = runs["out"]
    cfg = _cfg(out)
    assert cfg["distill_grid"] == [int(t) for t in JP.halving_grids(1000, 8, 2)[-1]]
    assert cfg["v_prediction"] is True and cfg["distilled_scale"] == GUIDE
    assert cfg["model_name"] == "sdf_chdvnl_distill"
    assert cfg["distill_teacher"] == os.path.abspath(runs["teacher"])
    assert os.readlink(os.path.join(out, "chkpts")) == os.path.join("phase_2", "chkpts")
    for stage in ("stage_a", "phase_4", "phase_2"):
        ckpt = torch.load(os.path.join(out, stage, "chkpts", "last.pt"), weights_only=True)
        assert ckpt["step"] == 1
        assert _cfg(os.path.join(out, stage))["cond_mode"] == "cond"
    # each phase starts from the finished stage's weights: its step moved them
    a, b = (load_unet_params(os.path.join(out, s)) for s in ("stage_a", "phase_4"))
    assert any((a[k] != b[k]).any() for k in a)
    capsys.readouterr()
    gen_dir = runs["root"] / "gen"
    (gen,) = infer_main(["--chkpt_path", out, "--data_dir", runs["data"], "--song_fn",
                         "song1.npz", "--output_dir", str(gen_dir), "--device", "cpu",
                         "--ddim", "--length", "1"])
    assert gen.shape == (1, 2, 128, 128) and np.isfinite(gen).all()
    assert "using its 2-step grid" in capsys.readouterr().out
    (mid,) = os.listdir(gen_dir)
    assert mid.startswith("sdf_chdvnl_distill[scale=1.0,ddim2_eta0.0_distilled]_")


def test_cli_stage_a_alone_writes_no_grid(runs):
    out = str(runs["root"] / "stage_a_only")
    _distill(runs["teacher"], runs["data"], out, "--base_steps", "2", "--end_steps", "2")
    cfg = _cfg(out)
    assert "distill_grid" not in cfg and cfg["v_prediction"] is True
    assert os.readlink(os.path.join(out, "chkpts")) == os.path.join("stage_a", "chkpts")
    assert sorted(os.listdir(out)) == ["chkpts", "params.yaml", "stage_a"]


def test_cli_chain_mode_continues_the_stored_grid(runs, capsys):
    out = str(runs["root"] / "chained")
    capsys.readouterr()
    _distill(runs["out"], runs["data"], out, "--end_steps", "1", "--guide_scale", "2.0")
    assert "chaining stage-B phases (2 -> 1 steps)" in capsys.readouterr().out
    cfg = _cfg(out)
    stored = _cfg(runs["out"])["distill_grid"]
    assert cfg["distill_grid"] == stored[1::2] == [int(t) for t in
                                                  JP.halving_grids(1000, 8, 1)[-1]]
    assert cfg["distilled_scale"] == GUIDE  # inherited, not the flag's 2.0
    assert cfg["model_name"] == "sdf_chdvnl_distill"
    assert sorted(os.listdir(out)) == ["chkpts", "params.yaml", "phase_1"]


@pytest.mark.parametrize("case", ["skip_a", "pad", "chain_size", "chain_done", "chain_free",
                                  "no_model"])
def test_cli_refuses(runs, case):
    root, data = runs["root"], runs["data"]
    teacher, args = runs["teacher"], []
    if case == "skip_a":
        args = ["--skip_stage_a", "--base_steps", "4", "--end_steps", "4"]
    elif case == "pad":
        args = ["--base_steps", "8", "--end_steps", "2", "--pad_phase_tables", "3"]
    elif case == "chain_size":
        teacher, args = runs["out"], ["--end_steps", "3"]
    elif case == "chain_done":
        teacher, args = runs["out"], ["--end_steps", "2"]
    elif case == "chain_free":
        teacher = str(root / "stage_a_only")
        if not os.path.exists(teacher):
            _distill(runs["teacher"], data, teacher, "--base_steps", "2", "--end_steps", "2")
        args = ["--base_steps", "2", "--end_steps", "2"]
    else:
        teacher = str(root / "teacher.pt")
        torch.save(load_unet_params(runs["teacher"]), teacher)
    with pytest.raises(SystemExit):
        _distill(teacher, data, str(root / f"refused_{case}"), *args)
    assert not os.path.exists(root / f"refused_{case}")


def test_student_session_matches_jax(runs):
    """The 2-step student on its grid at scale 1 through the port's session
    and JAX's, the port's weights read into JAX by the JAX package's torch
    importer; the same starting noise."""
    out = runs["out"]
    cfg = load_params(os.path.join(out, "params.yaml"))
    task = build_task_for_inference(cfg, device="cpu")
    state = load_unet_params(out)
    task.load_unet_state(state)
    jtask = JaxSDFTask(JaxParams(cfg))
    params = unet_params_from_torch({k: v.numpy() for k, v in state.items()})
    sess = InferenceSession(task, use_ddim=True, device="cpu")
    jsess = JaxSession(jtask, params, use_ddim=True)
    np.testing.assert_array_equal(sess.ddim.time_steps, jsess.ddim.time_steps)
    np.testing.assert_array_equal(sess.ddim.time_steps, cfg["distill_grid"])
    assert sess.ddim_label == jsess.ddim_label == "ddim2_eta0.0_distilled"
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((2, 1, cfg["d_cond"])).astype(np.float32)
    noise = rng.standard_normal((2, 128, 128, 2)).astype(np.float32)
    want = jsess.predict(cond, noise=noise)
    got = sess.predict(cond, noise=noise)
    assert got.shape == (2, 2, 128, 128) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
