"""SDXL-base's UNet on the port (``tasks/sdxl.py``, the SDXL keys of
``models/unet.py``): a tiny SDXL-shaped UNet and its DDIM sampling against the
benchmark's plain reference (``cardbench/reference/sdxl_unet.py``) on the same
seeded weights, fp32 on the CPU; the published configuration built on the
meta device; the two-part condition, its CFG unconditional pair and the
attention dispatch's counters; the benchmark's cell at a tiny size through
its own ``run_cell``."""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from cardbench import spec as specs
from cardbench.families import sdxl as fam
from cardbench.reference import diffusion as ref_diffusion
from cardbench.reference import sdxl_unet as ref_unet
from cardbench.run import run_cell
from polyffusion_tpu_torch import tracing
from polyffusion_tpu_torch.config import PARAMS_DIR, Params, load_params
from polyffusion_tpu_torch.diffusion.sampler import make_eps_fn
from polyffusion_tpu_torch.inference import InferenceSession
from polyffusion_tpu_torch.models.unet import UNetModel
from polyffusion_tpu_torch.tasks.sdxl import SDXLTask, make_unet

CELL = "sdxl.gen-ddim50-b4"
SEED = 2 ** 31 + 2023
# three levels, transformer depths [0, 1, 2] (2 in the middle), heads of 16,
# 8 context tokens, y of a 16-wide pooled vector and six 8-wide size sinusoids
TINY = {"in_channels": 4, "out_channels": 4, "channels": 32, "channel_multipliers": [1, 2, 4],
        "n_res_blocks": 2, "attention_levels": [1, 2], "tf_layers": [0, 1, 2],
        "d_head": 16, "d_cond": 24, "n_ctx": 8, "pooled_dim": 16,
        "size_embed_dim": 8, "adm_in_channels": 16 + 6 * 8, "img_h": 16, "img_w": 16,
        "n_steps": 100, "bf16": False, "precision": "fp32"}
# heads of 64 and a 32 x 32 latent: self-attention of 256 and 64 tokens, which
# the dispatch sends to kernel 1's path
TINY_KERNEL = {**TINY, "channels": 64, "d_head": 64, "img_h": 32, "img_w": 32}
# the published UNet: diffusers' UNet2DConditionModel of this checkpoint holds
# the same number
PUBLISHED_PARAMETERS = 2_567_463_684
# fp32 on both sides, the port's one-pass GroupNorm statistics against the
# reference's two-pass: tests/test_unet_parity.py's UNet tolerance
ATOL, RTOL = 2e-4, 1e-4
# fp32 on both sides through 5 DDIM steps with CFG 5: three seeds read 1.97e-6-2.18e-6
SAMPLE_GAP = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(extra=TINY):
    cfg = copy.deepcopy(specs.load(CELL).config)
    cfg.update(extra)
    return cfg


def _condition(cfg, batch, r=0):
    return fam.request_condition(cfg, SEED, r, batch, "cpu")


def _task(cfg):
    return SDXLTask(Params(cfg), fam.unet_weights(cfg, SEED, "cpu"), device="cpu")


def _rows_gap(got, want):
    got, want = got.double().flatten(1), want.double().flatten(1)
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


@pytest.mark.parametrize("batch", [1, 3])
def test_a_tiny_unet_matches_the_reference(batch):
    cfg = _config()
    task = _task(cfg)
    ref = fam.reference_models(cfg, SEED, "cpu")
    g = torch.Generator().manual_seed(batch)
    x = torch.randn(batch, 4, 16, 16, generator=g)
    t = torch.randint(0, 1000, (batch,), generator=g)
    c = _condition(cfg, batch)
    context, y = task.encode_cond(c["context"], c["pooled"], c["size_ids"])
    with torch.no_grad():
        got = task.apply_eps(x, t, (context, y))
        want = ref(x, t, context, ref_unet.vector_condition(cfg, c["pooled"], c["size_ids"]))
    assert got.dtype == torch.float32 and got.shape == (batch, 4, 16, 16)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_the_published_configuration_on_meta_has_the_references_parameters():
    """The preset built the task's way (meta device, bf16 cast) against the
    reference of the benchmark's configuration: the same names and shapes,
    2,567,463,684 parameters, norms fp32 and every other weight bf16."""
    task = SDXLTask(load_params("sdxl_base"), device="meta")
    ref = fam.meta_unet(specs.load(CELL).config)
    got = {k: tuple(v.shape) for k, v in task.unet.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in task.unet.parameters()) == PUBLISHED_PARAMETERS
    assert {k for k in got if k.startswith("label_emb")} == {
        "label_emb.0.0.weight", "label_emb.0.0.bias", "label_emb.0.2.weight",
        "label_emb.0.2.bias"}
    assert task.unet.state_dict()["label_emb.0.0.weight"].shape == (1280, 2816)
    dtypes = {k: v.dtype for k, v in task.unet.state_dict().items()}
    assert dtypes["middle_block.1.transformer_blocks.9.norm3.weight"] == torch.float32
    assert dtypes["output_blocks.0.0.in_layers.0.weight"] == torch.float32
    assert dtypes["middle_block.1.proj_in.weight"] == torch.bfloat16


def test_the_published_sites_an_evaluation():
    """70 self-attentions (10 heads at 64^2 tokens, 20 at 32^2) and 46
    GroupNorms an evaluation, two of them 2560 channels wide (80 a group)."""
    cfg = specs.load(CELL).config
    from cardbench import yardstick

    sites = yardstick.sites(fam.meta_unet(cfg), *fam.eval_inputs(cfg, 8, "meta"))
    assert len(sites.attention) == 70
    assert sorted(set(sites.attention)) == [(8, 1024, 20, 64), (8, 4096, 10, 64)]
    assert sum(t == 4096 for _, t, _, _ in sites.attention) == 10
    assert len(sites.group_norm) == 46
    assert sorted(s for s in sites.group_norm if s[1] > 2048) == [(8, 2560, 32, 32)] * 2


def test_the_preset_is_the_benchmarks_configuration():
    with open(os.path.join(PARAMS_DIR, "sdxl_base.yaml")) as f:
        preset = yaml.safe_load(f)
    config = specs.load(CELL).config
    assert {k: config[k] for k in preset} == preset
    assert [c for c in specs.benchmark()["configs"] if c["name"] == "sdxl_base"][0][
        "reduced"] == []


def test_meta_to_the_device_draws_nothing_on_the_cpu(monkeypatch):
    """The task builds its UNet on the meta device, materialises it on its
    own, uninitialised, and fills it from the state dict: torch's default
    init runs on meta tensors only."""
    seen = []
    orig = torch.nn.init.kaiming_uniform_

    def spy(tensor, *a, **k):
        seen.append(tensor.device.type)
        return orig(tensor, *a, **k)

    monkeypatch.setattr(torch.nn.init, "kaiming_uniform_", spy)
    cfg = _config()
    sd = fam.unet_weights(cfg, SEED, "cpu")
    task = SDXLTask(Params(cfg), sd, device="cpu")
    assert seen and set(seen) == {"meta"}
    for name, p in task.unet.state_dict().items():
        assert p.device.type == "cpu" and torch.equal(p, sd[name]), name


def test_the_vector_condition_is_the_pooled_vector_and_six_size_sinusoids():
    cfg = _config()
    task = _task(cfg)
    c = _condition(cfg, 2)
    context, y = task.encode_cond(c["context"], c["pooled"], c["size_ids"])
    assert torch.equal(context, c["context"])
    assert y.shape == (2, cfg["adm_in_channels"])
    assert torch.equal(y[:, :16], c["pooled"])
    ids = torch.tensor(cfg["size_ids"], dtype=torch.float32)
    freqs = torch.exp(-np.log(10000) * torch.arange(4, dtype=torch.float32) / 4)
    args = ids[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=1).reshape(-1)
    torch.testing.assert_close(y[0, 16:], emb, atol=1e-6, rtol=0)
    torch.testing.assert_close(y, ref_unet.vector_condition(cfg, c["pooled"], c["size_ids"]),
                               atol=0, rtol=0)


def test_the_cfg_unconditional_pair_is_zeros_of_the_text_parts():
    """SDXL-base's ``force_zeros_for_empty_prompt``: the text tokens and the
    pooled vector zeros; the size ids are part of both halves. The double
    batch stacks [uncond, cond] in each part."""
    cfg = _config()
    task = _task(cfg)
    c = _condition(cfg, 2)
    cond = task.encode_cond(c["context"], c["pooled"], c["size_ids"])
    u_ctx, u_y = task.uncond_condition(cond)
    assert torch.equal(u_ctx, torch.zeros_like(cond[0]))
    assert torch.equal(u_y[:, :16], torch.zeros(2, 16)) and torch.equal(u_y[:, 16:], cond[1][:, 16:])
    want = ref_unet.unconditional(cfg, *cond)
    assert torch.equal(u_ctx, want[0]) and torch.equal(u_y, want[1])
    calls = []

    def apply(x, t, pair):
        calls.append(pair)
        return torch.zeros_like(x)

    make_eps_fn(apply, 5.0, (u_ctx, u_y))(torch.zeros(2, 4, 8, 8), torch.zeros(2), cond)
    (ctx_in, y_in), = calls
    assert torch.equal(ctx_in, torch.cat([u_ctx, cond[0]]))
    assert torch.equal(y_in, torch.cat([u_y, cond[1]]))


def test_predict_matches_the_references_ddim_with_cfg():
    cfg = _config()
    task = _task(cfg)
    session = InferenceSession(task, use_ddim=True, ddim_steps=5, seed=1, device="cpu")
    c = _condition(cfg, 2)
    noise = torch.randn(2, 16, 16, 4, generator=torch.Generator().manual_seed(5))
    got = session.predict(task.encode_cond(c["context"], c["pooled"], c["size_ids"]),
                          uncond_scale=5.0, noise=noise)
    assert got.shape == (2, 4, 16, 16)
    traffic = {"ddim_steps": 5, "cfg_scale": 5.0}
    want = fam.reference_generate(cfg, traffic, SEED, c, noise.permute(0, 3, 1, 2), "cpu")
    assert _rows_gap(torch.from_numpy(got), want) < SAMPLE_GAP


def _tiny_spec(extra=TINY):
    s = copy.deepcopy(specs.load(CELL))
    s.config.update(extra)
    s.traffic.update(batch=2, ddim_steps=5, check_rows=2)
    # the tiny fp32 program reads about 2e-6, the tiny fp8 control 0.16-0.20 (three seeds)
    s.limits = {"sample_gap": 1e-3}
    return s


@pytest.mark.parametrize("control", [None, "fp8"])
def test_the_cell_at_a_tiny_size_is_correct_and_its_control_is_not(control):
    s = _tiny_spec()
    s.control = control
    result = run_cell(s, SEED, 0.5, False, "cpu")
    gap = result["checks"]["sample_gap"]["value"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"gen_samples_per_s", "setup_s"}
    if control is None:
        assert result["correct"] and gap < SAMPLE_GAP
    else:
        assert not result["correct"] and gap > 10 * SAMPLE_GAP


def test_an_altered_answer_is_not_correct(monkeypatch):
    """Every answer scaled by 1.1 where ``generate`` returns it (``faults.py``'s
    ``answer_altered``, which names the ``generate`` driver only)."""
    s = _tiny_spec()
    orig = fam.GenProgram.generate
    monkeypatch.setattr(fam.GenProgram, "generate", lambda self, c, n: orig(self, c, n) * 1.1)
    result = run_cell(s, SEED, 0.5, False, "cpu")
    assert not result["correct"]
    assert result["checks"]["sample_gap"]["value"] == pytest.approx(0.1, rel=1e-3)


def test_the_cells_readers_read_a_traced_tiny_run():
    """The CPU's trace holds no device operation: the device readers find
    nothing and say so; the counter and the FLOPs read."""
    s = _tiny_spec()
    result = run_cell(s, SEED, 0.5, True, "cpu")
    assert result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # 17 transformer blocks an evaluation; heads of 16 miss kernel 1's path,
    # so self- and cross-attention both run the plain version
    assert got["plain_attn_per_eval.sdxl"] == 34
    assert got["mfu.sdxl"] > 0
    assert not {"unet_eval_ms.sdxl", "attn_fwd_roofline.sdxl", "gn_fwd_roofline.sdxl",
                "idle_share.sdxl"} & set(got)


@pytest.mark.parametrize("extra, blocks, self_plain", [(TINY, 17, True), (TINY_KERNEL, 17, False)],
                         ids=["heads-of-16", "heads-of-64"])
def test_the_dispatch_counts_the_plain_and_the_cross_attentions(extra, blocks, self_plain):
    cfg = _config(extra)
    task = _task(cfg)
    c = _condition(cfg, 2)
    cond = task.encode_cond(c["context"], c["pooled"], c["size_ids"])
    x = torch.randn(2, 4, cfg["img_h"], cfg["img_w"])
    before = tracing.counters()
    with torch.no_grad():
        task.apply_eps(x, torch.zeros(2, dtype=torch.long), cond)
    after = tracing.counters()
    delta = {k: after[k] - before[k] for k in ("ops.attention.plain_calls",
                                               "ops.attention.plain_cross_calls")}
    assert delta["ops.attention.plain_cross_calls"] == blocks
    assert delta["ops.attention.plain_calls"] == blocks * (2 if self_plain else 1)


def test_the_kernel_8_sites_of_the_published_evaluation():
    """``gn_fwd_roofline.sdxl`` checks 46 launches an evaluation: every
    GroupNorm, the two of 80 channels a group among them, which kernel 8's
    table of 128 holds."""
    s = specs.load(CELL)
    mod = specs.reader("gn_fwd_roofline.sdxl")
    from cardbench import readers

    gn = readers.sites(s, 8).group_norm
    assert len(gn) == 46 and len(mod.taken(gn)) == 46
    from polyffusion_tpu_torch.ops.gn_fwd import MAX_CHANNELS_PER_GROUP, gn_fwd_plan

    assert mod.MAX_CHANNELS_PER_GROUP == MAX_CHANNELS_PER_GROUP
    for shape in gn:
        fits = True
        try:
            gn_fwd_plan(*shape[1:], torch.bfloat16, 32, False)
        except ValueError:
            fits = False
        assert fits == (shape in mod.taken([shape])), shape


@pytest.mark.parametrize("depths", [1, [0, 0, 1, 1]])
def test_the_polyffusion_unet_keeps_its_parameters(depths):
    """The SDXL keys at their defaults, or one depth a level, leave the sdf
    UNet's modules, names and outputs as they were."""
    base = dict(in_channels=2, out_channels=2, channels=32, n_res_blocks=1,
                attention_levels=(2, 3), channel_multipliers=(1, 1, 2, 2), n_heads=2, d_cond=12)
    torch.manual_seed(0)
    a = UNetModel(**base)
    b = UNetModel(**base, tf_layers=depths)
    b.load_state_dict(a.state_dict(), strict=True)
    assert a.label_emb is None
    x, t, c = torch.randn(1, 2, 16, 16), torch.tensor([7]), torch.randn(1, 1, 12)
    with torch.no_grad():
        assert torch.equal(a(x, t, c), b(x, t, c))
    with pytest.raises(ValueError, match="label_emb"):
        a(x, t, c, y=torch.zeros(1, 4))


def test_make_unet_reads_the_preset():
    cfg = load_params("sdxl_base")
    with torch.device("meta"):
        unet = make_unet(cfg)
    st = unet.middle_block[1]
    assert st.linear and isinstance(st.proj_in, torch.nn.Linear)
    assert len(st.transformer_blocks) == 10
    blk = st.transformer_blocks[0]
    assert blk.attn1.n_heads == 20 and blk.attn1.d_head == 64
    assert blk.norm1.eps == 1e-5 and blk.ff.net[0].gelu == "none"
    assert unet.input_blocks[4][1].transformer_blocks[0].attn1.n_heads == 10
    assert len(unet.input_blocks[1]) == 1  # level 0 does not attend


def test_the_reference_schedule_is_sdf_chd8bars():
    a = ref_diffusion.schedule(specs.load(CELL).config).alpha_bar
    b = ref_diffusion.schedule(specs.load("chd8bar.gen-ddim50-b64").config).alpha_bar
    assert torch.equal(a, b)
