"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run without a GPU unless they are given the CPU."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "polyffusion_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import polyffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "flax", "polyffusion_tpu")
    or m.startswith(("jax.", "flax.", "polyffusion_tpu."))
)
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 53
    assert bad.strip() == "[]", bad


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax)\b|from\s+(jax|flax)\b|from\s+polyffusion_tpu\s+import\b"
    r"|import\s+polyffusion_tpu\b(?!_))|\bpolyffusion_tpu\.",
    re.MULTILINE,
)


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_sources_name_no_jax(path):
    with open(path) as f:
        hits = _FORBIDDEN.findall(f.read())
    assert not hits, hits


def test_entry_points_raise_without_cuda(monkeypatch):
    import torch

    from polyffusion_tpu_torch.config import load_params
    from polyffusion_tpu_torch.inference import InferenceSession
    from polyffusion_tpu_torch.models import ChordEncoder
    from polyffusion_tpu_torch.models.polydis import PolyDis, PolydisAftertouch
    from polyffusion_tpu_torch.tasks import SDFTask

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_params("sdf_chd8bar")
    cfg.update(channels=32, channel_multipliers=[1], attention_levels=[], n_res_blocks=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDFTask(cfg, ChordEncoder(36, 16, 512))
    task = SDFTask(cfg, ChordEncoder(36, 16, 512), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceSession(task)
    assert InferenceSession(task, device="cpu").device.type == "cpu"
    for entry in (PolyDis, PolydisAftertouch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(device=None)
    assert PolyDis(device="cpu").device.type == "cpu"
    assert PolydisAftertouch(device="cpu").model.device.type == "cpu"
