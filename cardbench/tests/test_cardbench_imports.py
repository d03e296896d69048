"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference loads nothing of the program. Each check runs in a fresh
interpreter, compares whole top-level module names, and fails on any."""

import glob
import os
import subprocess
import sys

from cardbench.spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "polyffusion_tpu")


def _loaded_after(code: str) -> set:
    probe = code + (
        "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_its_drivers_and_readers_load_no_jax():
    readers = sorted(glob.glob(os.path.join(ROOT, "cardbench", "metrics", "*.py")))
    code = ("import cardbench.run, cardbench.control, cardbench.faults, cardbench.programs\n"
            "from cardbench.drivers import generate, serve, train\n"
            "from cardbench.families import ddpm, sdf\n"
            "from cardbench import spec\n"
            "from polyffusion_tpu_torch import serve as _s, inference as _i\n"
            "from polyffusion_tpu_torch.train import step as _t\n"
            + "".join(f"spec.reader({os.path.basename(p)[:-3]!r})\n" for p in readers))
    assert not _loaded_after(code) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("from cardbench.reference import chord_encoder, ddpm_unet, diffusion, layers, "
            "midi, precision, sdf_unet, train\n")
    loaded = _loaded_after(code)
    assert not loaded & set(FORBIDDEN + ("polyffusion_tpu_torch",))
