"""The harness end to end on the CPU at a tiny size: the program against
the reference on the same seeded weights and inputs (the same mathematics
before the card compares them at full width), the lower-precision control in
the program's place and every fault a cell can have coming out as not
correct through the harness's own comparison."""

import pytest

from cardbench import control, faults
from cardbench.run import run_cell
from cardbench.tests.tiny import tiny_spec

SEED = 2 ** 31 + 99
CELLS = ("chd8bar.gen-ddim50-b64", "ddpm.train-fp32-b16", "chd8bar.train-bf16-b64",
         "chd8bar.serve-ddim50-open")
LOWER = {"sdf_chd8bar": "fp8", "ddpm": "bf16"}  # as below the full configurations
# the tiny fp32 cells read under 2e-3 on every number
TINY_LIMITS = 0.01
# the tiny bf16 step on fp32 masters reads loss 4.0e-4, gradient 0.030, change
# 0.046, working copy 6.8e-5, condition 0 on SEED
TINY_BF16_LIMITS = {"loss_gap": 5e-3, "grad_gap": 0.1, "delta_gap": 0.15, "work_gap": 0.1,
                    "cond_gap": 1e-4}


def _limits(s, bf16: bool):
    s.limits = dict(TINY_BF16_LIMITS) if bf16 else {k: TINY_LIMITS for k in s.limits}
    return s


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_matches_the_reference_at_a_tiny_size(cell):
    result = run_cell(tiny_spec(cell), SEED, 0.5, False, "cpu")
    assert result["correct"] and result["failed"] == 0
    for name, c in result["checks"].items():
        # fp32 on both sides: the program's tanh GELU and eps 1e-6 against the
        # published exact GELU and 1e-5 and the order of sums are all between them
        assert c["value"] <= 2e-3, (name, c)


def test_the_bf16_step_matches_the_reference_at_a_tiny_size():
    s = _limits(tiny_spec("chd8bar.train-bf16-b64", bf16=True), True)
    result = run_cell(s, SEED, 0.5, False, "cpu")
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(TINY_BF16_LIMITS)


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_reads_far_above_the_program(cell):
    """The reference in the precision below the configuration's, put in the
    program's place, fails the comparison that the program passes."""
    s = _limits(tiny_spec(cell), False)
    prog = control.readings(cell, SEED, "program", 0.5, "cpu", spec=s)
    ctl = control.readings(cell, SEED, "control", 0.5, "cpu", spec=s,
                           lower=LOWER[s.cell["config"]])
    assert prog["correct"] and not ctl["correct"]
    assert max(ctl[k] / max(prog[k], 1e-12) for k in s.limits) > 10


FAULTS = [("chd8bar.gen-ddim50-b64", "answer_altered", False),
          ("chd8bar.serve-ddim50-open", "rows_swapped", False),
          ("ddpm.train-fp32-b16", "state_unchanged", False),
          ("ddpm.train-fp32-b16", "half_batch", False),
          ("chd8bar.train-bf16-b64", "state_unchanged", False),
          ("chd8bar.train-bf16-b64", "half_batch", False),
          ("chd8bar.train-bf16-b64", "state_unchanged", True),
          ("chd8bar.train-bf16-b64", "half_batch", True),
          ("chd8bar.train-bf16-b64", "refresh_skipped", True)]


@pytest.mark.parametrize("cell, fault, bf16", FAULTS,
                         ids=[f"{c}-{f}{'-bf16' if b else ''}" for c, f, b in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, bf16):
    s = _limits(tiny_spec(cell, bf16=bf16), bf16)
    with faults.planted(fault, s):
        result = run_cell(s, SEED, 0.5, False, "cpu")
    assert not result["correct"], result["checks"]
    if fault == "refresh_skipped":
        # the masters move as the reference's do; the stale copy shows in the
        # working copy's change and in the losses of the steps after the first
        got = result["checks"]
        assert got["work_gap"]["value"] == 1.0
        assert got["loss_gap"]["value"] > got["loss_gap"]["limit"]
        assert got["grad_gap"]["value"] <= got["grad_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits_on_the_card(cuda, cell):
    """The control at the cell's own size on the card, in the program's
    place, comes out as not correct."""
    got = control.readings(cell, 7, "control", 3.0, cuda)
    assert not got["correct"], got
