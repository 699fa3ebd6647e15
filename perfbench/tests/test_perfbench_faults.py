"""A whole run with the timed path broken underneath (``faults.py``,
planted before the program solves) comes out not correct: a step that
returns its state unchanged, and an answer altered where the solve
returns it.  The cells solve one right-hand side at a time on one card,
so no batch can lose half its columns and no exchange between cards can
be left out."""
import time

import pytest
import torch

from perfbench import harness

from .test_perfbench_harness import SEED, dirs  # noqa: F401


@pytest.fixture
def restore():
    """Undo a fault planted in this process."""
    from repro_torch import solvers
    from repro_torch.solvers import krylov
    saved = krylov.CGSolver.loop_body, solvers.make_solver
    yield
    krylov.CGSolver.loop_body, solvers.make_solver = saved


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_answer"])
@pytest.mark.parametrize("cell", ["ksp.tiny", "cgsets.tiny-hpcg"])
def test_faults_are_caught(cell, fault, restore, dirs):  # noqa: F811
    out, checks = harness.run(cell, SEED, 1.0, False,
                              device=torch.device("cpu"), t0=time.time(),
                              dirs=dirs,
                              plant=f"perfbench.tests.faults:{fault}",
                              grace_s=5.0, warmup_grace_s=5.0)
    assert not out["correct"], checks
    assert out["failed"] >= 1
