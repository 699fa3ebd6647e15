"""The port's trainer CLI (``python -m repro_torch.launch.train``) on the
CPU, mirroring the reference's ``tests/test_launch.py``: the loss falls
over 8 steps, a run resumes from its step-4 checkpoint, a SIGKILLed run
resumes; and beyond it, a resumed run is bit for bit an uninterrupted
one, and a checkpoint the reference's trainer wrote resumes in the port.

xlstm-350m at ``reduced()``, B 2, S 64, as the reference's tests run it.
The in-process runs call ``main`` with ``--device cpu``; the killed run
is a subprocess.  The reference's checkpoint comes from its own
``main`` run in this process on qwen2.5-3b at ``reduced()`` with float32
compute (registered for the test in both packages' registries as
``qwen2.5-3b-f32``): at the config's bf16 compute two packages' losses
differ by ~1e-4 of their size, so the 1e-4 check that a checkpoint was
read right runs at float32 (reading: 3.3e-7).
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import SRC
from repro.configs import base as ref_base
from repro.launch.train import main as ref_main
from repro_torch.configs import base as port_base
from repro_torch.checkpoint import load, save
from repro_torch.configs import get_config
from repro_torch.launch.train import checkpoint_like, checkpoint_tree, main
from repro_torch.models.model import init_params
from repro_torch.optim import init_opt

F32_ARCH = "qwen2.5-3b-f32"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: the tensors here are small, and
    a pool per test worker oversubscribes the host under ``pytest -n``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(tmp, steps, extra=(), arch="xlstm-350m", every=2, seq=64):
    return ["--arch", arch, "--reduced", "--steps", str(steps),
            "--batch", "2", "--seq", str(seq),
            "--ckpt-dir", os.path.join(tmp, "ckpt"),
            "--ckpt-every", str(every), "--log-every", "1",
            "--metrics-out", os.path.join(tmp, "m.json"), *extra]


def _run(main_fn, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main_fn(argv) == 0
    return out.getvalue()


def _metrics(tmp) -> dict:
    with open(os.path.join(tmp, "m.json")) as f:
        return json.load(f)


def test_train_loop_loss_decreases(tmp_path):
    _run(main, _args(str(tmp_path), 8, ["--device", "cpu"]))
    m = _metrics(tmp_path)
    assert m["loss_decreased"], m
    assert len(m["losses"]) == 8 and all(np.isfinite(m["losses"]))
    # the deterministic mode is the run's only
    assert not torch.are_deterministic_algorithms_enabled()


def test_no_silent_fallback_to_the_cpu(tmp_path, monkeypatch):
    """``--device`` defaults to ``cuda``; without a card the CLI refuses
    (a usage error) and trains nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(_args(str(tmp_path), 2))
    assert e.value.code == 2
    assert not os.path.exists(os.path.join(tmp_path, "m.json"))


def test_train_resume_restarts_from_checkpoint(tmp_path):
    """Run 4 steps, then resume to 8: the resumed run starts from step 4
    and runs steps 5..8 only."""
    _run(main, _args(str(tmp_path), 4, ["--device", "cpu"]))
    out = _run(main, _args(str(tmp_path), 8, ["--device", "cpu",
                                              "--resume"]))
    assert "resumed from step 4" in out
    assert len(_metrics(tmp_path)["losses"]) == 4


def test_resumed_run_is_the_uninterrupted_run_bit_for_bit(tmp_path):
    """8 steps uninterrupted (a checkpoint every 4); then only the step-4
    checkpoint, resumed to 8: losses 5..8 and every array of the step-8
    checkpoint are the same bits."""
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    _run(main, _args(whole, 8, ["--device", "cpu"], every=4))
    os.makedirs(os.path.join(part, "ckpt"))
    shutil.copytree(os.path.join(whole, "ckpt", "step_000000004"),
                    os.path.join(part, "ckpt", "step_000000004"))
    out = _run(main, _args(part, 8, ["--device", "cpu", "--resume"],
                           every=4))
    assert "resumed from step 4" in out
    assert _metrics(part)["losses"] == _metrics(whole)["losses"][4:]
    arrays = [np.load(os.path.join(d, "ckpt", "step_000000008",
                                   "arrays.npz")) for d in (whole, part)]
    assert arrays[0].files == arrays[1].files
    for k in arrays[0].files:
        assert arrays[0][k].tobytes() == arrays[1][k].tobytes(), k


def test_train_survives_kill_and_resume(tmp_path):
    """Node-failure simulation: SIGKILL the trainer mid-run, then resume."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_args(str(tmp_path), 50, ["--device", "cpu"])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    ckpt = os.path.join(tmp_path, "ckpt")
    try:
        for _ in range(600):
            if os.path.isdir(ckpt) and any(
                    n.startswith("step_") and not n.endswith(".tmp")
                    for n in os.listdir(ckpt)):
                break
            time.sleep(0.2)
            assert p.poll() is None, p.stdout.read()
    finally:
        p.kill()
        p.wait()
    out = _run(main, _args(str(tmp_path), 6, ["--device", "cpu",
                                              "--resume"]))
    assert "resumed from step" in out


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-1.2b"])
def test_checkpoint_like_is_a_template_of_the_checkpoint(tmp_path, arch):
    """``checkpoint_like`` (meta-device leaves, no number copied) has the
    tree, shapes and dtypes of ``checkpoint_tree``: a saved checkpoint
    loads through it to the same bits (stacks, zamba's unstacked
    ``shared_attn``, the moments and the int32 step)."""
    model = init_params(get_config(arch).reduced(),
                        torch.Generator().manual_seed(0), device="cpu",
                        trainable=True)
    opt = init_opt(dict(model.named_parameters()))
    opt.m[next(iter(opt.m))].add_(1.5)
    tree = checkpoint_tree(model, opt)
    like = checkpoint_like(model, opt)
    assert all(t.device.type == "meta" for t in torch.utils._pytree
               .tree_leaves(like))
    save(str(tmp_path), 3, tree)
    got, _ = load(str(tmp_path), 3, like)

    def same(a, b, path="") -> int:
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            return sum(same(a[k], b[k], f"{path}.{k}") for k in a)
        if isinstance(a, tuple):
            return sum(same(x, y, f"{path}[{i}]")
                       for i, (x, y) in enumerate(zip(a, b, strict=True)))
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
        return 1
    assert same(got, tree) == len(torch.utils._pytree.tree_leaves(like))


@pytest.fixture
def f32_arch():
    """``qwen2.5-3b`` at float32 compute, registered in both packages for
    the test's duration."""
    for base in (ref_base, port_base):
        base.register(F32_ARCH)(lambda base=base: dataclasses.replace(
            base.get_config("qwen2.5-3b"), compute_dtype="float32"))
    yield F32_ARCH
    for base in (ref_base, port_base):
        base._REGISTRY.pop(F32_ARCH)


def test_resumes_a_checkpoint_the_reference_wrote(tmp_path, f32_arch):
    """The reference's trainer runs 2 steps and checkpoints; resumed to 3
    steps by the reference and, from a copy of that checkpoint, by the
    port: the two step-3 losses agree within 1e-4 relative."""
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(arch=f32_arch, every=1, seq=32)
    _run(ref_main, _args(ref, 2, **kw))
    os.makedirs(os.path.join(port, "ckpt"))
    shutil.copytree(os.path.join(ref, "ckpt", "step_000000002"),
                    os.path.join(port, "ckpt", "step_000000002"))
    _run(ref_main, _args(ref, 3, ["--resume"], **kw))
    out = _run(main, _args(port, 3, ["--resume", "--device", "cpu"], **kw))
    assert "resumed from step 2" in out
    (want,), (got,) = _metrics(ref)["losses"], _metrics(port)["losses"]
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
