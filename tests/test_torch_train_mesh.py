"""The mesh trainer (``launch/train.py`` on ``runtime/sharded.py``)
against the one-device trainer and the reference's sharded trainer, on
gloo ranks on the CPU.

One spawn of 4 ranks (a 2x2 ``data x model`` mesh) holds:

* qwen2.5-3b at ``reduced()`` and float32 compute, 3 AdamW steps (lr
  3e-5, warmup 1, 4 x 32 from the token pipeline): every rank's losses and
  grad norms equal, within ``train_mesh_check``'s gates of the one-device
  trainer's (relative 1e-5 and 1e-4: only summation orders differ), every
  leaf's gradient block after step 1 on every rank within 1e-4 (2-norm,
  relative) of the one-device gradient's, the parameters after step 3
  within 0.1 lr, every block of the shape its spec gives it and owning
  its storage (no whole leaf kept), and ``constrain_batch`` recording the
  reference's ``data`` axis at its call sites;
* zamba2-1.2b the same way: its ``conv_w`` leaves are split over
  ``model`` and replicated over ``data`` (qwen's leaves are split on both
  axes or on none), so its gradients take ``sync_grads``' all-reduce over
  one axis and its norm ``global_norm``'s skip of a partly replicated
  block; its losses and grad norms are also held to the reference's
  trainer sharded by ``param_pspecs`` on a 2x2 mesh of 4 XLA host devices
  (``tests/torch_reference.py --train-mesh``), from the same weights;
* the CLI's rank body (``run_on_mesh``) with ``--ckpt-dir``: 4 steps with
  a checkpoint every 2, then only ``step_000000002`` resumed to 4: losses
  3-4 and the last checkpoint's arrays bit for bit.  The checkpoint has the
  one-device trainer's layout (its arrays' names, shapes and dtypes), and
  the one-device trainer resumes from it.  A run whose third step reports
  a non-finite loss rolls back to step 2 on every rank (rank 0's verdict,
  agreed) and ends with the uninterrupted run's losses and arrays.

With no process group, a 1x1 mesh is the one-device trainer bit for bit
(``run_steps`` and the CLI's ``_train``), and ``constrain_batch`` returns
its input with no mesh.
"""
import dataclasses
import json
import shutil
import tempfile

import os

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh, spawn_mesh
from repro_torch.testing import train_mesh_check as tm

HERE = os.path.dirname(os.path.abspath(__file__))
ARCH = "qwen2.5-3b"
#: the arch with leaves split on one axis and replicated on the other
MIXED = "zamba2-1.2b"
STEPS, B, S, LR = tm.STEPS, tm.BATCH, tm.SEQ, tm.LR
CLI_STEPS, CLI_AT = 4, 2


def _cfg():
    return dataclasses.replace(get_config(ARCH).reduced(),
                               compute_dtype="float32")


def _cli(d: str, name: str, *extra) -> list:
    return ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
            str(CLI_STEPS), "--batch", str(B), "--seq", str(S),
            "--ckpt-dir", f"{d}/{name}/ckpt", "--ckpt-every", str(CLI_AT),
            "--log-every", str(CLI_STEPS), "--metrics-out",
            f"{d}/{name}.json", *extra]


def _train(mesh, arch: str, ref: dict) -> dict:
    """``arch``'s steps on ``mesh``, held to the one-device run's ``ref``
    (``train_mesh_check.one_device``)."""
    from repro_torch.models.common import record_constraints

    seen = {}

    def after(i, model, opt):
        if i == 0:
            seen["grad"] = tm.grad_diff(model, opt, ref["m1"])
    with record_constraints() as log:
        model, _, row = tm.run_steps(tm._f32(arch), "cpu", steps=STEPS,
                                     batch=B, seq=S, lr=LR, mesh=mesh,
                                     after=after)
    ok, shapes = tm.block_shapes(model)
    st = model.sharding
    row.update(shapes_ok=ok, shapes=shapes,
               want={k: st.placements[k].shard_shape(st.shapes[k])
                     for k in shapes},
               mixed=sorted(k for k, pl in st.placements.items()
                            if pl.splits and pl.replicated),
               storage=sum(p.untyped_storage().nbytes()
                           for p in st.params.values()),
               blocks=sum(p.numel() * p.element_size()
                          for p in st.params.values()),
               grad=seen["grad"], param_diff=tm.param_diff(model,
                                                           ref["params"]),
               axes=sorted({axes for _, axes in log}), sites=len(log))
    return row


def _rank(mesh, job: dict) -> dict:
    row = _train(mesh, ARCH, job["ref"])
    row["mixed_arch"] = _train(mesh, MIXED, job["ref_mixed"])
    d = job["dir"]
    train.run_on_mesh(mesh, _cli(d, "whole"))
    if mesh.rank == 0:
        step = f"step_{CLI_AT:09d}"
        shutil.copytree(f"{d}/whole/ckpt/{step}", f"{d}/part/ckpt/{step}")
    mesh.barrier()
    train.run_on_mesh(mesh, _cli(d, "part", "--resume"))
    make = train.make_train_step

    def faulty(*a, **kw):
        """The step function, reporting a NaN loss at its third call."""
        step, calls = make(*a, **kw), []

        def run(model, opt, batch):
            model, opt, loss, metrics = step(model, opt, batch)
            calls.append(1)
            return model, opt, loss * (float("nan") if len(calls) == 3
                                       else 1.0), metrics
        return run
    train.make_train_step = faulty
    try:
        train.run_on_mesh(mesh, _cli(d, "nan"))
    finally:
        train.make_train_step = make
    return row


@pytest.fixture(scope="module")
def one():
    row, ref = tm.one_device(ARCH, "cpu")
    return {**row, "ref": ref}


@pytest.fixture(scope="module")
def one_mixed():
    row, ref = tm.one_device(MIXED, "cpu")
    return {**row, "ref": ref}


@pytest.fixture(scope="module")
def mesh_run(one, one_mixed):
    d = tempfile.mkdtemp(prefix="train_mesh_")
    ranks = spawn_mesh(_rank, 4, "cpu", args=({
        "ref": one["ref"], "ref_mixed": one_mixed["ref"], "dir": d},),
        timeout=300)
    yield ranks, d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def reference_mixed(tmp_path_factory):
    """The reference's sharded trainer on 2x2 XLA host devices, from the
    port's weights for seed 0 and the token pipeline's batches."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models.model import init_params, to_reference

    cfg = tm._f32(MIXED)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    arrays = {}

    def put(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(v, f"{prefix}{k}/")
            else:
                arrays[f"{prefix}{k}"] = v
    put(to_reference(dict(model.named_parameters())), "params/")
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=B, seq_len=S, seed=0)
    for i in range(STEPS):
        arrays[f"tokens/{i}"] = pipe.batch_at(i)
    d = tmp_path_factory.mktemp("train_mesh_ref")
    np.savez(d / "in.npz", **arrays)
    r = run_subprocess([os.path.join(HERE, "torch_reference.py"),
                        str(d / "out.npz"), "--train-mesh",
                        str(d / "in.npz"), MIXED], device_count=4)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(d / "out.npz") as f:
        return {k: f[k].tolist() for k in f.files}


def test_ranks_agree_and_form_a_2x2_mesh(mesh_run):
    ranks, _ = mesh_run
    assert all(r["losses"] == ranks[0]["losses"]
               and r["grad_norms"] == ranks[0]["grad_norms"] for r in ranks)


def test_losses_and_norms_hold_the_one_device_trainers(mesh_run, one):
    got = mesh_run[0][0]
    for key, bound in (("losses", tm.LOSS_REL), ("grad_norms", tm.NORM_REL)):
        for a, b in zip(got[key], one[key]):
            assert abs(a - b) <= bound * abs(b), (key, got[key], one[key])


def test_parameters_after_the_steps_within_the_lr_bound(mesh_run):
    diff = mesh_run[0][0]["param_diff"]
    assert diff <= tm.PARAM_LR * LR


@pytest.mark.parametrize("rank", range(4))
def test_each_leafs_gradient_holds_the_one_device_gradient(mesh_run, rank):
    for row in (mesh_run[0][rank], mesh_run[0][rank]["mixed_arch"]):
        worst, leaf = row["grad"]
        assert worst <= tm.GRAD_REL, (leaf, worst)


def test_mixed_arch_has_leaves_split_on_one_axis_only(mesh_run):
    row = mesh_run[0][0]["mixed_arch"]
    assert any(k.endswith("conv_w") for k in row["mixed"]), row["mixed"]
    assert mesh_run[0][0]["mixed"] == []


def test_mixed_arch_holds_the_one_device_trainer(mesh_run, one_mixed):
    ranks, _ = mesh_run
    got = ranks[0]["mixed_arch"]
    assert all(r["mixed_arch"]["losses"] == got["losses"] for r in ranks)
    assert all(r["mixed_arch"]["shapes_ok"] for r in ranks)
    for key, bound in (("losses", tm.LOSS_REL), ("grad_norms", tm.NORM_REL)):
        for a, b in zip(got[key], one_mixed[key]):
            assert abs(a - b) <= bound * abs(b), (key, got[key],
                                                  one_mixed[key])
    assert got["param_diff"] <= tm.PARAM_LR * LR


def test_mixed_arch_holds_the_reference_sharded_trainer(mesh_run,
                                                        reference_mixed):
    got = mesh_run[0][0]["mixed_arch"]
    for key, bound in (("losses", tm.LOSS_REL), ("grad_norms", tm.NORM_REL)):
        want = reference_mixed[key]
        assert len(want) == len(got[key]) == STEPS
        for a, b in zip(got[key], want):
            assert abs(a - b) <= bound * abs(b), (key, got[key], want)


def test_each_rank_holds_its_specs_shards(mesh_run):
    ranks, _ = mesh_run
    for r in ranks:
        assert r["shapes_ok"] and r["shapes"] == r["want"]
    # a 2-D weight is split four ways, the 4096-less norms stay whole
    shapes = ranks[0]["shapes"]
    d = _cfg().d_model
    assert shapes["blocks.0.attn.wq"][0] == d // 2
    assert shapes["blocks.0.ln1"] == (d,)
    assert shapes["embed"][1] == d // 2


def test_each_rank_keeps_no_whole_leaf(mesh_run):
    # every block owns its storage: no view into a whole leaf is kept
    for r in mesh_run[0]:
        for row in (r, r["mixed_arch"]):
            assert row["storage"] == row["blocks"]


def test_constrain_batch_pins_the_data_axis_under_the_mesh(mesh_run):
    for r in mesh_run[0]:
        assert r["axes"] == [("data",)] and r["sites"] > 0


def test_resumed_cli_run_is_the_uninterrupted_one_bit_for_bit(mesh_run):
    _, d = mesh_run
    with open(f"{d}/whole.json") as f:
        whole = json.load(f)
    with open(f"{d}/part.json") as f:
        part = json.load(f)
    assert whole["mesh"] == {"data": 2, "model": 2}
    assert part["losses"] == whole["losses"][CLI_AT:]
    last = f"step_{CLI_STEPS:09d}"
    a = np.load(f"{d}/whole/ckpt/{last}/arrays.npz")
    b = np.load(f"{d}/part/ckpt/{last}/arrays.npz")
    assert a.files == b.files
    assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


def test_non_finite_loss_rolls_back_on_every_rank(mesh_run):
    _, d = mesh_run
    with open(f"{d}/whole.json") as f:
        whole = json.load(f)
    with open(f"{d}/nan.json") as f:
        nan = json.load(f)
    assert nan["losses"] == whole["losses"]
    last = f"step_{CLI_STEPS:09d}"
    a = np.load(f"{d}/whole/ckpt/{last}/arrays.npz")
    b = np.load(f"{d}/nan/ckpt/{last}/arrays.npz")
    assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


def test_mesh_checkpoint_is_the_one_device_layout(mesh_run, tmp_path,
                                                  capsys):
    _, d = mesh_run
    with train.deterministic():
        assert train.main(_cli(str(tmp_path), "one")) == 0
    last = f"step_{CLI_STEPS:09d}"
    a = np.load(f"{d}/whole/ckpt/{last}/arrays.npz")
    b = np.load(f"{tmp_path}/one/ckpt/{last}/arrays.npz")
    assert a.files == b.files
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
               for k in a.files)
    # the one-device trainer resumes from the mesh's checkpoint
    step = f"step_{CLI_AT:09d}"
    shutil.copytree(f"{d}/whole/ckpt/{step}",
                    f"{tmp_path}/resumed/ckpt/{step}")
    capsys.readouterr()
    assert train.main(_cli(str(tmp_path), "resumed", "--resume")) == 0
    assert f"resumed from step {CLI_AT}" in capsys.readouterr().out
    with open(f"{tmp_path}/resumed.json") as f:
        losses = json.load(f)["losses"]
    assert len(losses) == CLI_STEPS - CLI_AT and np.isfinite(losses).all()


def test_one_by_one_mesh_is_the_one_device_trainer_bit_for_bit():
    cfg = _cfg()
    m1, _, a = tm.run_steps(cfg, "cpu", steps=STEPS, batch=B, seq=S, lr=LR)
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.is_process
    m2, _, b = tm.run_steps(cfg, "cpu", steps=STEPS, batch=B, seq=S, lr=LR,
                            mesh=mesh)
    assert a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
    assert tm.checksums(m1) == tm.checksums(m2)


def test_one_by_one_mesh_cli_is_the_one_device_cli(tmp_path):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", str(B), "--seq", str(S)]
    with train.deterministic():
        assert train.main(argv + ["--metrics-out",
                                  f"{tmp_path}/a.json"]) == 0
        args = train._parser().parse_args(
            argv + ["--metrics-out", f"{tmp_path}/b.json"])
        train._train(args, torch.device("cpu"), make_host_mesh(device="cpu"))
    a, b = (json.load(open(f"{tmp_path}/{n}.json")) for n in "ab")
    assert a["losses"] == b["losses"]


def test_constrain_batch_without_a_mesh_is_the_identity():
    from repro_torch.models.common import ambient_mesh, constrain_batch

    x = torch.randn(3, 5)
    assert ambient_mesh() is None
    assert constrain_batch(x) is x and constrain_batch(x, 1, True) is x


def test_mesh_flags_need_a_process_mesh(capsys):
    with pytest.raises(SystemExit):
        train.main(["--arch", ARCH, "--device", "cpu", "--ranks", "4"])
    with pytest.raises(SystemExit):
        train.main(["--arch", ARCH, "--device", "cpu", "--mesh", "process"])
    with pytest.raises(ValueError, match="card"):
        train.main(["--arch", ARCH, "--device", "cpu", "--mesh", "process",
                    "--ranks", "2", "--dist-backend", "nccl"])
