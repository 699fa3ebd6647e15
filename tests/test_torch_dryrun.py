"""The dry-run (``launch/dryrun.py``) against the reference's rules, and
its fake trace against the real step, on the CPU.

* ``skip_reason`` equals the reference's for all 40 arch × shape pairs;
* ``wire_bytes`` of a census record equals the reference's
  ``parse_collectives`` on an HLO line written for the same kind, result
  shape and group (``tests/test_launch.py``'s three lines among them);
* ``python -m repro_torch.launch.dryrun --arch xlstm-350m --shape
  decode_32k`` (the reference's slow test's cell) gives status ``ok``,
  ``fits_hbm``, 256 chips and ``model_flops_global = 2·N_active·128``,
  and its ``argument_bytes`` equals a count made from ``launch/specs.py``
  and the rules' ``shard_shape``;
* at ``reduced()`` on a 1×1 mesh the fake trace's flop count (and its
  argument, peak, output, alias and op bytes) equals the count of the same
  step run for real on the CPU: the fake path is the path that runs;
* the census of a fake 2x2 group (its own process) records every
  weight's all-gather over ``model`` and the decode's combine.

The reference's answers come from ``tests/torch_reference.py --dryrun``:
importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from conftest import run_subprocess
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.core.collectives import Collective
from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
#: (kind, HLO result dtype, result shape, group size)
WIRE_CASES = [
    ("all-gather", "f32", (64, 512), 16),      # tests/test_launch.py's
    ("all-reduce", "bf16", (1024,), 2),        # tests/test_launch.py's
    ("collective-permute", "f32", (128,), 2),  # tests/test_launch.py's
    ("all-gather", "bf16", (4096, 2048), 16),
    ("all-gather", "f32", (512, 3), 256),
    ("reduce-scatter", "f32", (128, 64), 16),
    ("reduce-scatter", "bf16", (32,), 2),
    ("all-reduce", "f32", (), 256),
    ("all-reduce", "f32", (11, 13), 32),
    ("all-to-all", "f32", (16, 8), 4),
]


def _hlo(kind, dt, shape, g) -> str:
    dims = ",".join(map(str, shape))
    groups = ",".join(map(str, range(g)))
    extra = "source_target_pairs={{0,1}}" if kind == "collective-permute" \
        else f"replica_groups={{{{{groups}}}}}"
    return (f"  %x = {dt}[{dims}]{{0}} {kind}({dt}[{dims}]{{0}} %p), "
            f"{extra}\n")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ref")
    lines = d / "lines.json"
    lines.write_text(json.dumps([_hlo(*c) for c in WIRE_CASES]))
    out = d / "ref.json"
    r = run_subprocess([os.path.join(HERE, "torch_reference.py"), str(out),
                        "--dryrun", str(lines)], timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return json.loads(out.read_text())


def test_archs_and_shapes_are_the_reference(reference):
    assert dryrun.ARCHS == reference["archs"]
    assert list(SHAPES) == reference["shapes"]


@pytest.mark.parametrize("arch", dryrun.ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_skip_reason_matches_reference(reference, arch, shape):
    assert dryrun.skip_reason(arch, shape) == \
        reference["skip"][f"{arch}/{shape}"]


@pytest.mark.parametrize("i", range(len(WIRE_CASES)))
def test_wire_bytes_match_parse_collectives(reference, i):
    kind, dt, shape, g = WIRE_CASES[i]
    want = reference["parsed"][i]
    assert want["counts"][kind] == 1
    # the census record this rank would hand the call
    n = math.prod(shape)
    operand = {"all-gather": n // g, "reduce-scatter": n * g}.get(kind, n)
    rec = Collective(kind, ("model",), (operand,), _DT[dt], group=g)
    got = dryrun.wire_bytes(kind, dryrun.result_bytes(rec), g)
    assert abs(got - want["bytes"][kind]) < 1e-6 * max(1.0, got)
    stats = dryrun.collective_stats([rec], _Mesh())
    assert stats["counts"][kind] == 1
    assert abs(stats["total_bytes"] - want["total_bytes"]) \
        < 1e-6 * max(1.0, got)


class _Mesh:
    """A 16x16 mesh description: every group of it crosses nodes."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def test_links_follow_the_node():
    from repro_torch.runtime.sharding import MeshShape

    prod = MeshShape(("data", "model"), (16, 16))
    host = MeshShape(("data", "model"), (2, 2))
    assert dryrun.link_bw(prod, ("model",)) == dryrun.IB_BW
    assert dryrun.link_bw(prod, ("data",)) == dryrun.IB_BW
    assert dryrun.link_bw(host, ("data", "model")) == dryrun.NVLINK_BW
    assert dryrun.link_bw(MeshShape(("model",), (8,)),
                          ("model",)) == dryrun.NVLINK_BW


@pytest.fixture(scope="module")
def cell():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "xlstm-350m", "--shape", "decode_32k"],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return json.loads(r.stdout[r.stdout.index("{"):])


def test_single_cell_runs_on_256_fake_ranks(cell):
    cfg = get_config("xlstm-350m")
    assert cell["status"] == "ok"
    assert cell["n_chips"] == 256
    assert cell["per_device"]["fits_hbm"]
    assert cell["roofline"]["model_flops_global"] == \
        2.0 * cfg.n_active_params() * 128
    assert cell["per_device"]["hlo_flops"] > 0
    assert cell["per_device"]["collective_counts"]["all-gather"] > 0
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")


def test_argument_bytes_count_from_specs(cell):
    from repro_torch.launch.specs import cache_specs, input_specs, param_specs
    from repro_torch.runtime.sharding import (MeshShape, NamedSharding,
                                              batch_pspecs, cache_pspecs,
                                              param_pspecs)

    cfg = get_config("xlstm-350m")
    shape = SHAPES["decode_32k"]
    mesh = MeshShape(("data", "model"), (16, 16))

    def leaves(tree):
        for k, v in tree.items():
            yield from leaves(v) if isinstance(v, dict) else ((k, v),)

    def block_bytes(specs, tree, itemsize=None):
        return sum(math.prod(NamedSharding(mesh, s).shard_shape(t.shape))
                   * (itemsize or t.element_size())
                   for (_, s), (_, t) in zip(leaves(specs), leaves(tree)))

    params = param_specs(cfg)
    total = block_bytes(param_pspecs(cfg, mesh, params, serving=True),
                        params, itemsize=2)           # bf16 serving weights
    cache = cache_specs(cfg, shape)
    total += block_bytes(cache_pspecs(cfg, shape, mesh, cache), cache)
    inputs = input_specs(cfg, shape)
    total += block_bytes(batch_pspecs(cfg, shape, mesh), inputs)
    assert cell["per_device"]["argument_bytes"] == total


KINDS = {"train": (2, 16), "prefill": (2, 16), "decode": (2, 16)}
#: one arch per family and kind (xlstm's sLSTM token loop is trained
#: only at the sweep's size: its backward is the costliest to trace)
CELLS = [(a, k) for a in ("qwen2.5-3b", "whisper-large-v3") for k in KINDS] \
    + [("xlstm-350m", "prefill"), ("xlstm-350m", "decode"),
       ("zamba2-1.2b", "train")]


@pytest.mark.parametrize("arch,name", CELLS)
def test_fake_trace_counts_the_real_step(arch, name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_host_mesh

    b, s = KINDS[name]
    cfg = get_config(arch).reduced()
    mesh = make_host_mesh(device="cpu")
    shape = ShapeConfig(name, s, b, name)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = dryrun.measure(dryrun.build_cell(
            arch, cfg=cfg, mesh=mesh, shape=shape, device="cpu"))
    real = dryrun.measure(dryrun.build_cell(
        arch, cfg=cfg, mesh=mesh, shape=shape, device="cpu",
        generator=torch.Generator().manual_seed(0)))
    for key in ("hlo_flops", "argument_bytes", "peak_bytes", "output_bytes",
                "alias_bytes", "hlo_bytes"):
        assert fake[key] == real[key], key
    assert real["hlo_flops"] > 0 and real["temp_bytes"] > 0


_CENSUS = r'''
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch import dryrun
r = dryrun.predict("qwen2.5-3b", "decode", 4, 64, (2, 2), ("data", "model"))
print(json.dumps(r))
'''


def test_fake_two_by_two_census():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _CENSUS], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    cfg = get_config("qwen2.5-3b")
    counts = got["per_device"]["collective_counts"]
    # every split weight gathered once, plus one combine per layer
    assert counts["all-gather"] >= cfg.n_layers
    assert counts["reduce-scatter"] == counts["all-reduce"] == 0
    assert got["n_chips"] == 4
    assert got["roofline"]["t_collective_s"] > 0
