"""The port's dry run over a fake process group (``repro_torch.launch.
dryrun``) and its perf harness, each in a subprocess so that the fake
group of 256 ranks never meets the other tests' groups.

The LM cell is whisper-tiny ``train_4k`` on the 16 x 16 production mesh:
one ZeRO-1 train step at full size on fake tensors.  Its parameter bytes
a device equal ``parallel.tensor.local_param_bytes`` and its moment bytes
the ZeRO-1 share of the rank's leaves (each over the 16 data ranks where
``parallel.sharding.opt_state_specs`` splits it; whisper-tiny's attention
leaves stay whole over "model" at 16, PR 24's excess), both exact; its
FLOPs are printed beside ``cell_cost``'s and not gated (the dry run
counts the ops it dispatches, the cost model a formula).  The three conv
cells hold the collective contract exactly on ranks 0 and a middle rank.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.archs import ARCHS                # noqa: E402
from repro_torch.configs.shapes import SHAPES              # noqa: E402
from repro_torch.launch.costmodel import MeshShape, cell_cost  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh           # noqa: E402
from repro_torch.parallel.tensor import local_param_bytes  # noqa: E402
from test_torch_tensor_parallel_steps import _zero1_share_bytes  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(args, out):
    proc = subprocess.run(
        [sys.executable, "-m", *args, "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), cwd=REPO,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return proc.stdout


def test_dry_run_lm_cell_holds_the_ranks_bytes(tmp_path):
    _run(["repro_torch.launch.dryrun", "--arch", "whisper-tiny",
          "--shape", "train_4k"], tmp_path)
    rec = json.loads((tmp_path / "whisper-tiny__train_4k__pod.json")
                     .read_text())
    cfg, cell = ARCHS["whisper-tiny"], SHAPES["train_4k"]
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.lm import LM
    with FakeTensorMode():
        whole = LM(cfg).init(torch.Generator(), device="cpu")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    dev = rec["per_device"]
    assert (rec["mesh"], rec["n_chips"], rec["kind"]) == ("16x16", 256,
                                                          "train")
    assert dev["param_bytes"] == local_param_bytes(whole, mesh, cfg)
    assert dev["moment_bytes"] == _zero1_share_bytes(cfg, (16, 16))
    coll = dev["collectives"]
    assert coll["reduce-scatter"] > 0 and coll["all-gather"] > 0
    assert coll["total"] == sum(coll[k] for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"))
    mem = dev["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] >= \
        dev["param_bytes"] + dev["moment_bytes"]
    cost = cell_cost(cfg, cell.kind, cell.global_batch, cell.seq_len,
                     MeshShape())
    assert dev["flops"] > 0 and rec["model_flops_global"] == cost[
        "model_flops"]
    print(f"\nwhisper-tiny train_4k flops a device: dry run "
          f"{dev['flops']:.4e}, cell_cost {cost['flops'] / 256:.4e}")
    assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "dominant"}


def test_dry_run_conv_cells_hold_the_contract_exactly(tmp_path):
    _run(["repro_torch.launch.dryrun", "--conv", "all"], tmp_path)
    for name, ways in (("conv_channel", 16), ("conv_spatial", 16),
                       ("conv_batch_spatial", 1)):
        rec = json.loads((tmp_path / f"{name}__pod.json").read_text())
        sc = rec["shardcheck"]
        assert sc["verdict"] == "pass" and sc["violations"] == []
        assert sc["replicated_ways"] == ways
        for d in ("fwd", "grad"):
            got, want = sc["directions"][d]["observed"], \
                sc["directions"][d]["expected"]
            assert got == {k: int(v) for k, v in want.items()}, (name, d)
        assert len(sc["ranks"]) == 2 and rec["per_device"]["flops"] > 0


def test_perf_attaches_the_analytic_terms(tmp_path):
    _run(["repro_torch.launch.perf", "--arch", "xlstm-125m", "--shape",
          "decode_32k", "--set", "kv_cache_int8=True", "--tag", "int8"],
         tmp_path)
    rec = json.loads((tmp_path / "xlstm-125m__decode_32k__pod__int8.json")
                     .read_text())
    assert rec["overrides"] == {"kv_cache_int8": "True"}
    assert set(rec["analytic"]) == {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "roofline_frac"}
    assert rec["per_device"]["param_bytes"] > 0
