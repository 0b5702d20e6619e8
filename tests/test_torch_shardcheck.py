"""The port's collective-contract checker (``repro_torch.analysis.
shardcheck``), its counter (``launch.hlo_analysis.collective_bytes``) and
the precision-flow pass (``analysis.numcheck.precision_flow_findings``),
against the JAX package in process.

The pure functions (``trim_reshard``, ``replica_combine_bytes``,
``expected_collectives``, ``verify_collectives``) equal the JAX package's
on all 65 dist-baseline cells and on its own unit sweeps
(``tests/test_shardcheck.py``).  The port's contract (``rank_contract``)
takes the cotangent sums from them and prices what its execution adds
(the structural all-gathers) or drops (GSPMD's trim permute).
``check_sharding`` runs on 4 gloo ranks on the CPU (rank bodies in
``tests/test_torch_dist_workers.py``, one spawn for the module): its
verdict passes, the busiest rank equals the contract per kind, and every
rank's counts equal the tests' own ``WireCounter``, which wraps
``torch.distributed`` and shares nothing with the program's counter.  A
deleted halo exchange and a dropped cotangent sum each fail, naming the
kind.
"""
import json
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")

import repro.analysis.shardcheck as jsc                    # noqa: E402
import repro.launch.hlo_analysis as jhlo                   # noqa: E402
from repro.core.convspec import ConvSpec as JSpec          # noqa: E402

import test_torch_dist_workers as W                        # noqa: E402
from repro_torch.analysis import numcheck                  # noqa: E402
from repro_torch.analysis import shardcheck as tsc         # noqa: E402
from repro_torch.core.convspec import ConvSpec             # noqa: E402
from repro_torch.launch.costmodel import conv_partition_costs  # noqa: E402
from repro_torch.launch.mesh import spawn                  # noqa: E402
from repro_torch.parallel.conv import normalize_partition  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DIST = json.loads((REPO / "benchmarks/baselines/dist.json").read_text())
COMMITTED = json.loads((REPO / "BENCH_shardcheck.json").read_text())
KINDS = tsc.COLLECTIVE_KINDS
# the JAX package's unit-sweep geometry: o_h 14 splits evenly 2 ways, a
# 2-row halo, a trim shift of 1 row
SPEC = (2, 16, 16, 3, 3, 3, 4, 1, 1)


def _dist_cells():
    out = []
    for r in DIST["results"]:
        if "partition" not in r:
            continue
        spec = tuple(r["run_spec"][f] for f in ("i_n", "i_h", "i_w", "i_c",
                                                "k_h", "k_w", "k_c", "s_h",
                                                "s_w"))
        out.append((r["scenario"], r["algorithm"], spec,
                    normalize_partition(r["partition"]),
                    tuple(r.get("n_dev_axes") or [r["n_dev"]])))
    return out


CELLS = _dist_cells()
SWEEP = [(SPEC, ("batch",), (2,)), (SPEC, ("channel",), (2,)),
         (SPEC, ("spatial",), (2,)), (SPEC, ("batch", "spatial"), (2, 2)),
         (SPEC, ("batch", "channel"), (2, 2)),
         ((1, 18, 18, 3, 4, 4, 4, 1, 1), ("spatial",), (2,)),
         ((1, 16, 16, 3, 5, 5, 4, 1, 1), ("spatial",), (4,)),
         ((1, 12, 12, 3, 3, 3, 8, 3, 3), ("spatial",), (2,))]


def _nan_equal(a, b):
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


# ------------------------------------------------------ the pure functions

def test_the_sweeps():
    assert len(CELLS) == 65 and len(COMMITTED["results"]) == 65


@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_pure_functions_equal_the_jax_package(dtype_bytes):
    for cell in [(None, None) + c for c in SWEEP] + CELLS:
        spec, parts, sizes = cell[2], cell[3], cell[4]
        mine, ref = ConvSpec(*spec), JSpec(*spec)
        got = tsc.trim_reshard(mine, parts, sizes, dtype_bytes)
        want = jsc.trim_reshard(ref, parts, sizes, dtype_bytes)
        assert got[0] == want[0] and _nan_equal(got[1], want[1]), cell
        assert tsc.replica_combine_bytes(mine, parts, sizes, dtype_bytes) \
            == jsc.replica_combine_bytes(ref, parts, sizes, dtype_bytes)
        for direction in tsc.DIRECTIONS:
            for ways in (1, 16):
                assert tsc.expected_collectives(
                    mine, parts, sizes, dtype_bytes, direction,
                    replicated_ways=ways) == jsc.expected_collectives(
                        ref, parts, sizes, dtype_bytes, direction,
                        replicated_ways=ways), (cell, direction, ways)


def test_rank_contract_takes_the_sums_and_prices_its_own_wire():
    """The kinds both price are the JAX package's: the cotangent sums
    (required and, on a larger mesh, the optional combine).  The permute
    is the busiest rank's halo slabs (no trim); the all-gather is the
    port's own, checked on the ranks below."""
    for _, _, spec, parts, sizes in [(None, None) + c for c in SWEEP] + CELLS:
        mine = ConvSpec(*spec)
        halo = conv_partition_costs(
            mine, sizes if len(parts) > 1 else sizes[0])[
                parts if len(parts) > 1 else parts[0]][
                    "halo_bytes_per_device"]
        n_s = dict(zip(parts, sizes)).get("spatial", 1)
        for direction in tsc.DIRECTIONS:
            req, opt = tsc.rank_contract(mine, parts, sizes, 4, direction,
                                         replicated_ways=16)
            j_req, j_opt, _ = jsc.expected_collectives(
                JSpec(*spec), parts, sizes, 4, direction, replicated_ways=16)
            assert req["all-reduce"] == j_req["all-reduce"]
            assert opt["all-reduce"] == j_opt["all-reduce"]
            assert req["collective-permute"] == \
                halo * tsc.halo_sends(n_s, direction)
            assert opt["collective-permute"] == 0.0
            assert req["all-gather"] == tsc.structural_gathers(
                mine, parts, sizes, 4, direction)
            for kind in ("reduce-scatter", "all-to-all"):
                assert req[kind] == opt[kind] == 0.0
    # the busiest rank against each rank's own sends
    assert [tsc.halo_sends(4, "grad", i) for i in range(4)] == [1, 2, 2, 1]
    assert [tsc.halo_sends(2, "grad", i) for i in range(2)] == [1, 1]
    assert [tsc.halo_sends(3, "fwd", i) for i in range(3)] == [0, 1, 1]
    assert tsc.halo_sends(4, "grad") == 2 and tsc.halo_sends(2, "grad") == 1
    assert tsc.halo_sends(1, "grad") == 0


def _zero():
    return {k: 0.0 for k in KINDS}


def _verify_cases():
    """The JAX package's ``verify_collectives`` cases (its unit tests)."""
    req = dict(_zero(), **{"collective-permute": 100.0})
    opt = dict(_zero(), **{"collective-permute": 40.0})
    ok = dict.fromkeys(KINDS, 0)
    req2 = dict(_zero(), **{"collective-permute": 100.0,
                            "all-reduce": 200.0})
    req3 = dict(_zero(), **{"all-reduce": 200.0})
    allow = tsc.SCALAR_REDUCE_ALLOWANCE_BYTES
    return [
        (dict(ok, **{"collective-permute": 100}), req, "fwd", 4, opt),
        (dict(ok, **{"collective-permute": 140}), req, "fwd", 4, opt),
        (dict(ok, **{"collective-permute": 120}), req, "fwd", 4, opt),
        ({"collective-permute": 0, "all-reduce": 0, "all-gather": 64},
         req2, "grad", 4, None),
        ({"all-reduce": 200 + allow}, req3, "grad", 4, None),
        ({"all-reduce": 200 + allow}, req3, "fwd", 4, None),
        ({"all-reduce": 200 + allow + 1}, req3, "grad", 4, None),
        ({"collective-permute": 200}, req, "fwd", 2, None),
        ({"collective-permute": 200}, req, "fwd", 4, None),
        ({"collective-permute": 150}, req, "fwd", 2, None),
    ]


def test_verify_collectives_gives_the_jax_packages_verdicts():
    assert tsc.SCALAR_REDUCE_ALLOWANCE_BYTES == \
        jsc.SCALAR_REDUCE_ALLOWANCE_BYTES
    for observed, expected, direction, width, optional in _verify_cases():
        got = tsc.verify_collectives(observed, expected, direction,
                                     dtype_bytes=width, optional=optional)
        want = jsc.verify_collectives(observed, expected, direction,
                                      dtype_bytes=width, optional=optional)
        assert [(v.rule, v.direction) for v in got] == \
            [(v.rule, v.direction) for v in want], observed
        for v, w in zip(got, want):       # the same kind named first
            assert v.message.split()[0] == w.message.split()[0]


def test_bad_arguments_raise_like_the_jax_package():
    spec = ConvSpec(*SPEC)
    with pytest.raises(ValueError, match="unknown direction"):
        tsc.expected_collectives(spec, "spatial", 2, 4, "backward")
    with pytest.raises(ValueError, match="component"):
        tsc.expected_collectives(spec, ("batch", "spatial"), 2, 4, "fwd")
    with pytest.raises(ValueError, match="n_dev"):
        tsc.check_sharding(spec, "spatial", device="cpu")


# ------------------------------------------------------------------- skips

def test_skip_reasons_equal_the_committed_report():
    """Without ranks every cell is derived and skipped: the 28 the JAX
    package skipped for their geometry with its very reasons, the 37 it
    passed because the world (1) is smaller than the cell."""
    same = small = 0
    for (scenario, variant, spec, parts, sizes), rec in zip(
            CELLS, COMMITTED["results"]):
        assert (scenario, variant) == (rec["scenario"], rec["algorithm"])
        chk = tsc.check_sharding(ConvSpec(*spec), parts, sizes,
                                 device="cpu")
        assert chk.record["verdict"] == "skipped" and chk.ok
        if rec["verdict"] == "skipped":
            assert chk.skipped == rec["skipped_reason"]
            same += 1
        else:
            assert rec["verdict"] == "pass"
            assert chk.skipped.startswith(f"needs {math.prod(sizes)} ranks")
            small += 1
    assert (same, small) == (28, 37)
    one = tsc.check_sharding(ConvSpec(*SPEC), "spatial", 1, device="cpu")
    assert one.skipped.startswith("1-way")


# ------------------------------------------------------------- on 4 ranks

RANK_CASES = [
    {"spec": (2, 16, 12, 3, 3, 3, 4, 1, 1), "partition": "spatial",
     "n_dev": 4, "algorithm": "mec"},
    {"spec": (2, 12, 12, 3, 3, 3, 8, 1, 1), "partition": "channel",
     "n_dev": 4, "algorithm": "mec_fused"},
    {"spec": (4, 16, 12, 3, 3, 3, 4, 1, 1),
     "partition": ("batch", "spatial"), "n_dev": (2, 2),
     "algorithm": "mec_fused2"},
    {"spec": (2, 16, 12, 3, 3, 3, 4, 1, 1), "partition": "spatial",
     "n_dev": 2, "algorithm": "mec_lowered", "dtype": "bfloat16",
     "precision": "HIGHEST"},
    {"spec": (2, 16, 12, 3, 3, 3, 4, 1, 1), "partition": "spatial",
     "n_dev": 4, "algorithm": "mec", "mutation": "drop_halo"},
    {"spec": (2, 16, 12, 3, 3, 3, 4, 1, 1), "partition": "spatial",
     "n_dev": 4, "algorithm": "mec", "mutation": "drop_cotangent_sum"},
]


@pytest.fixture(scope="module")
def ranks():
    return spawn(W.shardcheck_cases, 4, args=(RANK_CASES,), timeout_s=60,
                 join_timeout_s=240), \
        spawn(W.counter_ops, 4, timeout_s=60, join_timeout_s=120)


def test_check_sharding_on_4_ranks_is_exact_at_the_busiest_rank(ranks):
    results, _ = ranks
    for i, case in enumerate(RANK_CASES[:4]):
        recs = [r[i] for r in results]
        rec = recs[0]["record"]
        assert rec["verdict"] == "pass", rec["violations"]
        assert all(r["record"] == rec for r in recs)
        spec, parts = ConvSpec(*case["spec"]), \
            normalize_partition(case["partition"])
        sizes = case["n_dev"] if isinstance(case["n_dev"], tuple) \
            else (case["n_dev"],)
        width = 2 if case.get("dtype") == "bfloat16" else 4
        for direction in tsc.DIRECTIONS:
            want, _ = tsc.rank_contract(spec, parts, sizes, width, direction)
            assert rec["directions"][direction]["observed"] == \
                {k: int(want[k]) for k in KINDS}, (i, direction)
        flow = rec["precision_flow"]
        assert flow["declared"] == case.get("precision")
        assert flow["unannotated_dot_ops"] == 0
        # traced only under a declared precision (K2 + K3's contractions)
        assert (flow["dot_ops"] is None) == ("precision" not in case)
        assert flow["dot_ops"] is None or flow["dot_ops"] > 0
        ran = [r for r in recs if r["ran"]]
        assert len(ran) == math.prod(sizes) == len(rec["ranks"])
        # every rank's counts equal the tests' own wire counter's
        for r, counts in zip(ran, rec["ranks"]):
            grad = counts["grad"]
            assert (r["wire"]["p2p"], r["wire"]["reduce"],
                    r["wire"]["gather"]) == (grad["collective-permute"],
                                             grad["all-reduce"],
                                             grad["all-gather"]), i


@pytest.mark.parametrize("i,kind", [(4, "collective-permute"),
                                    (5, "all-reduce")])
def test_a_deleted_exchange_fails_naming_its_kind(ranks, i, kind):
    results, _ = ranks
    rec = results[0][i]["record"]
    assert rec["verdict"] == "fail"
    missing = [v for v in rec["violations"]
               if v.startswith("[missing-collective]")]
    assert missing and all(kind in v for v in missing), rec["violations"]


def test_the_counter_follows_the_jax_packages_operand_convention(ranks):
    """Each kind's bytes on a (2, 8) f32 tensor over 4 ranks equal the
    JAX package's ``collective_bytes`` on the HLO line of the same shape
    and group."""
    _, counts = ranks
    groups = "replica_groups=[1,4]<=[4]"
    hlo = {
        "all-reduce": f"%a = f32[2,8]{{1,0}} all-reduce(f32[2,8]{{1,0}} %p),"
                      f" {groups}, to_apply=%add",
        "all-gather": f"%a = f32[8,8]{{1,0}} all-gather(f32[2,8]{{1,0}} %p),"
                      f" {groups}, dimensions={{0}}",
        "reduce-scatter": f"%a = f32[2,2]{{1,0}} reduce-scatter(f32[2,8]"
                          f"{{1,0}} %p), {groups}, dimensions={{1}}",
        "all-to-all": f"%a = f32[2,8]{{1,0}} all-to-all(f32[2,8]{{1,0}} %p),"
                      f" {groups}, dimensions={{1}}",
        "collective-permute": "%a = f32[2,8]{1,0} collective-permute("
                              "f32[2,8]{1,0} %p), source_target_pairs="
                              "{{0,1},{1,2},{2,3},{3,0}}",
    }
    for rank in counts:
        for kind, line in hlo.items():
            want = jhlo.collective_bytes(line)
            got = rank[kind]
            assert got[kind] == want[kind] == 64, kind
            assert got["count"] == want["count"] == 1
            assert got["total"] == want["total"]


def test_the_planner_hook_skips_without_ranks_and_passes_on_2():
    spec = ConvSpec(2, 16, 12, 3, 3, 3, 4, 1, 1)

    class Plan:
        partition, partition_axes = ("spatial",), ("data",)
        dtype, algorithm, solution, precision = "float32", "mec", "auto", None
        backend = "cpu"

    Plan.spec = spec
    tsc._HOOK_CACHE.clear()
    assert tsc.assert_plan_contract(Plan()) is None       # no rules
    assert not tsc._HOOK_CACHE
    assert tsc.check_plan_contract(Plan()).skipped.startswith("no installed")
    got = spawn(W.plan_hook, 2, args=(tuple(spec.__dict__.values()),),
                timeout_s=60, join_timeout_s=180)
    for r in got:
        assert r["partition"] == ("spatial",) and r["axes"] == ("data",)
        assert r["memo"] == [True]
        assert r["error"] is not None and "collective-permute" in r["error"]


# --------------------------------------------------------- precision flow

def _sig(**dot):
    base = {"op": "mm", "operands": ["float32", "float32"], "out": "float32",
            "kernel": False, "accum": None, "site": "x.py:1", "tf32": False}
    return {"dots": [dict(base, **dot)], "casts": [], "narrow_widen": []}


def test_precision_flow_flags_tf32_and_narrow_accumulators():
    clean, viol = numcheck.precision_flow_findings([_sig()], "HIGHEST")
    assert clean == {"declared": "HIGHEST", "dot_ops": 1,
                     "unannotated_dot_ops": 0, "hlo_dots": 1,
                     "hlo_unannotated": 0} and viol == []
    for dot in ({"tf32": True}, {"operands": ["bfloat16"] * 2,
                                 "out": "bfloat16"},
                {"op": "kernel:x", "kernel": True, "accum": "bfloat16"}):
        tally, viol = numcheck.precision_flow_findings([_sig(**dot)], "HIGH")
        assert tally["unannotated_dot_ops"] == tally["hlo_unannotated"] == 1
        assert viol[0].rule == "precision-flow"
    # nothing declared (or DEFAULT): trivially clean
    for declared in (None, "DEFAULT"):
        tally, viol = numcheck.precision_flow_findings(
            [_sig(tf32=True)], declared)
        assert tally["unannotated_dot_ops"] == 0 and viol == []


def test_precision_flow_reads_the_tf32_flags_when_traced(monkeypatch):
    import torch.nn.functional as F
    spec = ConvSpec(1, 8, 8, 3, 3, 3, 4, 1, 1)
    x = torch.empty((1, 3, 8, 8), device="meta")
    w = torch.empty((4, 3, 3, 3), device="meta")
    a = torch.empty((8, 8), device="meta")
    for flags, program in ((torch.backends.cudnn, lambda: F.conv2d(x, w)),
                           (torch.backends.cuda.matmul, lambda: a @ a)):
        for allowed in (True, False):
            monkeypatch.setattr(flags, "allow_tf32", allowed)
            tally, viol = numcheck.precision_flow_findings(
                [numcheck.trace(program)], "HIGHEST")
            assert tally["unannotated_dot_ops"] == int(allowed)
            assert bool(viol) == allowed
    # with TF32 allowed everywhere, the port's paths keep f32: the
    # kernels (three TF32 products, f32 sums) and ``direct`` (cuDNN with
    # TF32 off around the call)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    for alg in ("mec_fused", "mec_fused2", "mec_lowered", "direct"):
        sig = numcheck.trace_signature(spec, alg, "float32", "grad")
        assert numcheck.precision_flow_findings([sig], "HIGHEST")[1] == [], \
            alg
