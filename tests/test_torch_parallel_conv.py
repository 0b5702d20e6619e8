"""The port's partitioned MEC conv (``repro_torch.parallel.conv``), its cost
model half (``launch.costmodel.conv_partition_costs`` /
``pick_conv_partition``), the planner's partition fields and the bench
``dist`` suite, against the JAX package on the CPU.

The pure algebra and the costs are held equal to the JAX functions in
process, on the JAX package's own sweeps (an ``AbstractMesh`` on either
side: they read only axis names and sizes).  The sharded conv runs on
gloo ranks on the CPU (``launch.mesh.spawn``, rank bodies in
``tests/test_torch_dist_workers.py``), 2 and 4 of them, for every
partition mode and composite, with and without a halo, through the
kernels' plain versions; every rank's output and input/kernel gradients
are held to the JAX package's single-device ``conv2d`` and ``jax.grad``
on the same numpy inputs within the f32 contract budgets
(``core.numerics``, scale-normalised).  The bytes a rank sends by halo
exchange forward, and by halo exchange and cotangent sums backward, are
counted by wrapping ``torch.distributed`` in the rank and must equal
``conv_partition_costs`` exactly.  One subprocess runs the JAX package's
own ``sharded_conv2d`` on 4 forced host devices against the port's 4
ranks.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                 # noqa: E402
import jax.numpy as jnp                                    # noqa: E402

import repro.launch.costmodel as jcost                     # noqa: E402
import repro.parallel.conv as jconv                        # noqa: E402
import repro.plan as jplan                                 # noqa: E402
from repro.core.compat import abstract_mesh                # noqa: E402
from repro.core.conv_api import conv2d as jconv2d          # noqa: E402
from repro.core.convspec import ConvSpec as JSpec          # noqa: E402
from repro.parallel.axes import ShardingRules as JRules    # noqa: E402
from repro.parallel.axes import use_rules as juse_rules    # noqa: E402

import repro_torch.plan as plan_mod                        # noqa: E402
from repro_torch.analysis import shardcheck                # noqa: E402
import test_torch_dist_workers as W                        # noqa: E402
from repro_torch.bench import check as tcheck              # noqa: E402
from repro_torch.bench import harness, scenarios           # noqa: E402
from repro_torch.core.convspec import ConvSpec             # noqa: E402
from repro_torch.core.numerics import fwd_tolerance, grad_tolerance  # noqa: E402
from repro_torch.launch import costmodel as tcost          # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, spawn    # noqa: E402
from repro_torch.parallel import conv as tconv             # noqa: E402
from repro_torch.parallel.axes import ShardingRules, use_rules  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DIST_BASELINE = REPO / "benchmarks" / "baselines" / "dist.json"
DIST_EXACT = ("partition", "n_dev", "n_dev_axes", "halo_bytes_per_device",
              "per_device_overhead_elems", "comm_bytes_per_device",
              "auto_partition", "spec", "dtype", "overhead_elems",
              "overhead_bytes", "flops")


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    """Both packages' plan caches and calibrations under tmp_path."""
    for prefix in ("REPRO", "REPRO_TORCH"):
        monkeypatch.setenv(f"{prefix}_PLAN_CACHE_DIR", str(tmp_path / prefix))
        monkeypatch.setenv(f"{prefix}_CALIBRATION",
                           str(tmp_path / f"{prefix}-calibration-off.json"))
    for mod in (plan_mod, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()
    yield tmp_path


def _meshes(shape, axes):
    return AbstractMesh(tuple(shape), tuple(axes)), abstract_mesh(shape, axes)


def _specs():
    """The JAX package's test geometries, Table 2 at batch 1 and 8, and
    the halo edge cases."""
    out = [(4, 16, 16, 3, 3, 3, 8, 1, 1), (1, 18, 18, 3, 3, 3, 8, 2, 2),
           (1, 20, 20, 3, 3, 3, 8, 2, 2), (1, 16, 16, 3, 11, 11, 8, 1, 1),
           (2, 16, 16, 3, 5, 5, 8, 1, 1), (1, 15, 16, 3, 3, 3, 8, 1, 1),
           (1, 15, 16, 3, 3, 3, 9, 1, 1), (2, 16, 16, 3, 3, 3, 8, 1, 1),
           (1, 12, 12, 3, 3, 3, 8, 3, 3), (2, 4, 8, 3, 2, 2, 4, 1, 1),
           (2, 4, 8, 3, 3, 3, 4, 1, 1), (2, 16, 16, 4, 3, 3, 8, 1, 1)]
    for name in scenarios.CV_LAYERS:
        for batch in (1, 8):
            out.append(tuple(dataclasses.astuple(
                scenarios.layer_spec(name, batch=batch))))
    return out


SPECS = _specs()


# ------------------------------------------------------------ the algebra

def test_normalize_partition_and_name_equal_the_jax_package():
    for arg in ("batch", "channel", "spatial", ("batch", "spatial"),
                ["spatial", "channel"], "batch+channel"):
        assert tconv.normalize_partition(arg) == \
            jconv.normalize_partition(arg)
        assert tconv.partition_name(arg) == jconv.partition_name(arg)
    assert (tconv.PARTITIONS, tconv.COMPOSITE_PARTITIONS) == \
        (jconv.PARTITIONS, jconv.COMPOSITE_PARTITIONS)
    for bad in ("rows", ("spatial", "batch"), ("batch", "batch"), 3):
        with pytest.raises(ValueError) as mine:
            tconv.normalize_partition(bad)
        with pytest.raises(ValueError) as ref:
            jconv.normalize_partition(bad)
        assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "x".join(map(str, s)))
def test_viability_costs_and_pick_equal_the_jax_package(spec):
    mine, ref = ConvSpec(*spec), JSpec(*spec)
    for n in (1, 2, 3, 4, 8, 256):
        for part in tconv.PARTITIONS:
            assert tconv.partition_viable(mine, part, n) == \
                jconv.partition_viable(ref, part, n)
        assert tcost.conv_partition_costs(mine, n) == \
            jcost.conv_partition_costs(ref, n)
        assert tcost.conv_partition_costs(mine, n, dtype_bytes=2) == \
            jcost.conv_partition_costs(ref, n, dtype_bytes=2)
    for sizes in ((2, 2), (2, 4), (4, 2), (1, 4), (2, 3)):
        for comp in tconv.COMPOSITE_PARTITIONS:
            assert tconv.partition_viable(mine, comp, sizes) == \
                jconv.partition_viable(ref, comp, sizes)
        assert tcost.conv_partition_costs(mine, sizes) == \
            jcost.conv_partition_costs(ref, sizes)
    for cands in ({"batch": 4, "channel": 4, "spatial": 4},
                  {"batch": 2, "spatial": 2, ("batch", "spatial"): (2, 2),
                   ("batch", "channel"): (2, 2),
                   ("spatial", "channel"): (2, 2)},
                  {("batch", "spatial"): (1, 4)}, {"spatial": 8}):
        assert tcost.pick_conv_partition(mine, cands) == \
            jcost.pick_conv_partition(ref, cands)


def test_costs_halo_edge_cases():
    """The JAX package's zero-halo and single-row-shard geometries."""
    assert tconv.spatial_halo_rows(3, 3) == tconv.spatial_halo_rows(2, 3) == 0
    c = tcost.conv_partition_costs(ConvSpec(1, 12, 12, 3, 3, 3, 8, 3, 3),
                                   4)["spatial"]
    assert (c["viable"], c["halo_bytes_per_device"],
            c["comm_bytes_bwd_per_device"]) == (True, 0.0, 3 * 3 * 3 * 8 * 4)
    spec = ConvSpec(2, 4, 8, 3, 2, 2, 4, 1, 1)
    c = tcost.conv_partition_costs(spec, 4)["spatial"]
    assert c["viable"] and c["halo_bytes_per_device"] == 2 * 1 * 8 * 3 * 4
    assert not tconv.partition_viable(spec, "spatial", 8)
    assert not tconv.partition_viable(ConvSpec(2, 4, 8, 3, 3, 3, 4, 1, 1),
                                      "spatial", 4)
    for bad in ({"rows": 2}, {("spatial", "batch"): (2, 2)},
                {"batch": (2, 2)}):
        with pytest.raises(ValueError):
            tcost.pick_conv_partition(spec, bad)
    with pytest.raises(ValueError, match="2-tuple"):
        tcost.conv_partition_costs(spec, (2, 2, 2))


MESHES = [((4,), ("data",)), ((2, 2), ("data", "model")),
          ((1, 1), ("ax0", "ax1")), ((2, 4), ("model", "data")),
          ((2, 16, 16), ("pod", "data", "model")), ((16, 16), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", MESHES)
def test_axis_resolution_and_candidates_equal_the_jax_package(shape, axes):
    mine, ref = _meshes(shape, axes)
    rule_sets = [(None, None)]
    if "data" in axes:
        rule_sets.append((
            ShardingRules(mesh=mine, rules={}, dp_axes=("data",),
                          tp_axis="model" if "model" in axes else None),
            JRules(mesh=ref, rules={}, dp_axes=("data",),
                   tp_axis="model" if "model" in axes else None)))
    for trules, jrules in rule_sets:
        for axis in (None, axes[0], tuple(axes[:2])):
            assert tconv.enumerate_partition_candidates(mine, trules, axis) \
                == jconv.enumerate_partition_candidates(ref, jrules, axis)
        for part in tconv.PARTITIONS + tconv.COMPOSITE_PARTITIONS:
            try:
                want = jconv.default_axis(part, ref, jrules)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tconv.default_axis(part, mine, trules)
                assert str(got.value) == str(e)
                continue
            assert tconv.default_axis(part, mine, trules) == want


def test_partition_specs_equal_the_jax_package():
    for part, axis in (("batch", "data"), ("spatial", "model"),
                       ("channel", "model"), (("batch", "spatial"),
                                              ("data", "model")),
                       (("batch", "channel"), ("data", "model")),
                       (("spatial", "channel"), ("model", "data"))):
        assert tconv.conv_partition_specs(part, axis) == tuple(
            tuple(p) for p in jconv.conv_partition_specs(part, axis))
    with pytest.raises(ValueError, match="axis"):
        tconv.conv_partition_specs(("batch", "spatial"), "data")


def test_plan_under_rules_records_the_jax_package_partition(monkeypatch):
    """plan_conv2d(partition=...) under installed rules records the
    candidate the executor would run, as the JAX package's planner does;
    the partitioned plan serialises field for field as the JAX package's
    and explains its wire bytes.  The JAX planner's collective check
    (``shardcheck``, not ported) compiles on real devices, so it is
    stubbed for the abstract mesh."""
    import repro.analysis.shardcheck as jshard
    monkeypatch.setattr(jshard, "assert_plan_contract",
                        lambda plan, mesh=None: None)
    mine, ref = _meshes((2, 2), ("data", "model"))
    trules = ShardingRules(mesh=mine, rules={"batch": "data"})
    jrules = JRules(mesh=ref, rules={"batch": "data"})
    for spec in ((2, 16, 16, 3, 3, 3, 8, 1, 1), (1, 16, 16, 3, 3, 3, 8, 1, 1),
                 (1, 15, 16, 3, 3, 3, 9, 1, 1)):
        for part in (None, "auto", "spatial", ("batch", "channel")):
            try:
                with juse_rules(jrules):
                    want = jplan.plan_conv2d(JSpec(*spec), backend="cpu",
                                             partition=part)
            except ValueError:
                with use_rules(trules), pytest.raises(ValueError):
                    plan_mod.plan_conv2d(ConvSpec(*spec), backend="cpu",
                                         partition=part)
                continue
            with use_rules(trules):
                got = plan_mod.plan_conv2d(ConvSpec(*spec), backend="cpu",
                                           partition=part)
                text = got.explain()
            assert got.to_dict() == want.to_dict(), (spec, part)
            if got.partition is not None:
                assert "predicted comm bytes/device" in text
    with use_rules(trules):
        cached = plan_mod.plan_conv2d(ConvSpec(2, 16, 16, 3, 3, 3, 8),
                                      backend="cpu", mode="cached")
        fresh = plan_mod.plan_conv2d(ConvSpec(2, 16, 16, 3, 3, 3, 8),
                                     backend="cpu")
    assert cached.partition == ("batch",) and \
        cached.to_dict() == dict(fresh.to_dict(), mode="analytic")
    # The same key without rules re-plans single-device, not the hit.
    assert plan_mod.plan_conv2d(ConvSpec(2, 16, 16, 3, 3, 3, 8),
                                backend="cpu", mode="cached").partition \
        is None


# ------------------------------------------------------- on gloo ranks

def _rand(shape, rng):
    return rng.randn(*shape).astype(np.float32)


def _case(rng, partition, mesh_shape, mesh_axes, x_shape, k_shape, stride,
          algorithm, axis=None, padding="VALID", via="sharded"):
    x, k = _rand(x_shape, rng), _rand(k_shape, rng)
    ref = jconv2d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                  padding=padding, algorithm="direct", partition="none")
    g = _rand(ref.shape, rng)
    return dict(x=x, k=k, g=g, stride=stride, padding=padding,
                algorithm=algorithm, partition=partition,
                mesh_shape=mesh_shape, mesh_axes=mesh_axes, axis=axis,
                via=via)


ALGOS = ("mec", "mec_fused", "mec_fused2", "mec_lowered", "im2col")


def _cases():
    """(case, expected halo/bwd bytes checked?) over 2- and 4-rank meshes:
    every base mode at 2 and 4 ranks, each composite on 2x2, with and
    without a halo, every algorithm somewhere."""
    rng = np.random.RandomState(0)
    out = []
    geoms = [((4, 16, 13, 3), (3, 3, 3, 8), 1),      # halo 2
             ((4, 16, 12, 2), (5, 5, 2, 4), 2),      # halo 3, strided
             ((4, 12, 12, 3), (3, 3, 3, 8), 3),      # stride covers: no halo
             ((4, 8, 9, 3), (2, 2, 3, 4), 1)]        # halo 1
    i = 0
    for part in tconv.PARTITIONS:
        for n in (2, 4):
            for x_shape, k_shape, s in geoms:
                out.append(_case(rng, part, (n,), ("data",), x_shape,
                                 k_shape, s, ALGOS[i % len(ALGOS)]))
                i += 1
    for comp in tconv.COMPOSITE_PARTITIONS:
        for x_shape, k_shape, s in geoms:
            out.append(_case(rng, comp, (2, 2), ("data", "model"), x_shape,
                             k_shape, s, ALGOS[i % len(ALGOS)],
                             axis=("data", "model")))
            i += 1
    # the single-row shard: 4 rows over 4 ranks, k_h = 2
    out.append(_case(rng, "spatial", (4,), ("data",), (2, 4, 8, 3),
                     (2, 2, 3, 4), 1, "mec"))
    # SAME padding, auto partition on a 2x2 mesh, a plan, installed rules
    out.append(_case(rng, "auto", (2, 2), ("data", "model"), (2, 12, 10, 3),
                     (3, 3, 3, 8), 1, "mec_fused", padding="SAME"))
    out.append(_case(rng, ("batch", "spatial"), (2, 2), ("data", "model"),
                     (2, 16, 12, 3), (3, 3, 3, 4), 1, "mec_fused2",
                     via="plan"))
    out.append(_case(rng, None, (4,), ("data",), (4, 10, 10, 3),
                     (3, 3, 3, 8), 1, "mec", padding="SAME", via="rules"))
    return out


@pytest.fixture(scope="module")
def rank_results():
    cases = _cases()
    return cases, spawn(W.conv_cases, 4, args=(cases,), timeout_s=60,
                        join_timeout_s=240)


def _jax_grads(case):
    x, k, g = (jnp.asarray(case[n]) for n in ("x", "k", "g"))

    def loss(a, b):
        return jnp.sum(jconv2d(a, b, stride=case["stride"],
                               padding=case["padding"], algorithm="direct",
                               partition="none") * g)

    y = jconv2d(x, k, stride=case["stride"], padding=case["padding"],
                algorithm="direct", partition="none")
    dx, dk = jax.grad(loss, argnums=(0, 1))(x, k)
    return np.asarray(y), np.asarray(dx), np.asarray(dk)


def _err(a, ref):
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-30))


def test_sharded_conv_on_ranks_matches_the_jax_package(rank_results):
    cases, results = rank_results
    for i, case in enumerate(cases):
        y, dx, dk = _jax_grads(case)
        k_h, k_w, i_c, k_c = case["k"].shape
        fwd_tol = fwd_tolerance("mec", "float32", k_h * k_w * i_c)
        dx_tol = grad_tolerance("mec", "float32", k_h * k_w * k_c)
        dk_tol = grad_tolerance("mec", "float32",
                                y.shape[0] * y.shape[1] * y.shape[2])
        ran = [r[i] for r in results if r[i] is not None]
        assert len(ran) == int(np.prod(case["mesh_shape"]))
        for r in ran:
            assert r["y"].shape == y.shape, i
            assert _err(r["y"], y) < fwd_tol, (i, case["partition"])
            assert _err(r["dx"], dx) < dx_tol, (i, case["partition"])
            assert _err(r["dk"], dk) < dk_tol, (i, case["partition"])
            # every rank holds the same global answers
            for f in ("y", "dx", "dk"):
                assert np.array_equal(r[f], ran[0][f]), (i, f)


def test_counted_wire_bytes_equal_the_cost_model(rank_results):
    """Halo bytes sent forward, and halo plus cotangent-sum bytes sent
    backward, by the busiest rank equal ``conv_partition_costs``; the
    output gather (returning global tensors) is not part of it."""
    cases, results = rank_results
    checked = 0
    for i, case in enumerate(cases):
        if case["via"] != "sharded" or case["padding"] != "VALID":
            continue
        parts = tconv.normalize_partition(case["partition"])
        sizes = case["mesh_shape"] if len(parts) > 1 else case["mesh_shape"][0]
        spec = ConvSpec(*case["x"].shape, *case["k"].shape[:2],
                        case["k"].shape[3], case["stride"], case["stride"])
        costs = tcost.conv_partition_costs(spec, sizes)[
            parts if len(parts) > 1 else parts[0]]
        ran = [r[i] for r in results if r[i] is not None]
        fwd = max(r["fwd"]["p2p"] + r["fwd"]["reduce"] for r in ran)
        bwd = max(r["bwd"]["p2p"] + r["bwd"]["reduce"] for r in ran)
        assert fwd == costs["halo_bytes_per_device"] \
            == costs["comm_bytes_fwd_per_device"], (i, parts)
        assert bwd == costs["comm_bytes_bwd_per_device"], (i, parts)
        checked += 1
    assert checked == 37


def test_the_jax_package_sharded_conv_matches_the_port_on_4_ranks(
        rank_results):
    """The JAX package's own ``sharded_conv2d`` on 4 forced host devices,
    one spatial case with a halo and one batch x spatial case, against
    the port's 4 ranks on the same inputs."""
    cases, results = rank_results
    picks = [i for i, c in enumerate(cases)
             if c["via"] == "sharded" and c["mesh_shape"] in ((4,), (2, 2))
             and c["partition"] in ("spatial", ("batch", "spatial"))
             and c["stride"] == 1 and c["k"].shape[0] == 3][:2]
    assert len(picks) == 2
    arrays = {}
    for j, i in enumerate(picks):
        for f in ("x", "k", "g"):
            arrays[f"{f}{j}"] = cases[i][f]
    path = pathlib.Path(os.environ.get("TMPDIR", "/tmp"))
    npz = path / f"jax-sharded-{os.getpid()}.npz"
    np.savez(npz, **arrays)
    parts = [cases[i]["partition"] for i in picks]
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import json
        import numpy as np, jax, jax.numpy as jnp
        from repro.launch.mesh import make_host_mesh
        from repro.parallel.conv import sharded_conv2d
        a = np.load({str(npz)!r})
        out = []
        for j, part in enumerate({parts!r}):
            part = tuple(part) if isinstance(part, list) else part
            mesh = (make_host_mesh(shape=(2, 2), axes=("data", "model"))
                    if isinstance(part, tuple) else make_host_mesh())
            x, k, g = (jnp.asarray(a[f + str(j)]) for f in "xkg")
            f = lambda xx, kk: sharded_conv2d(xx, kk, algorithm="mec",
                                              partition=part, mesh=mesh)
            y = f(x, k)
            dx, dk = jax.grad(lambda xx, kk: jnp.sum(f(xx, kk) * g),
                              argnums=(0, 1))(x, k)
            out.append([np.asarray(t).ravel().tolist() for t in (y, dx, dk)])
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    try:
        proc = subprocess.run([sys.executable, "-c", prog], env=env,
                              cwd=REPO, capture_output=True, text=True,
                              timeout=300)
    finally:
        npz.unlink(missing_ok=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    for (y, dx, dk), i in zip(ref, picks):
        mine = results[0][i]
        k_h, k_w, i_c, k_c = cases[i]["k"].shape
        assert _err(mine["y"].ravel(), np.asarray(y)) < \
            fwd_tolerance("mec", "float32", k_h * k_w * i_c)
        assert _err(mine["dx"].ravel(), np.asarray(dx)) < \
            grad_tolerance("mec", "float32", k_h * k_w * k_c)
        assert _err(mine["dk"].ravel(), np.asarray(dk)) < \
            grad_tolerance("mec", "float32", int(np.prod(
                mine["y"].shape[:3])))


def test_no_mesh_and_bad_calls_behave_as_the_jax_package():
    x = torch.randn(2, 8, 8, 2)
    k = torch.randn(3, 3, 2, 4)
    from repro_torch.core.conv_api import conv2d
    ref = conv2d(x, k, algorithm="mec", partition="none")
    assert torch.equal(tconv.sharded_conv2d(x, k, algorithm="mec",
                                            partition="spatial"), ref)
    for kw, match in (({"algorithm": "gemm"}, "unknown algorithm"),
                      ({"solution": "C"}, "unknown MEC solution"),
                      ({"partition": "rows"}, "unknown partition")):
        with pytest.raises(ValueError, match=match):
            tconv.sharded_conv2d(x, k, **kw)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="not in mesh axes"):
        tconv.sharded_conv2d(x, k, partition="auto", axis="dta", mesh=mesh)
    with pytest.raises(ValueError, match="distinct"):
        tconv.sharded_conv2d(x, k, axis=("data", "data"), mesh=mesh)


def test_local_batch_rules_keep_a_conv_on_the_rank():
    """Under ``local_batch`` rules (the data-parallel steps, where each
    rank holds its own batch) ``conv2d`` runs on the rank's tensors and
    the planner records no partition; an explicit partition, which would
    split and gather across the ranks' different batches, raises."""
    from repro_torch.core.conv_api import conv2d
    x = torch.randn(2, 8, 8, 2)
    k = torch.randn(3, 3, 2, 4)
    mesh = AbstractMesh((2,), ("data",))
    rules = ShardingRules(mesh=mesh, rules={"batch": "data"},
                          local_batch=True)
    spec = ConvSpec(2, 16, 16, 3, 3, 3, 8)
    with use_rules(dataclasses.replace(rules, local_batch=False)):
        assert plan_mod.plan_conv2d(spec, backend="cpu").partition == \
            ("batch",)
    with use_rules(rules):
        assert torch.equal(conv2d(x, k, algorithm="mec"),
                           conv2d(x, k, algorithm="mec", partition="none"))
        assert plan_mod.plan_conv2d(spec, backend="cpu").partition is None
        with pytest.raises(ValueError, match="local_batch"):
            conv2d(x, k, algorithm="mec", partition="batch")
        with pytest.raises(ValueError, match="local_batch"):
            plan_mod.plan_conv2d(spec, backend="cpu", partition="batch")


# --------------------------------------------------------- the dist suite

@pytest.fixture(scope="module")
def dist_doc():
    return spawn(W.dist_suite, 4, timeout_s=60, join_timeout_s=240)[0]


def test_dist_suite_on_4_ranks_equals_the_committed_baseline(dist_doc):
    """All 65 records' exact fields equal ``benchmarks/baselines/dist.json``;
    the smoke cells ran over 2 and 2x2 ranks and were timed, the Table-2
    cells, left out by ``time_only``, stay analytic."""
    base = json.loads(DIST_BASELINE.read_text())
    assert len(dist_doc["results"]) == len(base["results"]) == 65
    for mine, ref in zip(dist_doc["results"], base["results"]):
        assert (mine["scenario"], mine["algorithm"]) == \
            (ref["scenario"], ref["algorithm"])
        for f in DIST_EXACT:
            assert mine[f] == ref[f], (mine["scenario"], f)
        timed = mine["scenario"].startswith("smoke")
        assert (mine["us_per_call"] is not None) == timed, mine["scenario"]
    failures, _ = tcheck.compare(dist_doc, base, schema_only_on_timing=True)
    # The JAX package's CPU run timed its Table-2 cells (so recorded their
    # shardcheck verdicts) and channel-capped run specs; nothing else may
    # differ.  The executed smoke cells' shardcheck fields equal the
    # baseline's but where the port's execution differs from GSPMD's
    # (``analysis.shardcheck.rank_contract``): its output and gradient
    # all-gathers, which the JAX package's contract does not expect; no
    # trim permute (the port trims locally); and the halo slabs the
    # busiest rank sends (one each way, so one over the gradient program
    # with two spatial ranks, where GSPMD counts each device's operand of
    # both permutes).
    timed = {r["scenario"] for r in dist_doc["results"]
             if r["us_per_call"] is not None}
    # (shardcheck differences are held field by field below)
    assert all(any(f"{k}" in msg for k in ("run_spec", "out_shape",
                                           "run_flops", "numcheck",
                                           "shardcheck"))
               for msg in failures), failures
    checked = 0
    for mine, ref in zip(dist_doc["results"], base["results"]):
        if mine["scenario"] not in timed:
            assert "shardcheck" not in mine, mine["scenario"]
            continue
        got, want = mine["shardcheck"], ref["shardcheck"]
        for f in ("verdict", "skipped_reason", "directions", "violations"):
            assert got[f] == want[f], (mine["scenario"], f)
        assert set(got["expected"]) == set(want["expected"])
        parts = tconv.normalize_partition(mine["partition"])
        n_s = dict(zip(parts, mine["n_dev_axes"])).get("spatial", 1)
        for direction, exp in want["expected"].items():
            halo = exp["required"]["collective-permute"] / \
                (1 if direction == "fwd" else 2)
            for which in ("required", "optional"):
                ours = dict(got["expected"][direction][which])
                gathers = ours.pop("all-gather")
                assert (gathers > 0) == (which == "required"), \
                    (mine["scenario"], direction, which)
                permute = ours.pop("collective-permute")
                assert permute == (halo * shardcheck.halo_sends(n_s, direction)
                                   if which == "required" else 0.0), \
                    (mine["scenario"], direction, which)
                assert ours == {k: v for k, v in exp[which].items()
                                if k not in ("all-gather",
                                             "collective-permute")}, \
                    (mine["scenario"], direction, which)
        checked += 1
    assert checked == 12
    assert dist_doc["harness"]["world_size"] == 4


def test_dist_cell_analytics_without_ranks():
    """A dist cell measured with no process group carries the analytic
    block and is not executed."""
    (sc,) = [s for s in scenarios.resolve_suite("dist")
             if s.name == "smoke4_batch_spatial"]
    rec = harness.measure(sc, "mec_fused", device="cpu")
    base = {(r["scenario"], r["algorithm"]): r for r in json.loads(
        DIST_BASELINE.read_text())["results"]}[(sc.name, "mec_fused")]
    for f in DIST_EXACT:
        assert rec[f] == base[f], f
    assert rec["us_per_call"] is None
