"""The port's static launch check (``repro_torch.analysis.launch_check``)
against the JAX package's Pallas geometry checker
(``repro.analysis.pallas_check``) and against the launcher's own source,
on the CPU.

On the card, ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the
mirror equal to the compiled launcher (``mec_conv.fused_config``).  Here
the launcher's host code (``mma_config`` and the functions it calls,
``csrc/mec_conv.cu``) is compiled by the host C++ compiler with the CUDA
runtime stubbed to the H100's limits, and the mirror must give its
fields on every geometry of a seeded sweep.
"""
import ctypes
import pathlib
import random
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

import repro.plan as jplan                                  # noqa: E402
from repro.analysis import pallas_check as jcheck           # noqa: E402
from repro.bench.scenarios import resolve_suite as jsuite   # noqa: E402

import repro_torch.plan as plan_mod                         # noqa: E402
from repro_torch.analysis import launch_check as LC         # noqa: E402
from repro_torch.core.convspec import ConvSpec              # noqa: E402
from repro_torch.kernels import mec_conv, ops               # noqa: E402
from repro_torch.plan import convplan                       # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "kernels" / "csrc"
# a 33 x 33 kernel: no ring of a 33-column kernel slab fits the opt-in, on
# either reduction path, so the launcher refuses K1 and K4 (k_w) and K3
# (whose core's kernel is k_h wide)
REFUSED = ConvSpec(1, 40, 120, 32, 33, 33, 64, 1, 1)


@pytest.fixture(autouse=True)
def plan_env(tmp_path, monkeypatch):
    for prefix in ("REPRO", "REPRO_TORCH"):
        monkeypatch.setenv(f"{prefix}_PLAN_CACHE_DIR", str(tmp_path / prefix))
        monkeypatch.setenv(f"{prefix}_CALIBRATION",
                           str(tmp_path / f"{prefix}-calibration-off.json"))
    for mod in (plan_mod, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()
    yield tmp_path
    for mod in (plan_mod, jplan):
        mod.reset_global_plan_cache()
        mod.reset_calibration_cache()


_PLANS = [(suite, sc.name, sc.spec) for suite in ("smoke", "table2")
          for sc in jsuite(suite)]


@pytest.mark.parametrize("suite,name,jspec", _PLANS,
                         ids=[f"{s}-{n}" for s, n, _ in _PLANS])
def test_w_blk_out_of_range_agrees_with_pallas_check(suite, name, jspec):
    """Every smoke and Table-2 geometry, every kernel path, blocks inside,
    on and past the range: both checkers flag ``w-blk-out-of-range``
    alike."""
    spec = ConvSpec(*[getattr(jspec, f) for f in
                      ("i_n", "i_h", "i_w", "i_c", "k_h", "k_w", "k_c",
                       "s_h", "s_w")])
    for alg in LC.KERNEL_ALGORITHMS:
        for w_blk in (None, 0, 1, spec.o_w, spec.o_w + 1, -3):
            mine = LC.check_geometry(spec, alg, w_blk)
            ref = jcheck.check_geometry(jspec, alg, w_blk)
            rules = {v.rule for v in mine.violations}
            jrules = {v.rule for v in ref.violations}
            assert ("w-blk-out-of-range" in rules) == \
                ("w-blk-out-of-range" in jrules), (alg, w_blk)
            assert mine.kernel and (w_blk is None or rules
                                    or 1 <= w_blk <= spec.o_w)


# ------------------------------------------- the launcher's own source

def _harness(tmp: pathlib.Path) -> ctypes.CDLL:
    """``mma_config`` of ``csrc/mec_conv.cu`` and what it calls, built
    for the host with the CUDA runtime stubbed (opt-in 227 KB, 132 SMs),
    behind one C entry that returns the launch's fields and grid."""
    cu = (CSRC / "mec_conv.cu").read_text()
    mma = (CSRC / "mec_mma.cuh").read_text()
    params = mma[mma.index("constexpr int kBN = 64;"):
                 mma.index("// ----", mma.index("struct Params"))]
    consts = cu[cu.index("constexpr int kThreads = 256;"):
                cu.index("// ----", cu.index("enum Kind"))]
    host = cu[cu.index("bool fits_int("):
              cu.index("template <typename T, int MT, int NT, int WM, int WN>"
                       "\ncudaError_t launch_mma_tile")]
    src = r'''
#include <cstddef>
#include <cstdint>
#include <initializer_list>
typedef int cudaError_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1,
          cudaErrorInvalidDevice = 101;
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin,
                      cudaDevAttrMultiProcessorCount };
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : 132;
  return 0; }
namespace mec_mma {
''' + params + "}\nnamespace {\n" + consts + host + r'''
}
extern "C" int cfg(int kind, int elem, long long i_n, int i_h, int i_w,
                   int i_c, int k_h, int k_w, int k_c, int s_h, int s_w,
                   int o_h, int o_w, int w_blk, int oh_blk, long long* out) {
  MmaLaunch L;
  int err = mma_config(static_cast<Kind>(kind), elem, nullptr, nullptr,
                       nullptr, i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w,
                       o_h, o_w, w_blk, kind == 1 ? 1 : oh_blk, &L);
  if (err) return err;
  const mec_mma::Params& p = L.p;
  long long v[13] = {p.tr, p.tc, L.bm, p.compact, p.cc, p.nchunk, p.split,
                     (long long)L.smem, p.compact ? 16 : p.vin, p.vk,
                     L.grid.x, L.grid.y, L.grid.z};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}
'''
    (tmp / "launcher.cpp").write_text(src)
    subprocess.run([shutil.which("g++"), "-O1", "-std=c++17", "-shared",
                    "-fPIC", str(tmp / "launcher.cpp"), "-o",
                    str(tmp / "liblauncher.so")], check=True, timeout=120)
    lib = ctypes.CDLL(str(tmp / "liblauncher.so"))
    i64 = ctypes.c_longlong
    lib.cfg.argtypes = [ctypes.c_int] * 2 + [i64] + [ctypes.c_int] * 12 + [
        ctypes.POINTER(i64)]
    return lib


def _source_fields(lib, spec, alg, dtype, w_blk):
    """What the compiled launcher chooses for the executor's call, None
    where it refuses."""
    mode = alg[len("mec_"):]
    shapes = ((spec.i_n, spec.i_h, spec.i_w, spec.i_c),
              (spec.k_h, spec.k_w, spec.i_c, spec.k_c), (spec.s_h, spec.s_w))
    wb = ops.default_w_blk(mode, *shapes) if w_blk is None else w_blk
    if mode == "lowered":
        kwic = spec.k_w * spec.i_c
        core = mec_conv.gemm_core((spec.i_n, spec.o_w, spec.i_h, kwic),
                                  (spec.k_h, kwic, spec.k_c), spec.k_h,
                                  spec.s_h, wb)
        kk = core["kernel"]
        args = (*core["inp"], kk[0], kk[1], kk[3], *core["stride"],
                *core["out_shape"][1:3], core["w_blk"], core["oh_blk"])
        kind = 3
    else:
        oh = ops.pick_oh_blk(spec.o_h, spec.o_w, wb, spec.k_c, spec.i_n)
        args = (spec.i_n, spec.i_h, spec.i_w, spec.i_c, spec.k_h, spec.k_w,
                spec.k_c, spec.s_h, spec.s_w, spec.o_h, spec.o_w,
                min(wb, spec.o_w), min(oh, spec.o_h))
        kind = 1 if mode == "fused" else 4
    out = (ctypes.c_longlong * 13)()
    if lib.cfg(kind, 4 if dtype == "float32" else 2, *args, out):
        return None, None
    return dict(zip(mec_conv.FUSED_CONFIG_FIELDS, out[:10])), tuple(out[10:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_equals_the_launchers_source(tmp_path, dtype):
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib = _harness(tmp_path)
    rng = random.Random(0 if dtype == "float32" else 1)
    checked = refused = 0
    for _ in range(700):
        k_h, k_w = rng.choice([1, 2, 3, 5, 7, 11, 33]), \
            rng.choice([1, 2, 3, 5, 7, 11, 33])
        s_h, s_w = rng.choice([1, 1, 2, 4]), rng.choice([1, 1, 2, 3])
        spec = ConvSpec(rng.choice([1, 2, 16]), k_h + rng.randint(0, 60),
                        k_w + rng.randint(0, 250),
                        rng.choice([1, 3, 8, 16, 17, 64, 256, 512]), k_h, k_w,
                        rng.choice([1, 8, 64, 65, 256]), s_h, s_w)
        for alg in LC.KERNEL_ALGORITHMS:
            w_blk = None if rng.random() < 0.7 else rng.randint(1, spec.o_w)
            want, grid = _source_fields(lib, spec, alg, dtype, w_blk)
            got = LC.check_geometry(spec, alg, w_blk, dtype)
            assert (got.kernels[-1].config if got.ok else None) == want, \
                (spec, alg, w_blk, got.render())
            if got.ok:
                assert got.kernels[-1].grid == grid
            assert LC.launcher_fields(alg, dtype, spec,
                                      got.w_blk if w_blk is None
                                      else w_blk) == want
            checked += 1
            refused += want is None
    assert checked == 2100 and 0 < refused < checked


# ----------------------------------------------------- the five kinds

def test_each_violation_kind_fires():
    spec = ConvSpec(2, 16, 16, 8, 3, 3, 64, 1, 1)
    kinds = {
        "w-blk-out-of-range": LC.check_geometry(spec, "mec_fused",
                                                spec.o_w + 1),
        "smem-budget-overrun": LC.check_geometry(REFUSED, "mec_fused2",
                                                 None),
        "grid-not-covering": LC.check_geometry(
            spec, "mec_fused", 1, limits=LC.DeviceLimits(max_grid_yz=8)),
        "dtype-without-instance": LC.check_geometry(spec, "mec_lowered",
                                                    None, "float64"),
    }
    for rule, result in kinds.items():
        assert not result.ok and rule in {v.rule for v in result.violations}
        assert "REJECTED" in result.render()
    # an output row past the input: a spec whose o_h the executor would
    # never derive (duck-typed plans carry whatever they carry)
    bad = type("Spec", (), {**{f: getattr(spec, f) for f in (
        "i_n", "i_h", "i_w", "i_c", "k_h", "k_w", "k_c", "s_h", "s_w",
        "o_w")}, "o_h": spec.o_h + 4})()
    for alg in ("mec_fused", "mec_fused2"):
        assert "block-index-out-of-bounds" in {
            v.rule for v in LC.check_geometry(bad, alg, None).violations}
    assert LC.check_geometry(spec, "mec_fused", None).ok


def test_accumulator_overrun(monkeypatch):
    spec = ConvSpec(2, 16, 140, 8, 3, 3, 64, 1, 1)
    result = LC.check_geometry(spec, "mec_fused", None)
    assert result.ok and result.kernels[0].config["mma_rows"] == 128
    monkeypatch.setattr(LC, "ACC_REGISTERS", 32)
    rules = {v.rule for v in LC.check_geometry(spec, "mec_fused",
                                               None).violations}
    assert rules == {"accumulator-overrun"}


def test_smaller_card_refuses_more():
    spec = ConvSpec(16, 14, 14, 256, 3, 3, 256, 1, 1)
    h100 = LC.check_geometry(spec, "mec_fused2", None)
    small = LC.check_geometry(spec, "mec_fused2", None,
                              limits=LC.DeviceLimits(smem_optin=48 * 1024))
    assert h100.ok and h100.smem_bytes <= LC.H100.smem_optin
    assert not small.ok and {v.rule for v in small.violations} == \
        {"smem-budget-overrun"}
    # fewer SMs, fewer CTAs wanted: the split never grows
    few = LC.check_geometry(spec, "mec_fused2", None,
                            limits=LC.DeviceLimits(sms=8))
    assert few.kernels[0].config["split"] <= h100.kernels[0].config["split"]


def test_non_kernel_algorithms_pass():
    for alg in ("direct", "im2col", "fft", "winograd", "mec"):
        result = LC.check_geometry(REFUSED, alg, None)
        assert result.ok and not result.kernel and result.kernels == ()


def test_lowered_checks_k2_and_k3():
    spec = ConvSpec(16, 14, 14, 256, 3, 3, 256, 1, 1)
    result = LC.check_geometry(spec, "mec_lowered", None, "bfloat16")
    k2, k3 = result.kernels
    assert k2.name.startswith("K2") and k3.name.startswith("K3")
    assert k2.config["rows"] * 3 * 256 <= LC.K2_ELEMS or k2.config["rows"] == 1
    assert k2.grid == (16 * 12, -(-14 // k2.config["rows"]), 1)
    assert k3.config["tr"] * k3.config["tc"] <= LC.MAX_BM


# ------------------------------------------------------- the planner

@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_plan_conv2d_rejects_a_refused_kernel_plan_without_a_card(backend):
    """On a machine with no card, the planner refuses a kernel plan the
    launcher would refuse, whatever the backend (the JAX package gates
    its Pallas plans in interpret mode too)."""
    assert not torch.cuda.is_available()
    with pytest.raises(LC.LaunchCheckError, match="smem-budget-overrun"):
        convplan.assert_plan(convplan.ConvPlan(
            spec=REFUSED, dtype="float32", algorithm="mec_fused",
            w_blk=convplan._kernel_w_blk(REFUSED, "mec_fused"),
            backend=backend))
    for alg in LC.KERNEL_ALGORITHMS:
        assert not LC.check_geometry(REFUSED, alg, None).ok
    if backend == "cuda":        # the card's analytic pick is K1
        with pytest.raises(LC.LaunchCheckError):
            plan_mod.plan_conv2d(REFUSED, backend="cuda")


def test_measured_race_skips_a_refused_kernel_candidate():
    spec = ConvSpec(1, 6, 160, 32, 3, 33, 8, 1, 1)
    assert not LC.check_geometry(spec, "mec_fused", None).ok
    with pytest.warns(UserWarning, match="skips mec_fused"):
        mc = convplan.measure_candidates_detailed(
            spec, candidates=("direct", "mec_fused"), iters=1,
            record=False, backend="cpu")
    assert set(mc.times) == {"direct"}
    assert mc.skipped["mec_fused"].startswith("launch_check: ")
