"""Device-memory traffic of the MEC data flows on the H100, modeled from
the kernels' launch geometry (counterpart of ``benchmarks/tpu_traffic.py``).

Per Table-2 layer at a server batch (32, f32), the bytes each data flow
moves, with the blocks, sub-tiles and grids the launchers choose
(``repro_torch.analysis.launch_check``, no card needed):

  im2col  : read I + write L_i2c + read L_i2c + read K + write O
  lowered : K2 (read I + write L_mec) + K3 (the L rows and kernel slabs
            its CTAs stage) + write O
  fused   : K1, the input rows and kernel slabs its CTAs stage + write O
  fused2  : K4, the same with its row-stacked sub-tiles

A CTA stages, for every sub-tile and kernel row, the input row of each of
its tile rows (the columns its positions span, all channels) and the
kernel slab of its 64 output channels; the model counts every staged
byte as read from device memory (no L2 reuse: an upper bound), and each
output once.  Arithmetic intensity (FLOP per byte of the fused flow)
against the card's ridge says whether a layer is bound by bytes or by
operations: 3.35 TB/s, and f32 through three TF32 tensor-core products a
multiply-add at 495 TFLOP/s (the H100 SXM data sheet, as
``chip_smoke.py`` ``PEAKS``).

    PYTHONPATH=src python -m repro_torch.benchmarks.hbm_traffic
"""
from __future__ import annotations

import json

from repro_torch.analysis.launch_check import BN, check_geometry
from repro_torch.bench.scenarios import CV_LAYERS, layer_spec
from repro_torch.benchmarks import _cli
from repro_torch.core.memory import conv_flops, im2col_overhead, mec_overhead
from repro_torch.kernels.mec_conv import gemm_core

#: H100 SXM data sheet: device-memory bandwidth, and the rate of f32
#: multiply-adds as three TF32 tensor-core products
HBM_BW = 3.35e12
PEAK_FLOPS = 495e12 / 3
RIDGE = PEAK_FLOPS / HBM_BW
BATCH = 32
F32 = 4


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def staged_bytes(geo, core) -> int:
    """Bytes the CTAs of one K1/K3/K4 launch stage: ``geo`` its mirrored
    launch, ``core`` the geometry in the core's terms (i_c, k_h, k_w,
    k_c, s_w)."""
    c = geo.config
    oh_blk, w_blk = geo.block
    i_c, k_h, k_w, k_c, s_w = core
    ctas = geo.grid[0] // c["split"] * geo.grid[1] * geo.grid[2]
    subtiles = _ceil_div(oh_blk, c["tr"]) * _ceil_div(w_blk, c["tc"])
    span = (c["tc"] - 1) * s_w + k_w
    rows = ctas * subtiles * c["tr"] * k_h * span * i_c
    slabs = ctas * subtiles * k_h * k_w * i_c * min(BN, k_c)
    return (rows + slabs) * F32


def traffic(s) -> dict:
    i_b = s.i_n * s.i_h * s.i_w * s.i_c * F32
    o_b = s.i_n * s.o_h * s.o_w * s.k_c * F32
    k_b = s.k_h * s.k_w * s.i_c * s.k_c * F32
    l_i2c = im2col_overhead(s) * F32
    l_mec = mec_overhead(s) * F32
    direct = (s.i_c, s.k_h, s.k_w, s.k_c, s.s_w)
    fused = check_geometry(s, "mec_fused", None).kernels[-1]
    fused2 = check_geometry(s, "mec_fused2", None).kernels[-1]
    kwic = s.k_w * s.i_c
    k3 = check_geometry(s, "mec_lowered", None).kernels[-1]
    core = gemm_core((s.i_n, s.o_w, s.i_h, kwic), (s.k_h, kwic, s.k_c),
                     s.k_h, s.s_h)
    k3_core = (kwic, core["kernel"][0], core["kernel"][1], s.k_c,
               core["stride"][1])
    return {
        "im2col": i_b + 2 * l_i2c + k_b + o_b,
        "lowered": i_b + l_mec + staged_bytes(k3, k3_core) + o_b,
        "fused": staged_bytes(fused, direct) + o_b,
        "fused2": staged_bytes(fused2, direct) + o_b,
    }


def rows(batch: int = BATCH):
    out = []
    for name in CV_LAYERS:
        s = layer_spec(name, batch=batch)
        t = traffic(s)
        flops = conv_flops(s)
        ai = flops / t["fused"]
        out.append({"name": name, "flops": flops, "ai_flop_per_byte": ai,
                    "bound": "operations" if ai > RIDGE else "bytes",
                    "bound_us": max(t["fused"] / HBM_BW,
                                    flops / PEAK_FLOPS) * 1e6, **t})
    return out


def main(emit=print, fmt: str = "csv"):
    rs = rows()
    if fmt == "json":
        emit(json.dumps(rs, indent=2))
        return rs
    emit("table,name,us_per_call,derived")
    for r in rs:
        emit(f"hbm_traffic,{r['name']},{r['bound_us']:.1f},"
             f"im2col={r['im2col'] / 2 ** 20:.1f}MB;"
             f"lowered={r['lowered'] / 2 ** 20:.1f}MB;"
             f"fused={r['fused'] / 2 ** 20:.1f}MB;"
             f"fused2={r['fused2'] / 2 ** 20:.1f}MB;"
             f"fused_vs_im2col={r['im2col'] / r['fused']:.2f}x;"
             f"AI={r['ai_flop_per_byte']:.0f}FLOP/B;bound={r['bound']}")
    return rs


if __name__ == "__main__":
    a = _cli.parse(__doc__)
    main(fmt=a.format)
