"""The frozen yardstick pinned to numbers worked out by hand at the cells'
shapes: a change to any count or peak fails here.

    python -m pytest -q mecbench/tests
"""
import json
import math
from pathlib import Path

import pytest

from mecbench.yardstick import conv, peaks

ROOT = Path(__file__).resolve().parents[2]


def _geoms(batch):
    cfg = json.loads((ROOT / "mecbench/configs/resnet101-convs.json")
                     .read_text())
    out = []
    for L in cfg["layers"].values():
        out += [(batch, L["i_h"], L["i_w"], L["i_c"], L["k_h"], L["k_w"],
                 L["k_c"], L["stride"], L["stride"])] * L["count"]
    return out


def test_peaks():
    assert peaks.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                                "float32": 495e12}
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.bound_s(989e12, 0, "bfloat16") == 1.0
    assert peaks.bound_s(0, 3.35e12, "float32") == 1.0


def test_stack_has_34_convs():
    assert len(_geoms(64)) == 34


@pytest.mark.parametrize("batch,train,flops", [
    (64, False, 670_235_623_424),     # infer: ~6.7e11 a step
    (128, True, 4_021_413_740_544),   # train: 3 x 1,340,471,246,848
])
def test_stack_flops(batch, train, flops):
    assert conv.stack_flops(_geoms(batch), train=train) == flops


@pytest.mark.parametrize("batch,dtype,nbytes,bound", [
    (64, "bfloat16", 1_066_672_128, 6.804170817924936e-04),
    (128, "float32", 4_180_508_672, 2.7189667705072216e-03),
])
def test_stack_bytes_and_bound(batch, dtype, nbytes, bound):
    geoms = _geoms(batch)
    assert sum(conv.forward_bytes(g, dtype) for g in geoms) == nbytes
    assert math.isclose(conv.stack_bound_s(geoms, dtype), bound,
                        rel_tol=1e-12)


@pytest.mark.parametrize("geom,eq2,eq3,eq4,flops", [
    ((1, 224, 224, 64, 7, 7, 64, 2, 2), 37_258_816, 10_938_368, 26_320_448,
     4_769_128_448),
    ((1, 14, 14, 256, 3, 3, 256, 1, 1), 331_776, 129_024, 202_752,
     169_869_312),
])
def test_conv_eq2_to_eq4(geom, eq2, eq3, eq4, flops):
    assert conv.im2col_overhead(geom) == eq2
    assert conv.mec_overhead(geom) == eq3
    assert conv.mec_saving(geom) == eq4
    assert conv.flops(geom) == flops
