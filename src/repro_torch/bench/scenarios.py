"""Scenario registry: the paper's evaluation as data (counterpart of
``repro.bench.scenarios``).

A :class:`Scenario` names one convolution geometry and the ``conv2d``
algorithm variants to run on it.  It carries two specs, as the JAX
package's does:

* ``spec``      - the exact paper geometry; the analytic metrics (memory
  overhead, flops) are computed on it;
* ``run_spec``  - the geometry actually timed.

**Where the port differs.**  The JAX package times capped channels
(16, or 8 in the k/s sweep) because it ran on one CPU core, where the
full-channel paper layers take minutes.  The port times them on the card
at the paper's full widths: ``run_spec == spec`` in every suite.

Suites (resolve with :func:`resolve_suite`):

===============  ===========================================================
``table2``       paper Table 2, ``cv1``-``cv12``, every algorithm
``resnet101``    Table 3's ResNet-101 layers with occurrence weights
``ks_sweep``     Fig 4(a): cv1 geometry, stride swept 1..10, MEC vs im2col
``batch``        batch-size diversity (cv9 at n = 1/4/16)
``channels``     channel-count diversity (cv12 geometry, widths 32..512)
``dtype``        dtype diversity (cv9 in f32 and bf16)
``smoke``        3 small layers x all algorithms plus a ``w_blk``-tuning
                 kernel cell
``dist``         distributed cells (2/8/256-way spatial partitions of
                 cv1-cv12, composite 2-D partitions and 2- and 4-device
                 smoke cells): the per-device analytics of every cell;
                 a cell also runs over ranks when the world holds its
                 devices and its geometry splits
===============  ===========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

from repro_torch.core.convspec import ConvSpec

# Paper Table 2: name -> (i_h, i_w, i_c, k_h, k_w, o_c, stride).
CV_LAYERS = {
    "cv1": (227, 227, 3, 11, 11, 96, 4),
    "cv2": (231, 231, 3, 11, 11, 96, 4),
    "cv3": (227, 227, 3, 7, 7, 64, 2),
    "cv4": (224, 224, 64, 7, 7, 64, 2),
    "cv5": (24, 24, 96, 5, 5, 256, 1),
    "cv6": (12, 12, 256, 3, 3, 512, 1),
    "cv7": (224, 224, 3, 3, 3, 64, 1),
    "cv8": (112, 112, 64, 3, 3, 128, 1),
    "cv9": (56, 56, 64, 3, 3, 64, 1),
    "cv10": (28, 28, 128, 3, 3, 128, 1),
    "cv11": (14, 14, 256, 3, 3, 256, 1),
    "cv12": (7, 7, 512, 3, 3, 512, 1),
}

# Paper Table 3: ResNet-101 layer occurrence counts.
RESNET101_WEIGHTS = {"cv4": 1, "cv9": 3, "cv10": 4, "cv11": 23, "cv12": 3}

# conv2d dispatch variants: bench name -> conv2d(**kwargs).  mecA/mecB are
# the paper's Solution A/B of the reference Algorithm 2; the mec_* names
# are the CUDA kernel paths (K1 fused, K4 h-blocked fused, K2+K3 lowered).
ALGORITHM_VARIANTS: Dict[str, Dict[str, str]] = {
    "direct": {"algorithm": "direct"},
    "im2col": {"algorithm": "im2col"},
    "fft": {"algorithm": "fft"},
    "winograd": {"algorithm": "winograd"},
    "mecA": {"algorithm": "mec", "solution": "A"},
    "mecB": {"algorithm": "mec", "solution": "B"},
    "mec_lowered": {"algorithm": "mec_lowered"},
    "mec_fused": {"algorithm": "mec_fused"},
    "mec_fused2": {"algorithm": "mec_fused2"},
}

ALL_VARIANTS = tuple(ALGORITHM_VARIANTS)
# Cheap cross-section for the diversity suites (reference + one kernel).
CORE_VARIANTS = ("direct", "im2col", "mecA", "mec_fused")


def eligible_algorithms(spec: ConvSpec, names=ALL_VARIANTS) -> Tuple[str, ...]:
    """Filter variant names by geometry (winograd is 3x3/stride-1 only)."""
    return tuple(n for n in names
                 if n != "winograd"
                 or (spec.k_h, spec.k_w, spec.s_h, spec.s_w) == (3, 3, 1, 1))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One geometry x algorithm-set cell of a suite."""

    name: str
    spec: ConvSpec                 # exact paper geometry (analytic metrics)
    run_spec: ConvSpec             # geometry actually timed (== spec here)
    algorithms: Tuple[str, ...]
    dtype: str = "float32"
    weight: int = 1                # Table-3 occurrence count (else 1)
    # Distributed cells (suite ``dist``): partition mode (or a composite
    # 2-D tuple) and device count (or one per sub-axis).
    partition: Union[str, Tuple[str, ...], None] = None
    n_dev: Union[int, Tuple[int, ...]] = 1
    # The measured race of the autotune suite restricted to these conv2d
    # algorithm names (executor names, not mecA/mecB), so that a
    # kernel-tuning cell exercises the stage-2 ``w_blk`` grid.
    tune_candidates: Union[Tuple[str, ...], None] = None


def layer_spec(name: str, batch: int = 1) -> ConvSpec:
    """ConvSpec of a Table 2 layer."""
    ih, iw, ic, kh, kw, oc, s = CV_LAYERS[name]
    return ConvSpec(batch, ih, iw, ic, kh, kw, oc, s, s)


def _full_width(name: str, spec: ConvSpec, algorithms, **kw) -> Scenario:
    """A scenario timed at its own geometry (``run_spec == spec``)."""
    return Scenario(name=name, spec=spec, run_spec=spec,
                    algorithms=tuple(algorithms), **kw)


def _layer_scenario(name: str, batch: int = 1, algorithms=ALL_VARIANTS,
                    dtype: str = "float32", weight: int = 1,
                    tag: str = "") -> Scenario:
    spec = layer_spec(name, batch=batch)
    return _full_width(name + tag, spec, eligible_algorithms(spec, algorithms),
                       dtype=dtype, weight=weight)


def _table2() -> Tuple[Scenario, ...]:
    return tuple(_layer_scenario(n) for n in CV_LAYERS)


def _resnet101() -> Tuple[Scenario, ...]:
    return tuple(_layer_scenario(n, weight=w,
                                 algorithms=CORE_VARIANTS + ("mecB",))
                 for n, w in RESNET101_WEIGHTS.items())


def _ks_sweep() -> Tuple[Scenario, ...]:
    # Fig 4(a): cv1's 11x11 kernel, stride 1..10 -- the k/s ratio drives
    # both the Eq. 4 memory saving and the runtime gap vs im2col.
    return tuple(_full_width(f"cv1_s{s}", ConvSpec(1, 227, 227, 3, 11, 11,
                                                   96, s, s),
                             ("mecA", "im2col"))
                 for s in range(1, 11))


def _batch() -> Tuple[Scenario, ...]:
    return tuple(_layer_scenario("cv9", batch=b, tag=f"_b{b}")
                 for b in (1, 4, 16))


def _channels() -> Tuple[Scenario, ...]:
    out = []
    for c in (32, 128, 512):
        spec = ConvSpec(1, 7, 7, c, 3, 3, c, 1, 1)
        out.append(_full_width(f"cv12_c{c}", spec, eligible_algorithms(spec)))
    return tuple(out)


def _dtype() -> Tuple[Scenario, ...]:
    return tuple(_layer_scenario("cv9", dtype=d, tag=f"_{tag}",
                                 algorithms=CORE_VARIANTS)
                 for d, tag in (("float32", "f32"), ("bfloat16", "bf16")))


def _smoke() -> Tuple[Scenario, ...]:
    # Three small layers x every algorithm: a winograd-eligible 3x3/s1, a
    # strided 5x5 and a cv1-shaped 11x11/s4; then a wide row (o_w = 520)
    # whose race is kept to the kernel paths, so that stage 2 tunes w_blk.
    shapes = {
        "s3x3": ConvSpec(1, 14, 14, 4, 3, 3, 8, 1, 1),
        "s5x5": ConvSpec(1, 16, 16, 3, 5, 5, 8, 2, 2),
        "s11x11": ConvSpec(1, 23, 23, 3, 11, 11, 8, 4, 4),
    }
    cells = [_full_width(n, s, eligible_algorithms(s))
             for n, s in shapes.items()]
    kernels = ("mec_lowered", "mec_fused", "mec_fused2")
    cells.append(_full_width("w520", ConvSpec(1, 3, 522, 3, 3, 3, 8, 1, 1),
                             kernels, tune_candidates=kernels))
    return tuple(cells)


def _dist() -> Tuple[Scenario, ...]:
    # The JAX package's distributed cells, kept as data: every Table-2
    # layer under 2/8/256-way spatial partitions, composite 2-D partitions
    # at batch 8, and tiny 2- and 2x2-device smoke cells.
    out = []
    for n_dev in (2, 8, 256):
        for layer in CV_LAYERS:
            out.append(_full_width(f"{layer}_d{n_dev}", layer_spec(layer),
                                   ("mecB",), partition="spatial",
                                   n_dev=n_dev))
    for layer in CV_LAYERS:
        out.append(_full_width(f"{layer}_bs2x2", layer_spec(layer, batch=8),
                               ("mecB",), partition=("batch", "spatial"),
                               n_dev=(2, 2)))
    for layer, n_dev in (("cv5", (2, 4)), ("cv6", (2, 4)),
                         ("cv12", (2, 4))):
        out.append(_full_width(f"{layer}_bc{n_dev[0]}x{n_dev[1]}",
                               layer_spec(layer, batch=8), ("mecB",),
                               partition=("batch", "channel"), n_dev=n_dev))
    for layer in ("cv4", "cv8"):
        out.append(_full_width(f"{layer}_sc2x2", layer_spec(layer),
                               ("mecB",), partition=("spatial", "channel"),
                               n_dev=(2, 2)))
    small = ConvSpec(2, 16, 16, 4, 3, 3, 8, 1, 1)
    for part in ("batch", "channel", "spatial"):
        out.append(_full_width(f"smoke2_{part}", small, ("mecB", "mec_fused"),
                               partition=part, n_dev=2))
    for comp in (("batch", "spatial"), ("batch", "channel"),
                 ("spatial", "channel")):
        out.append(_full_width(f"smoke4_{comp[0]}_{comp[1]}", small,
                               ("mecB", "mec_fused"), partition=comp,
                               n_dev=(2, 2)))
    return tuple(out)


# ---------------------------------------------------------------------------
# serve suite (repro_torch.serving.conv_service; harness.run_serve)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeScenario:
    """One conv-serving cell: a fixed kernel geometry, a bounded set of
    padded shape classes, and a deterministic mixed-shape request stream
    cycled ``n_requests`` times."""

    name: str
    kernel_shape: Tuple[int, int, int, int]     # (k_h, k_w, i_c, k_c)
    stride: Tuple[int, int]
    padding: Union[str, Tuple]                  # size-independent only
    classes: Tuple[Tuple[int, int, int], ...]   # (n, h, w) padded classes
    requests: Tuple[Tuple[int, int, int], ...]  # request shapes, cycled
    n_requests: int = 24
    dtype: str = "float32"


def serve_cells() -> Tuple[ServeScenario, ...]:
    # A whisper-style conv1d (h = time), a ViT patch embed, and a strided
    # 2-D conv with batch diversity.
    return (
        ServeScenario(
            name="mel1d", kernel_shape=(3, 1, 8, 16), stride=(1, 1),
            padding=((1, 1), (0, 0)),
            classes=((1, 16, 1), (1, 32, 1)),
            requests=((1, 10, 1), (1, 16, 1), (1, 23, 1), (1, 32, 1))),
        ServeScenario(
            name="patch4", kernel_shape=(4, 4, 3, 8), stride=(4, 4),
            padding="VALID",
            classes=((1, 16, 16), (1, 32, 32)),
            requests=((1, 12, 12), (1, 16, 16), (1, 24, 20), (1, 32, 32))),
        ServeScenario(
            name="s3x3", kernel_shape=(3, 3, 4, 8), stride=(2, 2),
            padding=1,
            classes=((1, 12, 12), (2, 16, 16)),
            requests=((1, 9, 11), (1, 12, 12), (2, 13, 16), (2, 16, 16))),
    )


SUITES: Dict[str, Callable[[], Tuple[Scenario, ...]]] = {
    "table2": _table2,
    "resnet101": _resnet101,
    "ks_sweep": _ks_sweep,
    "batch": _batch,
    "channels": _channels,
    "dtype": _dtype,
    "smoke": _smoke,
    "dist": _dist,
}


def resolve_suite(name: str) -> Tuple[Scenario, ...]:
    if name not in SUITES:
        raise KeyError(f"unknown suite {name!r}; expected one of "
                       f"{sorted(SUITES)}")
    scenarios = SUITES[name]()
    seen = set()
    for sc in scenarios:
        if sc.name in seen:
            raise ValueError(f"suite {name!r}: duplicate scenario {sc.name!r}")
        seen.add(sc.name)
        if not sc.algorithms:
            raise ValueError(f"suite {name!r}: {sc.name!r} has no algorithms")
    return scenarios
