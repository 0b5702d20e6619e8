"""The conv stack driver: a CNN's convolutions through ``repro_torch``'s
``conv2d``, forward (``loop: infer``) or forward and backward (``loop:
train``), in a closed loop with no synchronisation between steps.

Set-up builds the kernels (``kernels/build.py``, into the checkout's
``build/kernels``), draws every conv's kernel and ``input_sets`` sets of
inputs (one input a conv a set) on the device from the seed, in one call
a set, and runs two steps, which resolve each conv's plan and load the
libraries.  The window enqueues steps, set after set, for ``--seconds``,
then waits for the device: ``images_per_s`` is the images of every step
over the whole window.  The outputs (and, training, the gradients) of the
window's last step on each set are what the reference judges, once the
window has closed and ``peak_mem_gib`` has been read.
"""
from __future__ import annotations

import time

import torch

from mecbench.common import (Check, Result, Spans, label, log_marks, profile,
                             seed_stream)
from mecbench.yardstick import conv as yconv

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def geometries(config: dict, batch: int) -> list:
    """(layer name, geometry) of every conv of the stack, in order."""
    out = []
    for name, L in config["layers"].items():
        g = (batch, L["i_h"], L["i_w"], L["i_c"], L["k_h"], L["k_w"],
             L["k_c"], L["stride"], L["stride"])
        out += [(name, g)] * L["count"]
    return out


def _carve(flat: torch.Tensor, shapes) -> list:
    out, at = [], 0
    for shape in shapes:
        n = 1
        for s in shape:
            n *= s
        out.append(flat[at:at + n].view(shape))
        at += n
    return out


def make_operands(geoms, dtype, n_sets: int, seed: int, device,
                  train: bool) -> dict:
    """Kernels N(0, 1/(k_h k_w i_c)), inputs and cotangents N(0, 1), drawn
    on ``device`` from the seed, one ``randn`` call each group."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_stream(seed, 0))
    k_shapes = [(g[4], g[5], g[3], g[6]) for _, g in geoms]
    x_shapes = [(g[0], g[1], g[2], g[3]) for _, g in geoms]
    o_shapes = [(g[0],) + yconv.out_hw(g) + (g[6],) for _, g in geoms]

    def draw(shapes):
        total = sum(torch.Size(s).numel() for s in shapes)
        return _carve(torch.randn(total, generator=gen, device=device,
                                  dtype=dtype), shapes)

    kernels = draw(k_shapes)
    for w, (_, g) in zip(kernels, geoms):
        w.mul_((g[4] * g[5] * g[3]) ** -0.5)
    sets = [draw(x_shapes) for _ in range(n_sets)]
    ops = {"kernels": kernels, "sets": sets, "cots": None}
    if train:
        ops["cots"] = draw(o_shapes)
        ops["kernels"] = [w.detach().requires_grad_() for w in kernels]
        ops["sets"] = [[x.detach().requires_grad_() for x in xs]
                       for xs in sets]
    return ops


class Stack:
    """One step of the stack over a set of inputs."""

    def __init__(self, geoms, ops: dict, algorithm: str, train: bool,
                 spans: Spans = None):
        from repro_torch.core.conv_api import conv2d
        self.conv2d = conv2d
        self.geoms, self.ops = geoms, ops
        self.algorithm, self.train, self.spans = algorithm, train, spans

    def _conv(self, x, w, s):
        if self.spans is None:
            return self.conv2d(x, w, stride=s, padding="VALID",
                               algorithm=self.algorithm)
        t0 = time.perf_counter()
        y = self.conv2d(x, w, stride=s, padding="VALID",
                        algorithm=self.algorithm)
        self.spans.add("conv2d", time.perf_counter() - t0)
        return y

    def __call__(self, k: int):
        """Step on set ``k``: (outputs, gradients or None)."""
        xs = self.ops["sets"][k]
        ws = self.ops["kernels"]
        if not self.train:
            with torch.inference_mode():
                return [self._conv(x, w, g[7]) for x, w, (_, g)
                        in zip(xs, ws, self.geoms)], None
        with torch.enable_grad():
            outs = [self._conv(x, w, g[7]) for x, w, (_, g)
                    in zip(xs, ws, self.geoms)]
            grads = torch.autograd.grad(outs, list(xs) + list(ws),
                                        self.ops["cots"])
        return [y.detach() for y in outs], grads


def _window(stack: Stack, n_sets: int, seconds: float, sync):
    """Enqueue steps for ``seconds``, then wait: (steps, window seconds,
    the last step's answers on each set)."""
    last = {}
    sync()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        k = steps % n_sets
        last[k] = stack(k)
        steps += 1
    sync()
    return steps, time.perf_counter() - t0, last


def workspace_bytes(stack: Stack, sync) -> dict:
    """Per layer shape: the peak allocated during one call (training: its
    forward and backward) less what was live before it and less the
    tensors the call returns."""
    out = {}
    seen = set()
    for i, (name, g) in enumerate(stack.geoms):
        if name in seen:
            continue
        seen.add(name)
        x, w = stack.ops["sets"][0][i], stack.ops["kernels"][i]
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if stack.train:
            with torch.enable_grad():
                y = stack._conv(x, w, g[7])
                made = [y] + list(torch.autograd.grad(
                    [y], [x, w], [stack.ops["cots"][i]]))
        else:
            with torch.inference_mode():
                made = [stack._conv(x, w, g[7])]
        sync()
        peak = torch.cuda.max_memory_allocated()
        out[name] = peak - base - sum(t.numel() * t.element_size()
                                      for t in made)
        del made
    return out


def _answers(ref, stack: Stack, k: int, i: int, precision=None) -> dict:
    """The reference's answers for conv ``i`` on set ``k``, at
    ``precision`` (None: the reference's own)."""
    x, w = stack.ops["sets"][k][i], stack.ops["kernels"][i]
    s = stack.geoms[i][1][7]
    if stack.train:
        return ref.forward_backward(x, w, s, stack.ops["cots"][i], precision)
    return {"out_err": ref.forward(x, w, s, precision)}


def check(ctx, stack: Stack, last: dict, limits: dict, control=False):
    """Each answer of the window's last step on each set against the
    reference: the worst scaled error over the convs and sets of the
    outputs and, training, the input and kernel gradients.  With
    ``control`` also (second) the same numbers of the control: the
    reference computed in the precision just below the traffic's, cast to
    the traffic's dtype, in the program's place."""
    ref = ctx.reference
    keys = ["out_err"] + (["dx_err", "dw_err"] if stack.train else [])
    worst = dict.fromkeys(keys, 0.0)
    lower = dict.fromkeys(keys, 0.0)
    n = len(stack.geoms)
    dtype = _DTYPES[ctx.traffic["dtype"]]
    for k, (outs, grads) in sorted(last.items()):
        for i in range(n):
            got = {"out_err": outs[i]}
            if stack.train:
                got.update(dx_err=grads[i], dw_err=grads[n + i])
            want = _answers(ref, stack, k, i)
            for key in keys:
                worst[key] = max(worst[key], ref.scaled_error(got[key],
                                                              want[key]))
            if control:
                low = _answers(ref, stack, k, i, ref.LOWER[ctx.traffic["dtype"]])
                for key in keys:
                    lower[key] = max(lower[key], ref.scaled_error(
                        low[key].to(dtype), want[key]))
    checks = [Check(key, worst[key], limits[key]) for key in keys]
    if not control:
        return checks
    return checks, [Check(key, lower[key], limits[key]) for key in keys]


def run(ctx) -> Result:
    from repro_torch.kernels import build
    traffic = ctx.traffic
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [("start", ctx.t_start), ("imports", time.perf_counter())]
    if cuda:
        build.build()
        from repro_torch.kernels import mec_conv
        mec_conv._lib()
    marks.append(("build", time.perf_counter()))
    train = traffic["loop"] == "train"
    dtype = _DTYPES[traffic["dtype"]]
    geoms = geometries(ctx.config, traffic["batch"])
    n_sets = traffic["input_sets"]
    ops = make_operands(geoms, dtype, n_sets, ctx.seed, device, train)
    sync()
    marks.append(("operands", time.perf_counter()))
    stack = Stack(geoms, ops, traffic["algorithm"], train)
    for k in range(n_sets):       # set-up: plans resolved, libraries loaded
        stack(k)
    sync()
    marks.append(("warm steps", time.perf_counter()))
    setup_s = time.perf_counter() - ctx.t_start
    log_marks("set-up", marks)

    steps, window_s, last = _window(stack, n_sets, ctx.seconds, sync)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    images = steps * traffic["batch"]
    metrics = {"images_per_s": images / window_s,
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    trace = None
    if ctx.trace:
        spans = Spans()
        timed = Stack(geoms, ops, traffic["algorithm"], train, spans)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < min(2.0, ctx.seconds):
            timed(0)
            sync()       # an empty queue: the spans time the host alone
        labelled = Stack(geoms, ops, traffic["algorithm"], train)
        prof_steps = 2 * n_sets

        def profiled():
            for i in range(prof_steps):
                with label(f"step {'train' if train else 'infer'}"):
                    labelled(i % n_sets)

        trace = {
            "geoms": [g for _, g in geoms], "dtype": traffic["dtype"],
            "train": train, "steps": steps, "window_s": window_s,
            "spans": spans.spans,
            "profile": profile(profiled, sync) if cuda else None,
            "profiled_steps": prof_steps,
            "workspace_bytes": workspace_bytes(stack, sync) if cuda else {},
        }
    control = None
    if ctx.control:
        checks, control = check(ctx, stack, last, traffic["limits"], True)
    else:
        checks = check(ctx, stack, last, traffic["limits"])
    return Result(metrics=metrics, checks=checks, attempted=images,
                  failed=0, memory_peak_bytes=peak, trace=trace,
                  control=control)
