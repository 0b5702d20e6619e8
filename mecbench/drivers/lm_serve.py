"""The LM serving driver: a Zamba2 configuration through ``repro_torch``'s
serving path, ``models.serve.prefill`` and ``models.serve.decode_step``
captured by ``serving.step_graph.DecodeProgram``, with K5 for the Mamba2
conv in prefill, in closed loops timed by ``common.token_window``.

The configuration file holds a Zamba2 ``config.json``'s keys; the port's
config is ``repro_torch.configs.archs.zamba2_config`` of them.  Set-up
builds K5 (``kernels/build.py``, into the checkout's ``build/kernels``),
draws the weights on the device from the seed, layer by layer, and the
prompts (token ids uniform over the vocabulary), and warms every shape:
a prefill batch, and for decode a prefill, the graph's capture and two
replays; ``setup_s`` ends there.

* ``loop: prefill``: each step prefills a batch of fresh prompts into
  caches of ``max_len`` and yields its last-position logits; it counts
  the prompts' tokens.  The last ``judged_batches`` batches of the window
  are judged: every sequence's last-position logits against the
  reference's.
* ``loop: decode``: each batch is a step that prefills its prompts into
  the program's caches (copied into its buffers) and counts nothing,
  then ``gen_len - 1`` steps that replay the captured decode step, each
  counting the batch's tokens; decoding is greedy.  The window's last
  batch is run to its end once the window has closed, and the logits of
  its first ``judged_sequences`` sequences at every generated position
  (the prefill's, then each step's) are judged against the reference's
  full forward over the prompt and the tokens the program emitted.

The window's rate (``prefill_tokens_per_s`` or ``decode_tokens_per_s``)
is in the result's values and on standard error; ``BENCHMARK.json``
does not list it as an end-to-end metric yet, so the line leaves it out.
Each judged number is max|y - ref| / max|ref| over the logits compared.
With ``--trace 1`` the run profiles one more step (a prefill batch, or
``TRACE_REPLAYS`` replays after a fresh batch's prefill) twice with
``common.profile``, then once more under ``obs.recording()`` and a
profiler of host and card, whose kernels ``obs.attribute`` gives to the
port's spans; the readers take them from the trace.
"""
from __future__ import annotations

import collections
import math
import time

import torch

from mecbench.common import (Check, Result, label, log_marks, profile,
                             seed_stream, stderr, token_window)

#: decode replays in each profiled pass of a traced run
TRACE_REPLAYS = 8
#: distinct prompt batches drawn for the prefill loop, used in turn
PREFILL_POOL = 16


def model_config(config: dict, dtype: str):
    """The port's config of the configuration file, at ``dtype``."""
    from repro_torch.configs.archs import zamba2_config
    return zamba2_config(config, config["name"], dtype=dtype)


def reference_weights(params: dict, cfg) -> dict:
    """The reference's names (``LAYER_WEIGHTS``) for the program's own
    weights: views of the port's parameter tree, in (in, out)
    orientation, nothing copied."""
    out = {"embed": params["emb"], "final_norm": params["final_norm"]}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]["w"]
    m = params["mamba"]
    for n in range(cfg.n_layers):
        for name, leaf in (("norm", params["mamba_norms"]),
                           ("in_proj", m["in_proj"]["w"]),
                           ("conv_w", m["conv_w"]), ("conv_b", m["conv_b"]),
                           ("dt_bias", m["dt_bias"]), ("a_log", m["a_log"]),
                           ("d", m["d_skip"]), ("gated_norm", m["norm"]),
                           ("out_proj", m["out_proj"]["w"])):
            out[f"layers.{n}.{name}"] = leaf[n]
    s = params["shared"]
    for b in range(cfg.n_mem_blocks):
        for name, leaf in (("norm1", s["norm1"]), ("q", s["attn"]["wq"]["w"]),
                           ("k", s["attn"]["wk"]["w"]),
                           ("v", s["attn"]["wv"]["w"]),
                           ("o", s["attn"]["wo"]["w"]), ("norm2", s["norm2"]),
                           ("gate_up", s["mlp"]["gate_up"]["w"]),
                           ("down", s["mlp"]["down"]["w"])):
            out[f"blocks.{b}.{name}"] = leaf[b]
    h = params["hybrid"]
    for k in range(cfg.shared_apps):
        for name in ("lora_a", "lora_b", "linear"):
            out[f"hybrid.{k}.{name}"] = h[name]["w"][k]
    return out


def draw_weights(weights: dict, config: dict, gen: torch.Generator) -> None:
    """Draw every weight of the reference's names (``reference_weights``:
    views of the program's tree) anew from ``gen``, in place, one tensor
    at a time in float32, as the configuration's ``assumed`` states them.
    The norms' weights and D are drawn around 1, not at 1, so that a norm
    that leaves out its weight, or takes another layer's or group's, and D
    mapped to the wrong heads, all change the logits."""
    lo, hi, floor = (config["time_step_min"], config["time_step_max"],
                     config["time_step_floor"])
    out_scale = 2 * config["num_hidden_layers"]

    def normal(shape, std):
        return std * torch.randn(shape, generator=gen, device=gen.device)

    for name, w in weights.items():
        part = name.rsplit(".", 1)[-1]
        if part == "embed":
            new = normal(w.shape, 0.02)
        elif "norm" in part:
            new = 1 + normal(w.shape, 0.2)
        elif part in ("conv_w", "conv_b"):
            new = normal(w.shape, 0.2)
        elif part == "dt_bias":
            u = torch.rand(w.shape, generator=gen, device=gen.device)
            dt = torch.exp(u * (math.log(hi) - math.log(lo))
                           + math.log(lo)).clamp(min=floor)
            new = dt + torch.log(-torch.expm1(-dt))
        elif part == "a_log":
            new = torch.log(torch.arange(1, w.shape[0] + 1,
                                         device=gen.device,
                                         dtype=torch.float32))
        elif part == "d":
            new = 2 * torch.rand(w.shape, generator=gen, device=gen.device)
        else:                               # a matrix, (in, out)
            new = normal(w.shape, (w.shape[0] * (
                out_scale if part == "o" else 1)) ** -0.5)
        w.copy_(new)


def _copy_into(dst: dict, src: dict) -> None:
    """Copy a cache tree into the buffers of another of its shapes."""
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_into(dst[key], value)
        else:
            dst[key].copy_(value)


class _Model:
    """The model, its weights and the step functions of a loop."""

    def __init__(self, ctx, cfg, device):
        from repro_torch.models import lm, serve
        self.serve = serve
        self.cfg = cfg
        self.model = lm.LM(cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_stream(ctx.seed, 0))
        self.params = self.model.init(gen, device=device)
        draw_weights(reference_weights(self.params, cfg), ctx.config, gen)
        self.gen = gen
        self.device = device

    def prompts(self, n: int, batch: int, length: int) -> torch.Tensor:
        """``n`` batches of prompts, (n, batch, length) token ids uniform
        over the vocabulary."""
        return torch.randint(0, self.cfg.vocab, (n, batch, length),
                             generator=self.gen, device=self.device)

    def prefill(self, tokens: torch.Tensor, max_len: int):
        return self.serve.prefill(self.model, self.params,
                                  {"tokens": tokens}, max_len)

    def program(self, cache: dict, tokens: torch.Tensor):
        from repro_torch.serving.step_graph import DecodeProgram
        serve, model, params = self.serve, self.model, self.params
        return DecodeProgram(
            lambda c, t: serve.decode_step(model, params, c, t), cache,
            tokens)


class _Decode:
    """The decode loop's state: a batch is ``gen_len`` steps, its prefill
    and ``gen_len - 1`` replays; the judged sequences' logits and emitted
    tokens are kept step by step."""

    def __init__(self, m: _Model, traffic: dict, pool: torch.Tensor):
        self.m, self.t, self.pool = m, traffic, pool
        self.g = traffic["gen_len"]
        self.n = traffic["judged_sequences"]
        self.batch = -1
        logits, cache = m.prefill(pool[0], traffic["max_len"])
        self.tokens = torch.zeros((traffic["batch"], 1), dtype=torch.long,
                                  device=m.device)
        self.program = m.program(cache, self.tokens)
        self.kept = torch.zeros((self.g, self.n, m.cfg.vocab),
                                dtype=torch.float32, device=m.device)
        self.emitted = torch.zeros((self.n, self.g), dtype=torch.long,
                                   device=m.device)

    def _emit(self, i: int, logits: torch.Tensor) -> None:
        self.kept[i].copy_(logits[:self.n])
        self.tokens.copy_(logits.argmax(-1, keepdim=True))
        self.emitted[:, i].copy_(self.tokens[:self.n, 0])

    def step(self, i: int) -> int:
        j = i % self.g
        if j == 0:
            self.batch = i // self.g
            prompt = self.pool[self.batch % len(self.pool)]
            logits, cache = self.m.prefill(prompt, self.t["max_len"])
            _copy_into(self.program.cache, cache)
            del cache
            self._emit(0, logits)
            return 0
        self._emit(j, self.program())
        return self.t["batch"]

    def finish(self, steps: int) -> None:
        """Run the last batch of ``steps`` to its end."""
        while steps % self.g:
            self.step(steps)
            steps += 1

    def judged(self):
        """(teacher-forced tokens (n, prompt + gen - 1), the program's
        logits (n, gen, V), the positions they are at)."""
        prompt = self.pool[self.batch % len(self.pool)][:self.n]
        tokens = torch.cat([prompt, self.emitted[:, :-1]], dim=1)
        p = prompt.shape[1]
        return (tokens, self.kept.transpose(0, 1),
                list(range(p - 1, p - 1 + self.g)))


def _errors(ctx, m: _Model, sets, positions, precision=None):
    """The worst over ``sets`` of (tokens, the program's logits) of
    max |got - ref| / max |ref|, the reference's logits at ``positions``
    of the tokens; with ``precision``, also (second) the same of the
    reference at that precision in the program's place."""
    ref = ctx.reference
    weights = reference_weights(m.params, m.cfg)
    err = low = 0.0
    for tokens, got in sets:
        want = ref.logits(weights, ctx.config, tokens, positions)
        err = max(err, ref.scaled_error(got, want))
        if precision is not None:
            low = max(low, ref.scaled_error(ref.logits(
                weights, ctx.config, tokens, positions, precision), want))
    return err, None if precision is None else low


def _trace(ctx, m: _Model, decode, pool, sync, steps, window_s):
    """The traced run's record: ``common.profile`` of one more step (a
    prefill batch; or ``TRACE_REPLAYS`` replays), and a pass of it under
    ``obs.recording()`` whose spans ``obs.attribute`` gives their
    kernels' device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch import obs
    t = ctx.traffic
    if decode is None:
        def fn():
            with label("prefill"):
                m.prefill(pool[0], t["max_len"])
        lengths = []
    else:
        decode.step(0)                      # a fresh batch's prefill
        sync()
        # three runs of fn (profile's two, the recorded pass) fit the cache
        replays = min(TRACE_REPLAYS, (t["max_len"] - t["prompt_len"]) // 3)
        start = int(decode.program.cache["len"].item()) + 2 * replays

        def fn():
            with label("decode replays"):
                for _ in range(replays):
                    decode.program()
        lengths = [start + i + 1 for i in range(replays)]
    prof = profile(fn, sync)
    cuda = torch.device(ctx.device).type == "cuda"
    obs.reset()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with obs.recording(), torch_profile(activities=activities) as p:
        fn()
        sync()
    obs.attribute(p)
    names = obs.summary()["names"]
    return {"loop": t["loop"], "config": ctx.config, "dtype": t["dtype"],
            "batch": t["batch"], "prompt_len": t["prompt_len"],
            "gen_len": t.get("gen_len"),
            "steps": steps, "window_s": window_s, "profile": prof,
            "profiled_steps": 1, "lengths": lengths,
            "spans": {k: names[k] for k in names
                      if k.startswith(("lm.", "mamba2.", "decode_program."))}}


def run(ctx) -> Result:
    t = ctx.traffic
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # first, so that a port without the published block fails at once
    cfg = model_config(ctx.config, t["dtype"])
    marks = [("start", ctx.t_start), ("imports", time.perf_counter())]
    if cuda:
        from repro_torch.kernels import build, mec_conv1d
        build.build(["mec_conv1d"])
        mec_conv1d._lib()
    marks.append(("build", time.perf_counter()))
    with torch.no_grad():
        m = _Model(ctx, cfg, device)
        decode = None
        if t["loop"] == "prefill":
            pool = m.prompts(PREFILL_POOL, t["batch"], t["prompt_len"])
            sync()
            marks.append(("weights", time.perf_counter()))
            kept = collections.deque(maxlen=t["judged_batches"])

            def step(i):
                tokens = pool[i % PREFILL_POOL]
                kept.append((tokens, m.prefill(tokens, t["max_len"])[0]))
                return tokens.numel()
            warm = 1
        else:
            n_batches = 1 + int(ctx.seconds) // 4
            pool = m.prompts(n_batches, t["batch"], t["prompt_len"])
            sync()
            marks.append(("weights", time.perf_counter()))
            decode = _Decode(m, t, pool)
            step, warm = decode.step, 3
        for i in range(warm):
            step(i)
        sync()
        marks.append(("warm steps", time.perf_counter()))
        setup_s = time.perf_counter() - ctx.t_start
        if decode is None:
            kept.clear()
        log_marks("set-up", marks)

        steps, tokens, window_s = token_window(step, ctx.seconds, device)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        rate = f"{t['loop']}_tokens_per_s"
        metrics = {rate: tokens / window_s, "peak_mem_gib": peak / 2 ** 30,
                   "setup_s": setup_s}
        stderr(f"mecbench: {rate} {metrics[rate]!r} ({tokens} tokens, "
               f"{steps} steps, {window_s!r} s)")
        precision = ctx.reference.LOWER[t["dtype"]] if ctx.control else None
        if decode is None:
            err, low = _errors(ctx, m, [(tk, lg[:, None]) for tk, lg in kept],
                               [t["prompt_len"] - 1], precision)
        else:
            decode.finish(steps)
            toks, got, positions = decode.judged()
            err, low = _errors(ctx, m, [(toks, got)], positions, precision)
        limit = t["limits"]["logits_err"]
        checks = [Check("logits_err", err, limit)]
        trace = (_trace(ctx, m, decode, pool, sync, steps, window_s)
                 if ctx.trace else None)
    return Result(metrics=metrics, checks=checks, attempted=tokens,
                  failed=0, memory_peak_bytes=peak, trace=trace,
                  control=None if low is None
                  else [Check("logits_err", low, limit)])
