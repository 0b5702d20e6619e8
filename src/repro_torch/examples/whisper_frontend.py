"""The whisper conv frontend (counterpart of ``examples/whisper_frontend.py``):
the two-conv-layer mel frontend through MEC convolution, fed into the
port's whisper encoder and decoder.

Two constructions of the same frontend, with the same kernels:

* :func:`make_conv_frontend`: the fixed-shape pattern, each layer's plan
  resolved once, at construction, for ONE mel shape, then replayed
  through ``conv2d(plan=)``;
* ``repro_torch.serving.whisper_frontend_service``: the serving pattern,
  plans warmed per padded shape *class*, so variable-length mels bucket
  into a bounded set of class executors (CUDA graphs on the card).

    PYTHONPATH=src python -m repro_torch.examples.whisper_frontend \\
        [--device cpu]

Runs on the card unless ``--device cpu``.  Where the JAX package's
example runs the training forward over the frames (``LM.forward``, not
ported: ROADMAP Queue 1 item 10), this one runs a serving prefill.
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from repro_torch.configs.archs import smoke_config
from repro_torch.core import conv2d, conv2d_spec
from repro_torch.models import serve as serve_lib
from repro_torch.models.lm import LM
from repro_torch.plan import plan_conv2d
from repro_torch.serving.conv_service import (fit_prefix,
                                              whisper_frontend_kernels,
                                              whisper_frontend_service)

N_MELS = 80


def make_conv_frontend(kernels, mel_shape, plan_mode: str = "cached",
                       emit=print):
    """mel (B, T, n_mels) -> (B, ceil(T/2), d_model) through two MEC conv1d
    layers (height-1 conv2d: the paper's Algorithm 2 with i_h = time).
    Layer 1 pads SAME; the stride-2 layer keeps the whisper-conventional
    symmetric (1, 1) time pad explicitly (SAME would pad (0, 1) for even
    T, shifting every window by one frame).  Each layer's ConvPlan is
    resolved here, once, for the kernels' device; every call replays it."""
    w1, w2 = kernels
    b, t, n_mels = mel_shape
    backend = w1.device.type
    x1 = torch.empty((b, t, 1, n_mels), device="meta")
    plan1 = plan_conv2d(conv2d_spec(x1, w1, stride=(1, 1), padding="SAME"),
                        dtype=w1.dtype, mode=plan_mode, backend=backend)
    x2 = torch.empty((b, t, 1, w2.shape[2]), device="meta")
    plan2 = plan_conv2d(conv2d_spec(x2, w2, stride=(2, 1),
                                    padding=((1, 1), (0, 0))),
                        dtype=w2.dtype, mode=plan_mode, backend=backend)
    emit(f"[whisper] frontend plans: conv1={plan1.algorithm!r} "
         f"conv2={plan2.algorithm!r} (resolved once, mode={plan_mode!r})")

    def frontend(mel):
        x = mel[:, :, None, :]                   # (B, T, 1, mels) h=time
        x = F.gelu(conv2d(x, w1, stride=(1, 1), padding="SAME", plan=plan1),
                   approximate="tanh")
        x = F.gelu(conv2d(x, w2, stride=(2, 1), padding=((1, 1), (0, 0)),
                          plan=plan2), approximate="tanh")
        return x[:, :, 0, :]

    return frontend


@torch.inference_mode()
def main(argv=None, emit=print) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("the whisper frontend example runs on the CUDA "
                         "card by default and none is available; pass "
                         "--device cpu")
    device = torch.device(args.device)
    cfg = smoke_config("whisper-tiny")
    model = LM(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen, device=device)
    t_full = 2 * cfg.encoder_len
    mel = torch.randn((2, t_full, N_MELS), generator=gen, device=device)
    gen.manual_seed(2)
    kernels = whisper_frontend_kernels(gen, N_MELS, cfg.d_model,
                                       device=device)
    frontend = make_conv_frontend(kernels, mel.shape, emit=emit)
    frames = frontend(mel)
    emit(f"[whisper] mel {tuple(mel.shape)} -> frames {tuple(frames.shape)}")
    assert frames.shape == (2, cfg.encoder_len, cfg.d_model)
    enc = model.encode(params, frames)
    emit(f"[whisper] encoder output {tuple(enc.shape)} finite: "
         f"{bool(torch.isfinite(enc).all())}")
    logits, _ = serve_lib.prefill(
        model, params, {"frames": frames,
                        "tokens": torch.zeros((2, 16), dtype=torch.long,
                                              device=device)}, 17)
    emit(f"[whisper] decoder prefill logits {tuple(logits.shape)}")

    # The serving construction: the same two layers as warm ConvServices
    # over (batch, T, 1) time classes.  A shorter clip pads into its class,
    # runs the class executor, and its own frames come back; a clip of a
    # class's full length gives the fixed-shape path's bits.
    svc_frontend, services = whisper_frontend_service(
        None, N_MELS, cfg.d_model, classes=[(2, t_full // 2, 1),
                                            (2, t_full, 1)],
        device=device, kernels=kernels)
    for svc in services:
        emit(f"[whisper] {svc.warmup.summary()}")
    clips = {}
    for t in (t_full // 2 - 3, t_full // 2, t_full - 5, t_full):
        clip = torch.randn((2, t, N_MELS), generator=gen, device=device)
        cls = services[0].bucket((2, t, 1))
        out = fit_prefix(svc_frontend(clip), cfg.encoder_len)
        emit(f"[whisper] clip T={t:3d} -> class {cls.tag()} -> frames "
             f"{tuple(out.shape)}")
        assert out.shape == (2, cfg.encoder_len, cfg.d_model)
        clips[t] = cls.tag()
    same = torch.equal(svc_frontend(mel), frames)
    emit(f"[whisper] full-length mel: service frames equal the fixed-shape "
         f"path's: {same}")
    assert same
    return {"frames": tuple(frames.shape), "logits": tuple(logits.shape),
            "classes": clips,
            "warnings": sum(s.warmup.warning_count for s in services)}


if __name__ == "__main__":
    main()
