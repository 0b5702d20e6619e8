"""Batched LM serving through the port's prefill/decode path (counterpart
of ``examples/serve_lm.py``): zamba2 (hybrid) at its smoke size, so the
Mamba2 blocks' MEC conv1d runs in prefill and decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Arguments are passed on to ``repro_torch.launch.serve``; runs on the card
unless ``--device cpu``.
"""
import sys

from repro_torch.launch.serve import main as serve_main

ARGS = ["--arch", "zamba2-7b", "--smoke", "--batch", "4", "--prompt-len",
        "24", "--gen", "12", "--temperature", "0.8"]


def main(argv=None):
    return serve_main(ARGS + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
