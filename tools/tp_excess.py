"""Each rank's parameter bytes under the port's tensor parallelism against
``param_specs``' share, per architecture and axis size, and the leaves
whose segments stay whole on every rank (the replicated excess).

    PYTHONPATH=src python tools/tp_excess.py [--tp 2,4,8,16] [--arch A,B]

The parameter trees are fake tensors (shapes and dtypes, no storage), so
it runs on the CPU in seconds for every full-size config; nothing is
timed.  The placements are ``repro_torch.parallel.tensor``'s, the same
the ranks hold.
"""
import argparse

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.archs import ARCHS
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.lm import LM
from repro_torch.parallel import tensor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", default="2,4,8,16")
    ap.add_argument("--arch", default=",".join(sorted(ARCHS)))
    args = ap.parse_args(argv)
    print("| arch | tp | rank bytes | param_specs bytes | excess | leaves |")
    print("| --- | --- | --- | --- | --- | --- |")
    for arch in args.arch.split(","):
        cfg = ARCHS[arch]
        with FakeTensorMode():
            params = LM(cfg).init(torch.Generator(), device="cpu")
        for tp in (int(t) for t in args.tp.split(",")):
            mesh = AbstractMesh((1, tp), ("data", "model"))
            excess = tensor.excess_bytes(params, mesh, cfg)
            leaves = ", ".join(f"`{k}` {v:,}" for k, v in excess.items())
            print(f"| {arch} | {tp} | "
                  f"{tensor.local_param_bytes(params, mesh, cfg):,} | "
                  f"{tensor.spec_local_bytes(params, mesh, cfg):,} | "
                  f"{sum(excess.values()):,} | {leaves or '-'} |")


if __name__ == "__main__":
    main()
