"""The comparison that decides ``correct`` has to fail what it exists to
catch, here at a size a test run can hold, on the CPU:

* the control: the reference computed in the precision just below the
  traffic's, put in the program's place (float8 e4m3 operands for the
  bfloat16 cell, TF32 operands for the float32 one), fails a number of
  every cell;
* a run with the timed path broken underneath (an answer altered where it
  is produced, half of the batch left out and the mean of the rest in its
  place) comes out with ``correct`` false.

The look for a card is skipped; everything else runs as a run does.  On
the card, ``python mecbench/control.py`` reads the same numbers at each
cell's own size.
"""
import pytest
import torch

from mecbench import run as bench_run
from mecbench.tests.test_mecbench_harness import BENCH, smoke_context

CELLS = [w["name"] for w in BENCH["workloads"]]
#: the cells that run the conv stack, whose convs the faults break
CONV_CELLS = [w["name"] for w in BENCH["workloads"]
              if bench_run.load_config(w["config"])["driver"] == "conv_stack"]
DEVICE = {"platform": "gpu", "kind": "test", "count": 1,
          "memory_peak_bytes": 0}


def _correct(res, workload):
    return bench_run.result_line(BENCH, workload, res, False,
                                 DEVICE)["correct"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_program_passes_and_control_fails(workload, seed):
    ctx = smoke_context(workload, seed=seed)
    ctx.control = True
    res = bench_run.load_driver(ctx.config).run(ctx)
    assert all(c.ok for c in res.checks), res.checks
    assert not all(c.ok for c in res.control), res.control


def _conv_fault(kind):
    def wrap(orig):
        def _conv(self, x, w, s):
            y = orig(self, x, w, s)
            if kind == "answer altered":
                delta = torch.zeros_like(y)
                delta.view(-1)[y.numel() // 2] = 0.05 * y.detach().abs().max()
                return y + delta
            half = y.shape[0] // 2                 # half of the batch
            rest = y[:half].mean(0, keepdim=True)
            return torch.cat([y[:half], rest.expand_as(y[half:])])
        return _conv
    return wrap


@pytest.mark.parametrize("workload", CONV_CELLS)
@pytest.mark.parametrize("kind", ["answer altered", "half of the batch"])
def test_conv_fault_is_not_correct(workload, kind, monkeypatch):
    ctx = smoke_context(workload)
    drv = bench_run.load_driver(ctx.config)
    monkeypatch.setattr(drv.Stack, "_conv", _conv_fault(kind)(drv.Stack._conv))
    assert _correct(drv.run(ctx), workload) is False
