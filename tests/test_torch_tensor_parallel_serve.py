"""The port's tensor parallelism served and placed on gloo ranks
(``tests/test_torch_tensor_parallel.py`` holds it to the JAX package):
``launch.serve.serve`` under (1, 2) rules against one process for every
family (the greedy tokens equal, the logits within 1e-5 scaled, f32;
with ``warm_plans`` the conv frontends run whole on every rank), and the
rank-local init and the segment tables' round trip to the bit.  A file
of its own so the test runner's workers share the spawns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_dist_workers as W                        # noqa: E402
from test_torch_tensor_parallel import (FAMILIES, EDGES, _close,  # noqa: E402
                                        _flat)
from repro_torch.configs import archs as tarchs            # noqa: E402
from repro_torch.launch import mesh as tmesh               # noqa: E402
from repro_torch.models.lm import LM                       # noqa: E402
from repro_torch.parallel import tensor                    # noqa: E402


@pytest.mark.parametrize("arch,warm", [(a, False) for a in FAMILIES]
                         + [("whisper-tiny", True), ("llava-next-34b", True),
                            ("kimi-k2-1t-a32b", False)])
def test_serving_on_2_ranks_equals_one_rank(arch, warm):
    """``launch.serve.serve`` under (1, 2) rules (eager decode, the argmax
    over the vocab shards) against one process: the greedy tokens equal,
    the prefill's and the last step's logits within 1e-5 scaled (f32).
    With ``warm_plans`` the conv frontend runs whole on every rank."""
    from repro_torch.launch.serve import serve
    ranks = tmesh.spawn(W.tp_serve, 2, args=(arch, {}, "cpu", warm),
                        timeout_s=60, join_timeout_s=240)
    one = serve(tarchs.smoke_config(arch), batch=2, prompt_len=16, gen=5,
                device="cpu", warm_plans=warm)
    for r in ranks:
        assert not r["decode_graph"]
        assert np.array_equal(r["tokens"], one["tokens"].numpy())
        _close(r["prefill_logits"], one["prefill_logits"].numpy(),
               "prefill", 1e-5)
        _close(r["logits"], one["logits"].numpy(), "last step", 1e-5)



@pytest.mark.parametrize("arch,over", [(a, {}) for a in FAMILIES] + EDGES)
def test_rank_local_init_and_segment_round_trip(arch, over):
    """``LM.init(mesh=)`` equals ``shard_params`` of the one-rank init and
    ``gather_params`` of the ranks' trees equals the whole tree, to the
    bit; each rank's bytes are ``local_param_bytes``."""
    ranks = tmesh.spawn(W.tp_round_trip, 2, args=(arch, over), timeout_s=60,
                        join_timeout_s=180)
    cfg = tarchs.smoke_config(arch).with_(**over)
    whole = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    mesh = tmesh.AbstractMesh((1, 2), ("data", "model"))
    want = tensor.local_param_bytes(whole, mesh, cfg)
    flat = _flat(whole)
    for r in ranks:
        assert r["init_is_slice"] and r["gather_is_whole"]
        got = sum(int(np.prod(s)) * flat[k].element_size()
                  for k, s in r["local_shapes"].items())
        assert got == want


