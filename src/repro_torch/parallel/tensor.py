"""Tensor parallelism of the LMs over the ``"model"`` mesh axis: the
placements of every family's leaves, and the collectives of the
Megatron-style layers.

In the JAX package GSPMD partitions the parameters as
``parallel.sharding.param_specs`` places them and inserts the collectives
itself.  Here a rank holds its slice of each leaf and the layers write
the collectives out, which needs whole heads and whole channel groups on
a rank.  So the port keeps ``param_specs``' split dimension but takes a
leaf's slice segment by segment of its logical layout (Mamba2's
``in_proj`` ``[z | x | B | C | dt]``, the mLSTM ``up``'s two halves),
and keeps on every rank of the axis a segment that does not divide into
whole heads: attention k/v when ``n_kv_heads % tp != 0``, a whole
attention block when ``n_heads % tp != 0``, Mamba2's B and C (one
group), and likewise any block whose heads or width do not divide.  The
moe family's experts are split only under ``moe_impl="ep"`` (expert
parallelism); the JAX package's local dispatch keeps them whole here.
Each rank's bytes are ``param_specs``' local bytes plus that replicated
excess (:func:`excess_bytes`).

The collectives are autograd Functions, each with its transpose, on the
convention that a tensor replicated over the axis carries the same full
cotangent on every rank:

================= ========================= ==========================
function          forward                   backward
================= ========================= ==========================
:func:`copy_to`   identity                  all-reduce
:func:`reduce_from` all-reduce              identity
:func:`psum`      all-reduce                all-reduce (a sum whose
                                            users are partial too)
:func:`scatter_seq` reduce-scatter over the all-gather
                  sequence (Megatron-SP)
:func:`gather_seq` all-gather               reduce-scatter
:func:`shard_seq` the rank's rows           all-gather
:func:`gather_rep` all-gather               the rank's slice
:func:`rep_part`  identity on a replicated  all-reduce of the
                  leaf a rank uses in part  replicated part
================= ========================= ==========================

A replicated leaf that a rank uses only in part (a norm over the rank's
channels or rows, the router on the rank's tokens, B and C read by the
rank's heads) goes through :func:`rep_part`, so its gradient is the sum
of the ranks' parts; a replicated leaf used on whole replicated
activations is left alone, so its gradient is not doubled.  Reductions
of 16-bit floats run in f32 and cast back.  The reduce-scatter is an
all-reduce followed by the rank's chunk (gloo has no reduce-scatter).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AbstractMesh, axis_sizes
from repro_torch.parallel import comm
from repro_torch.parallel.axes import current_rules

#: the mesh axis the layers split over
TP_AXIS = "model"

_F32 = torch.float32


# ------------------------------------------------------------------ context

@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place on the tensor-parallel axis."""

    group: Any
    rank: int
    size: int
    #: the rules map ``seq_tp`` to the axis: Megatron-SP where the config
    #: asks for it
    seq: bool = False


def context() -> Optional[TP]:
    """The tensor-parallel axis of the installed rules: None without rules,
    without a ``tp_axis`` or where it is 1-way.  Rules over an
    ``AbstractMesh`` with a larger axis have no ranks to run on and
    raise."""
    rules = current_rules()
    if rules is None or rules.tp_axis is None:
        return None
    n = axis_sizes(rules.mesh).get(rules.tp_axis, 1)
    if n == 1:
        return None
    if isinstance(rules.mesh, AbstractMesh):
        raise ValueError(f"tensor parallelism over {rules.tp_axis!r} "
                         f"({n}-way) needs a DeviceMesh over ranks, not an "
                         "AbstractMesh")
    group = rules.mesh.get_group(rules.tp_axis)
    return TP(group, dist.get_rank(group), n,
              rules.rules.get("seq_tp") == rules.tp_axis)


def if_divides(tp: Optional[TP], *dims: int) -> Optional[TP]:
    """``tp`` where every one of ``dims`` divides over it, else None (the
    block runs whole on every rank)."""
    if tp is None or any(d % tp.size for d in dims):
        return None
    return tp


# The rules that decide, for a config and an axis size, which blocks
# split.  The placements and the layers both read them.

def attn_splits(cfg, n: int) -> bool:
    return cfg.n_heads % n == 0


def kv_splits(cfg, n: int) -> bool:
    return cfg.n_kv_heads % n == 0


def mamba_heads(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim


def experts_split(cfg, n: int) -> bool:
    return cfg.moe_impl == "ep" and cfg.n_experts % n == 0


def attn_tp(cfg) -> Optional[TP]:
    tp = context()
    return tp if tp is not None and attn_splits(cfg, tp.size) else None


def sp_active(cfg, tp: Optional[TP], seq_len: int) -> bool:
    """Megatron-SP in a block: the config asks for it, the rules map
    ``seq_tp`` to the axis, and the block's heads and sequence divide."""
    return (tp is not None and tp.seq and cfg.seq_parallel
            and attn_splits(cfg, tp.size) and seq_len % tp.size == 0)


def kv_slots(cfg, n: int, rank: int) -> List[int]:
    """The kv heads the rank's q heads read, one a local kv slot: the
    rank's own kv heads where they split; where they are replicated, the
    distinct heads its q heads read when the q heads a kv head serves
    group evenly on the rank, else one slot a q head."""
    h_loc = cfg.n_heads // n
    g = cfg.n_heads // cfg.n_kv_heads
    if kv_splits(cfg, n):
        k_loc = cfg.n_kv_heads // n
        return list(range(rank * k_loc, (rank + 1) * k_loc))
    per_q = [(rank * h_loc + i) // g for i in range(h_loc)]
    if h_loc % g == 0 or g % h_loc == 0:
        return sorted(set(per_q))
    return per_q


def local_kv_heads(cfg, tp: Optional[TP]) -> int:
    """The kv heads a rank's attention and KV cache hold."""
    if tp is None or not attn_splits(cfg, tp.size):
        return cfg.n_kv_heads
    return len(kv_slots(cfg, tp.size, 0))


# ---------------------------------------------------------- collectives

def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(_F32) if t.dtype in (torch.bfloat16, torch.float16) else t


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    return comm.all_reduce_sum(_wide(t), group).to(t.dtype)


def _chunk(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    return t.chunk(n, dim)[rank].contiguous()


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):  # lint-ignore: accepted-kwarg-not-forwarded (autograd's signature)
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):  # lint-ignore: accepted-kwarg-not-forwarded (autograd's signature)
        return g, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, rank, n, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(_all_reduce(t, group), dim, rank, n)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather_cat(g, ctx.dim, ctx.group), None, None, \
            None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, rank, n, group):
        ctx.dim, ctx.rank, ctx.n, ctx.group = dim, rank, n, group
        return comm.all_gather_cat(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (_chunk(_all_reduce(g, ctx.group), ctx.dim, ctx.rank, ctx.n),
                None, None, None, None)


class _RepPart(torch.autograd.Function):
    """Identity; the cotangent's ``ranges`` along ``dim`` (all of it when
    None) are summed over ``group``."""

    @staticmethod
    def forward(ctx, t, group, dim, ranges):
        ctx.group, ctx.dim, ctx.ranges = group, dim, ranges
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if ctx.ranges is None:
            return _all_reduce(g, ctx.group), None, None, None
        g = g.clone()
        for a, b in ctx.ranges:
            part = g.narrow(ctx.dim, a, b - a)
            part.copy_(_all_reduce(part, ctx.group))
        return g, None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def copy_to(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The input of a column-parallel region."""
    return x if tp is None else comm.Replicated.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The output of a row-parallel region, summed over the axis."""
    return x if tp is None else _Reduce.apply(x, tp.group)


def psum(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` summed over ``tp`` (a :class:`TP` or a process group)."""
    return x if tp is None else _PSum.apply(x, getattr(tp, "group", tp))


def scatter_seq(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    return _ReduceScatter.apply(x, dim, tp.rank, tp.size, tp.group)


def gather_seq(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    return _AllGather.apply(x, dim, tp.rank, tp.size, tp.group)


def shard_seq(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    return comm.Shard.apply(x, dim, tp.rank, tp.size, tp.group)


def gather_rep(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    return comm.Gathered.apply(x, dim, tp.rank, tp.size, tp.group)


def enter(x: torch.Tensor, tp: Optional[TP], sp: bool) -> torch.Tensor:
    """A column-parallel block's input: copied in, or all-gathered over
    the sequence under SP."""
    if tp is None:
        return x
    return gather_seq(x, tp) if sp else copy_to(x, tp)


def leave(y: torch.Tensor, tp: Optional[TP], sp: bool) -> torch.Tensor:
    """A row-parallel block's output: all-reduced, or reduce-scattered
    over the sequence under SP."""
    if tp is None:
        return y
    return scatter_seq(y, tp) if sp else reduce_from(y, tp)


def rep_part(w: torch.Tensor, tp: Optional[TP], dim: int = -1,
             ranges: Optional[Sequence[Tuple[int, int]]] = None
             ) -> torch.Tensor:
    """A replicated leaf (or its ``ranges`` along ``dim``) that the rank
    uses in part: its gradient is summed over the axis."""
    if tp is None:
        return w
    dim = dim % w.dim()
    return _RepPart.apply(w, tp.group, dim,
                          None if ranges is None else tuple(ranges))


def rep_slice(w: torch.Tensor, tp: Optional[TP], dim: int = -1
              ) -> torch.Tensor:
    """The rank's equal chunk of a replicated leaf along ``dim``."""
    if tp is None:
        return w
    return rep_part(w, tp).chunk(tp.size, dim)[tp.rank]


def scale_grad(w: torch.Tensor, scale: float) -> torch.Tensor:
    return _ScaleGrad.apply(w, scale)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             tp: Optional[TP]) -> torch.Tensor:
    """RMS norm over a last axis split over ``tp``: the sum of squares is
    all-reduced (``x`` holds the rank's channels, ``w`` its chunk of the
    replicated weight)."""
    if tp is None:
        from repro_torch.models.layers import rms_norm as plain
        return plain(x, w, eps)
    x32 = x.to(_F32)
    ssq = psum(torch.sum(x32 * x32, dim=-1, keepdim=True), tp)
    var = ssq / (x.shape[-1] * tp.size)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * rep_slice(w, tp)


def embed(emb: torch.Tensor, tokens: torch.Tensor, tp: Optional[TP]
          ) -> torch.Tensor:
    """The lookup into a vocab-sharded embedding (the rank's rows): the
    rank's tokens looked up, the others zero, summed over the axis."""
    if tp is None:
        return emb[tokens]
    v_loc = emb.shape[0]
    ids = tokens - tp.rank * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    rows = emb[torch.clamp(ids, 0, v_loc - 1)]
    rows = rows * mine[..., None].to(rows.dtype)
    return reduce_from(rows, tp)


def gather_vocab(logits: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The whole (..., V) logits from the ranks' vocab shards."""
    if tp is None:
        return logits
    return comm.all_gather_cat(logits, logits.dim() - 1, tp.group)


def argmax_vocab(logits: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """``argmax`` over vocab shards (B, V_loc) -> (B,): the local maximum
    and its index, all-gathered as (value, index), the first largest
    kept (the lowest index, as ``torch.argmax``)."""
    if tp is None:
        return torch.argmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    val = torch.take_along_dim(logits, idx[:, None], dim=-1)[:, 0]
    vals = comm.all_gather_cat(val.to(_F32)[:, None], 1, tp.group)
    idxs = comm.all_gather_cat((idx + tp.rank * logits.shape[-1])[:, None],
                               1, tp.group)
    best = torch.argmax(vals, dim=-1)
    return torch.take_along_dim(idxs, best[:, None], dim=-1)[:, 0]


# ------------------------------------------------------------ placements

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf splits over ``n`` ranks: ``dim`` (counted from the end,
    so layer-stacked leaves share it; None: replicated) and its segments
    along it, each (length, split): a split segment gives each rank an
    equal contiguous piece, a replicated one is kept whole."""

    dim: Optional[int]
    segments: Tuple[Tuple[int, bool], ...] = ()
    n: int = 1

    @property
    def split(self) -> bool:
        return self.dim is not None and self.n > 1

    def pieces(self, rank: int) -> List[Tuple[int, int]]:
        """The (start, stop) ranges of the whole leaf's ``dim`` the rank
        keeps, in order."""
        out, start = [], 0
        for length, split in self.segments:
            if split:
                part = length // self.n
                out.append((start + rank * part, start + (rank + 1) * part))
            else:
                out.append((start, start + length))
            start += length
        return out

    def local_ranges(self, split: bool) -> List[Tuple[int, int]]:
        """The (start, stop) ranges of the local leaf's ``dim`` that hold
        split (``split=True``) or replicated segments."""
        out, start = [], 0
        for length, is_split in self.segments:
            size = length // self.n if is_split else length
            if is_split == split:
                out.append((start, start + size))
            start += size
        return out

    def local_shape(self, shape) -> Tuple[int, ...]:
        shape = list(shape)
        if self.split:
            shape[self.dim] = sum(b - a for a, b in self.pieces(0))
        return tuple(shape)


REPLICATED = Placement(None)


def _seg(*parts) -> Tuple[Tuple[int, bool], ...]:
    return tuple(parts)


def _ffn_width(comps: Tuple[str, ...], cfg) -> int:
    if "moe" in comps:
        return cfg.moe_d_ff * cfg.n_shared_experts
    return cfg.d_ff


def _rule(comps: Tuple[str, ...], shape: Tuple[int, ...], cfg, n: int):
    """(dim, segments) of a leaf at path ``comps``, or None (replicated).
    Whether a leaf splits is decided from the config alone; a leaf cut
    into one segment takes its length from ``shape`` (so a rank's local
    leaf gives its local length), one cut into several from the
    config."""
    name = "/".join(comps)
    last = comps[-1]
    leaf = comps[-2] if last in ("w", "b") and len(comps) > 1 else last

    def whole(dim):
        return dim, _seg((shape[dim], True))

    if last == "emb":
        return whole(-2) if cfg.vocab % n == 0 else None
    if re.search(r"lm_head/w$", name):
        return whole(-1) if cfg.vocab % n == 0 else None
    if re.search(r"vision_proj/w$", name):
        return whole(-1) if cfg.d_model % n == 0 else None
    if last == "b":                       # biases stay whole
        return None
    if "attn" in comps or "xattn" in comps:
        if not attn_splits(cfg, n):
            return None
        if leaf == "wq":
            return whole(-1)
        if leaf in ("wk", "wv"):
            return whole(-1) if kv_splits(cfg, n) else None
        if leaf == "wo":
            return whole(-2)
        return None
    family_block = comps[0]
    if family_block in ("mamba", "mamba_tail"):
        h = mamba_heads(cfg)
        if h % n:
            return None
        d_in, s = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        if leaf == "in_proj":
            return -1, _seg((d_in, True), (d_in, True), (s, False),
                            (s, False), (h, True))
        if leaf == "conv_w":
            return -1, _seg((d_in, True), (s, False), (s, False))
        if leaf == "out_proj":
            return whole(-2)
        return None
    if family_block in ("mlstm", "slstm"):
        if cfg.n_heads % n:
            return None
        d_in = 2 * cfg.d_model
        if leaf == "up" and family_block == "mlstm":
            return -1, _seg((d_in, True), (d_in, True))
        if leaf in ("up", "conv_w", "wq", "wk", "wv", "w_gates"):
            return whole(-1)
        if leaf == "r_gates":
            return whole(-3)
        if leaf == "down":
            return whole(-2)
        return None
    if len(comps) >= 2 and comps[-2] == "moe" and leaf in ("wg", "wu", "wd"):
        return whole(-3) if experts_split(cfg, n) else None
    if ("mlp" in comps or "shared" in comps) and \
            _ffn_width(comps, cfg) % n == 0:
        if leaf in ("gate", "up"):
            return whole(-1)
        if leaf == "down":
            return whole(-2)
    return None


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(path, tree)


def tp_size(mesh) -> int:
    return axis_sizes(mesh).get(TP_AXIS, 1)


def _placement(path, shape, cfg, n: int, local: bool) -> Placement:
    got = _rule(path, tuple(shape), cfg, n) if n > 1 else None
    if got is None:
        return REPLICATED
    dim, segments = got
    if local and len(segments) == 1:     # the local length, times n
        segments = ((segments[0][0] * n, True),)
    return Placement(dim, segments, n)


def local_placement(params_shapes, mesh, cfg, prefix: Tuple[str, ...] = (),
                    local: bool = False):
    """The tree of :class:`Placement` a tree of leaves (anything with a
    ``shape``) takes over ``mesh``'s ``"model"`` axis (or an axis of that
    size); ``prefix`` is the tree's path in the model's tree, for a subtree
    (one layer's).  ``local``: the shapes are a rank's local leaves."""
    n = mesh if isinstance(mesh, int) else tp_size(mesh)
    return _map_path(lambda path, leaf: _placement(
        prefix + path, leaf.shape, cfg, n, local), params_shapes)


def _zip(fn, placements, tree):
    if isinstance(tree, dict):
        return {k: _zip(fn, placements[k], v) for k, v in tree.items()}
    return None if tree is None else fn(placements, tree)


def _shard_leaf(pl: Placement, t: torch.Tensor, rank: int) -> torch.Tensor:
    if not pl.split:
        return t
    dim = pl.dim % t.dim()
    parts = [t.narrow(dim, a, b - a) for a, b in pl.pieces(rank)]
    return (torch.cat(parts, dim) if len(parts) > 1 else parts[0]).clone(
        memory_format=torch.contiguous_format)


def shard_params(full_tree, mesh, cfg, rank: int,
                 prefix: Tuple[str, ...] = ()):
    """The rank's (its ``"model"`` coordinate's) local tree of a whole
    tree: each split leaf's pieces copied, replicated leaves as given."""
    placements = local_placement(full_tree, mesh, cfg, prefix)
    return _zip(lambda pl, t: _shard_leaf(pl, t, rank), placements,
                full_tree)


def _gathered(t: torch.Tensor, group) -> List[torch.Tensor]:
    stacked = comm.all_gather_cat(t[None], 0, group)
    return list(stacked.unbind(0))


def gather_params(local_tree, mesh, cfg):
    """The whole tree from the ranks' local trees (every rank gets it):
    split segments concatenated in rank order, replicated ones taken from
    the rank's own leaf."""
    if tp_size(mesh) == 1:
        return local_tree
    return _zip(lambda sh, t: sh.gather(t), shardings(local_tree, mesh, cfg),
                local_tree)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout over the ranks of a "model" group: its
    :class:`Placement` and this rank's index in ``group``.  Checkpoints
    read it (``ckpt.manager``): a save gathers the whole leaf, a restore
    keeps the rank's pieces."""

    placement: Placement
    rank: int
    group: Any = None

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """The rank's local leaf of the whole one."""
        return _shard_leaf(self.placement, whole, self.rank)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from the ranks' local ones (a collective)."""
        pl = self.placement
        if not pl.split:
            return local
        dim = pl.dim % local.dim()
        ranks = _gathered(local.contiguous(), self.group)
        out, start = [], 0
        for length, split in pl.segments:
            size = length // pl.n if split else length
            if split:
                out.extend(r.narrow(dim, start, size) for r in ranks)
            else:
                out.append(local.narrow(dim, start, size))
            start += size
        return torch.cat(out, dim)


def shardings(local_tree, mesh, cfg):
    """The tree of :class:`Sharding` of a rank's local tree over ``mesh``
    (its "model" axis; every leaf replicated without one)."""
    n = tp_size(mesh)
    group = mesh.get_group(TP_AXIS) if n > 1 else None
    rank = model_rank(mesh)
    return _map_path(lambda path, t: Sharding(
        _placement(path, t.shape, cfg, n, local=True), rank, group),
        local_tree)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _leaf_bytes(params_shapes, mesh, cfg):
    """({path: a rank's bytes of the leaf}, {path: ``param_specs``' share of
    it}) over a whole tree."""
    from repro_torch.parallel.sharding import param_specs
    sizes = axis_sizes(mesh)
    specs = param_specs(params_shapes, mesh)
    placements = local_placement(params_shapes, mesh, cfg)
    port, spec = {}, {}

    def walk(sp, pl, t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(sp[k], pl[k], v, path + (k,))
            return
        if t is None:
            return
        shape = list(t.shape)
        for i, ax in enumerate(sp):
            if ax is not None:
                axes = (ax,) if isinstance(ax, str) else ax
                shape[i] //= math.prod(sizes[a] for a in axes)
        key = "/".join(path)
        port[key] = _nbytes(pl.local_shape(t.shape), t.dtype)
        spec[key] = _nbytes(shape, t.dtype)

    walk(specs, placements, params_shapes, ())
    return port, spec


def local_param_bytes(params_shapes, mesh, cfg) -> int:
    """The bytes of one rank's local leaves (every rank holds as many)."""
    return sum(_leaf_bytes(params_shapes, mesh, cfg)[0].values())


def spec_local_bytes(params_shapes, mesh, cfg) -> int:
    """One device's bytes under ``param_specs``' placements."""
    return sum(_leaf_bytes(params_shapes, mesh, cfg)[1].values())


def excess_bytes(params_shapes, mesh, cfg) -> dict:
    """{leaf path: local bytes less ``param_specs``' local bytes}, for the
    leaves where they differ: the replicated segments."""
    port, spec = _leaf_bytes(params_shapes, mesh, cfg)
    return {k: port[k] - spec[k] for k in port if port[k] != spec[k]}


def model_rank(mesh) -> int:
    """This process's coordinate on ``mesh``'s ``"model"`` axis (0 when the
    mesh has none)."""
    if tp_size(mesh) == 1:
        return 0
    return mesh.get_local_rank(TP_AXIS)


def square_parts(pl: Placement, g: torch.Tensor):
    """(split, replicated) lists of f32 sums of squares of a rank's leaf
    ``g`` (or of a slice of it along another dimension than ``pl.dim``):
    its split segments' and its replicated segments' (the whole leaf,
    where it does not split)."""
    from repro_torch.optim.adamw import sum_squares
    if not pl.split:
        return [], [sum_squares(g)]
    dim = pl.dim % g.dim()
    return tuple([sum_squares(g.narrow(dim, a, b - a))
                  for a, b in pl.local_ranges(split_part)]
                 for split_part in (True, False))


def global_norm(grads, placements, tp: Optional[TP]) -> torch.Tensor:
    """The gradient norm of the whole model from one rank's local tree:
    each split segment's squares summed over the axis once, each
    replicated leaf or segment counted once."""
    split, rep = [], []

    def one(pl, g):
        s, r = square_parts(pl, g)
        split.extend(s)
        rep.extend(r)

    _zip(one, placements, grads)
    zero = torch.zeros((), dtype=_F32)
    split = torch.stack(split).sum() if split else zero
    rep = torch.stack(rep).sum() if rep else zero
    if tp is not None:
        split = comm.all_reduce_sum(split.reshape(1), tp.group)[0]
    return torch.sqrt(split.to(rep.device) + rep)
