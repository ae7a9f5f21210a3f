"""Sharding rules and the model-parallel runtime of the port.

Counterpart of ``repro/models/sharding.py``.  The Neutron compiler picks
per layer between depth parallelism (split output channels; share
activations) and line parallelism (split lines; share parameters) by
estimated latency (§IV-A).  On a mesh of GPUs the same two formats are
tensor parallelism over the ``model`` axis and data parallelism over the
``data`` axis.  This module holds

  * the active mesh (``launch.mesh.use_mesh`` sets it) and the activation
    constraint ``maybe_shard``, identity when no mesh is active;
  * the rule set mapping every parameter to a spec: a tuple of mesh axis
    names, one entry per dimension, as the reference's PartitionSpec, so
    the two packages' specs compare equal (``param_spec``,
    ``tree_partition_specs``), and ``placements``, which turns a spec
    into DTensor placements on a ``DeviceMesh``;
  * :class:`FormatPlanner`, the latency model that chooses depth or line
    per block, with the H100's rates;
  * the SPMD runtime: autograd-aware collectives over one mesh axis
    (``copy_to``, ``reduce_from``, ``gather_from``, ``scatter_to``,
    ``all_to_all``), the vocabulary split over ``model``
    (``vocab_lookup``, ``sum_of_one``, ``argmax_over``) and the parameter
    views the layers take (``local``, ``full``, ``gathered``), after
    ``shard_params`` has cut each parameter to this rank's shard;
  * FSDP over ``data`` (``cfg.fsdp``): a parameter whose spec names
    ``data`` keeps only this rank's slice along that dimension too, and
    each layer takes its weights gathered over ``data`` at its use
    (``fsdp_gathered``, ``unshard_data``), in the forward and again in
    remat's recomputation; the gather's backward sums the gradient over
    the data ranks in rank order and keeps this rank's slice, so the
    data-parallel mean of the step only divides it
    (``train.data_parallel_mean``).  The layers compute on the gathered
    weights exactly what they compute without FSDP.

Every collective reports its output and group size to the active cost
counter (``analysis.cost``: the dry run), one ``is None`` test when
there is none.

The reference lets GSPMD partition one program.  The port runs one
program per rank on plain local tensors (no DTensor reaches a kernel):
the residual stream is replicated over ``model`` and split by rows over
``data``.  Every attention (GQA, MLA, the whisper encoder's and
cross-attention, zamba2's shared block with its LoRA) runs on this
rank's heads, the SSD block on its SSD heads, the MLP on its columns of
w_in/w_gate and rows of w_out (Megatron's column/row pairing: one sum
over ``model`` a block), MoE on this rank's experts through
``all_to_all`` (``moe.moe_a2a``) or, for the dense dispatch over
``data``, on its share of the experts (``moe._moe_dense_data``).  The
embedding and the LM head, where the specs split the vocabulary over
``model``, work on this rank's slice of it: the lookup of the tokens it
holds (``vocab_lookup``), logits over its columns, the loss's
log-sum-exp across the ranks (``layers.VocabParallelCE``); a vocabulary
the axis does not divide stays whole on every rank.  With
``cfg.seq_parallel`` the residual stream between decoder layers holds
this rank's positions (``lm._decoder_layer``).  The dense dispatch takes
its experts in full (``gathered``) where the model axis does not split
them.  The math is the reference's in every case; the formats change
where bytes move, not what is computed.

Every sum across ranks is taken in rank order (an all-gather, then a
sum over ranks 0..n-1), on any backend, so a rerun is bit-equal and
every rank holds the same bits; a sum where one rank holds each element
(``sum_of_one``) is one all-reduce, exact in any order.
"""
from __future__ import annotations

import contextlib
import copy
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import is_dtensor
from repro_torch.analysis import cost as _cost

#: a spec: one entry per dimension, each a mesh axis name, a tuple of
#: names (the dimension split over their product, major first) or None
Spec = Tuple[Any, ...]

# --------------------------------------------------------------------------
# The active mesh
# --------------------------------------------------------------------------

_MESHES: List[Any] = []


def active_mesh():
    """The mesh ``launch.mesh.use_mesh`` made active, or None."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def activate(mesh) -> Iterator[Any]:
    """Make `mesh` the active mesh inside the context (nestable)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def active_mesh_axes() -> Tuple[str, ...]:
    """Axis names of the active mesh; () with none."""
    m = active_mesh()
    return tuple(m.mesh_dim_names) if m is not None else ()


def mesh_axis_size(name: str) -> int:
    """The size of mesh axis `name`; 1 with no mesh or no such axis."""
    m = active_mesh()
    if m is None or name not in m.mesh_dim_names:
        return 1
    return int(m.shape[list(m.mesh_dim_names).index(name)])


def axis_rank(name: str) -> int:
    """This rank's coordinate on mesh axis `name` (0 where it is 1)."""
    if mesh_axis_size(name) == 1:
        return 0
    return int(active_mesh().get_local_rank(name))


def axis_group(name: str):
    """The process group of this rank's slice along mesh axis `name`."""
    return active_mesh().get_group(name)


def maybe_shard(x, *spec):
    """The reference's ``with_sharding_constraint`` that degrades to
    identity when no mesh is active.  Axis names the mesh lacks are
    dropped, as there.  A plain tensor of the per-rank program is left
    as it is, since its layout is fixed by the program (module doc); no
    path of the port passes a DTensor, and one that a caller holds is
    redistributed to the spec's placements."""
    axes = active_mesh_axes()
    if not axes:
        return x

    def keep(s):
        if s is None:
            return None
        if isinstance(s, tuple):
            kept = tuple(a for a in s if a in axes)
            return kept if kept else None
        return s if s in axes else None

    clean = tuple(keep(s) for s in spec)
    if is_dtensor(x):
        return x.redistribute(x.device_mesh,
                              placements(clean, x.device_mesh))
    return x


# --------------------------------------------------------------------------
# Parameter partition rules
# --------------------------------------------------------------------------

#: rule table: regex on the param path -> spec builder(shape) -> tuple.
#: 'M' = model axis, 'F' = fsdp (data) axis, None = replicated.
_RULES = [
    # MoE experts: expert-parallel over model axis (must precede the
    # generic w_in/w_gate/w_out rules)
    (r"experts/w_(in|gate|out)$", lambda sh: ("M", "F", None)),
    (r"router$", lambda sh: (None, None)),
    # embeddings / lm head: vocab on model axis
    (r"embed$", lambda sh: ("M", "F")),
    (r"lm_head$", lambda sh: ("F", "M")),
    (r"mtp_head$", lambda sh: ("F", "M")),
    # attention: column-parallel qkv, row-parallel out
    (r"wq$|wk$|wv$|w_uq$|w_uk$|w_uv$", lambda sh: ("F", "M")),
    (r"wo$", lambda sh: ("M", "F")),
    (r"w_dq$|w_dkv$", lambda sh: ("F", None)),
    # mlp: column-parallel in/gate, row-parallel out
    (r"w_in$|w_gate$", lambda sh: ("F", "M")),
    (r"w_out$", lambda sh: ("M", "F")),
    # mamba: split the inner dim (heads) over model
    (r"ssm_in$", lambda sh: ("F", "M")),
    (r"ssm_out$", lambda sh: ("M", "F")),
    (r"conv_w$", lambda sh: (None, "M")),
    (r"(A_log|D|dt_bias)$", lambda sh: ("M",)),
    # norms / small vectors replicated
    (r".*", lambda sh: tuple(None for _ in sh)),
]


def _path_str(path) -> str:
    """A tree path (dict keys, or JAX-style key objects with ``.key`` /
    ``.idx``) as "a/b/c"."""
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def param_spec(path: str, shape: Tuple[int, ...],
               model_axis: str = "model",
               fsdp_axis: Optional[str] = None,
               stacked: bool = False) -> Spec:
    """Spec for one parameter.  The rule's spec is RIGHT-aligned onto the
    shape so any number of leading stack axes (layer stacks, grouped
    G x R stacks) are replicated automatically."""
    base: Tuple = ()
    for pat, fn in _RULES:
        if re.search(pat, path):
            base = fn(shape)
            break
    subst = {"M": model_axis, "F": fsdp_axis, None: None}
    spec = tuple(subst.get(s, None) for s in base)
    rank = len(shape)
    if len(spec) > rank:
        spec = spec[len(spec) - rank:]
    return tuple(None for _ in range(rank - len(spec))) + spec


#: mesh axis sizes for divisibility checks: the reference's production
#: mesh (16 x 16, two pods).  ``tree_partition_specs`` always checks
#: against these, whatever mesh is active, as the reference does, so the
#: two packages give the same specs; a smaller mesh divides whatever
#: these divide.
DEFAULT_AXIS_SIZES = {"model": 16, "data": 16, "pod": 2}


def enforce_divisible(spec: Spec, shape: Tuple[int, ...],
                      axis_sizes: Optional[Dict[str, int]] = None) -> Spec:
    """Drop axis names from dims the mesh axis doesn't divide (odd vocab
    sizes like 50280 stay replicated; head padding is the opt-in fix)."""
    sizes = axis_sizes or DEFAULT_AXIS_SIZES
    out = []
    for dim, s in zip(shape, tuple(spec) + (None,) * len(shape)):
        if s is None:
            out.append(None)
            continue
        names = s if isinstance(s, tuple) else (s,)
        total = 1
        for nm in names:
            total *= sizes.get(nm, 1)
        out.append(s if dim % total == 0 else None)
    return tuple(out)


_STACKED = re.compile(r"(layers|groups|tail|enc_layers|dec_layers)/")


def tree_partition_specs(params: Any, model_axis: str = "model",
                         fsdp_axis: Optional[str] = None,
                         replicate_kv: bool = False,
                         replicate_q: bool = False) -> Any:
    """The spec tree matching `params`, a nested dict whose leaves have a
    ``.shape`` (arrays, tensors, meta tensors); None leaves stay None.
    ``replicate_kv`` keeps wk/wv replicated over the model axis (the
    broadcast-operand format), ``replicate_q`` wq/wo."""

    def spec_of(path, leaf):
        ps = _path_str(path)
        n = len(leaf.shape)
        if replicate_kv and re.search(r"(wk|wv)$", ps):
            return (None,) * n
        if replicate_q and re.search(r"(wq|wo)$", ps):
            return (None,) * n
        spec = param_spec(ps, tuple(leaf.shape), model_axis, fsdp_axis,
                          bool(_STACKED.search(ps)))
        return enforce_divisible(spec, tuple(leaf.shape))

    return map_with_path(spec_of, params)


def map_with_path(fn, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of a nested dict, whose nodes
    may also be named tuples (an ``SSMState``: keyed by field); None
    stays None."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if tree is None:
        return None
    return fn(path, tree)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of `spec` on `mesh`, one per mesh dimension:
    ``Shard(d)`` where the spec names that mesh axis at tensor dimension
    d, ``Replicate()`` elsewhere.  A dimension split over a tuple of axes
    is sharded over each, major first, as the reference's
    ``P(("pod", "data"))``."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, s in enumerate(spec):
        for name in (s if isinstance(s, tuple) else (s,)):
            if name is not None:
                where[name] = d
    return [Shard(where[n]) if n in where else Replicate()
            for n in mesh.mesh_dim_names]


# --------------------------------------------------------------------------
# Format planner (depth vs line), analogue of §IV-A
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshSpec:
    """A mesh and its per-device rates.  The defaults are one NVIDIA H100
    SXM5 80GB HBM3 at its 700 W power limit, from NVIDIA's data sheet
    (dense bf16 tensor-core rate, HBM3 bandwidth, NVLink 4 bandwidth in
    one direction over all 18 links); a card set below 700 W runs
    slower under load."""
    n_data: int
    n_model: int
    n_pod: int = 1
    flops_per_chip: float = 989e12
    hbm_gbps: float = 3.35e12
    ici_gbps: float = 450e9


@dataclass
class LayerShape:
    """One matmul-ish block: (tokens, d_in, d_out), bytes/elt."""
    name: str
    tokens: int
    d_in: int
    d_out: int
    bytes_per_elt: int = 2


@dataclass
class FormatChoice:
    name: str
    fmt: str                            # "depth" (TP) | "line" (SP/DP)
    t_depth: float
    t_line: float


class FormatPlanner:
    """Pick per-block depth (shard d_out over model, all-reduce partials)
    vs line (shard tokens, all-gather params) by modeled latency, the
    paper's format-selection criterion with collective bytes playing the
    role of the TCM-copy bytes."""

    def __init__(self, mesh: MeshSpec):
        self.mesh = mesh

    def block_latency(self, ls: LayerShape, fmt: str) -> float:
        m = self.mesh
        flops = 2.0 * ls.tokens * ls.d_in * ls.d_out
        t_compute = flops / m.n_model / m.flops_per_chip
        if fmt == "depth":
            # TP: weights split n_model ways; activations replicated;
            # the row-parallel partner needs one all-reduce of the output
            coll = 2.0 * ls.tokens * ls.d_out * ls.bytes_per_elt \
                * (m.n_model - 1) / m.n_model
        else:
            # line: tokens split; parameters all-gathered
            coll = ls.d_in * ls.d_out * ls.bytes_per_elt \
                * (m.n_model - 1) / m.n_model
        t_coll = coll / m.ici_gbps
        w_bytes = ls.d_in * ls.d_out * ls.bytes_per_elt / m.n_model
        a_bytes = ls.tokens * (ls.d_in + ls.d_out) * ls.bytes_per_elt
        if fmt == "line":
            a_bytes /= m.n_model
        t_mem = (w_bytes + a_bytes) / m.hbm_gbps
        return max(t_compute, t_mem) + t_coll

    def choose(self, ls: LayerShape) -> FormatChoice:
        td = self.block_latency(ls, "depth")
        tl = self.block_latency(ls, "line")
        return FormatChoice(ls.name, "depth" if td <= tl else "line",
                            td, tl)

    def plan(self, blocks) -> Dict[str, FormatChoice]:
        return {b.name: self.choose(b) for b in blocks}


# --------------------------------------------------------------------------
# Collectives in rank order
# --------------------------------------------------------------------------


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """(n * x.shape[0], ...): every rank's `x` along dim 0, in rank
    order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    c = _cost.active()
    if c is not None:
        c.collective("all-gather", out, n)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim`, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if dim == 0:
        return _gather0(x, group)
    return _gather0(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


def sum_in_rank_order(x: torch.Tensor, group,
                      acc_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The sum over the ranks of `group` of their `x`, added in rank order
    0, 1, ..., n-1 in `acc_dtype` (x's own by default) and returned in
    x's dtype: the same bits on every rank and in every rerun.  A
    reduce-scatter, then an all-gather: each rank takes its 1 / n of
    every rank's `x` (``_a2a``), adds those parts in rank order, and the
    sums are all-gathered; so a rank holds about three times `x` at
    once, not n times, and sends 2 (n - 1) / n of it."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    flat = x.reshape(-1)
    m = -(-flat.numel() // n)
    if n * m != flat.numel():
        flat = torch.nn.functional.pad(flat, (0, n * m - flat.numel()))
    parts = _a2a(flat.view(n, m), group)        # row j: rank j's part
    acc_dtype = acc_dtype or x.dtype
    total = parts[0].to(acc_dtype)
    for i in range(1, n):
        total = total + parts[i].to(acc_dtype)
    total = _gather0(total.to(x.dtype), group)
    return total[:x.numel()].reshape(x.shape)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over the ranks of `group`."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    c = _cost.active()
    if c is not None:
        c.collective("all-reduce", x, n)
    return x


def sum_of_one(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of `group` of their `x` where, at each
    element, at most one rank holds a value other than zero (a lookup in
    a table split by rows, a gold logit owned by one vocabulary slice):
    one all-reduce, exact in any order, so every rank holds the same bits
    as a sum in rank order would give.  No autograd."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    c = _cost.active()
    if c is not None:
        c.collective("all-reduce", x, n)
    return x


def argmax_over(x: torch.Tensor, group) -> torch.Tensor:
    """The index along the last dimension of the largest element of the
    rows that `x`, this rank's slice of them (rank r holds columns
    [r V_l, (r + 1) V_l)), makes with the other ranks' slices: the max
    over the group, then the lowest index among the equal maxima, as
    ``torch.argmax`` of the whole rows picks.  int64, the same on every
    rank."""
    n = dist.get_world_size(group)
    i = torch.argmax(x, dim=-1)
    if n == 1:
        return i
    m = x.gather(-1, i[..., None])[..., 0]
    top = max_over(m, group)
    big = torch.full_like(i, n * x.shape[-1])
    cand = torch.where(m == top, i + dist.get_rank(group) * x.shape[-1], big)
    return -max_over(-cand, group)


def _local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    r = dist.get_rank(group)
    return x.narrow(dim, r * (size // n), size // n)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group:
    where a replicated tensor enters rank-specific work."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_in_rank_order(g.contiguous(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over the group forward; identity backward: where rank
    partials (a row-parallel product) become replicated."""

    @staticmethod
    def forward(ctx, x, group):
        return sum_in_rank_order(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along `dim` forward; the backward keeps this rank's
    slice: the gathered tensor feeds replicated work, whose gradient is
    the same on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _local_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    """This rank's slice along `dim` forward; the backward all-gathers:
    where replicated work splits into rank slices."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _local_slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


class _GatherRows(torch.autograd.Function):
    """All-gather along `dim` forward where every rank goes on with its
    own work on the whole (the rows of the `data` axis; the SSD block's
    projection and conv weights over `model`): the backward sums the
    gradient over the group in rank order and keeps this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        s = sum_in_rank_order(g.contiguous(), ctx.group)
        return _local_slice(s, ctx.dim, ctx.group).contiguous(), None, None


class _GatherParam(torch.autograd.Function):
    """A parameter's slice gathered over `data` (FSDP) for a layer's use:
    all-gather along `dim` forward; the backward sums the gradient over
    the data ranks in rank order in float32 and keeps this rank's slice,
    as ``train.data_parallel_mean`` sums a replicated parameter's."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        s = sum_in_rank_order(g.contiguous(), ctx.group,
                              acc_dtype=torch.float32)
        return _local_slice(s, ctx.dim, ctx.group).contiguous(), None, None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    c = _cost.active()
    if c is not None:
        c.collective("all-to-all", out, dist.get_world_size(group))
    return out


class _AllToAll(torch.autograd.Function):
    """x (n, ...): chunk j goes to rank j, and chunk j of the result
    came from rank j.  The exchange is its own transpose, so the
    backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def copy_to(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    if mesh_axis_size(axis) == 1:
        return x
    return _CopyTo.apply(x, axis_group(axis))


def reduce_from(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    if mesh_axis_size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, axis_group(axis))


def gather_from(x: torch.Tensor, dim: int, axis: str = "model"
                ) -> torch.Tensor:
    if mesh_axis_size(axis) == 1:
        return x
    return _GatherFrom.apply(x, dim % x.dim(), axis_group(axis))


def scatter_to(x: torch.Tensor, dim: int, axis: str = "model"
               ) -> torch.Tensor:
    if mesh_axis_size(axis) == 1:
        return x
    return _ScatterTo.apply(x, dim % x.dim(), axis_group(axis))


def gather_rows(x: torch.Tensor, dim: int = 0, axis: str = "data"
                ) -> torch.Tensor:
    if mesh_axis_size(axis) == 1:
        return x
    return _GatherRows.apply(x, dim % x.dim(), axis_group(axis))


def all_to_all(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    if mesh_axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, axis_group(axis))


class _SumOfOne(torch.autograd.Function):
    """``sum_of_one`` forward; identity backward: where partials of which
    one rank holds each element (the embedding of a vocabulary split
    over the group) become replicated."""

    @staticmethod
    def forward(ctx, x, group):
        return sum_of_one(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` where `table` is this rank's rows of an embedding
    split by vocabulary over `model` (rank r: rows [r V_l, (r + 1) V_l)):
    each rank looks up the tokens it holds, zeros elsewhere, and the ranks'
    lookups are summed (``sum_of_one``: exact, the same bits as the whole
    table's lookup).  The backward fills only this rank's rows."""
    Vl = table.shape[0]
    local = tokens - axis_rank("model") * Vl
    mine = (local >= 0) & (local < Vl)
    rows = table[local.clamp(0, Vl - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return _SumOfOne.apply(rows, axis_group("model"))


def all_sum(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The sum over `axis` of every rank's `x` where the sum feeds
    rank-specific work (a statistic over heads split across the ranks,
    as the SSD block's gated norm): forward and backward both sum."""
    return copy_to(reduce_from(x, axis), axis)


# --------------------------------------------------------------------------
# Parameters: shards and the views the layers take
# --------------------------------------------------------------------------


def model_parallel() -> bool:
    """Whether a `model` axis larger than 1 is active."""
    return mesh_axis_size("model") > 1


def shard_dim(w: torch.Tensor) -> Optional[int]:
    """The dimension of `w` split over `model` (``shard_params``), or
    None for a replicated parameter or a plain tensor."""
    return getattr(w, "_tp_dim", None)


def local(w: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of `w` along `dim`, for rank-specific work: the
    shard itself when `w` is split there, else this rank's slice of the
    replicated `w` (whose gradient the backward then sums over
    ``model``).  `w` unchanged without a model axis."""
    if not model_parallel():
        return w
    sd = shard_dim(w)
    if sd is not None:
        if sd != dim % w.dim():
            raise ValueError(f"a parameter split on dim {sd} asked for on "
                             f"dim {dim}")
        return w
    return _local_slice(copy_to(w), dim % w.dim(), axis_group("model"))


def replicated(w: torch.Tensor) -> torch.Tensor:
    """A replicated parameter used in rank-specific work (the router of
    ``moe_a2a``): its gradient is summed over ``model``."""
    return copy_to(w)


def full(w: torch.Tensor) -> torch.Tensor:
    """`w` in full: a shard is all-gathered (the line format), over
    `data` first where FSDP splits it (``unshard_data``)."""
    w = unshard_data(w)
    sd = shard_dim(w)
    if sd is None or not model_parallel():
        return w
    return gather_from(w, sd)


def full_for_rank_work(w: torch.Tensor) -> torch.Tensor:
    """`w` in full where each rank uses its own part of it, which the
    storage shards do not follow (the SSD block's conv weights: this
    rank's heads' channels and the shared B and C channels): a shard
    all-gathered, a replicated `w` as it is; either way its gradient is
    summed over `model`."""
    if not model_parallel():
        return w
    sd = shard_dim(w)
    if sd is None:
        return copy_to(w)
    return gather_rows(w, sd, "model")


def columns_gathered(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` from this rank's columns of `w`, all-gathered over
    `model` (the activation moves, not the weight): a product that
    replicated work reads in full, such as kv heads that do not divide
    the axis.  ``x @ w`` without a model axis."""
    return gather_from(copy_to(x) @ local(w, 1), -1)


def as_shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Mark `t`, a tensor computed from this rank's shards (zamba2's
    shared weights plus a group's LoRA delta), as this rank's part along
    `dim`, as ``shard_tensor`` marks a parameter: ``local`` then takes
    it as it is.  `t` unmarked without a model axis."""
    if model_parallel():
        t._tp_dim = dim % t.dim()
    return t


def gathered(mod: torch.nn.Module) -> torch.nn.Module:
    """`mod` with every parameter in full (``full``): a shallow copy of
    the module tree whose sharded parameters are replaced by their
    all-gathers, for a layer computed in the line format.  `mod` itself
    without a model axis or without a sharded parameter."""
    if not model_parallel() or not any(
            shard_dim(p) is not None for p in mod.parameters()):
        return mod
    return _with_params(mod, full)


def _with_params(mod: torch.nn.Module, fn) -> torch.nn.Module:
    """A shallow copy of the module tree `mod` whose every parameter p is
    ``fn(p)``."""
    new = copy.copy(mod)
    new._parameters = {k: (None if v is None else fn(v))
                       for k, v in mod._parameters.items()}
    new._modules = {k: (None if m is None else _with_params(m, fn))
                    for k, m in mod._modules.items()}
    return new


def data_dim(w: torch.Tensor) -> Optional[int]:
    """The dimension of parameter `w` split over `data` (FSDP,
    ``shard_tensor``), or None: replicated over `data`, a plain tensor,
    or no data axis above 1."""
    d = getattr(w, "_dp_dim", None)
    if d is None or mesh_axis_size("data") == 1:
        return None
    return d


def is_data_sharded(p: torch.Tensor) -> bool:
    return data_dim(p) is not None


def unshard_data(w: torch.Tensor) -> torch.Tensor:
    """Parameter `w` gathered over `data` where FSDP splits it
    (``_GatherParam``: the backward sums its gradient over the data
    ranks), still split over `model` as `w` is; `w` itself otherwise."""
    d = data_dim(w)
    if d is None:
        return w
    g = _GatherParam.apply(w, d, axis_group("data"))
    g._tp_dim = shard_dim(w)
    return g


def fsdp_gathered(mod):
    """`mod` with every parameter split over `data` gathered
    (``unshard_data``): a shallow copy of the module tree, made where a
    layer starts, so that a layer holds its whole weights only while it
    runs (and again in remat's recomputation).  `mod` itself when no
    parameter of it is split over `data`, or when it is not a module (a
    namespace of weights already gathered)."""
    if not isinstance(mod, torch.nn.Module) or not any(
            data_dim(p) is not None for p in mod.parameters()):
        return mod
    return _with_params(mod, unshard_data)


def param_specs(cfg, model) -> Dict[int, Spec]:
    """id(parameter) -> its per-layer spec: the spec of its leaf in the
    reference's tree (``tree_partition_specs`` of the stacked shapes,
    ``models.convert.reference_leaves``) without the stacked axes."""
    from .convert import reference_leaves
    out: Dict[int, Spec] = {}
    for path, lead, ts in reference_leaves(cfg, model):
        shape = (*lead, *ts[0].shape)
        spec = tree_partition_specs(_nest_one(path, _Shape(shape)),
                                    fsdp_axis="data" if cfg.fsdp else None)
        spec = _lookup(spec, path)[len(lead):]
        for t in ts:
            out[id(t)] = spec
    return out


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _nest_one(path, leaf):
    tree = leaf
    for k in reversed(path):
        tree = {k: tree}
    return tree


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def shard_params(cfg, model) -> torch.nn.Module:
    """Cut every parameter of `model` (an ``lm.LM`` holding the full
    weights, the same on every rank) to this rank's shard over the
    active mesh's `model` axis and, where the spec names it (FSDP),
    its `data` axis, by ``param_specs``; each keeps its spec as
    ``_spec`` and its split dimensions as ``_tp_dim`` and ``_dp_dim``
    (None: replicated)."""
    specs = param_specs(cfg, model)
    for p in model.parameters():
        shard_tensor(p, specs[id(p)])
    return model


@torch.no_grad()
def shard_tensor(p: torch.nn.Parameter, spec: Spec) -> torch.nn.Parameter:
    """Cut parameter `p` (in full) to this rank's shard by `spec`, in
    place, and record ``_spec``, ``_tp_dim`` and ``_dp_dim`` on it (see
    ``shard_params``).  Raises where an axis does not divide the
    dimension it splits."""
    p._spec = tuple(spec)
    p._tp_dim = p._dp_dim = None
    for d, s in enumerate(spec):
        names = s if isinstance(s, tuple) else (s,)
        for axis, attr in (("model", "_tp_dim"), ("data", "_dp_dim")):
            n = mesh_axis_size(axis)
            if axis not in names or n == 1:
                continue
            if p.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(p.shape)} does not "
                                 f"split over a {axis} axis of {n}")
            size = p.shape[d] // n
            p.data = p.data.narrow(d, axis_rank(axis) * size, size).clone()
            setattr(p, attr, d)
    return p


def is_sharded(p: torch.Tensor) -> bool:
    return shard_dim(p) is not None and model_parallel()


def full_tensor(p: torch.Tensor, t: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Parameter `p` in full, or `t`, a tensor laid out as `p` (its
    moment, its gradient), with no autograd: the all-gather of the
    shards over ``model``, then over ``data`` where FSDP splits it.  A
    collective: every rank of the axes calls it."""
    t = (p if t is None else t).detach()
    sd = shard_dim(p)
    if sd is not None and model_parallel():
        t = all_gather_dim(t, sd, axis_group("model"))
    dd = data_dim(p)
    if dd is not None:
        t = all_gather_dim(t, dd, axis_group("data"))
    return t


def full_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The shape of parameter `p` in full."""
    shape = list(p.shape)
    sd = shard_dim(p)
    if sd is not None and model_parallel():
        shape[sd] *= mesh_axis_size("model")
    dd = data_dim(p)
    if dd is not None:
        shape[dd] *= mesh_axis_size("data")
    return tuple(shape)


def shard_like(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the full tensor `t`, laid out as `p`."""
    for d, axis in ((shard_dim(p), "model"), (data_dim(p), "data")):
        n = mesh_axis_size(axis)
        if d is not None and n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, axis_rank(axis) * size, size).clone()
    return t


def sharded_sum_squares(tensors: Sequence[torch.Tensor],
                        params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 sum of squares of every element of the full tensors
    that `tensors` are this rank's parts of (laid out as `params`): the
    replicated ones counted once, the shards' sums added over ``model``
    and, for those FSDP splits, over ``data``, in rank order."""
    parts: Dict[Tuple[bool, bool], torch.Tensor] = {}
    for t, p in zip(tensors, params):
        s = torch.sum(torch.square(t.float()))
        key = (is_sharded(p), is_data_sharded(p))
        parts[key] = s if key not in parts else parts[key] + s
    total = None
    for (by_model, by_data), s in sorted(parts.items()):
        for split, axis in ((by_model, "model"), (by_data, "data")):
            if split:
                s = sum_in_rank_order(s.reshape(1),
                                      axis_group(axis)).reshape(())
        total = s if total is None else total + s
    return total


def params_split(params: Sequence[torch.Tensor]) -> bool:
    """Whether any of `params` is split over an axis (``model``, or
    ``data`` by FSDP): its norm then needs ``sharded_sum_squares``."""
    return model_parallel() or any(is_data_sharded(p) for p in params)

