"""DTensor-aware forms of the few model operations that DTensor cannot run
as written, for the dry run (``launch/dryrun.py``), which runs the model
on meta ``DTensor``s.  Each is the plain operation on a plain tensor, the
same call and the same bits, so the CPU and card paths are unchanged.

On a ``DTensor`` each first moves its operands to a placement the
operation supports, with ``redistribute``, whose collective the dry run's
counter sees and counts; the forms that run per shard (``per_head_shard``,
``embed_rows``, ``take_last``, ``scatter_seq_``) then run
the plain operation on each device's local tensors.  Nothing here reads a
tensor's values.
"""
from __future__ import annotations

import math
import sys

import torch


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``; none can be while
    ``torch.distributed.tensor`` is not imported, and the check does not
    import it (the CPU and card paths never do)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


# --------------------------------------------------------------------------
# Placements
# --------------------------------------------------------------------------
def _placed(t, mesh, pl):
    """``t`` (a ``DTensor``, or a plain tensor taken as replicated) with
    the placements ``pl`` on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t if list(pl) == list(t.placements) else t.redistribute(mesh, pl)


def _like(t, ref, dims_map):
    """``t`` on ``ref``'s mesh with, on each mesh dimension,
    ``Shard(dims_map[d])`` where ``ref`` is ``Shard(d)`` and ``d`` is in
    ``dims_map``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(dims_map[p.dim]) if p.is_shard() and p.dim in dims_map
          else Replicate() for p in ref.placements]
    return _placed(t, ref.device_mesh, pl)


def _unshard(t, dims):
    """``t`` with every mesh dimension that shards one of tensor ``dims``
    replicated (an all-gather over it); other placements kept."""
    from torch.distributed.tensor import Replicate
    return _placed(t, t.device_mesh,
                   [Replicate() if p.is_shard() and p.dim in dims else p
                    for p in t.placements])


def _block_start(mesh, dims, block: int) -> int:
    """The first index of this device's block of a dim split over the mesh
    dimensions ``dims`` (major first) in blocks of ``block``."""
    coord = mesh.get_coordinate()
    start = 0
    for i in dims:
        start = start * mesh.size(i) + coord[i]
    return start * block


def block_start_of(t, dim: int, block: int) -> int:
    """The first index of this device's block of ``t``'s dim ``dim`` (a
    ``DTensor``), blocks of ``block``; 0 where the dim is not split."""
    dims = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
    return _block_start(t.device_mesh, dims, block)


def gather_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with its dim ``dim`` whole on every device: on a ``DTensor``
    split there (a norm over a tensor-parallel projection's columns), an
    all-gather over the mesh dims that split it; otherwise ``t``."""
    return _unshard(t, {dim % t.ndim}) if is_dtensor(t) else t


def gather_axes(tree, axes):
    """Every ``DTensor`` leaf of ``tree`` (dicts, lists, tuples) with the
    mesh dimensions named in ``axes`` replicated (an all-gather over each:
    the FSDP gather of the weights' data-parallel shards before use, whose
    backward is the gradients' reduce-scatter); other leaves as they are,
    so a plain tree comes back leaf for leaf."""
    from repro_torch.tree import map_params
    from torch.distributed.tensor import Replicate

    def leaf(t):
        if not is_dtensor(t):
            return t
        names = t.device_mesh.mesh_dim_names
        return _placed(t, t.device_mesh,
                       [Replicate() if names[i] in axes else p
                        for i, p in enumerate(t.placements)])

    return map_params(leaf, tree)


class _Constrain(torch.autograd.Function):
    """``t`` redistributed to ``pl``, and its gradient too: the transpose
    of a sharding constraint constrains the cotangent alike, as JAX's
    ``with_sharding_constraint`` does, before it goes back to ``t``'s
    placements (a ``Partial`` one taken as ``Replicate``, as DTensor's
    backward takes it).  DTensor's own ``redistribute`` passes a
    ``Partial`` gradient through as it is, so the tensor-parallel partial
    sums of the residual stream's gradient would reach every branch
    unreduced, and each branch's backward products would gather their
    weights whole instead (16 times the FLOPs on the ``model`` axis)."""

    @staticmethod
    def forward(ctx, t, pl):
        from torch.distributed.tensor import Replicate
        ctx.pl = pl
        ctx.back = [Replicate() if p.is_partial() else p
                    for p in t.placements]
        return _placed(t, t.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        g = _placed(g, g.device_mesh, ctx.pl)
        return _placed(g, g.device_mesh, ctx.back), None


def constrain(t: torch.Tensor, *dim_axes) -> torch.Tensor:
    """``t`` with one entry of ``dim_axes`` a dim, as a spec's
    (``parallel/sharding.py``; ``"dp"`` names the data-parallel axes),
    fitted where the size divides: on a ``DTensor``, it and its gradient
    redistributed to that placement (the reference's
    ``with_sharding_constraint``); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from repro_torch.parallel import sharding as S
    mesh = t.device_mesh
    axes = [S.dp_axes(mesh) if a == "dp" else a for a in dim_axes]
    return _Constrain.apply(t, S.to_placements(
        mesh, S._spec(mesh, tuple(t.shape), *axes)))


def constrain_acts(x: torch.Tensor, seq_shard: bool = False) -> torch.Tensor:
    """The residual stream x [B, S, d], and each block branch where it
    joins it: on a ``DTensor`` the batch split over the data-parallel axes
    and, under ``seq_shard`` (``cfg.seq_shard_acts``), the sequence over
    ``model`` (the reference's ``_maybe_seq_shard``: the branches' partial
    sums are reduce-scattered, and the blocks' inputs all-gathered), else
    replicated there (the partial sums all-reduced), each where the size
    divides.  DTensor picks each op's placement greedily, and without this
    it carried the stream split over ``d``.  Plain tensors: x as it is."""
    return constrain(x, "dp", "model" if seq_shard else None, None)


# --------------------------------------------------------------------------
# Heads
# --------------------------------------------------------------------------
def split_last(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``t [..., prod(sizes)]`` as ``[..., *sizes]`` (heads out of a
    projection's columns).  A ``DTensor`` whose last dim is split over mesh
    dimensions whose product does not divide ``sizes[0]`` (whisper-base's
    8 heads, llama4-scout's 40, over the 16-wide ``model`` axis) is
    gathered there first: DTensor cannot split a dim unevenly, where the
    reference's XLA partitioner pads the split.  Every device then holds
    every head of its rows."""
    if is_dtensor(t):
        d = t.ndim - 1
        parts = math.prod(t.device_mesh.size(i)
                          for i, p in enumerate(t.placements)
                          if p.is_shard(d))
        if sizes[0] % parts:
            t = _unshard(t, {d})
    return t.reshape(*t.shape[:-1], *sizes)


class _UnshardGrad(torch.autograd.Function):
    """Identity whose backward gathers the gradient's last dim."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _unshard(g, {g.ndim - 1}) if is_dtensor(g) else g


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``t [..., H, hd]`` as ``[..., H * hd]`` (attention's output before
    its projection).  On a ``DTensor`` whose ``H`` some mesh dimension does
    not divide, the backward would split the gradient's merged dim over it
    and then fail to view it as heads: the gradient is gathered there
    first, as :func:`split_last` gathers the forward."""
    out = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if is_dtensor(t) and any(t.shape[-2] % n for n in t.device_mesh.shape):
        out = _UnshardGrad.apply(out)
    return out


def _heads_local(t, q, heads: int):
    """``t`` [B, T, Hk, ...] (keys, values, or SSD groups) as the local
    shard that goes with ``q``'s (its batch rows and, where ``q`` splits
    its heads, the same heads of ``heads``): split where ``q`` is, or, when
    the mesh dims that split ``q``'s heads do not divide ``Hk``, replicated
    there, repeated to ``heads`` and sliced to this device's heads."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    head_dims = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    parts = math.prod(mesh.size(i) for i in head_dims)
    Hk = t.shape[2]
    if Hk % parts == 0:
        return _placed(t, mesh, q.placements).to_local()
    loc = _placed(t, mesh, [Shard(0) if p.is_shard(0) else Replicate()
                            for p in q.placements]).to_local()
    loc = loc.repeat_interleave(heads // Hk, dim=2)
    block = heads // parts
    return loc.narrow(2, _block_start(mesh, head_dims, block), block)


def per_head_shard(fn, q, kv=(), rest=(), out_head_dims=(2,)):
    """``fn(q, *kv, *rest)`` run on each device's shard, for an operation
    independent across batch rows and heads (attention, the SSD scan and
    its decode step): q [B, S, H, ...] keeps its batch and head splits and
    is gathered on any other (the sequence, a partial sum); each of ``kv``
    [B, T, Hk, ...] is taken as :func:`_heads_local` gives it (a cache
    split over its sequence is gathered); each of ``rest`` is ``(tensor,
    batch dim, head dim)`` (either dim ``None``), split as ``q``'s rows and
    heads there (a ``None`` tensor stays ``None``).  Each output is split
    as ``q``'s rows and heads, its heads at its entry of
    ``out_head_dims``.  Plain tensors: ``fn`` as it is."""
    if not is_dtensor(q):
        return fn(q, *kv, *(t for t, _, _ in rest))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    q = _placed(q, mesh, [p if p.is_shard(0) or p.is_shard(2)
                          else Replicate() for p in q.placements])
    kv_l = [_heads_local(t, q, q.shape[2]) for t in kv]
    rest_l = []
    for t, bd, hd in rest:
        to = {0: bd, 2: hd}
        rest_l.append(None if t is None else _placed(t, mesh, [
            Shard(to[p.dim]) if p.is_shard() and to[p.dim] is not None
            else Replicate() for p in q.placements]).to_local())
    out = fn(q.to_local(), *kv_l, *rest_l)

    def wrap(o, hd):
        pl = [Shard(hd) if p.is_shard(2) else p for p in q.placements]
        return None if o is None else \
            DTensor.from_local(o, mesh, pl, run_check=False)

    if isinstance(out, tuple):
        return tuple(wrap(o, hd) for o, hd in zip(out, out_head_dims))
    return wrap(out, out_head_dims[0])


# --------------------------------------------------------------------------
# Lookups and writes by index
# --------------------------------------------------------------------------
def _vocab_parallel(x, idx, dim: int, take):
    """``take(local x, local ids, inside)``: each device looks up the ids
    that fall in its block of ``x``'s dim ``dim`` (the vocab; ``inside``
    marks them, the others read as zeros).  ``idx`` is split as ``x``'s
    dims before ``dim`` (the logits' rows), or else as it is (the tokens'
    batch), and replicated over the mesh dims that split the vocab.  The
    result, ``idx``'s shape followed by ``x``'s dims after ``dim``, is a
    partial sum over those mesh dims, reduced where it is next used."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    x = _placed(x, mesh, [p if p.is_shard() else Replicate()
                          for p in x.placements])
    vdims = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    own = idx.placements if is_dtensor(idx) else [Replicate()] * mesh.ndim
    idx = _placed(idx, mesh, [
        Shard(p.dim) if p.is_shard() and p.dim < dim else
        Replicate() if i in vdims or not o.is_shard() else o
        for i, (p, o) in enumerate(zip(x.placements, own))])
    xl, il = x.to_local(), idx.to_local()
    V = xl.shape[dim]
    rel = il - _block_start(mesh, vdims, V)
    out = take(xl, rel.clamp(0, V - 1), (rel >= 0) & (rel < V))
    pl = [Partial() if i in vdims else p
          for i, p in enumerate(idx.placements)]
    shape = (*idx.shape, *x.shape[dim + 1:])
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def embed_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (an embedding lookup: table [V, d], idx [...]
    int64).  On a ``DTensor`` table it is the vocab-parallel lookup
    (:func:`_vocab_parallel`): DTensor's own ``index`` fails there on
    torch 2.11 (an index split over ``("pod", "data")``, and the
    backward's ``index_put`` on a vocab-split table)."""
    if not is_dtensor(table):
        return table[idx]
    return _vocab_parallel(
        table, idx, 0,
        lambda t, i, inside: t[i] * inside[..., None].to(t.dtype))


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, idx[..., None])[..., 0]``: x [..., V], idx
    [...] (int64).  DTensor's gather refuses a sharded ``x`` (the
    cross-entropy's logits, vocab split over ``model``): on a ``DTensor``
    it is the vocab-parallel gather (:func:`_vocab_parallel`)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    return _vocab_parallel(
        x, idx, x.ndim - 1,
        lambda t, i, inside: torch.gather(t, -1, i[..., None])[..., 0]
        * inside.to(t.dtype))


def scatter_seq_(cache: torch.Tensor, new: torch.Tensor,
                 index: torch.Tensor) -> None:
    """``cache[b, index[b]:index[b]+S] = new[b]`` in place for every row
    (cache [B, T, ...], new [B, S, ...], index [B] int64) on a ``DTensor``
    cache: DTensor refuses an in-place ``index_put_`` on a cache split over
    ``(batch, heads)`` or ``(batch, seq)``.  ``new`` and ``index`` are
    split as the cache's batch and trailing dims (replicated over a mesh
    dimension that splits the sequence), and each device writes its shard
    with its rows, as an SPMD dynamic-update-slice does.  Where the
    sequence is split, a device holds one block of it; which block a row
    lands in depends on ``index``'s values, so the local write takes the
    positions modulo the block (the count is one device's write of the
    new rows, whatever the values)."""
    keep = {d: d for d in range(new.ndim) if d != 1}
    new_l = _like(new.to(cache.dtype), cache, keep).to_local()
    idx_l = _like(index, cache, {0: 0}).to_local()
    c = cache.to_local()
    S = new_l.shape[1]
    r = torch.arange(c.shape[0], device=c.device)
    cols = idx_l[:, None] + torch.arange(S, device=c.device)[None]
    if any(p.is_shard(1) for p in cache.placements):
        cols = cols.remainder(c.shape[1])
    c[r[:, None], cols] = new_l
