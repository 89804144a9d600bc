"""DTensor helpers at the points where the model meets an op that DTensor
cannot partition as it stands.

GSPMD partitions any XLA op: where it cannot keep an operand's sharding
through a reshape, a sort or a scatter, it gathers the operand first.
DTensor refuses such an op, or picks a costly strategy, instead.  The
model code calls these helpers there and does what GSPMD does:

  - ``reshape``: gathers a sharded dim that the new shape splits unevenly
    (two heads on a model axis of four) or merges behind another dim;
  - ``unshard``: gathers the named dims (the vocabulary for the loss),
    keeping the other placements;
  - ``rows_local``: a function on each rank's rows of the leading (batch
    or group) dim, the other dims whole: the MoE's per-group routing and
    dispatch (a sort and scatters within a group);
  - ``vocab_lookup``: the embedding lookup, vocab-parallel (each rank's
    block of the table, ids outside it masked, the results all-reduced);
  - ``local_heads``: math independent across batch rows and heads (the
    attention core, the SSD / mLSTM / sLSTM scans) on each rank's rows
    and heads;
  - ``local_map``: a function on given placements (the MoE's experts over
    'model');
  - ``pointwise``: an elementwise function DTensor has no rule for;
  - ``chunk_rows``: microbatches of each rank's own rows;
  - ``gather_full`` / ``replicated_like``: the kernel boundary
    (``kernels/ops.py``): a DTensor operand is gathered whole, the kernel
    runs on it, and the result comes back as a replicated DTensor.

Each is the identity on a plain tensor, so a run without a mesh takes the
same operations, bit for bit.  Where a helper runs a function on local
shards, an input that is whole over a mesh dim the computation splits
gets a partial gradient there (``_local``).  ``mesh_mode`` is the context
a mesh-placed step runs in: the hint rules, and plain tensors made inside
the model (masks, RoPE tables, aranges) taken as replicated where they
meet a DTensor.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch


_DTENSOR = None


def is_dtensor(x) -> bool:
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


@contextlib.contextmanager
def mesh_mode(mesh, table: dict):
    """The hint rules of ``table`` on ``mesh``, and implicit replication of
    plain tensors that meet DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import hints
    with hints.use_rules(mesh, table), implicit_replication():
        yield


def _shard_dims(x) -> dict:
    """Tensor dim -> the mesh dims that shard it."""
    from torch.distributed.tensor import Shard
    out: dict = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            out.setdefault(p.dim, []).append(i)
    return out


def unshard(x, *dims: int):
    """``x`` with the given tensor dims whole on every rank (each mesh dim
    that shards one of them replicated, the other placements kept);
    ``x`` itself when it is plain or none of them is sharded."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    nd = x.dim()
    want = {d % nd for d in dims}
    new = [Replicate() if isinstance(p, Shard) and p.dim in want else p
           for p in x.placements]
    if new == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, new)


def _view_groups(src: Sequence[int], dst: Sequence[int]) -> list:
    """Pairs (source dims, target dims) of equal products, left to right:
    the dims a reshape maps onto each other."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gs, gd, ps, pd = [], [], 1, 1
        if i < len(src):
            gs.append(i)
            ps *= src[i]
            i += 1
        if j < len(dst):
            gd.append(j)
            pd *= dst[j]
            j += 1
        while ps != pd:
            if ps < pd and i < len(src):
                gs.append(i)
                ps *= src[i]
                i += 1
            elif pd < ps and j < len(dst):
                gd.append(j)
                pd *= dst[j]
                j += 1
            else:
                break
        groups.append((gs, gd))
    return groups


def reshape(x, *shape):
    """``x.reshape(shape)``; for a DTensor, a sharded dim is gathered
    first unless it stays whole, or leads the dims it is merged with, or
    is split into dims whose first is divisible by its shard count (what
    DTensor's view can keep sharded)."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    if not is_dtensor(x):
        return x.reshape(shape)
    src = tuple(x.shape)
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        total = 1
        for s in src:
            total *= s
        shape = tuple(total // known if s == -1 else s for s in shape)
    sizes = x.device_mesh.shape
    sharded = _shard_dims(x)
    bad = []
    for gs, gd in _view_groups(src, shape):
        gs_big = [d for d in gs if src[d] != 1]
        gd_big = [d for d in gd if shape[d] != 1]
        for d in gs:
            if d not in sharded:
                continue
            m = 1
            for i in sharded[d]:
                m *= sizes[i]
            if gs_big[:1] != [d]:
                bad.append(d)           # merged behind another dim
            elif src[d] % m or (gd_big and shape[gd_big[0]] % m):
                bad.append(d)           # split unevenly
    return _Reshape.apply(unshard(x, *bad), shape)


class _Reshape(torch.autograd.Function):
    """A DTensor reshape whose backward goes through ``reshape`` too: the
    gradient may arrive sharded where the forward's input was not."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        # contiguous first: DTensor decides a view from the global strides,
        # which a gradient's local shard need not share
        return reshape(grad.contiguous(), ctx.src), None


def pointwise(fn: Callable, x):
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no rule for
    (``logsigmoid``'s backward): on a DTensor, ``fn`` runs on each rank's
    shard (partial sums reduced first) and the result keeps the shards'
    placements.  Autograd runs through it."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor
    x = unshard_partial(x)
    out = fn(x.to_local())
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def rows_local(fn: Callable, rows: Sequence, whole: Sequence = ()):
    """``fn(*rows, *whole)`` on each rank's share of the leading dim of
    ``rows`` (every other dim whole), the ``whole`` arguments replicated;
    every output of ``fn`` is per row and comes back sharded as its
    inputs were.  The leading dim is split over the mesh dims that shard
    dim 0 of the first of ``rows`` where they divide it, else not at all.
    Autograd runs through it.  Plain tensors call ``fn`` as it is."""
    if not any(is_dtensor(t) for t in (*rows, *whole)):
        return fn(*rows, *whole)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    lead = next(t for t in (*rows, *whole) if is_dtensor(t))
    mesh = lead.device_mesh
    n = rows[0].shape[0]
    first = rows[0] if is_dtensor(rows[0]) else lead
    split = [i for i, p in enumerate(first.placements)
             if isinstance(p, Shard) and p.dim == 0]
    m = 1
    for i in split:
        m *= mesh.shape[i]
    if n % m:
        split = []
    row_pl = [Shard(0) if i in split else Replicate()
              for i in range(mesh.ndim)]
    rep_pl = [Replicate()] * mesh.ndim

    def place(t, pl):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, rep_pl, run_check=False)
        return _local(t.redistribute(mesh, pl), split)

    out = fn(*[place(t, row_pl) for t in rows],
             *[place(t, rep_pl) for t in whole])

    def back(o):
        shape = (n, *o.shape[1:])
        return DTensor.from_local(o, mesh, row_pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))

    if isinstance(out, tuple):
        return tuple(back(o) for o in out)
    return back(out)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _local(x, split) -> torch.Tensor:
    """``x.to_local()`` for a computation split over the mesh dims
    ``split``: where ``x`` is whole on such a dim, each rank's gradient is
    a part of the sum (``Partial``), not the whole gradient."""
    from torch.distributed.tensor import Partial, Replicate
    grad = [Partial() if i in split and isinstance(p, Replicate) else p
            for i, p in enumerate(x.placements)]
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a local
    gradient leaves for DTensor, which decides views from global strides
    that a non-contiguous local shard does not have."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def follow(x, dims: dict) -> list:
    """Placements for a partner of DTensor ``x``: each mesh dim that
    shards ``x``'s dim ``d`` shards the partner's ``dims[d]``; every other
    mesh dim replicates."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
            else Replicate() for p in x.placements]


def local_map(fn: Callable, args: Sequence, in_placements: Sequence,
              out_placements):
    """``fn`` on each rank's shards: each argument is redistributed to its
    placements and ``fn`` runs on the local tensors; its result is a
    DTensor with ``out_placements`` (evenly sharded).  Autograd runs
    through it.  With no DTensor argument, ``fn(*args)``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import Shard
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    split = [i for i, p in enumerate(out_placements) if isinstance(p, Shard)]
    local = [_local(a.redistribute(mesh, pl), split)
             for a, pl in zip(args, in_placements)]
    return DTensor.from_local(fn(*local), mesh, out_placements,
                              run_check=False)


def vocab_lookup(table, tokens):
    """``table[tokens]``, the embedding lookup; on a mesh, vocab-parallel
    as Megatron and GSPMD do it.  Each rank keeps its block of the table's
    rows (the mesh dims that shard the vocabulary) and gathers the rest of
    its width (FSDP's all-gather), looks up its rows of the batch, gives 0
    for ids outside its block, and the blocks' results are summed over
    the vocabulary's mesh dims (one all-reduce of the (B, S, d) result).
    The table's gradient stays on each rank's block.  Plain tensors:
    ``table[tokens]``."""
    if not is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    block = 0           # this rank's block of rows, row-major over `vocab`
    for i in vocab:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    tok_pl = [Replicate() if i in vocab else p
              for i, p in enumerate(tokens.placements)]

    def lookup(tok, rows):
        ids = tok.long() - block * rows.shape[0]
        out = (ids < 0) | (ids >= rows.shape[0])
        return rows[ids.clamp(0, rows.shape[0] - 1)].masked_fill(
            out[..., None], 0)

    x = local_map(lookup, (tokens, table),
                  (tok_pl, [Shard(0) if i in vocab else Replicate()
                            for i in range(mesh.ndim)]),
                  [Partial() if i in vocab else p
                   for i, p in enumerate(tok_pl)])
    return unshard_partial(x)


def unshard_partial(x):
    """``x`` with its partial sums reduced (each ``Partial`` mesh dim
    replicated), the other placements kept."""
    from torch.distributed.tensor import Partial, Replicate
    new = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    if new == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, new)


def chunk_rows(x, n: int) -> tuple:
    """``x.chunk(n)`` on the leading dim; a DTensor sharded there is split
    on each rank's own rows, so every chunk keeps its placements."""
    from torch.distributed.tensor import Shard
    if not (is_dtensor(x) and any(isinstance(p, Shard) and p.dim == 0
                                  for p in x.placements)):
        return x.chunk(n, dim=0)
    from torch.distributed.tensor import DTensor
    return tuple(DTensor.from_local(c, x.device_mesh, x.placements,
                                    run_check=False)
                 for c in x.to_local().chunk(n, dim=0))


def axis_ranks(x, name: str) -> int:
    """The size of ``x``'s mesh axis ``name``; 1 for a plain tensor or a
    mesh without that axis."""
    if not is_dtensor(x) or name not in (x.device_mesh.mesh_dim_names or ()):
        return 1
    return x.device_mesh.size(x.device_mesh.mesh_dim_names.index(name))


def axis_rank(x, name: str) -> int:
    """This rank's coordinate on ``x``'s mesh axis ``name``."""
    return x.device_mesh.get_local_rank(name)


def local_heads(fn: Callable, args: Sequence, batch_dims: Sequence,
                head_dims: Sequence, out_batch_dims: Sequence,
                out_head_dims: Sequence):
    """``fn(*args)`` for math that is independent across batch rows and
    heads (attention's core, the SSD and mLSTM scans): on a mesh, each
    rank runs ``fn`` on its rows of the batch and, over the 'model' axis,
    its block of heads, and the outputs come back so sharded.

    ``batch_dims[i]`` / ``head_dims[i]`` name argument ``i``'s batch and
    head dims (``None``: it has none, and is whole over that axis);
    ``out_*`` the same for each output (``fn`` returns a tuple when more
    than one).  The batch is split over the mesh dims that split the
    first argument's batch dim; the heads over 'model' when it divides
    every head dim, else not at all (GQA: the query and the KV heads both,
    so a rank's query heads meet their own KV heads).  Non-tensor
    arguments pass through.  Autograd runs through it."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    first = args[0]
    mesh = first.device_mesh
    names = mesh.mesh_dim_names or ()
    sizes = mesh.shape
    tensors = [(a, b, h) for a, b, h in zip(args, batch_dims, head_dims)
               if isinstance(a, torch.Tensor)]
    roles = []
    split_b = 1
    for i, p in enumerate(first.placements):
        if (isinstance(p, Shard) and p.dim == batch_dims[0]
                and all(b is None or t.shape[b] % (split_b * sizes[i]) == 0
                        for t, b, _ in tensors)):
            roles.append("batch")
            split_b *= sizes[i]
        elif (i < len(names) and names[i] == "model"
              and any(h is not None for _, _, h in tensors)
              and all(h is None or t.shape[h] % sizes[i] == 0
                      for t, _, h in tensors)):
            roles.append("heads")
        else:
            roles.append(None)

    split = [i for i, r in enumerate(roles) if r is not None]

    def pl(b, h):
        return [Shard(b) if r == "batch" and b is not None else
                Shard(h) if r == "heads" and h is not None else Replicate()
                for r in roles]

    local = []
    for a, b, h in zip(args, batch_dims, head_dims):
        if not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(_local(a.redistribute(mesh, pl(b, h)), split))
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    placed = tuple(DTensor.from_local(o, mesh, pl(b, h), run_check=False)
                   for o, b, h in zip(outs, out_batch_dims, out_head_dims))
    return placed if isinstance(out, tuple) else placed[0]


def gather_full(x):
    """A DTensor's whole value as a plain tensor (partial sums reduced);
    a plain tensor as it is.  Where no mesh dim of more than one rank
    splits or sums it, its local tensor is that value, as it is (a view
    stays a view)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    if all(isinstance(p, Replicate) or n == 1
           for p, n in zip(x.placements, x.device_mesh.shape)):
        return x.to_local()
    return x.full_tensor()


def replicated_like(out: torch.Tensor, like):
    """``out`` as a replicated DTensor on ``like``'s mesh when ``like`` is
    a DTensor, else ``out``."""
    if not is_dtensor(like):
        return out
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
