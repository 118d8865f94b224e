"""The placements the model code fixes itself when it runs on DTensors.

Only the dry-runs (``launch/dryrun.py``) run the model on DTensors.  The
reference's GSPMD tiles each operation over every mesh axis it can and
reduces a row-parallel product's partial sums where it is made.
DTensor's propagation picks one placement an operation, carries partial
sums on, replicates a whole tensor where a view would split a sharded
dimension unevenly, and cannot flatten two sharded dimensions into one
(as an einsum over batch and heads does) before torch 2.13.  These
helpers make the reference's choice explicitly where DTensor's differs.
On plain tensors, and on a mesh of one rank (where DTensor's program is
the card's), each returns its arguments unchanged or computes what the
caller computed before, so no result of the port moves.

* ``batch_only``: the residual stream split over the batch axes alone and
  whole on the others, forward and backward, where GSPMD keeps it between
  blocks; ``grad_like``: a gradient placed as its tensor before a view.
* ``kv_for_local_heads``: GQA with q's heads split over an axis that k's
  and v's fewer heads do not divide (the rules replicate them there).
  Each rank takes the kv heads of its own q heads, as GSPMD tiles the
  (kv head, group) split; their gradient stays partial.
* ``reduced_once``: a partial gradient reduced once, before the
  optimizer's updates would each reduce it.
* ``along_batch``, ``batch_state``, ``take_rows``: positions, a
  recurrence's zero state and embedding rows made for a rank's own batch
  rows.
* ``local_attention``, ``local_call``: attention's core and the chunked
  scans run on each rank's local tensors (its batch rows and heads), with
  autograd's own graph of that local work kept from the forward and run
  in the backward.  Each call is a local region: the dispatch modes on
  the stack that count work (``launch.collectives.StepTrace``) are told
  how many ranks share it, so that a global FLOP count stays whole.
  (``local_map`` would splice the local graph into the step's, where its
  backward runs outside any region and cannot be counted so.)
* ``vocab_call``: the unembedding's blocked cast and product
  (``layers.unembed`` in serving) on each rank's rows and vocab shard.
* ``experts_call``: the MoE dispatch on each rank's tokens and experts,
  its collectives stated as GSPMD's program makes them
  (``gather_whole``, ``sum_partial``, ``sum_grad``: a local region's
  all-gathers and all-reduces, forward or backward).
* ``token_nll``: the loss's per-token negative log-likelihood; over more
  than one rank each rank takes its rows and vocab shard, and the max,
  the sum of exponentials and the gold logit are reduced over the
  vocab's axes (a vocab-parallel cross-entropy), where DTensor gathers
  the logits or their gradient whole.
"""
from __future__ import annotations

import contextlib
import math
import sys

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def local_region(scale: int):
    """A block whose operations on local tensors are one rank's share of
    work split ``scale`` ways: entered on each dispatch mode on the stack
    that has a ``local_region`` (the dry-run's trace), a no-op else."""
    stack = contextlib.ExitStack()
    for mode in _get_current_dispatch_mode_stack():
        enter = getattr(mode, "local_region", None)
        if enter is not None:
            stack.enter_context(enter(int(scale)))
    return stack


def caller() -> str:
    """``file:line`` of the innermost model frame outside this module on
    the stack ("" if none): a custom Function keeps it as ``ctx.site``,
    so that a collective its backward issues names the model line whose
    forward it follows (``launch.collectives.collective_site``)."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        at = path.rfind("repro_torch/models/")
        if at >= 0 and not path.endswith("/spmd.py"):
            return f"{path[at + len('repro_torch/'):]}:{f.f_lineno}"
        f = f.f_back
    return ""


def is_dtensor(t) -> bool:
    # no DTensor exists until its module is imported: a serving process
    # never imports it, and the check is a lookup and an isinstance
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def split(t) -> bool:
    """``t`` is a DTensor over more than one rank."""
    return is_dtensor(t) and t.device_mesh.size() > 1


def _batch_placements(t):
    """``t``'s placements with every one but its batch split (dim 0)
    replaced by ``Replicate``, but on axes of one rank, where every
    placement holds the whole and none is changed."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    return tuple(p if p == Shard(0) or mesh.size(i) == 1 else Replicate()
                 for i, p in enumerate(t.placements))


def _wrap(local, mesh, placements, shape):
    """A DTensor of global ``shape`` whose shard here is ``local`` (every
    shard alike: DTensor takes the global strides from ``local``'s)."""
    from torch.distributed.tensor import DTensor
    out = DTensor.from_local(local, mesh, placements, run_check=False)
    if out.shape != torch.Size(shape):
        raise ValueError(f"shards of {tuple(local.shape)} under "
                         f"{placements} make {tuple(out.shape)}, not "
                         f"{tuple(shape)}")
    return out


def _shards(mesh, placements) -> int:
    """Ranks that hold distinct shards under ``placements``."""
    return math.prod(mesh.size(i) for i, p in enumerate(placements)
                     if p.is_shard())


class _Place(torch.autograd.Function):
    """Redistribute to ``placements`` in the forward and the gradient to
    the same placements in the backward."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements, ctx.site = placements, caller()
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def batch_only(x):
    """``x`` (B, ...) split over the mesh axes that split its batch and
    whole on the rest (partial sums reduced), its gradient too; ``x``
    itself when plain or on one rank."""
    if not split(x):
        return x
    return _Place.apply(x, _batch_placements(x))


def grad_like(x):
    """``x``, its gradient redistributed to ``x``'s own placements (a
    view that DTensor can take forward may not take the gradient's
    placement backward); ``x`` itself when plain or on one rank."""
    if not split(x):
        return x
    return _Place.apply(x, x.placements)


def reduced_once(g):
    """A gradient ``g`` with each mesh axis on which it is partial reduced
    now, once: scattered over the first of its dims that the axis divides
    and no other axis splits (a reduce-scatter, DTensor's own choice where
    an update first meets it), else replicated.  Left partial, ``g`` would
    be reduced again at each use (AdamW's two moments); ``g`` itself when
    plain, on one rank or whole."""
    if not split(g) or not any(p.is_partial() for p in g.placements):
        return g
    from torch.distributed.tensor import Replicate, Shard
    mesh, local = g.device_mesh, list(g.to_local().shape)
    pl = list(g.placements)
    taken = {p.dim for p in pl if p.is_shard()}
    for i, p in enumerate(pl):
        if not p.is_partial():
            continue
        n = mesh.size(i)
        dim = next((d for d in range(g.dim())
                    if d not in taken and local[d] % n == 0),
                   None) if n > 1 else None
        if dim is None:
            pl[i] = Replicate()
        else:
            pl[i] = Shard(dim)
            taken.add(dim)
            local[dim] //= n
    return g.redistribute(mesh, pl)


def along_batch(pos, like):
    """``pos`` ((B, ...) or (1, ...), a plain tensor whole on every rank)
    as a DTensor over ``like``'s mesh, its batch split as ``like``'s (B,
    ...) dim 0 is; ``pos`` itself when ``like`` is a plain tensor or
    ``pos`` a DTensor."""
    if not is_dtensor(like) or is_dtensor(pos):
        return pos
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = like.device_mesh
    split_rows = pos.shape[0] == like.shape[0]
    pl = tuple(p if split_rows and p == Shard(0) else Replicate()
               for p in like.placements)
    return DTensor.from_local(pos, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, pl)


def batch_state(make, like, batch_dim: int):
    """``make(B)``, a dict of zero states whose dim ``batch_dim`` is the
    batch, for ``like``'s batch B; on a DTensor ``like``, made for this
    rank's rows and split over the batch's axes as ``like`` is."""
    if not is_dtensor(like):
        return make(like.shape[0])
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Shard(batch_dim) if p == Shard(0) else Replicate()
               for p in _batch_placements(like))
    out = {}
    for k, t in make(like.to_local().shape[0]).items():
        shape = list(t.shape)
        shape[batch_dim] = like.shape[0]
        out[k] = _wrap(t, like.device_mesh, pl, shape)
    return out


class _VocabParallelRows(torch.autograd.Function):
    """``table[idx].to(dtype)`` for a DTensor table (V, d) over more than
    one rank: each rank looks up the ids in its vocab shard and zeros the
    rest, casts its rows to ``dtype``, and the rows are summed over the
    vocab's axes and split by the batch as ``idx`` is (each token has one
    non-zero summand, so the sum in ``dtype`` has the bits of the cast of
    the sum, and moves ``dtype``'s bytes, as the reference's cast table's
    gather does); the table's gradient, in its own dtype, is each rank's
    rows summed into its shard, partial over the batch's axes."""

    @staticmethod
    def forward(ctx, table, idx, dtype):
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh = table.device_mesh
        vocab = tuple(i for i, p in enumerate(table.placements)
                      if p == Shard(0) and mesh.size(i) > 1)
        whole = tuple(Shard(0) if i in vocab else Replicate()
                      for i in range(mesh.ndim))
        rows = tuple(p if p == Shard(0) else Replicate()
                     for p in idx.placements)
        t = table.redistribute(mesh, whole).to_local()
        local = idx.redistribute(mesh, rows).to_local().long()
        local = local - shard_index(mesh, vocab) * t.shape[0]
        inside = (local >= 0) & (local < t.shape[0])
        local = local.clamp(0, t.shape[0] - 1)
        out = _reduce((t[local] * inside[..., None]).to(dtype), mesh, vocab,
                      "sum", rows)
        ctx.save_for_backward(local, inside)
        ctx.site = caller()
        ctx.meta = (mesh, t.shape, t.dtype, tuple(
            Partial() if p == Shard(0) else q
            for p, q in zip(rows, whole)), table.shape, rows)
        return _wrap(out, mesh, rows, tuple(idx.shape) + (t.shape[1],))

    @staticmethod
    def backward(ctx, g):
        local, inside = ctx.saved_tensors
        mesh, shape, dtype, grad_pl, table_shape, rows = ctx.meta
        g = g.redistribute(mesh, rows).to_local().to(dtype)
        grad = torch.zeros(shape, dtype=dtype, device=g.device)
        grad.index_add_(0, local.reshape(-1),
                        (g * inside[..., None]).reshape(-1, shape[1]))
        return _wrap(grad, mesh, grad_pl, table_shape), None, None


def take_rows(table, idx, dtype=None):
    """``table[idx].to(dtype)`` (``dtype`` None: the table's); for a
    DTensor table over more than one rank, the lookup in each rank's vocab
    shard (``_VocabParallelRows``), where DTensor's own gathers the table
    or the rows' gradient whole."""
    dtype = dtype or table.dtype
    if not split(table):
        return table[idx].to(dtype)
    if not is_dtensor(idx):
        from torch.distributed.tensor import DTensor, Replicate
        idx = DTensor.from_local(idx, table.device_mesh,
                                 [Replicate()] * table.device_mesh.ndim,
                                 run_check=False)
    return _VocabParallelRows.apply(table, idx, dtype)


def kv_for_local_heads(q, k, v, kv_groups: int):
    """(k, v, kv_groups) for attention of q (B, Sq, H, hd) over k, v (B,
    Sk, KV, hd) where q's heads are split over a mesh axis and k's are
    not (KV does not divide it): each rank's k and v are the kv heads its
    own H/n q heads read, a slice of its replicated copy, and the result
    is placed by heads as q is, with the kv heads and groups of that
    split.  Anything else comes back unchanged.

    The slice's gradient, each rank's share and zero outside the slice,
    stays partial over the axis: DTensor carries it by linearity through
    what made k and v (RoPE, the k-norm, the projection) into the input
    gradient's one reduction and the kv weights' gradient.  Reduced back
    to k's placement it would move the whole (B, Sk, KV, hd) k and v over
    the axis; reduced over the ranks that read the same kv heads (GSPMD's
    program), it would move the slice only for one of them to zero it,
    since a partial sum must count it once."""
    if not is_dtensor(q):
        return k, v, kv_groups
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, pq = q.device_mesh, q.placements
    axes = [i for i, p in enumerate(pq) if p == Shard(2)]
    if not axes or all(k.placements[i] == Shard(2) for i in axes):
        return k, v, kv_groups
    if len(axes) > 1:
        raise ValueError(f"q's heads split over mesh axes {axes}: one axis "
                         "is supported")
    [m] = axes
    n, rank = mesh.size(m), mesh.get_local_rank(m)
    local_h = q.shape[2] // n
    first = rank * local_h
    # k's own placements on the other axes (a cache's sequence may be
    # split over "data"), replicated over m, partial there in the backward
    whole = tuple(Replicate() if i == m else p
                  for i, p in enumerate(k.placements))
    grad = tuple(Partial() if i == m else p for i, p in enumerate(whole))
    placed = tuple(Shard(2) if i == m else p for i, p in enumerate(whole))
    if local_h % kv_groups and kv_groups % local_h:
        raise ValueError(f"{local_h} query heads a rank in groups of "
                         f"{kv_groups}: neither divides the other")
    lo = first // kv_groups
    hi = (first + local_h - 1) // kv_groups + 1
    groups = local_h // (hi - lo)

    def local_heads(t):
        # a redistribution, even one that moves nothing forward, would
        # reduce the partial gradient to t's placement in its backward
        if tuple(t.placements) != whole:
            t = t.redistribute(mesh, whole)
        part = t.to_local(grad_placements=grad)[:, :, lo:hi]
        return _wrap(part, mesh, placed, (t.shape[0], t.shape[1],
                                          n * part.shape[2], t.shape[3]))
    return local_heads(k), local_heads(v), groups


# ---- attention's core on local tensors -----------------------------------

def attend(q, k, v, bias, kv_groups: int):
    """The plain route's attention core: q (B, Sq, H, hd), k and v (B,
    Sk, KV, hd), ``bias`` (or a function that makes it, called once the
    scores are made) broadcast to the scores (B, KV, G, Sq, Sk); out (B,
    Sq, H, hd).  In bf16 the scores and probabilities round to bf16, as in
    the JAX package."""
    B, Sq, H, hd = q.shape
    q = q.reshape(B, Sq, k.shape[2], kv_groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    scores = scores / math.sqrt(hd)
    if callable(bias):
        bias = bias()
    probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def local_attention(q, k, v, bias, kv_groups: int):
    """``attend`` for DTensors over more than one rank: k and v placed as
    q on the batch and heads axes (``kv_for_local_heads`` first), the
    bias on the batch's, and each rank's core run on its own tensors."""
    from torch.distributed.tensor import Replicate, Shard
    pq = q.placements
    kv_pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                  for p in pq)
    bias = along_batch(bias, q)
    bias_pl = tuple(p if p == Shard(0) and bias.shape[0] == q.shape[0]
                    else Replicate() for p in pq)
    [out] = local_call(lambda *a: (attend(*a, kv_groups),),
                       [q, k, v, bias], [pq, kv_pl, kv_pl, bias_pl], [pq],
                       [q.shape])
    return out


# ---- any function of batch-and-heads tensors on local tensors ------------

class _Enter(torch.autograd.Function):
    """``x`` as an input of a kept local graph, its gradient read at this
    node's edge: the graph holds ``anchor`` (a scalar) where a leaf would
    hold ``x``'s storage."""

    @staticmethod
    def forward(ctx, x, anchor):
        return x.detach()

    @staticmethod
    def backward(ctx, g):
        return None, None


class _LocalCall(torch.autograd.Function):
    """``fn(*args)`` on each rank's local tensors, autograd's graph of it
    kept from the forward and run in the backward (its own graph task).
    The tensors that graph saves are this node's saved tensors, unpacked
    in the step's graph task: a checkpoint around the call drops them and
    recomputes them once, as it does the plain route's.  They stay live
    until ``fn`` returns, where the plain route under a checkpoint frees
    each as it goes."""

    @staticmethod
    def forward(ctx, fn, kwargs, out_meta, scale, partial, *args):
        local = [a.to_local() if is_dtensor(a) else a for a in args]
        wants = [i for i, a in enumerate(args)
                 if ctx.needs_input_grad[5 + i] and is_dtensor(a)]
        if not wants:
            with local_region(scale):
                outs = fn(*local, **kwargs)
            return tuple(_wrap(o, *m) for o, m in zip(outs, out_meta))
        saved, box = [], []

        def pack(t):
            saved.append(t.detach())
            return len(saved) - 1

        def unpack(i):              # each index is unpacked once
            t, box[i] = box[i], None
            return t

        with torch.enable_grad(), local_region(scale), \
                torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            anchor = torch.zeros((), device=local[wants[0]].device,
                                 requires_grad=True)
            for i in wants:
                local[i] = _Enter.apply(local[i], anchor)
            outs = fn(*local, **kwargs)
        get_edge = torch.autograd.graph.get_gradient_edge
        ctx.save_for_backward(*saved)
        saved.clear()               # the graph's hooks hold the list
        ctx.set_materialize_grads(False)    # an unused output's is None
        ctx.box, ctx.scale, ctx.out_meta = box, scale, out_meta
        ctx.partial = partial
        ctx.site = caller()
        ctx.ins = [(i, get_edge(local[i])) for i in wants]
        ctx.outs = [get_edge(o) if o.requires_grad else None for o in outs]
        ctx.arg_meta = [(a.device_mesh, a.placements, a.shape)
                        if is_dtensor(a) else None for a in args]
        return tuple(_wrap(o.detach(), *m) for o, m in zip(outs, out_meta))

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(e, g.redistribute(m[0], m[1]).to_local())
                 for e, g, m in zip(ctx.outs, grads, ctx.out_meta)
                 if e is not None and g is not None]
        out = [None] * len(ctx.arg_meta)
        if pairs:
            ctx.box.extend(ctx.saved_tensors)
            with local_region(ctx.scale):
                got = torch.autograd.grad([e for e, _ in pairs],
                                          [e for _, e in ctx.ins],
                                          [g for _, g in pairs],
                                          allow_unused=True)
            ctx.box.clear()
            # an argument whole on an axis that splits the work (a scan's
            # bonus over the batch) gets each rank's share: partial there
            # (``partial``; else the work is repeated there and each rank's
            # gradient is whole).  A gradient is handed on contiguous:
            # DTensor takes a global layout from the local one, and a view
            # of a transposed one would split a sharded dim (the plain
            # route's reshape copies)
            from torch.distributed.tensor import Partial
            work = ctx.out_meta[0][1]
            for (i, _), g in zip(ctx.ins, got):
                if g is not None:
                    mesh, pl, shape = ctx.arg_meta[i]
                    pl = tuple(Partial() if ctx.partial and p.is_replicate()
                               and w.is_shard() else p
                               for p, w in zip(pl, work))
                    out[i] = _wrap(g.contiguous(), mesh, pl, shape)
        ctx.ins = ctx.outs = None
        return (None, None, None, None, None, *out)


def local_call(fn, args, placements, out_placements, out_shapes,
               **kwargs):
    """``fn(*args, **kwargs)`` (a tuple of tensors) on each rank's local
    tensors: each DTensor argument redistributed to its entry of
    ``placements`` first, each output a DTensor of ``out_placements`` and
    ``out_shapes``.  The placements split the work so that the ranks that
    hold distinct shards of the first output share it evenly."""
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    placed = [a.redistribute(mesh, p) if is_dtensor(a) else a
              for a, p in zip(args, placements)]
    meta = [(mesh, p, s) for p, s in zip(out_placements, out_shapes)]
    return _LocalCall.apply(fn, kwargs, meta,
                            _shards(mesh, out_placements[0]), True, *placed)


def vocab_call(fn, x, table, vocab_dim: int):
    """``fn(x, table, vocab_dim)``, logits (B, ..., V) of ``x`` (B, ...,
    d) against a DTensor ``table`` whose vocab is its dim ``vocab_dim``, on
    each rank's local tensors: ``x`` split by its batch alone, the table
    by its vocab alone but on an axis that splits the batch, the logits as
    both."""
    from torch.distributed.tensor import Replicate, Shard
    xp = _batch_placements(x)
    tp = tuple(p if p == Shard(vocab_dim) and q != Shard(0) else Replicate()
               for p, q in zip(table.placements, xp))
    op = tuple(Shard(0) if q == Shard(0) else Shard(x.dim() - 1)
               if p == Shard(vocab_dim) else Replicate()
               for p, q in zip(tp, xp))
    [out] = local_call(lambda a, b: (fn(a, b, vocab_dim),), [x, table],
                       [xp, tp], [op],
                       [tuple(x.shape[:-1]) + (table.shape[vocab_dim],)])
    return out


def heads_call(fn, args, specs, out_specs, out_shapes, **kwargs):
    """``local_call`` for a function of batch-and-heads tensors (the
    scans): ``specs`` and ``out_specs`` give each argument's and output's
    (has a batch at dim 0, its heads' dim or None).  The batch splits as
    the first argument with a batch does; the heads over the last other
    axis of more than one rank that divides them."""
    from torch.distributed.tensor import Replicate, Shard
    ref = next(a for a, (b, _) in zip(args, specs) if b and is_dtensor(a))
    mesh = ref.device_mesh
    rows = [i for i, p in enumerate(ref.placements) if p == Shard(0)]
    heads = ref.shape[specs[args.index(ref)][1]]
    axes = [i for i in range(mesh.ndim) if i not in rows
            and mesh.size(i) > 1 and heads % mesh.size(i) == 0]

    def placements(batch, head):
        return tuple(Shard(0) if batch and i in rows
                     else Shard(head) if axes and i == axes[-1]
                     and head is not None else Replicate()
                     for i in range(mesh.ndim))
    return local_call(fn, args, [placements(*s) for s in specs],
                      [placements(*s) for s in out_specs], out_shapes,
                      **kwargs)


# ---- collectives a local region states itself ---------------------------------

def shard_index(mesh, axes) -> int:
    """This rank's index among the shards of a dim split over mesh
    ``axes`` (the first major), as DTensor orders them."""
    first = 0
    for i in axes:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    return first


def _whole(local, mesh, placements):
    """The local tensor of ``local`` under ``placements`` made whole on
    every rank (gathered or summed)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(local, mesh, placements,
                              run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


def _on(mesh, axes, placement):
    from torch.distributed.tensor import Replicate
    return [placement if i in axes else Replicate() for i in range(mesh.ndim)]


class _GatherWhole(torch.autograd.Function):
    """``x``'s shards over ``axes`` along ``dim`` gathered whole; its
    gradient, alike on every rank, sliced back to this rank's shard."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        from torch.distributed.tensor import Shard
        ctx.meta, ctx.site = (mesh, axes, dim, x.shape[dim]), caller()
        return _whole(x, mesh, _on(mesh, axes, Shard(dim)))

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, n = ctx.meta
        return (g.narrow(dim, shard_index(mesh, axes) * n, n), None, None,
                None)


class _SumPartial(torch.autograd.Function):
    """Partial sums over ``axes`` reduced; the gradient, alike on every
    rank, passed on as it is."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        from torch.distributed.tensor import Partial
        ctx.site = caller()
        return _whole(x, mesh, _on(mesh, axes, Partial()))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """``x`` as it is, read by each rank of ``axes`` for its own share;
    the gradient's partial sums reduced over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.meta, ctx.site = (mesh, axes), caller()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial
        mesh, axes = ctx.meta
        return _whole(g.contiguous(), mesh, _on(mesh, axes, Partial())), \
            None, None


def gather_whole(x, mesh, axes, dim: int):
    """In a local region: ``x`` split over mesh ``axes`` along ``dim``,
    all-gathered; its gradient must be alike on every rank."""
    return _GatherWhole.apply(x, mesh, tuple(axes), dim) if axes else x


def sum_partial(x, mesh, axes):
    """In a local region: partial sums over ``axes`` all-reduced; the
    gradient must be alike on every rank of ``axes``."""
    return _SumPartial.apply(x, mesh, tuple(axes)) if axes else x


def sum_grad(x, mesh, axes):
    """In a local region: ``x``, alike on the ranks of ``axes``, each of
    which reads a share of it; its gradient all-reduced over them."""
    return _SumGrad.apply(x, mesh, tuple(axes)) if axes else x


def experts_call(fn, logits, xf, experts, **kwargs):
    """The MoE dispatch ``fn(logits, xf, *experts, axes=(mesh, rows,
    split), **kwargs)`` -> (out (T, d), aux ()) on each rank's local
    tensors, placed as the reference's GSPMD places it: the tokens ``xf``
    (T, d) split over the mesh axes that split the batch (``rows``), the
    experts' stacks (E, ...) over the other axes the rules split E on
    (``split``) and whole on the rest, ``logits`` (T, E) split as both;
    ``out`` split as ``xf``, ``aux`` whole.  ``fn`` states its collectives
    (``gather_whole``, ``sum_partial``, ``sum_grad``).  The experts'
    products repeat on each rank of ``rows``, as in GSPMD's program: each
    argument's gradient is placed as the argument (whole where it is
    whole), and the FLOPs count that work once over the ranks of
    ``split``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = xf.device_mesh
    rows = tuple(i for i, p in enumerate(xf.placements)
                 if p == Shard(0) and mesh.size(i) > 1)
    split = tuple(i for i, p in enumerate(experts[0].placements)
                  if p == Shard(0) and mesh.size(i) > 1 and i not in rows)
    xp, ep = _on(mesh, rows, Shard(0)), _on(mesh, split, Shard(0))
    lp = [Shard(1) if i in split else p for i, p in enumerate(xp)]
    placed = [a.redistribute(mesh, p) for a, p in
              zip([logits, xf, *experts], [lp, xp] + [ep] * len(experts))]
    meta = [(mesh, tuple(xp), xf.shape),
            (mesh, (Replicate(),) * mesh.ndim, ())]
    return _LocalCall.apply(fn, dict(kwargs, axes=(mesh, rows, split)), meta,
                            math.prod(mesh.size(i) for i in split), False,
                            *placed)


# ---- the loss --------------------------------------------------------------

def _reduce(local, mesh, axes, op: str, rows):
    """``local`` (a rank's partial ``op``-reduction over the vocab's
    ``axes``) reduced over them: the local tensor of the result, whole
    on every axis but the batch's (``rows``)."""
    from torch.distributed.tensor import DTensor, Partial
    pl = tuple(Partial(op) if i in axes else p for i, p in enumerate(rows))
    return DTensor.from_local(local, mesh, pl, run_check=False).redistribute(
        mesh, rows).to_local()


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] per token for DTensor logits (B, S, V)
    split over their batch and the ``vocab`` mesh axes (see
    ``token_nll``).  It holds what the plain route's autograd holds, the
    f32 logits, and makes the temporaries its kernels make: ``(x -
    max).exp_()`` in the forward, and ``exp(x - logz)`` times the
    gradient in the backward."""

    @staticmethod
    def forward(ctx, logits, labels, vocab):
        from torch.distributed.tensor import Replicate, Shard
        mesh = logits.device_mesh
        placed = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                       for p in logits.placements)
        rows = tuple(p if p == Shard(0) else Replicate() for p in placed)
        x = logits.redistribute(mesh, placed).to_local().float()
        lab = labels.redistribute(mesh, rows).to_local().long()
        width = x.shape[-1]
        first = shard_index(mesh, vocab) * width   # this rank's first id
        top = _reduce(x.amax(-1), mesh, vocab, "max", rows)
        total = _reduce((x - top[..., None]).exp_().sum(-1), mesh, vocab,
                        "sum", rows)
        logz = torch.log(total) + top
        idx = lab - first
        inside = (idx >= 0) & (idx < width)
        idx = idx.clamp(0, width - 1)[..., None]
        gold = _reduce(torch.where(inside, x.gather(-1, idx)[..., 0], 0.0),
                       mesh, vocab, "sum", rows)
        ctx.save_for_backward(x, logz, idx, inside)
        ctx.site = caller()
        ctx.meta = (mesh, placed, rows, logits.shape, logits.dtype)
        return _wrap(logz - gold, mesh, rows, labels.shape)

    @staticmethod
    def backward(ctx, g):
        x, logz, idx, inside = ctx.saved_tensors
        mesh, placed, rows, shape, dtype = ctx.meta
        g = g.redistribute(mesh, rows).to_local()
        grad = (x - logz[..., None]).exp_().mul_(g[..., None])
        grad.scatter_add_(-1, idx, -torch.where(inside, g, 0.0)[..., None])
        return _wrap(grad.to(dtype), mesh, placed, shape), None, None


def token_nll(logits, labels):
    """-log softmax(logits)[label] in f32 per token: logits (B, S, V),
    labels (B, S) -> (B, S): ``torch.logsumexp`` less the gathered gold
    logit.  On DTensor logits over more than one rank (DTensor would make
    the gather's gradient whole on every rank): each rank's rows and vocab
    shard, the max, the sum of exponentials and the gold logit reduced
    over the mesh axes of more than one rank that split the vocab; the
    gradient placed as the logits."""
    if split(logits):
        from torch.distributed.tensor import Shard
        mesh = logits.device_mesh
        vocab = tuple(i for i, p in enumerate(logits.placements)
                      if p == Shard(2) and mesh.size(i) > 1)
        return _VocabParallelNLL.apply(logits, labels, vocab)
    logits = logits.float()
    # the last dim named by its index: DTensor shards a gather's backward
    # only along a non-negative dim; the trailing unit dim is dropped
    # after the subtraction
    last = logits.dim() - 1
    logz = torch.logsumexp(logits, dim=last, keepdim=True)
    gold = torch.gather(logits, last, labels[..., None].long())
    return (logz - gold)[..., 0]
