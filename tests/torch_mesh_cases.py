"""Multi-rank cases of the port's mesh runtime, for the tests on the CPU.

``run_world(n, fn, *args)`` runs ``fn(rank, n, *args)`` on each rank of an
n-rank gloo group and returns the results in rank order: n spawned CPU
processes over a file store in a fresh temporary directory (n = 1 runs in
this process, over a ``HashStore``).  The case functions below are what
the ranks run; each returns plain numbers and numpy arrays.  This module
imports no JAX and nothing of the JAX package: the workers start from a
fresh import of it, and the tests hold its results against the reference
in their own process.
"""
import multiprocessing
import os
import queue as queue_mod
import tempfile
import traceback
import types

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.paper_models import SmallNetConfig

# the CNN of tests/test_torch_cnn_client.py
TINY = SmallNetConfig("tiny", "cnn", 28, 1, hidden=16, conv_channels=(4, 8))


def _entry(rank, n, store, fn, args, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n)
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:                   # reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))


def run_world(n: int, fn, *args, timeout: float = 300.0):
    """[fn(rank, n, *args) for each rank] of an n-rank gloo world."""
    if n == 1:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            return [fn(0, 1, *args)]
        finally:
            dist.destroy_process_group()
            torch.set_num_threads(threads)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_entry,
                             args=(r, n, os.path.join(tmp, "store"), fn,
                                   args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got, failed = {}, None
        try:
            for _ in range(n):
                rank, ok, out = results.get(timeout=timeout)
                if not ok:
                    failed = f"rank {rank} of {n} failed:\n{out}"
                    break
                got[rank] = out
        except queue_mod.Empty:
            failed = f"a rank of {n} gave no result in {timeout} s"
        finally:
            for p in procs:
                if failed:
                    p.kill()
                p.join(timeout=60)
        if failed:
            raise RuntimeError(failed)
        assert not any(p.is_alive() for p in procs)
    return [got[r] for r in range(n)]


def _np(t):
    return t.detach().cpu().numpy()


def _tensor(a):
    """A tensor of its own holding numpy array ``a``."""
    return torch.from_numpy(np.array(a))


# ---- launch/mesh.py -------------------------------------------------------

MESH_SHAPES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (4, 1), (8, 1),
               (3, 1), (1, 3))


def mesh_case(rank, n):
    """For each requested (data, model): the mesh's shape and coordinates,
    each axis's ranks, and the sum of (rank + 1) over each axis group."""
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
    out = {}
    for shape in MESH_SHAPES:
        m = make_host_mesh(*shape, device="cpu")
        rec = {"shape": m.shape, "coords": m.coords}
        if m.coords is not None:
            for ax in m.axis_names:
                t = torch.tensor([float(rank + 1)])
                dist.all_reduce(t, group=m.group(ax))
                rec[ax] = (m.ranks(ax), float(t))
        out[shape] = rec
    d = make_data_mesh(device="cpu")
    out["data_mesh"] = {"shape": d.shape, "coords": d.coords}
    return out


# ---- fl/sharded.py ----------------------------------------------------------

def _fl_loss(kind, cfg):
    if kind == "linreg":
        def loss(params, batch):
            x, y = batch
            return torch.mean((x @ params["w"] - y) ** 2)
    elif kind == "const":
        def loss(params, batch):
            return torch.mean((params["w"] - batch) ** 2)
    else:
        from repro_torch.models import registry as R

        def loss(params, batch):
            return R.train_loss(params, cfg, {"tokens": batch},
                                impl="plain")[0]
    return loss


def fl_round_case(rank, n, cases):
    """Each case (name, loss kind, model config or None, params, batches,
    weights, J, lr, rounds) through ``make_fl_round`` on a data mesh over
    every rank, ``rounds`` rounds from the params: [(new params, mean
    loss) a round]."""
    from repro_torch.fl.sharded import make_fl_round
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_map
    mesh = make_host_mesh(data=n, device="cpu")
    out = {}
    for name, kind, cfg, params, batches, weights, J, lr, rounds in cases:
        fl_round = make_fl_round(_fl_loss(kind, cfg), mesh, local_iters=J,
                                 lr=lr)
        p = tree_map(_tensor, params)
        b = (tuple(torch.from_numpy(x) for x in batches)
             if isinstance(batches, tuple) else torch.from_numpy(batches))
        res = []
        for _ in range(rounds):
            p, loss = fl_round(p, b, torch.from_numpy(weights))
            res.append((tree_map(_np, p), float(loss)))
        out[name] = res
    return out


# ---- models/moe_ep.py -------------------------------------------------------

def moe_ep_case(rank, n, cfg, params, x, meshes, factor):
    """``make_ep_moe_layer`` on each (data, model) mesh of ``meshes`` that
    uses all n ranks: {mesh: (out, aux, dropped)}."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe_ep import make_ep_moe_layer
    from repro_torch.tree import tree_map
    p = tree_map(_tensor, params)
    xt = _tensor(x)
    out = {}
    for shape in meshes:
        if shape[0] * shape[1] != n:
            continue
        mesh = make_host_mesh(*shape, device="cpu")
        moe = make_ep_moe_layer(cfg, mesh, capacity_factor=factor)
        y, aux = moe(p, xt)
        out[shape] = (_np(y), float(aux), int(moe.dropped))
    return out


# ---- core/epoch_step.py and the simulator -----------------------------------

def synthetic_train_fn(params, inputs, ids, seed):
    """The fused step's train function of tests/test_scale_sharding.py:
    every participant's row is the global model moved by an offset of its
    id, the seed and its input."""
    from repro_torch.core.modelbank import FlatSpec
    flat = FlatSpec.of(params).flatten(params)
    ids = torch.as_tensor(np.asarray(ids, np.int64))
    offs = (((ids * 37 + int(seed)) % 11) - 5).to(torch.float32) * 0.01
    stack = flat[None, :] * 0.9 + offs[:, None] + inputs[:, None]
    return stack, offs


SYNTH_W0 = {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
            "b": np.ones(8, np.float32)}


def synthetic_step_inputs(C: int, layout: str):
    """The step arguments of tests/test_scale_sharding.py's program run at
    C participants: blocked or one-hot new-orbit layout, 2 carried rows of
    weight, and late rows to read back."""
    cap, K = 8, 2
    rng = np.random.default_rng(C)
    ids = np.arange(C, dtype=np.int32)
    inputs = np.linspace(0.0, 1.0, C).astype(np.float32)
    wv = (np.linspace(0.1, 0.2, C) / C).astype(np.float32)
    wc = np.zeros(cap, np.float32)
    wc[:2] = 0.05
    carry = rng.standard_normal((cap, 32)).astype(np.float32) * 0.1
    dwc = np.zeros((K, cap), np.float32)
    dwc[1, 0] = 0.25
    if layout == "blocked":
        blocked_m = C // K
        dw_row = np.full(C, 1.0 / C, np.float32)
        dw_seg = np.repeat(np.arange(K), C // K).astype(np.int32)
    else:
        blocked_m = 0
        dw_seg = (np.arange(C) % (K + 1)).astype(np.int32)   # K = dump
        dw_row = np.where(dw_seg < K, 3.0 / C, 0.0).astype(np.float32)
    late = [1, C // 2 + 1, C - 1]
    return dict(ids=ids, inputs=inputs, wv=wv, wc=wc, carry=carry,
                dwc=dwc, dw_row=dw_row, dw_seg=dw_seg, K=K,
                blocked_m=blocked_m, late=late)


def _synthetic_run(C, layout, mesh, fallback):
    from repro_torch.core import epoch_step as es
    from repro_torch.core.epoch_step import (EpochStepProgram, combine_stack,
                                             stack_rows)
    from repro_torch.core.modelbank import FlatSpec
    calls = []

    def counted(*args, **kw):          # fed_agg calls of the step itself
        calls.append(1)
        return fed_agg(*args, **kw)
    w0 = {k: torch.from_numpy(v) for k, v in SYNTH_W0.items()}
    spec = FlatSpec.of(w0)
    a = synthetic_step_inputs(C, layout)
    prog = EpochStepProgram(spec, synthetic_train_fn, mesh=mesh)
    w_flat = spec.flatten(w0)
    carry = torch.from_numpy(a["carry"])
    ref = torch.zeros(spec.num_params)
    wv, wc, base_w = a["wv"], a["wc"], 0.5
    if fallback:
        wv, wc, base_w = np.zeros_like(wv), np.zeros_like(wc), 1.0
    fed_agg, es.fed_agg = es.fed_agg, counted
    try:
        new_w, stack, dists, losses = prog.step(
            w_flat, carry, torch.from_numpy(a["inputs"]), a["ids"], 7, wv,
            wc, base_w, a["dw_row"], a["dw_seg"], a["K"], a["blocked_m"],
            a["dwc"], ref, fallback=fallback, late_rows=a["late"])
    finally:
        es.fed_agg = fed_agg
    if fallback:        # the simulator's fallback: combine after the step
        new_w = combine_stack(stack, a["wv"], carry, a["wc"], new_w, 0.5)
    try:                # a sharded bank holds only the rows asked for
        stack_rows(stack, [0, C - 2])
        refuses = False
    except ValueError:
        refuses = True
    return dict(w=_np(new_w), dists=_np(dists), losses=_np(losses),
                late=_np(stack_rows(stack, a["late"])), refuses=refuses,
                local=(tuple(getattr(stack, "local", stack).shape)),
                fed_agg_calls=len(calls),
                dispatches=(prog.dispatches, prog.fallback_dispatches))


def epoch_step_case(rank, n, C_bank, steps):
    """(a) ``sharded_contract`` over a C_bank-row bank made from seed 0,
    each rank passing its C_bank/n rows; (b) each (C, layout, fallback)
    of ``steps`` through the sharded program on a data mesh over every
    rank, and through the unsharded program in the same process."""
    from repro_torch.core.epoch_step import sharded_contract
    from repro_torch.launch.mesh import make_data_mesh
    mesh = make_data_mesh(device="cpu")
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((C_bank, 32)).astype(np.float32)
    w = rng.random(C_bank).astype(np.float32)
    m = C_bank // n
    got = sharded_contract(torch.from_numpy(w[rank * m:(rank + 1) * m]),
                           torch.from_numpy(bank[rank * m:(rank + 1) * m]),
                           mesh)
    out = {"contract": _np(got), "rows": m}
    for C, layout, fallback in steps:
        out[(C, layout, fallback)] = {
            "mesh": _synthetic_run(C, layout, mesh, fallback),
            "single": _synthetic_run(C, layout, None, fallback)}
    return out


def forget_first_orbit(sim):
    """Drop the lowest-numbered orbit from the grouping state, as if it had
    never been seen (tests/test_torch_slice.py): its next arrival is a new
    orbit again, and with stale models pending the epoch takes the
    fallback split."""
    sim._resolve_pending_dists()
    g = sim.grouping
    o = sorted(g.distances)[0]
    del g.distances[o]
    g.groups = [[x for x in grp if x != o] for grp in g.groups]
    g.groups = [grp for grp in g.groups if grp]


def simulation_case(rank, n, w0, table, scheme, epochs, kw, sim_kw,
                    forget_at=None):
    """A ``FLSimulation`` of ``scheme`` (``SimConfig(**sim_kw)``) on a data
    mesh over every rank, at TINY width (pool keywords ``kw``), with the
    minibatch indices of ``table`` ((seed, sat) -> (J, b)); at epoch
    ``forget_at`` the first orbit is forgotten.  Returns the history, the
    final flat model, the groups, the carried stragglers and the step
    counts."""
    from repro_torch.core.simulator import FLSimulation, SimConfig
    from repro_torch.fl.strategies import get_strategy
    from repro_torch.fl_constellation_sim import build_workload
    from repro_torch.launch.mesh import make_data_mesh

    def indices(seed, ids):
        return torch.stack([torch.from_numpy(table[(int(seed), int(s))])
                            for s in ids])

    work = build_workload(iid=True, device="cpu", cfg=TINY, num_train=400,
                          num_test=100,
                          w0={k: torch.from_numpy(v) for k, v in w0.items()},
                          batch_indices=indices, **kw)
    class Sim(FLSimulation):
        def _fused_epoch(self, prog, beta, *args):
            if beta == forget_at:
                forget_first_orbit(self)
            return super()._fused_epoch(prog, beta, *args)

    mesh = make_data_mesh(device="cpu")
    sim = Sim(get_strategy(scheme), work.pool, work.evaluator,
              SimConfig(duration_s=86400.0, mesh=mesh, **sim_kw))
    hist = sim.run(work.w0, max_epochs=epochs)
    prog = sim._fused_prog
    return dict(history=[vars(r) for r in hist], w=_np(sim._w_flat),
                groups=sim.grouping.groups,
                pend=[m[:2] for m in sim._pend_meta],
                steps=(prog.dispatches, prog.fallback_dispatches))


# ---- models/spmd.py: the dry-run's local regions on real data ----------------

def kv_heads_before(q, k, v, kv_groups: int):
    """``models/spmd.py``'s ``kv_for_local_heads`` as it was before the kv
    slice's gradient was left partial: k and v redistributed to their
    own placement first, whose backward reduces the gradient of the
    whole k and v over the axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models import spmd
    mesh, pq = q.device_mesh, q.placements
    axes = [i for i, p in enumerate(pq) if p == Shard(2)]
    if not axes or all(k.placements[i] == Shard(2) for i in axes):
        return k, v, kv_groups
    [m] = axes
    n = mesh.size(m)
    local_h = q.shape[2] // n
    first = mesh.get_local_rank(m) * local_h
    whole = tuple(Replicate() if i == m else p
                  for i, p in enumerate(k.placements))
    grad = tuple(Partial() if i == m else p for i, p in enumerate(whole))
    placed = tuple(Shard(2) if i == m else p for i, p in enumerate(whole))
    lo = first // kv_groups
    hi = (first + local_h - 1) // kv_groups + 1

    def local_heads(t):
        part = t.redistribute(mesh, whole).to_local(
            grad_placements=grad)[:, :, lo:hi]
        return spmd._wrap(part, mesh, placed, (t.shape[0], t.shape[1],
                                               n * part.shape[2],
                                               t.shape[3]))
    return local_heads(k), local_heads(v), local_h // (hi - lo)


def spmd_case(rank, n):
    """On a (2, n/2) ("data", "model") mesh of CPU ranks: the loss, the
    embedding lookup (f32 and bf16 rows), GQA attention (1 kv head under 4
    query heads; also under ``torch.utils.checkpoint``; and the whole
    block, its qk-norm, RoPE and projections, from weights placed as the
    dry-run's rules place them), the MoE FFN (with and without dropped
    assignments) and MLA's prefill, the chunked and sequential scans, a
    decode step and serving's unembedding on DTensors placed as the
    dry-run places them, and on the same plain tensors: each output and
    gradient, whole, as numpy (rank 0's; the others return None).
    ``res["bits"]``: the lookup (rows cast before the vocab's reduction)
    and attention (the kv slice's gradient left partial) against the
    routes before them on the same DTensors, in f32 and bf16: the
    outputs and gradients of both."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import layers as L
    from repro_torch.models import scan_ops, spmd
    mesh = DeviceMesh("cpu", torch.arange(n).view(2, n // 2),
                      mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(0)

    def draw(*shape):
        return torch.randn(shape, generator=gen)

    def run(fn, xs):
        """fn's outputs and the gradients of their weighted sum (in f32),
        whole, as numpy."""
        leaves = [t.detach().requires_grad_(t.is_floating_point())
                  for t in xs]
        with implicit_replication():    # plain positions, as in the step
            got = fn(*leaves)
            got = [g.full_tensor() if spmd.is_dtensor(g) else g
                   for g in (got if isinstance(got, tuple) else (got,))]
            total = sum((g.float() * torch.linspace(
                0.5, 1.5, g.numel()).view(g.shape)).sum() for g in got)
            total.backward()
        grads = [t.grad.full_tensor() if spmd.is_dtensor(t.grad)
                 else t.grad for t in leaves if t.requires_grad]
        return [_np(t.float()) for t in got + grads]

    def placed(plain, placements):
        return [distribute_tensor(t, mesh, p)
                for t, p in zip(plain, placements)]

    def both(fn, plain, placements):
        """``run`` on the plain tensors and on their DTensors."""
        return {"plain": run(fn, plain),
                "split": run(fn, placed(plain, placements))}

    S0, R = Shard(0), Replicate()
    B, T, V, d = 4, 8, 12, 6
    res = {}
    labels = torch.randint(0, V, (B, T), generator=gen)
    res["token_nll"] = both(lambda x, y: spmd.token_nll(x, y),
                            [draw(B, T, V), labels],
                            [[S0, Shard(2)], [S0, R]])
    res["take_rows"] = both(lambda w, i: spmd.take_rows(w, i),
                            [draw(V, d), labels], [[R, S0], [S0, R]])
    res["take_rows_bf16"] = both(
        lambda w, i: spmd.take_rows(w, i, torch.bfloat16),
        [draw(V, d), labels], [[R, S0], [S0, R]])
    H, KV, hd = 4, 1, 8
    pos = torch.arange(T)[None].expand(B, T)
    qkv = [draw(B, T, H, hd), draw(B, T, KV, hd), draw(B, T, KV, hd)]

    def attention(q, k, v):
        return L.attention_scores(q, k, v, pos, pos, causal=True, window=3,
                                  kv_groups=H // KV)
    res["attention"] = both(attention, qkv,
                            [[S0, Shard(2)], [S0, R], [S0, R]])
    # under remat, as the dry-run's train step runs it: the local graph's
    # saved tensors dropped with the layer's and recomputed
    res["attention_remat"] = both(
        lambda *a: checkpoint(attention, *a, use_reentrant=False), qkv,
        [[S0, Shard(2)], [S0, R], [S0, R]])
    # the whole block from its weights: q's heads and wo split over
    # "model", the one kv head's weights whole there (the rules replicate
    # what the axis does not divide), the kv gradient carried partial
    # through RoPE, the k-norm and the projection
    cfg = types.SimpleNamespace(num_heads=H, num_kv_heads=KV,
                                resolved_head_dim=hd, qk_norm=True,
                                use_rope=True, rope_theta=10000.0,
                                causal=True)

    def block(x, wq, wk, wv, wo, qn, kn):
        p = dict(wq=wq, wk=wk, wv=wv, wo=wo, q_norm=qn, k_norm=kn)
        return L.attention(p, cfg, x, pos, window=3, impl="plain")[0]
    dm = 4 * hd
    fan = dm ** -0.5                   # the model's fan-in scale
    res["attention_block"] = both(
        block, [draw(B, T, dm), draw(dm, H, hd) * fan, draw(dm, KV, hd) * fan,
                draw(dm, KV, hd) * fan, draw(H, hd, dm) * fan,
                1 + draw(hd) / 4, 1 + draw(hd) / 4],
        [[S0, R], [R, Shard(1)], [R, R], [R, R], [R, S0], [R, R], [R, R]])
    res["bits"] = {}
    table = draw(V, d)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = placed([table, labels], [[R, S0], [S0, R]])
        res["bits"][f"take_rows {name}"] = [
            run(lambda w, i: spmd.take_rows(w, i, dt), args),
            run(lambda w, i: spmd.take_rows(w, i).to(dt), args)]
        args = placed([t.to(dt) for t in qkv],
                      [[S0, Shard(2)], [S0, R], [S0, R]])
        now = run(attention, args)
        kv_heads, spmd.kv_for_local_heads = (spmd.kv_for_local_heads,
                                             kv_heads_before)
        try:
            res["bits"][f"attention {name}"] = [now, run(attention, args)]
        finally:
            spmd.kv_for_local_heads = kv_heads
    # the MoE dispatch on each rank's tokens and experts, at a capacity
    # that drops none and one that drops, with a shared expert; MLA's
    # prefill on each rank's heads, with query chunks and a window; the
    # weights placed as the dry-run's rules place them
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    mcfg = get_config("deepseek-v2-236b").reduced().replace(
        d_model=16, num_heads=4, nope_head_dim=4, rope_head_dim=4,
        kv_lora_rank=8, q_lora_rank=6, num_experts=4, top_k=2, moe_d_ff=8,
        num_shared_experts=1)
    dm, fe, E = 16, 8, 4

    def moe(factor):
        def fn(x, router, we1, we3, we2, w1, w3, w2):
            p = dict(router=router, we1=we1, we3=we3, we2=we2,
                     shared=dict(w1=w1, w3=w3, w2=w2))
            return MOE.moe_ffn(p, mcfg, x, capacity_factor=factor)
        return fn
    moe_args = [draw(B, T, dm), draw(dm, E) / 4, draw(E, dm, fe) / 4,
                draw(E, dm, fe) / 4, draw(E, fe, dm) / 3, draw(dm, fe) / 4,
                draw(dm, fe) / 4, draw(fe, dm) / 3]
    moe_pl = [[S0, R], [R, Shard(1)]] + [[R, S0]] * 3 + [
        [R, Shard(1)], [R, Shard(1)], [R, S0]]
    res["moe"] = both(moe(64.0), moe_args, moe_pl)
    res["moe_drop"] = both(moe(0.25), moe_args, moe_pl)

    def mla(x, w_dkv, w_kr, w_uk, w_uv, wo, kv_norm, w_dq, w_uq, q_norm):
        p = dict(w_dkv=w_dkv, w_kr=w_kr, w_uk=w_uk, w_uv=w_uv, wo=wo,
                 kv_norm=kv_norm, w_dq=w_dq, w_uq=w_uq, q_norm=q_norm)
        return MOE.mla_attention(p, mcfg, x, pos, window=3, q_chunks=2)[0]
    res["mla"] = both(
        mla, [draw(B, T, dm), draw(dm, 8) / 4, draw(dm, 4) / 4,
              draw(8, 4, 4) / 3, draw(8, 4, 4) / 3, draw(4, 4, dm) / 4,
              1 + draw(8) / 4, draw(dm, 6) / 4, draw(6, 4, 8) / 3,
              1 + draw(6) / 4],
        [[S0, R], [R, R], [R, R], [R, Shard(1)], [R, Shard(1)], [R, S0],
         [R, R], [R, R], [R, Shard(1)], [R, R]])
    Hs, K, Vd = 2, 4, 3
    res["scan"] = both(
        lambda r, k, v, ld, u: scan_ops.chunked_scan(
            r, k, v, ld, None, include_current=False, bonus=u, chunk=4),
        [draw(B, T, Hs, K), draw(B, T, Hs, K), draw(B, T, Hs, Vd),
         -draw(B, T, Hs, K).abs(), draw(Hs, K)],
        [[S0, Shard(2)]] * 4 + [[R, S0]])
    res["recurrent"] = both(
        lambda r, k, v, ld, st, u: scan_ops.recurrent_scan(
            r, k, v, ld, st, include_current=False, bonus=u),
        [draw(B, 2, Hs, K), draw(B, 2, Hs, K), draw(B, 2, Hs, Vd),
         -draw(B, 2, Hs, K).abs(), draw(B, Hs, K, Vd), draw(Hs, K)],
        [[S0, Shard(2)]] * 4 + [[S0, Shard(1)], [R, S0]])
    res["step"] = both(
        lambda r, k, v, ld, st: scan_ops.recurrent_step(
            r, k, v, ld, st, include_current=True),
        [draw(B, Hs, K), draw(B, Hs, K), draw(B, Hs, Vd),
         -draw(B, Hs).abs(), draw(B, Hs, K, Vd)],
        [[S0, Shard(1)]] * 5)
    # serving's unembedding (no gradient: the table cast in vocab blocks,
    # 5 rows a block) on each rank's rows and vocab shard, tied and not
    block, L.VOCAB_BLOCK = L.VOCAB_BLOCK, 5
    x, w = draw(B, T, d), draw(V, d).double()
    res["unembed"] = {}
    try:
        with torch.no_grad():
            for name, (xs, tied, untied) in (
                    ("plain", (x, w, w.T.contiguous())),
                    ("split", (distribute_tensor(x, mesh, [S0, R]),
                               distribute_tensor(w, mesh, [R, S0]),
                               distribute_tensor(w.T.contiguous(), mesh,
                                                 [R, Shard(1)])))):
                got = [L.unembed({"embedding": tied}, types.SimpleNamespace(
                           tie_embeddings=True), xs),
                       L.unembed({"unembed": untied}, types.SimpleNamespace(
                           tie_embeddings=False), xs)]
                res["unembed"][name] = [_np(g.full_tensor()
                                            if spmd.is_dtensor(g) else g)
                                        for g in got]
    finally:
        L.VOCAB_BLOCK = block
    return res if rank == 0 else None
