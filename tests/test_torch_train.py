"""Port vs JAX package: LM training (AdamW and clipping, gradients of
``R.train_loss``, ``make_train_step``, remat, the forward-only kernels'
refusals, ``make_batch`` and the ``launch.train`` entry point).

Weights are drawn by the JAX package and carried across; batches come
from the JAX package's ``make_batch`` (numpy seeds).  Tolerances:
* AdamW and clipping on identical numpy gradients: 1e-6 of each leaf's
  largest magnitude (the same f32 arithmetic in another order);
* gradients of ``R.train_loss``, reduced configs in f32: 1e-5 of each
  leaf's largest |g| (plain route against the JAX package's XLA route).
  rwkv6-7b is held in float64 on both sides: its per-head group norm over
  a near-zero WKV state at the first positions turns f32 rounding into
  gradient differences of 4e-4 of the leaf's max, whichever package
  computes them;
* one ``make_train_step`` step, in float64 on both sides: at 1e-4 where
  the reference gradient's sign is pinned by the gradient tolerance
  (|g| >= 1e-5 of the leaf's max, read off AdamW's first moment).
  AdamW's first step moves every other element by lr * g / (|g| + eps),
  whose sign is then set by rounding (the cross-entropy runs in f32 in
  both packages, so even float64 gradients agree only to ~4e-7 of the
  max); there the two steps are held to the most a step can move an
  element, 2 lr.
The gradient cases of the other archs are in
``tests/test_torch_train_archs.py`` and ``tests/test_torch_train_ssm.py``
(one file a worker: the JAX side traces each arch anew).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import steps as jsteps
from repro.launch.train import make_batch as jmake_batch
from repro.models import registry as JR
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply
from repro.optim import clip_by_global_norm as jclip
from repro.optim import global_norm as jnorm
from repro_torch.configs import ARCHS
from repro_torch.kernels.chunk_scan import chunk_scan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import registry as R
from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                               global_norm)
from repro_torch.tree import tree_leaves, tree_map, tree_paths

KEY = jax.random.PRNGKey(0)
B, S = 2, 32
GRAD_TOL = 1e-5               # of the leaf's max |g|
STEP_TOL = 1e-4
F64_GRAD_ARCHS = ("rwkv6-7b",)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU runs, restored after the
    module: under several pytest workers torch's spinning thread pools
    oversubscribe the cores and the runs take several times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(arch, dtype="float32"):
    return ARCHS[arch].reduced().replace(remat=False, dtype=dtype)


def _jreduced(arch, dtype="float32"):
    return JARCHS[arch].reduced().replace(remat=False, dtype=dtype)


def _to_torch_batch(jb):
    out = {}
    for k, v in jb.items():
        a = np.asarray(v)
        out[k] = torch.tensor(a.astype(np.int64) if k in ("tokens", "labels")
                              else a)
    return out


def _leaf_close(got, want, rel, what):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} * {scale:.3e}"


def _jax_inputs(arch, dtype):
    """(reference cfg, params, batch) at ``dtype``."""
    jc = _jreduced(arch, dtype)
    jp = jax.jit(lambda k: JR.init_params(k, jc))(KEY)
    if dtype == "float64":
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
    return jc, jp, jmake_batch(jc, B, S, seed=0)


def _port_params(jp):
    return tree_map(lambda a: torch.tensor(np.asarray(a)),
                    jax.device_get(jp))


def check_gradients(arch):
    """The gradient of ``R.train_loss`` (plain route) against ``jax.grad``
    of the reference's (XLA route), leaf by leaf."""
    dtype = "float64" if arch in F64_GRAD_ARCHS else "float32"
    with jax.enable_x64(dtype == "float64"):
        jc, jp, jb = _jax_inputs(arch, dtype)
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: JR.train_loss(p, jc, b), has_aux=True))(jp, jb)
    loss, metrics, g = steps.loss_and_grads(_port_params(jp),
                                            _reduced(arch, dtype),
                                            _to_torch_batch(jb))
    assert abs(float(loss) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    assert set(metrics) == {"ce", "aux"}
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tree_leaves(g))
    for (path, gl), jgl in zip(tree_paths(g), jleaves):
        assert tuple(gl.shape) == np.shape(jgl)
        _leaf_close(gl, jgl, GRAD_TOL, f"{arch} grad {'/'.join(path)}")


def check_train_step(arch):
    """One ``make_train_step`` step (``make_optimizer()``: AdamW, lr 3e-4,
    weight decay 0.1) against the reference's, in float64."""
    lr = 3e-4
    with jax.enable_x64(True):
        jc, jp, jb = _jax_inputs(arch, "float64")
        jopt = jsteps.make_optimizer(lr)
        jst = jopt.init(jp)
        jp2, jst2, jl = jax.jit(jsteps.make_train_step(jc, jopt))(jp, jst,
                                                                   jb)
    opt = steps.make_optimizer(lr)
    p = _port_params(jp)
    st = opt.init(p)
    p2, st2, loss = steps.make_train_step(_reduced(arch, "float64"), opt)(
        p, st, _to_torch_batch(jb))
    assert abs(float(loss) - float(jl)) <= STEP_TOL
    assert int(st2["step"]) == int(jst2["step"]) == 1
    pinned = 0
    for (path, a), b, m, jm in zip(tree_paths(p2),
                                   jax.tree_util.tree_leaves(jp2),
                                   tree_leaves(st2["m"]),
                                   jax.tree_util.tree_leaves(jst2["m"])):
        what = f"{arch} step {'/'.join(path)}"
        assert a.dtype == torch.float64 and np.asarray(b).dtype == np.float64
        d = np.abs(a.numpy() - np.asarray(b))
        g = np.abs(np.asarray(jm))           # (1 - b1) |g| after one step
        sign_set = g >= GRAD_TOL * g.max()
        pinned += int(sign_set.sum())
        assert (d[sign_set] <= STEP_TOL).all(), \
            f"{what}: {d[sign_set].max():.3e} > {STEP_TOL}"
        assert (d <= 2 * lr + 1e-9).all(), f"{what}: {d.max():.3e} > 2 lr"
        # no gradient (a token the batch lacks): weight decay alone
        assert (d[g == 0] <= 1e-12).all(), what
        assert m.dtype == torch.float32
        _leaf_close(m, jm, GRAD_TOL, f"{what} m")
    assert pinned > 0


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)
                  * scale,
                  "b": np.zeros(3, np.float32)},
            "c": rng.standard_normal((2, 2, 5)).astype(np.float32) * scale,
            "d": rng.standard_normal(7).astype(np.float32) * scale}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax_step_for_step(weight_decay):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** -k) for k in range(5)]
    for g in grads:                  # an exact zero and a tiny gradient
        g["d"][0], g["d"][1] = 0.0, 1e-9
    jopt = jadamw(1e-2, weight_decay=weight_decay)
    opt = adamw(1e-2, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    p = tree_map(torch.tensor, p0)
    st = opt.init(p)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert all(t.dtype == torch.float32 for t in tree_leaves(st["m"]))
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = japply(jp, ju)
        u, st = opt.update(tree_map(torch.tensor, g), st, p)
        p = apply_updates(p, u)
        for (path, a), b in zip(tree_paths(p), jax.tree_util.tree_leaves(jp)):
            _leaf_close(a, b, 1e-6, f"param {'/'.join(path)}")
        for name in ("m", "v"):
            for (path, a), b in zip(tree_paths(st[name]),
                                    jax.tree_util.tree_leaves(js[name])):
                _leaf_close(a, b, 1e-6, f"{name} {'/'.join(path)}")
    assert int(st["step"]) == int(js["step"]) == 5


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_match_jax(max_norm):
    t = _tree(np.random.default_rng(1))
    jt = jax.tree.map(jnp.asarray, t)
    tt = tree_map(torch.tensor, t)
    assert abs(float(global_norm(tt)) - float(jnorm(jt))) <= 1e-6 * float(
        jnorm(jt))
    clipped, norm = clip_by_global_norm(tt, max_norm)
    jclipped, jn = jclip(jt, max_norm)
    assert abs(float(norm) - float(jn)) <= 1e-6 * float(jn)
    for (path, a), b in zip(tree_paths(clipped),
                            jax.tree_util.tree_leaves(jclipped)):
        _leaf_close(a, b, 1e-6, f"clipped {'/'.join(path)}")
    zero = tree_map(torch.zeros_like, tt)        # max(norm, 1e-9): no NaN
    z, zn = clip_by_global_norm(zero, 1.0)
    assert float(zn) == 0.0 and all(float(x.abs().max()) == 0.0
                                    for x in tree_leaves(z))


# --------------------------------------------------------------------------
# gradients and one train step, against the reference
# --------------------------------------------------------------------------

ARCHS_HERE = ["deepseek-v2-236b", "llama3-8b", "qwen3-4b", "starcoder2-3b"]


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_gradients_match_jax(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_jax(arch):
    check_train_step(arch)


# --------------------------------------------------------------------------
# remat, refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-236b",
                                  "rwkv6-7b", "zamba2-2.7b"])
def test_remat_gives_the_same_gradients_and_forward(arch):
    cfg = _reduced(arch)
    params = R.init_params(0, cfg, device="cpu")
    batch = T.make_batch(cfg, B, S, seed=0, device="cpu")
    l0, _, g0 = steps.loss_and_grads(params, cfg, batch)
    l1, _, g1 = steps.loss_and_grads(params, cfg.replace(remat=True), batch)
    assert torch.equal(l0, l1)
    for (path, a), b in zip(tree_paths(g0), tree_leaves(g1)):
        assert torch.equal(a, b), "/".join(path)
    with torch.no_grad():                        # no grad: nothing changes
        a0, _ = R.apply(params, cfg, batch, impl="plain")
        a1, _ = R.apply(params, cfg.replace(remat=True), batch, impl="plain")
    assert torch.equal(a0, a1)


def test_lm_kernels_refuse_grad_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 32, generator=g)
    k = torch.randn(1, 8, 2, 32, generator=g)
    v = torch.randn(1, 8, 2, 32, generator=g)
    for t in (q, k, v):
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="plain"):
            flash_attention(q, k, v)
        t.requires_grad_(False)
    q.requires_grad_(True)
    with torch.no_grad():
        flash_attention(q, k, v)                 # no grad: the forward runs
    r, kk, vv = (torch.randn(1, 8, 2, 4, generator=g) for _ in range(3))
    ld = -torch.rand(1, 8, 2, 4, generator=g)
    ld.requires_grad_(True)
    with pytest.raises(RuntimeError, match="plain"):
        chunk_scan(r, kk, vv, ld, chunk=4)
    with torch.no_grad():
        chunk_scan(r, kk, vv, ld, chunk=4)
    ld.requires_grad_(False)
    chunk_scan(r, kk, vv, ld, chunk=4)           # nothing requires grad


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-7b"])
def test_train_step_on_the_kernel_route_raises(arch):
    cfg = _reduced(arch)
    params = R.init_params(0, cfg, device="cpu")
    opt = steps.make_optimizer()
    step = steps.make_train_step(cfg, opt, impl="kernel")
    with pytest.raises(RuntimeError, match="forward-only"):
        step(params, opt.init(params),
             T.make_batch(cfg, B, S, seed=0, device="cpu"))


# --------------------------------------------------------------------------
# make_batch and the entry point
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-1b",
                                  "hubert-xlarge"])
def test_make_batch_equals_jax(arch):
    got = T.make_batch(_reduced(arch), 3, 16, seed=5, device="cpu")
    want = jmake_batch(_jreduced(arch), 3, 16, seed=5)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_launch_train_main_on_the_cpu(capsys):
    out = T.main(["--arch", "qwen3-4b", "--steps", "3", "--batch", "2",
                  "--seq", "32", "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.strip().endswith("OK") and "params (reduced=True)" in text
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["cfg"].dtype == "float32" and not out["cfg"].remat
    assert all(t.device.type == "cpu" for t in tree_leaves(out["params"]))


def test_launch_train_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        T.main(["--arch", "qwen3-4b", "--steps", "1"])
