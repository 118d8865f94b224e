"""Expert-parallel MoE (``repro_torch.models.moe_ep``) in gloo worlds of 1,
2 and 4 CPU ranks, against the JAX package's ``moe_ffn_reference``.

deepseek-v2's reduced config in f32 (4 experts, top-2, one shared expert,
d_model 256) at capacity factor 64, where nothing drops, on the (data,
model) meshes (1, 1), (1, 2), (1, 4) and (2, 2).  Each world is spawned
once (a module fixture, ``torch_mesh_cases``; world 1 runs in this
process).  Tolerances are the reference's own tests': atol 1e-5 and rtol
1e-4 at one rank, 1e-4 across ranks.  ``aux`` is held against the
reference's formula, E * sum(mean probs * assignment share), over each
model rank's token block, averaged over the model axis, data row 0's (what
the reference's replicated output returns).  Every rank returns the same
bits.  ``ep_capacity`` equals the reference's on a grid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.models import moe as JMOE
from repro.models.moe_ep import ep_capacity as jep_capacity
from repro_torch.configs import ARCHS
from repro_torch.models.moe_ep import ep_capacity, make_ep_moe_layer
from torch_mesh_cases import moe_ep_case, run_world

MESHES = ((1, 1), (1, 2), (1, 4), (2, 2))
WORLDS = (1, 2, 4)
FACTOR = 64.0


def _cfg(archs):
    return archs["deepseek-v2-236b"].reduced().replace(
        dtype="float32", moe_capacity_factor=FACTOR)


def _block_aux(p, cfg, x, shape):
    """The reference's aux over each (data, model) block of ``x``: the mean
    over the model axis of data row 0."""
    nd, nm = shape
    B, S, d = x.shape
    vals = []
    for j in range(nm):
        xf = x[:B // nd, j * S // nm:(j + 1) * S // nm].reshape(-1, d)
        probs = jax.nn.softmax((xf @ p["router"]).astype(jnp.float32), -1)
        _, ids = jax.lax.top_k(probs, cfg.top_k)
        ce = jnp.zeros(cfg.num_experts).at[ids.reshape(-1)].add(1.0) \
            / (xf.shape[0] * cfg.top_k)
        vals.append(float(cfg.num_experts * jnp.sum(probs.mean(0) * ce)))
    return float(np.mean(vals))


@pytest.fixture(scope="module")
def runs():
    jcfg = _cfg(JARCHS)
    key = jax.random.PRNGKey(0)
    p = JMOE.init_moe_ffn(key, jcfg)
    x = jax.random.normal(key, (2, 16, jcfg.d_model)) * 0.5
    ref = np.asarray(JMOE.moe_ffn_reference(p, jcfg, x))
    auxes = {shape: _block_aux(p, jcfg, x, shape) for shape in MESHES}
    params = jax.tree.map(np.asarray, jax.device_get(p))
    worlds = {n: run_world(n, moe_ep_case, _cfg(ARCHS), params,
                           np.asarray(x), MESHES, FACTOR)
              for n in WORLDS}
    return ref, auxes, worlds


def _tol(shape):
    return (dict(atol=1e-5, rtol=1e-4) if shape == (1, 1)
            else dict(atol=1e-4, rtol=0))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_matches_reference(runs, shape):
    ref, auxes, worlds = runs
    results = worlds[shape[0] * shape[1]]
    for res in results:
        out, aux, dropped = res[shape]
        np.testing.assert_allclose(out, ref, **_tol(shape))
        assert aux == pytest.approx(auxes[shape], rel=1e-5)
        assert dropped == 0
    for res in results[1:]:           # every rank holds rank 0's bits
        np.testing.assert_array_equal(res[shape][0], results[0][shape][0])
        assert res[shape][1] == results[0][shape][1]


@pytest.mark.parametrize("tokens", [1, 7, 32, 128, 4096])
def test_ep_capacity_matches_reference(tokens):
    for k in (1, 2, 6, 8):
        for n in (1, 2, 4, 16, 64):
            for f in (0.25, 1.0, 1.25, 64.0):
                assert ep_capacity(tokens, k, n, f) == \
                    jep_capacity(tokens, k, n, f)
    assert ep_capacity(1, 1, 64, 1.0) == 8             # the floor


def test_ep_drops_beyond_capacity():
    """At capacity factor 0.25 on one rank every assignment goes to the one
    bucket, which holds ep_capacity of them: the rest drop, and the layer
    counts them."""
    cfg, key = _cfg(JARCHS), jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax.device_get(
        JMOE.init_moe_ffn(key, cfg)))
    x = np.asarray(jax.random.normal(key, (2, 16, cfg.d_model))) * 0.5
    (res,) = run_world(1, moe_ep_case, _cfg(ARCHS), params, x, ((1, 1),),
                       0.25)
    assert res[(1, 1)][2] == 32 * cfg.top_k - ep_capacity(32, cfg.top_k,
                                                           1, 0.25)


def test_uneven_experts_refuse():
    class Mesh:                      # three model ranks, four experts
        axis_names = ("data", "model")

        @staticmethod
        def size(axis):
            return {"data": 1, "model": 3}[axis]

    with pytest.raises(ValueError, match="4 experts over 3 ranks"):
        make_ep_moe_layer(_cfg(ARCHS), Mesh())
