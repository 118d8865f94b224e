"""The constellation-parallel FL round (``repro_torch.fl.sharded``) in gloo
worlds of 1, 2 and 4 CPU ranks, against the JAX package's round on
``make_host_mesh(data=1)``.

Each world is spawned once (a module fixture, ``torch_mesh_cases``; world
1 runs in this process) and runs every case; the tests assert them one by
one:

* the linear-regression case of ``tests/test_sharded.py`` (4 satellites,
  J = 3, lr 0.1), two rounds: each round's model and mean loss at 1e-5 of
  the reference's, and the loss falls;
* gamma < 1 (4 satellites at weight 0.125, lr 0): the round keeps the
  previous model's share, 7.0 stays 7.0;
* the qwen3-4b reduced loss in f32 (2 layers, d_model 256), 4 satellites,
  J = 2: the model at atol 1e-4 of the reference's (J SGD steps through a
  transformer, each framework summing in its own order), the loss at 1e-5
  relative.
Across worlds the port agrees with itself at 1e-5, and within a world
every rank holds rank 0's bits.

The reference's ISL-ring ``ppermute``, whose result it throws away, is
lowered in a subprocess on 4 forced CPU devices: the jaxpr holds it, the
lowered and the optimised HLO hold no ``collective-permute``.  So the
port sends nothing around the ring (``fl/sharded.py``).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.fl.sharded import make_fl_round as jmake_fl_round
from repro.launch import make_host_mesh as jmake_host_mesh
from repro.models import registry as JR
from repro_torch.configs import ARCHS
from torch_mesh_cases import fl_round_case, run_world

WORLDS = (1, 2, 4)
CFG = dict(dtype="float32", remat=False)


def _cases():
    """{name: (loss kind, port config, params, batches (JAX), batches
    (port), weights, J, lr, rounds)}."""
    rng = np.random.default_rng(0)
    out = {}
    w_true = rng.standard_normal((5, 1)).astype(np.float32)
    xs = rng.standard_normal((4, 3, 16, 5)).astype(np.float32)
    ys = (xs @ w_true).astype(np.float32)
    out["linreg"] = ("linreg", None, {"w": np.zeros((5, 1), np.float32)},
                     (xs, ys), (xs, ys), np.full(4, 0.25, np.float32), 3,
                     0.1, 2)
    out["gamma"] = ("const", None, {"w": np.full(3, 7.0, np.float32)},
                    np.zeros((4, 2, 3), np.float32),
                    np.zeros((4, 2, 3), np.float32),
                    np.full(4, 0.125, np.float32), 2, 0.0, 1)
    jcfg = JARCHS["qwen3-4b"].reduced().replace(**CFG)
    params = jax.device_get(JR.init_params(jax.random.PRNGKey(0), jcfg))
    toks = rng.integers(0, jcfg.vocab_size, (4, 2, 2, 16))
    weights = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    out["qwen3-4b"] = ("lm", ARCHS["qwen3-4b"].reduced().replace(**CFG),
                       jax.tree.map(np.asarray, params),
                       toks.astype(np.int32), toks.astype(np.int64),
                       weights, 2, 0.05, 1)
    return out


def _jax_loss(kind):
    if kind == "linreg":
        return lambda p, b: jnp.mean((b[0] @ p["w"] - b[1]) ** 2)
    if kind == "const":
        return lambda p, b: jnp.mean((p["w"] - b) ** 2)
    jcfg = JARCHS["qwen3-4b"].reduced().replace(**CFG)
    return lambda p, b: JR.train_loss(p, jcfg, {"tokens": b})[0]


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    mesh = jmake_host_mesh(data=1)
    refs = {}
    for name, (kind, _cfg, params, jb, _tb, w, J, lr, rounds) in \
            cases.items():
        fl_round = jmake_fl_round(_jax_loss(kind), mesh, local_iters=J,
                                  lr=lr)
        p, res = jax.tree.map(jnp.asarray, params), []
        for _ in range(rounds):
            p, loss = fl_round(p, jax.tree.map(jnp.asarray, jb),
                               jnp.asarray(w))
            res.append((jax.device_get(p), float(loss)))
        refs[name] = res
    port_cases = [(name, kind, cfg, params, tb, w, J, lr, rounds)
                  for name, (kind, cfg, params, _jb, tb, w, J, lr, rounds)
                  in cases.items()]
    worlds = {n: run_world(n, fl_round_case, port_cases) for n in WORLDS}
    return refs, worlds


TOL = {"linreg": 1e-5, "gamma": 1e-5, "qwen3-4b": 1e-4}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          prefix + (k,))]
    return [(prefix, np.asarray(tree))]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", list(TOL))
def test_round_matches_reference(runs, n, name):
    refs, worlds = runs
    for res in worlds[n]:
        assert len(res[name]) == len(refs[name])
        for (p, loss), (jp, jloss) in zip(res[name], refs[name]):
            got, want = _leaves(p), _leaves(jp)
            assert [k for k, _ in got] == [k for k, _ in want]
            for (k, a), (_, b) in zip(got, want):
                np.testing.assert_allclose(a, b, atol=TOL[name],
                                           err_msg=str(k))
            assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-6)
    if name == "linreg":              # the global model improves
        assert res[name][1][1] < res[name][0][1]
    if name == "gamma":               # gamma = 0.5 of a model that is 7.0
        np.testing.assert_allclose(res[name][0][0]["w"], 7.0, rtol=1e-6)


@pytest.mark.parametrize("name", list(TOL))
def test_worlds_agree(runs, name):
    _, worlds = runs
    base = worlds[1][0][name]
    for n in WORLDS[1:]:
        for (p, loss), (q, qloss) in zip(worlds[n][0][name], base):
            for (_, a), (_, b) in zip(_leaves(p), _leaves(q)):
                np.testing.assert_allclose(a, b, atol=1e-5)
            assert loss == pytest.approx(qloss, rel=1e-5)


@pytest.mark.parametrize("n", WORLDS[1:])
def test_ranks_bit_equal(runs, n):
    _, worlds = runs
    for res in worlds[n][1:]:
        for name in TOL:
            for (p, loss), (q, qloss) in zip(res[name], worlds[n][0][name]):
                for (_, a), (_, b) in zip(_leaves(p), _leaves(q)):
                    np.testing.assert_array_equal(a, b)
                assert loss == qloss


RING_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp
    from repro.fl.sharded import make_fl_round
    from repro.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=4)
    assert mesh.devices.shape == (4, 1)

    def loss_fn(p, b):
        return jnp.mean((b[0] @ p["w"] - b[1]) ** 2)

    fl_round = make_fl_round(loss_fn, mesh, local_iters=3, lr=0.1)
    args = ({"w": jnp.zeros((5, 1))},
            (jnp.ones((4, 3, 16, 5)), jnp.ones((4, 3, 16, 1))),
            jnp.full((4,), 0.25))
    jaxpr = str(jax.make_jaxpr(fl_round)(*args))
    lowered = jax.jit(fl_round).lower(*args)
    print("JAXPR", jaxpr.count("ppermute"))
    print("LOWERED", lowered.as_text().count("collective_permute"))
    print("OPTIMISED", lowered.compile().as_text().count("collective-permute"))
""")


def test_reference_ring_exchange_is_dropped():
    env = dict(os.environ,
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", RING_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = dict(line.split() for line in proc.stdout.splitlines()
                  if line.split()[0] in ("JAXPR", "LOWERED", "OPTIMISED"))
    assert counts == {"JAXPR": "1", "LOWERED": "0", "OPTIMISED": "0"}
