"""The whole slice: the port's epoch loop against the JAX package's, and the
port's rules (no JAX inside it, no silent CPU, and the option it once
refused, a mesh, runs).

Both simulations start from the same w0 and train with the same minibatch
indices (the JAX draws, fed to the port).  Simulated time, model counts,
gamma and stale groups come from host numpy timing and metadata math:
exactly equal.  Accuracy may differ by at most one test sample (the
trained weights agree to f32 reduction-order noise, which can move one
argmax); the final global models are held at atol 1e-4, as the training
test holds the trained stacks.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import FLSimulation as JSim, SimConfig as JSimConfig
from repro.data import class_conditional_images, iid_partition
from repro.fl import Evaluator as JEvaluator, ImageClassifierPool as JPool
from repro.fl import get_strategy as jget
from repro_torch.core.modelbank import params_from_jax
from repro_torch.core.simulator import FLSimulation, SimConfig
from repro_torch.fl.strategies import get_strategy
from repro_torch.fl_constellation_sim import build_workload, main
from repro_torch.launch.mesh import make_data_mesh
from test_torch_cnn_client import TINY, _w0, injected, jcfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
DAYS = 1.0
NUM_TEST = 100
KW = dict(local_iters=2, batch_size=8)


@pytest.fixture(scope="module")
def setup():
    imgs, labs = class_conditional_images(0, 400, separation=0.8)
    ti, tl = class_conditional_images(99, NUM_TEST, separation=0.8)
    shards = iid_partition(labs, 40, 0)
    jpool = JPool(jcfg(TINY), imgs, labs, shards, **KW)
    jev = JEvaluator(jcfg(TINY), ti, tl)
    w0 = _w0(TINY)
    work = build_workload(iid=True, device="cpu", cfg=TINY, num_train=400,
                          num_test=NUM_TEST, w0=params_from_jax(w0,
                                                                device="cpu"),
                          batch_indices=injected(KW, shards), **KW)
    return jpool, jev, w0, work


def _forget_first_orbit(sim):
    """Drop the lowest-numbered orbit from the grouping state, as if it had
    never been seen: its next arrival is a new orbit again."""
    sim._resolve_pending_dists()
    g = sim.grouping
    o = sorted(g.distances)[0]
    del g.distances[o]
    g.groups = [[x for x in grp if x != o] for grp in g.groups]
    g.groups = [grp for grp in g.groups if grp]


def _with_fallback_at(cls, epoch):
    """``cls`` whose epoch ``epoch`` sees a known orbit as new.  On
    asyncfleo-hap that epoch also commits carried stale models (its
    first stale-only group), so the epoch takes the fallback split: the
    step, then the aggregation over this epoch's distances."""
    class Sim(cls):
        def _fused_epoch(self, prog, beta, *args):
            if beta == epoch:
                _forget_first_orbit(self)
            return super()._fused_epoch(prog, beta, *args)
    return Sim


# asyncfleo-hap runs to epoch 14, its first stale-only group (gamma < 1),
# and takes the fallback split there; fedspace (interval aggregation, no
# ISL) discounts from epoch 1
@pytest.mark.parametrize("scheme,epochs", [("asyncfleo-hap", 15),
                                           ("asyncfleo-gs", 3),
                                           ("fedisl", 3), ("fedspace", 3)])
def test_history_matches_jax(setup, scheme, epochs):
    jpool, jev, w0, work = setup
    jcls, tcls = JSim, FLSimulation
    if epochs > 3:
        jcls = _with_fallback_at(JSim, epochs - 1)
        tcls = _with_fallback_at(FLSimulation, epochs - 1)
    jsim = jcls(jget(scheme), jpool, jev, JSimConfig(duration_s=DAYS * 86400))
    jbefore = getattr(jpool, "_epoch_programs", {})
    jfb = sum(p.fallback_dispatches for p in jbefore.values())
    jhist = jsim.run(w0, max_epochs=epochs)
    tsim = tcls(get_strategy(scheme), work.pool, work.evaluator,
                SimConfig(duration_s=DAYS * 86400))
    tfb = sum(p.fallback_dispatches
              for p in getattr(work.pool, "_epoch_programs", {}).values())
    thist = tsim.run(work.w0, max_epochs=epochs)
    assert len(thist) == len(jhist) == epochs
    if epochs > 3:
        assert thist[-1].gamma < 1.0 and thist[-1].stale_groups
        assert jsim._fused_prog.fallback_dispatches - jfb == 1
        tprog = work.pool._epoch_programs[tsim._spec]
        assert tprog.fallback_dispatches - tfb == 1
    for a, b in zip(thist, jhist):
        assert (a.epoch, a.time_s, a.num_models, a.gamma, a.stale_groups) \
            == (b.epoch, b.time_s, b.num_models, b.gamma, b.stale_groups)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / NUM_TEST + 1e-6
    np.testing.assert_allclose(tsim._w_flat.numpy(),
                               np.asarray(jsim._w_flat), atol=1e-4)
    assert tsim.grouping.groups == jsim.grouping.groups
    assert [m[:2] for m in tsim._pend_meta] == \
        [m[:2] for m in jsim._pend_meta]
    assert tsim.last_epoch_included == jsim.last_epoch_included


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
    mods = sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                  .replace(".__init__", "") for p in PORT.rglob("*.py"))
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert {"repro_torch.core.simulator", "repro_torch.obs.export",
            "repro_torch.obs.profile", "repro_torch.sweep.batch",
            "repro_torch.sweep.driver", "repro_torch.models.mamba",
            "repro_torch.tree", "repro_torch.optim.optimizers",
            "repro_torch.checkpoint", "repro_torch.checkpoint.io",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.launch.fl_train", "repro_torch.fl.client",
            "repro_torch.llm_federated_pretrain"} \
        <= set(mods) and len(mods) >= 30


def test_ast_scan_finds_no_jax_import():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(ROOT)} imports {n}"


def test_cuda_without_a_card_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    *_, work = setup
    for make in (lambda: build_workload(iid=True),
                 lambda: params_from_jax({"a": np.zeros(2, np.float32)}),
                 lambda: main(["--epochs", "1"])):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    from repro_torch.kernels.fed_agg import fed_agg
    with pytest.raises(ValueError):
        fed_agg(torch.zeros((2, 3), device="meta"),
                torch.zeros(2, device="meta"))


@pytest.mark.parametrize("change", [dict(mesh=make_data_mesh)])
def test_unported_options_raise(setup, change):
    """The one option the port used to refuse, ``SimConfig.mesh``, runs
    now: on a one-rank data mesh (the identity mesh) the run is the
    unsharded one, history and model bits."""
    *_, work = setup
    runs = []
    try:
        for kw in ({}, {k: make(device="cpu") for k, make in change.items()}):
            sim = FLSimulation(get_strategy("asyncfleo-hap"), work.pool,
                               work.evaluator,
                               SimConfig(duration_s=DAYS * 86400, **kw))
            runs.append((sim.run(work.w0, max_epochs=2), sim._w_flat))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    (h0, w0), (h1, w1) = runs
    assert [vars(r) for r in h0] == [vars(r) for r in h1] and len(h0) == 2
    assert torch.equal(w0, w1)
