"""The dry-run's abstract specs (``repro_torch.launch.specs``) against the
JAX package's ``launch/specs.py``.

For all ten archs at full width, the parameter and AdamW-state trees, and
for every (arch, shape) pair the batch and, for the decode shapes where
the arch has a decode step, the cache: the same leaf paths, shapes and
dtypes as the reference's ``jax.eval_shape`` trees, every leaf on the meta
device (nothing allocated).  The one difference is named: the decode
cache's ``index`` is a host int 0 in the port, a 0-dim int32 array in the
reference.
"""
import jax
import pytest
import torch

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.configs import applicable as japplicable
from repro.launch import specs as JS
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import specs as S
from repro_torch.tree import tree_paths

PAIRS = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]
DECODE = [(a, s) for a, s in PAIRS if SHAPES[s].kind == "decode"
          and japplicable(JARCHS[a], JSHAPES[s])]


def _ref_leaves(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(k.key for k in path), tuple(x.shape), str(x.dtype))
            for path, x in leaves]


def _port_leaves(tree):
    out = []
    for path, t in tree_paths(tree):
        assert isinstance(t, torch.Tensor), (path, t)
        assert t.device.type == "meta", (path, t.device)
        out.append((path, tuple(t.shape), str(t.dtype).split(".")[-1]))
    return out


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs(arch, shape):
    got = S.input_specs(ARCHS[arch], SHAPES[shape])
    want = JS.input_specs(JARCHS[arch], JSHAPES[shape])
    assert _port_leaves(got) == _ref_leaves(want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs(arch):
    assert (_port_leaves(S.param_specs(ARCHS[arch]))
            == _ref_leaves(JS.param_specs(JARCHS[arch])))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_specs(arch):
    p = S.param_specs(ARCHS[arch])
    got = S.opt_state_specs(ARCHS[arch], p)
    want = JS.opt_state_specs(JARCHS[arch])
    assert _port_leaves(got) == _ref_leaves(want)
    # the default params are the arch's param_specs
    assert _port_leaves(S.opt_state_specs(ARCHS[arch])) == _port_leaves(got)


@pytest.mark.parametrize("arch,shape", DECODE)
def test_cache_specs(arch, shape):
    got = S.cache_specs(ARCHS[arch], SHAPES[shape])
    want = JS.cache_specs(JARCHS[arch], JSHAPES[shape])
    ref = _ref_leaves(want)
    if "index" in got:
        # the port's decode index is a host int (models.registry)
        assert got.pop("index") == 0
        assert (("index",), (), "int32") in ref
        ref.remove((("index",), (), "int32"))
    assert _port_leaves(got) == ref
