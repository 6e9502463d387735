"""The port's logical specs (``Model.param_spec`` / ``Model.cache_spec`` and
the ``spec_*`` of every layer) against the JAX package's, for every
registered config at its published widths, entry for entry:

- the logical trees themselves (plain tuples, equal to the reference's);
- resolved with ``TRAIN_RULES`` and the ('pod', 'agent') prefix on the
  agent-stacked parameters, on the training meshes (1, A, 16 / A, 16) and
  (2, A, 16 / A, 16) (A the config's ``agents_per_pod``) and the debug
  meshes (1, 2, 1, 2) and (1, 2, 2, 2);
- the parameters and the caches resolved with ``serve_rules`` (small and
  big) on the serve meshes (16, 16) and (2, 16, 16);

as ``tuple(PartitionSpec)``, exactly. The reference's shapes come from
``jax.eval_shape``, the port's from the meta device; a mesh is a stand-in
with its axis names and sizes (resolution reads nothing else).
"""
import functools
from types import SimpleNamespace

import jax
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import sharding as ref_sharding
from repro_torch.configs import get_config, list_archs
from repro_torch.models import build_model
from repro_torch.models import sharding

CACHE_B, CACHE_S = 32, 64


def _mesh(shape, names=("pod", "agent", "fsdp", "model")):
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


def _flat(tree, at=""):
    """{dotted path: leaf as a tuple} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{at}.{k}" if at else k))
        return out
    return {at: tuple(tree)}


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(the reference's ShapeDtypeStructs, the port's meta tensors) of one
    agent's parameters of ``arch``."""
    ref_model = ref_build_model(ref_get_config(arch))
    return (jax.eval_shape(ref_model.init_params, jax.random.PRNGKey(0)),
            build_model(get_config(arch)).init_params(None, "meta"))


def _stacked_shapes(arch, m):
    """The agent-stacked shapes of ``arch``'s parameters, both packages."""
    ref, port = _shapes(arch)
    ref = jax.tree.map(lambda s: jax.ShapeDtypeStruct((m,) + s.shape,
                                                      s.dtype), ref)
    port = _tree_map(lambda x: torch.empty((m,) + tuple(x.shape),
                                           device="meta"), port)
    return ref, port


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _train_meshes(cfg):
    A = cfg.dist.agents_per_pod
    return [(1, A, 16 // A, 16), (2, A, 16 // A, 16), (1, 2, 1, 2),
            (1, 2, 2, 2)]


@pytest.mark.parametrize("arch", list_archs())
def test_param_spec_resolved_for_training(arch):
    """The logical parameter tree, then its resolution with TRAIN_RULES and
    the agent prefix on every training and debug mesh."""
    cfg = get_config(arch)
    model = build_model(cfg)
    spec = model.param_spec()
    ref_spec = ref_build_model(ref_get_config(arch)).param_spec()
    assert _flat(spec) == _flat(ref_spec)
    for shape in _train_meshes(cfg):
        m = shape[0] * shape[1]
        ref_shapes, port_shapes = _stacked_shapes(arch, m)
        mesh = _mesh(shape)
        prefix = (("pod", "agent"),)
        got = sharding.resolve(spec, port_shapes, mesh, sharding.TRAIN_RULES,
                               prefix=prefix)
        want = ref_sharding.resolve(ref_spec, ref_shapes, mesh,
                                    ref_sharding.TRAIN_RULES, prefix=prefix)
        assert _flat(got) == _flat(want), shape


@pytest.mark.parametrize("arch", list_archs())
def test_serve_specs_resolved(arch):
    """The logical cache tree, then the parameters and the caches (B 32, 64
    positions) resolved with serve_rules, small and big, on the serve
    meshes."""
    cfg = get_config(arch)
    model = build_model(cfg)
    ref_model = ref_build_model(ref_get_config(arch))
    assert _flat(model.cache_spec()) == _flat(ref_model.cache_spec())
    ref_params, params = _shapes(arch)
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(CACHE_B,
                                                            CACHE_S))
    cache = model.init_cache(CACHE_B, CACHE_S, device="meta")
    for mesh in (_mesh((16, 16), ("data", "model")),
                 _mesh((2, 16, 16), ("pod", "data", "model"))):
        for big in (False, True):
            rules = sharding.serve_rules(mesh, big)
            assert rules == ref_sharding.serve_rules(mesh, big)
            for spec, ref_spec, shapes, ref_shapes in (
                    (model.param_spec(), ref_model.param_spec(), params,
                     ref_params),
                    (model.cache_spec(), ref_model.cache_spec(), cache,
                     ref_cache)):
                got = sharding.resolve(spec, shapes, mesh, rules)
                want = ref_sharding.resolve(ref_spec, ref_shapes, mesh, rules)
                assert _flat(got) == _flat(want), (mesh.shape, big)
    assert sharding.SERVE_RULES_SMALL == ref_sharding.SERVE_RULES_SMALL


def test_spec_shapes_cover_every_leaf():
    """Every parameter leaf of every config has a spec leaf of at most its
    rank (the names align to the trailing dims), and no spec names a
    parameter that does not exist."""
    for arch in list_archs():
        model = build_model(get_config(arch))
        spec = _flat(model.param_spec())
        shapes = _flat(_tree_map(lambda x: tuple(x.shape), _shapes(arch)[1]))
        assert set(spec) == set(shapes), arch
        for k, names in spec.items():
            assert len(names) <= len(shapes[k]), (arch, k)
