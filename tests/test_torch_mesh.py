"""The port's mesh shape logic and FLOP counts against the JAX package's.

* ``models/sharding.py``: ``resolve_leaf`` and ``panel_pspec`` against the
  reference's on stand-in meshes (a ``shape`` mapping, the pattern of
  ``tests/test_sharding_resolve.py``), equal as tuples (a PartitionSpec is
  a tuple), over trailing alignment, stacked prefixes, indivisible dims and
  every row / column claim of a panel group; ``resolve`` over the
  reference's own logical spec tree of olmo-1b's parameters.
* ``launch/mesh.py``: the training mesh's shapes, ``num_agents``, and a
  world of 1 rank on the CPU (gloo, a ``file://`` rendezvous): its lines and
  collectives; a world size other than the mesh's is a SystemExit naming
  both.
* ``utils/flops.py``: ``param_counts`` and ``model_flops`` equal to the
  reference's for every registered config and input shape (the shapes from
  a model built on the ``meta`` device against ``jax.eval_shape``).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_threads  # noqa: F401
from _torch_dist import SRC
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.models import build_model as ref_build_model
from repro.models import sharding as ref_sharding
from repro.utils import flops as ref_flops
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build_model
from repro_torch.models import sharding
from repro_torch.utils import flops


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"pod": 1, "agent": 16, "fsdp": 1, "model": 16}),
          FakeMesh({"pod": 2, "agent": 4, "fsdp": 4, "model": 16}),
          FakeMesh({"pod": 1, "agent": 2, "fsdp": 2, "model": 2})]
RULES = {"fsdp": "fsdp", "model": "model", "expert": "model"}
LEAVES = [(("fsdp", "model"), (16, 16, 2048, 8192), (("pod", "agent"),)),
          (("fsdp", "model"), (16, 50432, 2048), (("pod", "agent"),)),
          ((None, "model"), (4, 2048, 8), ()),
          (("expert", "fsdp", None), (2, 3, 128, 7168, 2048),
           (("pod", "agent"),)),
          (("data", "fsdp"), (8, 6, 10), ()),
          ((), (3, 4), ()),
          (("fsdp",), (7,), ())]


@pytest.mark.parametrize("mesh", range(len(MESHES)))
@pytest.mark.parametrize("leaf", range(len(LEAVES)))
def test_resolve_leaf_matches_reference(mesh, leaf):
    spec, shape, prefix = LEAVES[leaf]
    for rules in (RULES, sharding.TRAIN_RULES):
        want = ref_sharding.resolve_leaf(spec, shape, MESHES[mesh], rules,
                                         prefix=prefix)
        got = sharding.resolve_leaf(spec, shape, MESHES[mesh], rules,
                                    prefix=prefix)
        assert isinstance(want, P) and got == tuple(want)


@pytest.mark.parametrize("mesh", range(len(MESHES)))
def test_panel_pspec_matches_reference(mesh):
    fm = MESHES[mesh]
    assert sharding.PANEL_ROW_AXES == ref_sharding.PANEL_ROW_AXES
    assert sharding.PANEL_COL_AXES == ref_sharding.PANEL_COL_AXES
    assert sharding.TRAIN_RULES == ref_sharding.TRAIN_RULES
    for rows in (1, 2, 3, 8, 16, 32):
        for width in (1, 33, 102, 4096, 237_502_464):
            for axes in ((None, None), (("agent",), ("fsdp", "model")),
                         (("pod", "agent", "nope"), ("fsdp",))):
                kw = {} if axes == (None, None) else {
                    "row_axes": axes[0], "col_axes": axes[1]}
                want = ref_sharding.panel_pspec(fm, rows, width, **kw)
                assert sharding.panel_pspec(fm, rows, width, **kw) == tuple(
                    want)


def test_resolve_over_olmo_spec_tree():
    """The reference's logical spec tree of olmo-1b (reduced) resolved by
    both against the parameter shapes (the port's, from the meta device)."""
    cfg = ref_get_config("olmo-1b").reduced()
    ref_model = ref_build_model(cfg)
    spec_tree = ref_model.param_spec()
    shapes = jax.eval_shape(ref_model.init_params, jax.random.PRNGKey(0))
    fm = MESHES[2]
    want = ref_sharding.resolve(spec_tree, shapes, fm, sharding.TRAIN_RULES,
                                prefix=(("pod", "agent"),))
    port_shapes = flops.param_shapes(build_model(get_config("olmo-1b")
                                                 .reduced()))
    got = sharding.resolve(spec_tree, port_shapes, fm, sharding.TRAIN_RULES,
                           prefix=(("pod", "agent"),))
    flat_want = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, P))
    flat_got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(w) for w in flat_want] == flat_got


def test_mesh_shapes_and_num_agents():
    assert mesh_mod.training_shape(4) == (1, 4, 4, 16)
    assert mesh_mod.training_shape(16, multi_pod=True) == (2, 16, 1, 16)
    with pytest.raises(ValueError):
        mesh_mod.training_shape(3)
    for fm in MESHES:
        want = 1
        for ax in ("pod", "agent"):
            want *= fm.shape[ax]
        assert mesh_mod.num_agents(fm) == want


WORLD1 = """
import os, sys, torch
from repro_torch.launch import mesh as mesh_mod
os.environ["REPRO_TORCH_INIT_METHOD"] = "file://" + sys.argv[1]
os.environ.update(RANK="0", WORLD_SIZE=sys.argv[2], LOCAL_RANK="0")
try:
    mesh = mesh_mod.make_debug_mesh(agents=1, fsdp=1, model=1, device="cpu")
except SystemExit as e:
    print("exit:", e); sys.exit(3)
assert mesh.backend == "gloo" and mesh.members == {
    "rows": [0], "fsdp": [0], "model": [0], "block": [0]}
x = torch.arange(6.0).reshape(2, 3)
assert torch.equal(mesh.all_gather(x, "rows"), x)
assert torch.equal(mesh.all_reduce(x.clone(), "fsdp"), x)
print("ok", mesh.shape, mesh.coord)
"""


@pytest.mark.parametrize("world", [1, 4])
def test_world_of_one_rank_and_wrong_world(tmp_path, world):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", WORLD1,
                        str(tmp_path / "rdv"), str(world)], env=env,
                       capture_output=True, text=True, timeout=60)
    if world == 1:
        assert r.returncode == 0, r.stderr
        assert "ok {'pod': 1, 'agent': 1, 'fsdp': 1, 'model': 1}" in r.stdout
    else:  # the (1, 1, 1, 1) mesh needs 1 rank, the world has 4
        assert r.returncode == 3
        assert "needs 1 ranks but the world size is 4" in r.stdout


@pytest.mark.parametrize("arch", list_archs())
def test_flops_match_reference(arch):
    ref_model = ref_build_model(ref_get_config(arch))
    model = build_model(get_config(arch))
    assert flops.param_counts(model) == ref_flops.param_counts(ref_model)
    for name, shape in REF_SHAPES.items():
        assert flops.model_flops(model, INPUT_SHAPES[name]) == \
            ref_flops.model_flops(ref_model, shape)
    shapes = flops.param_shapes(model)
    leaves = jax.tree.leaves(shapes)  # meta tensors: nothing allocated
    assert leaves and all(x.device.type == "meta" for x in leaves)
    assert np.isfinite(float(flops.param_counts(model)["active"]))
