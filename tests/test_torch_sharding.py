"""The port's sharding rules (`launch/mesh.py`, `distributed/sharding.py`,
`launch/shardings.py`) against the JAX package's on every architecture at
full width, shapes only: the reference's params from `jax.eval_shape`, the
port's under `FakeTensorMode`. Every param leaf's spec must equal the
reference's with the layer-stack entry dropped, on six meshes under every
combination of fsdp / kv_hd_shard / moe_ep; every cache leaf's spec the
reference's under each kv policy; the DTensor placements of a spec must
give the shard shapes of the reference's NamedSharding."""
import functools
import itertools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as ref_registry
from repro.launch import shardings as ref_sh
from repro.models import transformer as ref_tf
from repro_torch.configs import registry
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.models import transformer
from repro_torch.training import tree as tree_lib

ARCHS = sorted(registry.ALIASES)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
FLAGS = list(itertools.product((False, True), repeat=3))


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), mesh_lib.Mesh(names, sizes)


def _key(entry):
    return getattr(entry, "key", getattr(entry, "idx", None))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_registry.get_config(arch)
    shapes = jax.eval_shape(lambda k: ref_tf.init_params(cfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return cfg, {tuple(_key(e) for e in path): (path, leaf)
                 for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = registry.get_config(arch)
    with FakeTensorMode():
        params = transformer.init_params(cfg, seed=0, device="cpu",
                                         master=True)
    return cfg, params, tree_lib.leaves_with_path(params)


def _at(tree, path):
    """The entry of a spec tree at a leaf's path (a spec is a tuple, which
    the tree helpers would flatten)."""
    for k in path:
        tree = tree[k]
    return tree


def _ref_path(cfg, path):
    """The reference's path of a port leaf: the layer index dropped."""
    if sh.stack_count(cfg, path) is not None:
        return path[:2] + path[3:]
    return path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh_name):
    ref_cfg, ref = _ref_params(arch)
    cfg, _, flat = _port_params(arch)
    jmesh, mesh = _meshes(mesh_name)
    seen = set()
    for path, leaf in flat:
        rpath = _ref_path(cfg, path)
        assert rpath in ref, (arch, path)
        seen.add(rpath)
        jpath, rleaf = ref[rpath]
        count = sh.stack_count(cfg, path)
        lshape = sh.logical_shape(cfg, path, leaf.shape)
        want_shape = rleaf.shape[1:] if count is not None else rleaf.shape
        assert lshape == tuple(want_shape), (path, lshape, rleaf.shape)
        for fsdp, kv_hd, ep in FLAGS:
            got = sh.param_pspec(cfg, mesh, path, leaf, fsdp=fsdp,
                                 kv_hd_shard=kv_hd, moe_ep=ep)
            want = tuple(ref_sh.param_pspec(ref_cfg, jmesh, jpath, rleaf,
                                            fsdp=fsdp, kv_hd_shard=kv_hd,
                                            moe_ep=ep))
            if count is not None:
                want = want[1:]
            assert got == want, (arch, mesh_name, path, fsdp, kv_hd, ep,
                                 got, want)
    assert seen == set(ref), sorted(set(ref) - seen)[:5]


def test_param_shardings_tree_matches_param_pspec():
    cfg, params, flat = _port_params("qwen2-1.5b")
    _, mesh = _meshes("16x16")
    tree = sh.param_shardings(cfg, mesh, params, fsdp=True)
    for path, leaf in flat:
        assert _at(tree, path) == sh.param_pspec(cfg, mesh, path, leaf,
                                                 fsdp=True)


# every pair the reference runs (it skips whisper-tiny x long_500k)
CACHE_PAIRS = [(a, s) for a in ARCHS
               for s in ("decode_32k", "long_500k", "prefill_32k")
               if not registry.shape_supported(registry.get_config(a),
                                               registry.SHAPES[s])]


@pytest.mark.parametrize("arch,shape_name", CACHE_PAIRS)
def test_cache_specs_equal_reference(arch, shape_name):
    shape = registry.SHAPES[shape_name]
    ref_shape = ref_registry.SHAPES[shape_name]
    cfg = registry.adapt_for_shape(registry.get_config(arch), shape)
    ref_cfg = ref_registry.adapt_for_shape(ref_registry.get_config(arch),
                                           ref_shape)
    with FakeTensorMode():
        specs = registry.input_specs(cfg, shape, device="cpu")
    ref_specs = ref_registry.input_specs(ref_cfg, ref_shape)
    flat = tree_lib.leaves_with_path(specs["cache"])
    rflat, _ = jax.tree_util.tree_flatten_with_path(ref_specs["cache"])
    assert [tuple(_key(e) for e in p) for p, _ in rflat] == \
        [p for p, _ in flat]
    for mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
        for policy in ("hd_model", "replicate", "seq_model"):
            got = sh.cache_shardings(mesh, specs["cache"], kv_policy=policy)
            want = ref_sh.cache_shardings(jmesh, ref_specs["cache"],
                                          kv_policy=policy)
            wflat = jax.tree_util.tree_leaves(
                want, is_leaf=lambda x: isinstance(x, NamedSharding))
            assert [tuple(w.spec) for w in wflat] == \
                [_at(got, p) for p, _ in flat], \
                (arch, shape_name, mesh_name, policy)
        got = sh.input_shardings(mesh, {k: v for k, v in specs.items()
                                        if k != "cache"})
        want = ref_sh.input_shardings(
            jmesh, {k: v for k, v in ref_specs.items() if k != "cache"})
        assert {k: tuple(v.spec) for k, v in want.items()} == got


@pytest.mark.parametrize("mesh_name", ["2x2", "4x1"])
def test_placements_give_reference_shard_shapes(mesh_name):
    import torch.distributed as dist
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore
    jmesh, mesh = _meshes(mesh_name)
    ref_cfg, ref = _ref_params("qwen3-moe-30b-a3b")
    cfg, _, flat = _port_params("qwen3-moe-30b-a3b")
    dist.init_process_group("fake", store=FakeStore(), world_size=4, rank=0)
    try:
        dm = mesh_lib.device_mesh(mesh, device_type="cpu")
        assert dm.mesh_dim_names == mesh.axis_names
        for fsdp, ep in ((False, False), (True, True)):
            for path, leaf in flat:
                spec = sh.param_pspec(cfg, mesh, path, leaf, fsdp=fsdp,
                                      moe_ep=ep)
                lshape = sh.logical_shape(cfg, path, leaf.shape)
                local, _ = compute_local_shape_and_global_offset(
                    lshape, dm, shd.placements(mesh, spec))
                want = NamedSharding(jmesh, P(*spec)).shard_shape(lshape)
                assert tuple(local) == tuple(want), (path, spec)
        # a tuple axis shards one dim over both mesh dims, major first
        spec = (("data", "model"), None)
        local, _ = compute_local_shape_and_global_offset(
            (8, 3), dm, shd.placements(mesh, spec))
        assert tuple(local) == NamedSharding(jmesh, P(*spec)).shard_shape(
            (8, 3))
        with pytest.raises(RuntimeError):
            mesh_lib.device_mesh(mesh_lib.make_production_mesh())
    finally:
        dist.destroy_process_group()


def test_device_mesh_and_constraint_raise():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        mesh_lib.device_mesh(mesh_lib.make_local_mesh())
    x = torch.ones(4, 4)
    assert shd.constraint(x, mesh_lib.make_local_mesh(), ("data", None)) is x
    with pytest.raises(NotImplementedError):
        shd.constraint(x, mesh_lib.make_edge_mesh(4), ("data", None))
    with pytest.raises(ValueError):
        shd.placements(mesh_lib.make_local_mesh(), (("model", "data"), None))


def test_mesh_helpers_match_reference():
    from repro.distributed import sharding as ref_shd
    for name in MESHES:
        jmesh, mesh = _meshes(name)
        assert mesh.shape == dict(jmesh.shape)
        assert shd.batch_axes(mesh) == ref_shd.batch_axes(jmesh)
        assert shd.model_axis(mesh) == ref_shd.model_axis(jmesh)
        for dim in (1, 2, 3, 8, 16, 48, 512):
            for axis in (None, "data", "model", ("data", "model"),
                         shd.batch_axes(mesh)):
                assert shd.shardable(mesh, dim, axis) == \
                    ref_shd.shardable(jmesh, dim, axis)
    assert mesh_lib.make_production_mesh().axis_sizes == (16, 16)
    assert mesh_lib.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert mesh_lib.named_mesh("h100x4").shape == {"data": 4, "model": 1}
