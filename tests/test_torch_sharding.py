"""The port's sharding rules against the reference's, on the CPU: every
parameter of every arch (full configs, as ``meta`` shapes against
``jax.eval_shape``) on the 2×16×16 and 16×16 production meshes with fsdp
off and on, every batch and cache leaf (with ``seq_parallel`` and
``dp_sp``), the reference's ``sanitize_spec``/``filter_spec`` cases, and
``to_placements`` on a fake process group, whose local shapes follow the
specs.  Specs are equal entry for entry (the reference's stacked leading
``None`` dropped); there is no tolerance."""

import dataclasses

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.parallel import sharding

P = sharding.P
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    """Both production meshes: the reference's AbstractMesh and the port's
    on one fake process group of 512 ranks (the 16×16 mesh takes the
    first 256)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    port = {name: mesh_mod.make_abstract_mesh(*MESHES[name]) for name in ("2x16x16", "16x16")}
    yield port, {name: ref_abstract_mesh(*shape_axes) for name, shape_axes in MESHES.items()}
    if dist.is_initialized():
        dist.destroy_process_group()


def _port_mesh(port, name):
    return port[name]


def _path(path) -> str:
    return ref_sharding._path_str(path)


def _ref_leaves(tree):
    return [(_path(p), leaf) for p, leaf in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]]


def _port_name(ref_path: str, cfg, i: int) -> str:
    """The port's ``state_dict`` name of repeat ``i`` of a reference path."""
    parts = ref_path.split("/")
    U = len(cfg.unit)
    if parts[0] == "units":
        return ".".join([f"layers.{i * U + int(parts[1])}", *parts[2:]])
    if parts[0] == "tail":
        return ".".join([f"layers.{cfg.n_units * U + int(parts[1])}", *parts[2:]])
    return ".".join(parts)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_every_leaf(arch, meshes):
    port_meshes, ref_meshes = meshes
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    ref_shapes = ref_steps.param_shapes(ref_cfg)
    port_shapes = steps.param_shapes(cfg)
    checked = 0
    for name in MESHES:
        for fsdp in (False, True):
            ref_specs = dict(_ref_leaves(ref_sharding.param_specs(
                ref_shapes, ref_cfg, fsdp=fsdp, mesh=ref_meshes[name])))
            port_specs = sharding.param_specs(port_shapes, cfg, fsdp=fsdp,
                                              mesh=_port_mesh(port_meshes, name))
            for path, leaf in _ref_leaves(ref_shapes):
                want = tuple(ref_specs[path])
                stacked = path.startswith("units/")
                for i in range(cfg.n_units if stacked else 1):
                    port_name = _port_name(path, cfg, i)
                    assert tuple(port_shapes[port_name].shape) == tuple(
                        leaf.shape[1:] if stacked else leaf.shape), port_name
                    got = tuple(port_specs[port_name])
                    assert got == (want[1:] if stacked else want), (name, fsdp, port_name)
                    checked += 1
    assert checked == 4 * len(port_shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_reference(arch, meshes):
    port_meshes, ref_meshes = meshes
    for mode in ("tp", "dp_sp"):
        cfg = dataclasses.replace(get_config(arch), shard_mode=mode)
        ref_cfg = dataclasses.replace(ref_get_config(arch), shard_mode=mode)
        for name in MESHES:
            pm, rm = _port_mesh(port_meshes, name), ref_meshes[name]
            for shape in SHAPES:
                port_in, ref_in = input_specs(cfg, SHAPES[shape]), ref_input_specs(
                    ref_cfg, REF_SHAPES[shape])
                for sp in (False, True):
                    got = sharding.batch_specs(port_in, seq_parallel=sp, mesh=pm)
                    want = ref_sharding.batch_specs(ref_in, seq_parallel=sp, mesh=rm)
                    assert {k: tuple(v) for k, v in got.items()} == {
                        k: tuple(v) for k, v in want.items()}, (name, shape, sp)
            cell = SHAPES["decode_32k"]
            port_c = steps.cache_shapes(cfg, cell.global_batch, cell.seq_len)
            ref_c = ref_steps.cache_shapes(ref_cfg, cell.global_batch, cell.seq_len)
            got = sharding.cache_specs(port_c, cfg, mesh=pm)
            want = dict(_ref_leaves(ref_sharding.cache_specs(ref_c, ref_cfg, mesh=rm)))
            n = 0
            for path, leaf in _ref_leaves(ref_c):
                parts = path.split("/")
                stacked = parts[0] == "units"
                for i in range(cfg.n_units if stacked else 1):
                    layer = int(_port_name(path, cfg, i).split(".")[1])
                    spec = tuple(got[layer][parts[-1]])
                    assert spec == (tuple(want[path])[1:] if stacked else tuple(want[path]))
                    assert tuple(port_c[layer][parts[-1]].shape) == tuple(
                        leaf.shape[1:] if stacked else leaf.shape)
                    n += 1
            assert n == sum(len(c) for c in port_c)


def test_sanitize_and_filter_cases_of_the_reference(meshes):
    mesh = meshes[0]["2x16x16"]
    # mamba vocab 50280 % 16 != 0 → model axis must be dropped
    assert tuple(sharding.sanitize_spec(P("model", None), (50280, 1536), mesh)) == (None, None)
    assert tuple(sharding.sanitize_spec(P("model", None), (50304, 1536), mesh)) == ("model", None)
    # tuple axes: batch 8 not divisible by pod*data=32 → dropped
    assert tuple(sharding.sanitize_spec(P(("pod", "data"), None), (8, 4), mesh)) == (None, None)
    single = meshes[0]["16x16"]
    assert tuple(sharding.filter_spec(P(("pod", "data"), "model"), single)) == ("data", "model")
    # the reference agrees on every case
    ref_mesh = ref_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    for spec, shape in (((("model", None)), (50280, 1536)), (("model", None), (50304, 1536)),
                        ((("pod", "data"), None), (8, 4))):
        assert tuple(sharding.sanitize_spec(P(*spec), shape, mesh)) == tuple(
            ref_sharding.sanitize_spec(JP(*spec), shape, ref_mesh))


def test_to_placements_round_trip_local_shapes(meshes):
    port_meshes, _ = meshes
    mesh = port_meshes["16x16"]
    cases = [  # spec, global shape, local shape on rank 0
        (P("data", "model"), (64, 32), (4, 2)),
        (P(None, "model"), (64, 32), (64, 2)),
        (P(("data", "model"), None), (512, 8), (2, 8)),
        (P(("pod", "data"), None), (64, 8), (4, 8)),  # pod is not on this mesh
        (P(), (5, 3), (5, 3)),
    ]
    names = mesh.mesh_dim_names
    for spec, shape, local in cases:
        t = sharding.place(torch.empty(shape, device="meta"), mesh, spec)
        assert tuple(t.shape) == shape and tuple(t.to_local().shape) == local, spec
        # the placements name the spec's axes, major first
        back = [()] * len(shape)
        for i, pl in enumerate(t.placements):
            if pl.is_shard():
                back[pl.dim] += (names[i],)
        back = tuple(None if not b else b[0] if len(b) == 1 else b for b in back)
        want = tuple(sharding.filter_spec(spec, mesh))
        assert back == want + (None,) * (len(shape) - len(want)), spec
    with pytest.raises(ValueError, match="axis order"):
        sharding.to_placements(P(("model", "data")), mesh)
