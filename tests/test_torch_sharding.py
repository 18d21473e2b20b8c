"""The port's sharding rules against the JAX package's: parameter specs of
every config (full and scaled down) on four meshes under the three
policies, batch and decode-cache specs exactly, and DTensor placements on a
fake (2, 2, 2) mesh."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.models import get_model
from repro_torch.sharding import rules
from repro_torch.tree import flatten_with_path


class FakeMesh:
    """Just enough of a mesh for either package's MeshInfo."""
    def __init__(self, shape_map):
        self.axis_names = tuple(shape_map)
        self.shape = dict(shape_map)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "16x8": {"data": 16, "model": 8},
          "1x1": {"data": 1, "model": 1}}
POLICIES = ("tp", "dp", "serve")


@pytest.fixture(autouse=True)
def default_policy():
    yield
    rules.set_policy("tp")
    ref_rules.set_policy("tp")


def configs(arch, scale):
    cfg = get_config(arch)
    ref = ref_get_config(arch)
    if scale == "scaled_down":
        cfg, ref = cfg.scaled_down(), ref.scaled_down()
    return cfg, ref


def ref_flat(tree):
    """keystr path -> leaf of a JAX tree whose leaves are specs or shapes."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): leaf for p, leaf in leaves}


def port_to_ref_path(path: str):
    """(reference path, stack dims) of a port leaf path: its list indices
    are the reference's leading stack dims."""
    import re
    n = len(re.findall(r"\[\d+\]", path))
    return re.sub(r"\[\d+\]", "", path), n


@pytest.mark.parametrize("scale", ["full", "scaled_down"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, scale):
    cfg, ref = configs(arch, scale)
    port_params = get_model(cfg, "cpu").init_abstract(max_seq=512)
    ref_params = ref_get_model(ref).init_abstract(max_seq=512)
    ref_shapes = ref_flat(ref_params)
    port_leaves = flatten_with_path(port_params)
    for mesh_name, shape_map in MESHES.items():
        for policy in POLICIES:
            rules.set_policy(policy)
            ref_rules.set_policy(policy)
            port = rules.param_specs(port_params, rules.MeshInfo(FakeMesh(shape_map)),
                                     cfg.n_experts)
            want = ref_flat(ref_rules.param_specs(
                ref_params, ref_rules.MeshInfo(FakeMesh(shape_map)), ref.n_experts))
            got = flatten_with_path(port, is_leaf=rules.is_spec)
            assert len(got) == len(port_leaves)
            seen = set()
            for (path, spec), (_p, leaf) in zip(got, port_leaves):
                ref_path, lead = port_to_ref_path(path)
                seen.add(ref_path)
                ref_spec = tuple(want[ref_path])
                ref_spec += (None,) * (len(ref_shapes[ref_path].shape) - len(ref_spec))
                assert all(a is None for a in ref_spec[:lead]), (path, ref_spec)
                full = tuple(spec) + (None,) * (leaf.dim() - len(spec))
                assert tuple(leaf.shape) == tuple(ref_shapes[ref_path].shape)[lead:]
                assert full == ref_spec[lead:], (arch, mesh_name, policy, path)
            assert seen == set(want), set(want) ^ seen


#: every config, and the transformer's again with the int8 decode cache
CACHE_CASES = [(arch, False) for arch in ARCH_IDS] + [
    (arch, True) for arch in ARCH_IDS if get_config(arch).family in ("dense", "moe", "vlm")]


@pytest.mark.parametrize("arch,quant", CACHE_CASES,
                         ids=[f"{a}-{'int8' if q else 'plain'}" for a, q in CACHE_CASES])
def test_batch_and_cache_specs_equal_the_reference(arch, quant):
    cfg, ref = configs(arch, "full")
    if quant:
        cfg = dataclasses.replace(cfg, cache_quant=True)
        ref = dataclasses.replace(ref, cache_quant=True)
    port_model, ref_model = get_model(cfg, "cpu"), ref_get_model(ref)
    for shape_name, shape in SHAPES.items():
        port_in = port_model.input_specs(shape)
        ref_in = ref_model.input_specs(REF_SHAPES[shape_name])
        port_shapes = {p: (tuple(t.shape), rules._dtype_name(t.dtype))
                       for p, t in flatten_with_path(port_in)}
        assert port_shapes == {p: (tuple(s.shape), str(s.dtype))
                               for p, s in ref_flat(ref_in).items()}
        for mesh_name, shape_map in MESHES.items():
            for policy in POLICIES:
                rules.set_policy(policy)
                ref_rules.set_policy(policy)
                info = rules.MeshInfo(FakeMesh(shape_map))
                ref_info = ref_rules.MeshInfo(FakeMesh(shape_map))
                if shape.kind == "decode":
                    got = rules.cache_specs(port_in["cache"], info,
                                            batch_size=shape.global_batch)
                    want = ref_rules.cache_specs(ref_in["cache"], ref_info,
                                                 batch_size=shape.global_batch)
                    got["token"] = rules.batch_spec({"t": port_in["token"]}, info)["t"]
                    want["token"] = ref_rules.batch_spec({"t": ref_in["token"]},
                                                         ref_info)["t"]
                else:
                    got = rules.batch_spec(port_in, info)
                    want = ref_rules.batch_spec(ref_in, ref_info)
                got = {p: tuple(s) for p, s in flatten_with_path(got, is_leaf=rules.is_spec)}
                assert got == {p: tuple(s) for p, s in ref_flat(want).items()}, \
                    (arch, shape_name, mesh_name, policy)


def test_cache_specs_dtype_set():
    """Only signed integer leaves of rank <= 2 take the kv_pos branch, as
    the reference's ``dtype.name.startswith("int")``."""
    info = rules.MeshInfo(FakeMesh({"data": 2, "model": 2}))
    for dt, want in [(torch.int8, True), (torch.int16, True), (torch.int32, True),
                     (torch.int64, True), (torch.uint8, False), (torch.bool, False),
                     (torch.bfloat16, False)]:
        leaf = torch.empty((3, 4), dtype=dt, device="meta")
        spec = rules.cache_specs({"x": leaf}, info, batch_size=4)["x"]
        assert (spec == (None, None)) == want, dt
    # an int8 K/V cache of rank > 2 takes the general branch
    kv = torch.empty((2, 4, 8, 2, 16), dtype=torch.int8, device="meta")
    assert rules.cache_specs({"k": kv}, info, batch_size=4)["k"] == \
        (None, "data", None, "model", None)


def test_rule_table_and_path_strings():
    assert rules._RULES == ref_rules._RULES
    assert rules._path_str("['layers'][0]['attn']['wq']") == "layers/0/attn/wq"
    assert rules._path_str("['local_layers'][2][4]['ln1']['scale']") == \
        "local_layers/2/4/ln1/scale"


def test_hooks_are_the_identity_on_plain_tensors():
    x = torch.randn(4, 8, 16)
    rules.set_activation_batch_axes(("data",))
    try:
        assert rules.constrain_batch(x) is x
        assert rules.constrain_batch_only(x) is x
        assert rules.replicate_dim(x, 0) is x
        assert rules.splittable(x, 2, 3) is x
        assert torch.equal(rules.lookup(x[0], torch.tensor([3, 1])), x[0][[3, 1]])
    finally:
        rules.set_activation_batch_axes(None)


PLACEMENTS = textwrap.dedent("""
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.rules import P, placements, distribute_tree, MeshInfo
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    fake_world(8)
    mesh = make_test_mesh(data=2, model=2, pod=2)
    info = MeshInfo(mesh)
    assert info.axis_names == ("pod", "data", "model") and info.data_size == 4
    R, S = Replicate(), Shard
    cases = {P(): (R, R, R), P(None, "model"): (R, R, S(1)),
             P(("pod", "data"), None): (S(0), S(0), R),
             P(("data", "model")): (R, S(0), S(0)),
             P("model", "data"): (R, S(1), S(0)),
             P(("pod", "data", "model"), None): (S(0), S(0), S(0))}
    for spec, want in cases.items():
        assert placements(spec, mesh) == want, (spec, placements(spec, mesh))
    for bad in (P(("data", "pod")), P("data", "data")):
        try:
            placements(bad, mesh)
        except AssertionError:
            continue
        raise SystemExit(f"{bad} was accepted")
    # round trip: the local shard of rank 0 is JAX's major-to-minor block
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    tree = distribute_tree({"a": x, "b": [x]}, {"a": P(("pod", "data"), "model"),
                                                "b": [P()]}, mesh)
    assert torch.equal(tree["a"].to_local(), x[:2, :3])
    assert torch.equal(tree["b"][0].to_local(), x)
    print("ok")
""")


def test_placements_round_trip_on_a_fake_mesh():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(["src", os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", PLACEMENTS], capture_output=True, text=True,
                       timeout=120, env=env)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stdout + r.stderr
