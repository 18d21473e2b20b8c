"""The MoE layer's kernels (``repro_torch.kernels.ops.moe_positions``,
``moe_dispatch``, ``moe_combine``) against its plain versions
(``models.layers.moe.queue_positions``, ``dispatch``, ``combine``).

On the CPU: ``apply_moe`` takes the plain path bit for bit, under autograd
too, and launches nothing; the plain versions equal a loop over the pairs;
each wrapper refuses what its kernel does not take and any tensor off the
card; which DTensor placements leave each device whole groups and experts.  On the card (marked ``cuda``, skipped without one; JAX-free):

    python -m pytest -q -m cuda tests/test_torch_moe_kernels.py

at both MoE cells' prefill and decode shapes: positions and dispatch equal
the plain versions bit for bit (a group with drops, a group of ties, a
group whose tokens all pick the same experts), combine and ``apply_moe``
within float32 summation order, two launches bit for bit, the launch
counts, autograd keeping the plain path, a one-card mesh's DTensors
running the kernels on their shards, and scaled-down granite_moe_3b's and
granite_h_small's greedy tokens through the kernels against the plain
path's."""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models import transformer as T
from repro_torch.models.layers import moe as M

ROOT = Path(__file__).resolve().parent.parent
COUNT_KEYS = ("moe_positions", "moe_dispatch", "moe_combine")


def layer_cfg(d, E, k, d_ff, dtype):
    """granite_moe_3b's MoE layer at another width, expert count and top-k."""
    return dataclasses.replace(get_config("granite_moe_3b"), d_model=d, n_experts=E,
                               n_experts_active=k, d_ff=d_ff, dtype=dtype)


def layer_params(cfg, seed, device):
    """The layer's leaves (``init_moe``'s), drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    draw = lambda shape, dtype: (torch.randn(shape, generator=gen, device=device)
                                 / shape[-2] ** 0.5).to(dtype)
    return {"router": draw((d, E), torch.float32), "wg": draw((E, d, f), dt),
            "wi": draw((E, d, f), dt), "wo": draw((E, f, d), dt)}


def layer_input(cfg, B, S, seed, device):
    """x (B, S, d) from the seed; with several groups a row, row 0's first
    group is all zeros (uniform gates: every token ties and takes experts
    0..k-1, so the first C of them keep) and its second repeats one token
    (every token the same experts: all drops past C)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=device)
    g = M.group_size(cfg, S)
    if S // g >= 2:
        x[0, :g] = 0
        x[0, g:2 * g] = x[0, g]
    return x.to(getattr(torch, cfg.dtype))


def plain_routing(r: M.Routing, E: int) -> M.Routing:
    """``r`` with the plain version's positions."""
    pos = M.queue_positions(r.topi, E)
    return M.Routing(r.g, r.C, r.topi, r.topv, pos, pos < r.C)


def loop_positions(topi, E):
    """Each pair's queue position by a loop over each group's pairs."""
    B_, n, g, k = topi.shape
    pos = torch.empty_like(topi)
    for b in range(B_):
        for m in range(n):
            seen = [0] * E
            for t in range(g):
                for j in range(k):
                    e = int(topi[b, m, t, j])
                    pos[b, m, t, j] = seen[e]
                    seen[e] += 1
    return pos


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,E,k", [(64, 8, 2), (96, 6, 3), (1, 8, 2)])
def test_plain_versions_equal_a_loop_over_the_pairs(S, E, k, dtype):
    """Positions, dispatch and combine of the plain path against loops: the
    dispatch buffer bit for bit, combine each token's gated kept rows."""
    cfg = dataclasses.replace(layer_cfg(32, E, k, 16, dtype), moe_group=32)
    params = layer_params(cfg, 0, "cpu")
    x = layer_input(cfg, 2, S, 1, "cpu")
    r = M.route(params, x, cfg)
    assert r.slot is None and r.inverse is None
    assert torch.equal(r.pos, loop_positions(r.topi, E))
    assert torch.equal(r.keep, r.pos < r.C)
    xe, slot = M.dispatch(r, x, E)
    B_, n, g, _ = r.topi.shape
    want = torch.zeros_like(xe)
    for b, m, t, j in (r.keep).nonzero().tolist():
        e, c = int(r.topi[b, m, t, j]), int(r.pos[b, m, t, j])
        want[e, (b * n + m) * r.C + c] = x[b, m * g + t]
    assert torch.equal(xe, want)
    ye = torch.randn(xe.shape, generator=torch.Generator().manual_seed(2)).to(xe.dtype)
    got = M.combine(r, ye, slot, x.dtype)
    for b, m, t in [(0, 0, 0), (B_ - 1, n - 1, g - 1)]:
        acc = torch.zeros(cfg.d_model, dtype=torch.float64)
        for j in range(k):
            if r.keep[b, m, t, j]:
                e, c = int(r.topi[b, m, t, j]), int(r.pos[b, m, t, j])
                w = r.topv[b, m, t, j].to(x.dtype).double()
                acc += w * ye[e, (b * n + m) * r.C + c].double()
        torch.testing.assert_close(got[b, m * g + t].double(), acc.to(x.dtype).double(),
                                   rtol=2 ** -7, atol=1e-6)
    if S >= 64:
        assert not r.keep.all()  # the repeated group drops


def compose_plain(params, x, cfg):
    """``apply_moe``'s plain path written out from its parts."""
    E = cfg.n_experts
    pr = plain_routing(M.route(params, x, cfg), E)
    xe, slot = M.dispatch(pr, x, E)
    h = M._act(cfg)(torch.bmm(xe, params["wg"])) * torch.bmm(xe, params["wi"])
    return M.combine(pr, torch.bmm(h, params["wo"]), slot, x.dtype)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_and_autograd_take_the_plain_path_bit_for_bit(dtype, grad):
    """On the CPU, with or without gradients wanted, ``apply_moe`` is its
    plain parts composed, bit for bit, launches nothing, and trains."""
    cfg = dataclasses.replace(layer_cfg(32, 8, 2, 16, dtype), moe_group=32)
    params = layer_params(cfg, 3, "cpu")
    x = layer_input(cfg, 2, 64, 4, "cpu")
    for p in params.values():
        p.requires_grad_(grad)
    before = {key: ops.COUNTS[key].launches for key in COUNT_KEYS}
    assert not M.on_card(params, x)
    got = M.apply_moe(params, x, cfg)
    assert torch.equal(got, compose_plain(params, x, cfg))
    assert {key: ops.COUNTS[key].launches for key in COUNT_KEYS} == before
    if grad:
        got.float().square().sum().backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in params.values())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_on_card_is_false_off_the_card(device):
    cfg = layer_cfg(32, 8, 2, 16, "bfloat16")
    params = {key: t.to(device) for key, t in layer_params(cfg, 0, "cpu").items()}
    assert not M.on_card(params, torch.zeros(1, 4, 32, device=device))


def wrapper_args(device="cpu"):
    """Valid arguments of the three wrappers: 2 rows of 2 groups of 8
    tokens, E 4, k 2, C 5, d 16 bf16."""
    topi = torch.tensor([[0, 1], [1, 2], [2, 3], [3, 0]] * 8).reshape(2, 2, 8, 2)
    x = torch.zeros(2, 16, 16, dtype=torch.bfloat16)
    inverse = torch.full((2, 2, 20), -1, dtype=torch.int32)
    ye = torch.zeros(4, 2 * 2 * 5, 16, dtype=torch.bfloat16)
    slot = torch.full((2, 2, 8, 2), -1, dtype=torch.int32)
    gates = torch.full((2, 2, 8, 2), 0.5)
    return [t.to(device) for t in (topi, x, inverse, ye, slot, gates)]


def call(name, topi, x, inverse, ye, slot, gates):
    if name == "positions":
        return ops.moe_positions(topi, 4, 5)
    if name == "dispatch":
        return ops.moe_dispatch(x, inverse, 4, 2)
    return ops.moe_combine(ye, slot, gates)


@pytest.mark.parametrize("name", ["positions", "dispatch", "combine"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrappers_refuse_a_tensor_off_the_card(name, device):
    """The wrappers have no plain branch: the kernel or a refusal."""
    with pytest.raises(ValueError, match="unsupported device"):
        call(name, *wrapper_args(device))


@pytest.mark.parametrize("name,change,match", [
    ("positions", lambda a: {**a, "topi": a["topi"].int()}, "int64"),
    ("dispatch", lambda a: {**a, "inverse": a["inverse"].long()}, "int32"),
    ("dispatch", lambda a: {**a, "x": a["x"].half()}, "float32 or bfloat16"),
    ("combine", lambda a: {**a, "gates": a["gates"].bfloat16()}, "float32 gates"),
    ("combine", lambda a: {**a, "slot": a["slot"].long()}, "int32"),
    ("combine", lambda a: {**a, "ye": a["ye"].half()}, "float32 or bfloat16")])
def test_wrappers_refuse_mixed_dtypes(name, change, match):
    topi, x, inverse, ye, slot, gates = wrapper_args()
    args = change(dict(topi=topi, x=x, inverse=inverse, ye=ye, slot=slot, gates=gates))
    with pytest.raises(ValueError, match=match):
        call(name, **args)


@pytest.mark.parametrize("name,change", [
    ("positions", lambda a: {**a, "topi": a["topi"].transpose(1, 2).contiguous()
                             .transpose(1, 2)}),
    ("dispatch", lambda a: {**a, "x": a["x"].transpose(0, 1).contiguous().transpose(0, 1)}),
    ("dispatch", lambda a: {**a, "inverse": a["inverse"].transpose(0, 1).contiguous()
                            .transpose(0, 1)}),
    ("combine", lambda a: {**a, "ye": a["ye"].transpose(0, 1).contiguous().transpose(0, 1)}),
    ("combine", lambda a: {**a, "gates": a["gates"].transpose(0, 1).contiguous()
                           .transpose(0, 1)})])
def test_wrappers_refuse_a_non_contiguous_input(name, change):
    topi, x, inverse, ye, slot, gates = wrapper_args()
    args = change(dict(topi=topi, x=x, inverse=inverse, ye=ye, slot=slot, gates=gates))
    assert not all(t.is_contiguous() for t in args.values())
    with pytest.raises(ValueError, match="contiguous"):
        call(name, **args)


@pytest.mark.parametrize("name,change,match", [
    ("positions", lambda a: {**a, "topi": a["topi"].reshape(4, 8, 2)}, "B, n, g, k"),
    ("positions", lambda a: {**a, "topi": a["topi"].repeat(1, 1, 1, 3)}, "experts a token"),
    ("dispatch", lambda a: {**a, "inverse": a["inverse"][:, :, :18].contiguous()}, "split"),
    ("dispatch", lambda a: {**a, "x": a["x"][:, :, :12].contiguous()}, "16 bytes"),
    ("combine", lambda a: {**a, "gates": a["gates"][..., :1].contiguous()}, "gates"),
    ("combine", lambda a: {**a, "ye": a["ye"][:, :19].contiguous()}, "capacity")])
def test_wrappers_refuse_a_wrong_shape(name, change, match):
    topi, x, inverse, ye, slot, gates = wrapper_args()
    args = change(dict(topi=topi, x=x, inverse=inverse, ye=ye, slot=slot, gates=gates))
    with pytest.raises(ValueError, match=match):
        call(name, **args)


@pytest.mark.parametrize("placements,sizes,rows,want", [
    (("R", "R"), (2, 4), False, True),
    (("S0", "R"), (2, 4), True, True),      # x split by batch rows: whole groups
    (("S0", "R"), (2, 4), False, False),    # experts split over 'data'
    (("S1", "R"), (2, 1), True, False),     # x split along the sequence: groups cut
    (("S1", "S0"), (1, 1), False, True),    # a one-card mesh holds everything
    (("R", "P"), (1, 2), True, False)])     # a partial sum is no whole tensor
def test_whole_on_each_device(placements, sizes, rows, want):
    """Which DTensor placements leave each device whole groups of x and
    every expert, so that the kernels can run on its shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    make = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1), "P": Partial()}
    assert M.whole([make[p] for p in placements], sizes, rows) is want


#: one rank of a (2, 1) ("data", "model") gloo mesh: the layer on each
#: rank's shards (the plain path here, the kernels on the card) against the
#: whole tensors, then the placements that split groups or experts refused
LOCAL_SHARDS = textwrap.dedent("""
    import dataclasses, sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import moe as M
    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    mesh = make_test_mesh(data=2, model=1)
    cfg = dataclasses.replace(get_config("granite_moe_3b"), d_model=32, n_experts=8,
                              n_experts_active=2, d_ff=16, dtype="float32", moe_group=16)
    gen = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(32, 8, generator=gen) / 6,
              **{key: torch.randn(shape, generator=gen) / 6 for key, shape in
                 (("wg", (8, 32, 16)), ("wi", (8, 32, 16)), ("wo", (8, 16, 32)))}}
    x = torch.randn(4, 64, 32, generator=gen)
    whole = (Replicate(), Replicate())
    dparams = {key: distribute_tensor(t, mesh, whole) for key, t in params.items()}
    got = M._on_local_shards(dparams, distribute_tensor(x, mesh, (Shard(0), Replicate())), cfg)
    assert isinstance(got, DTensor) and tuple(got.placements) == (Shard(0), Replicate())
    torch.testing.assert_close(got.full_tensor(), M.apply_moe(params, x, cfg),
                               rtol=1e-5, atol=1e-6)
    split_experts = dict(dparams, wg=distribute_tensor(params["wg"], mesh, (Shard(0), Replicate())))
    for p, dx in ((split_experts, distribute_tensor(x, mesh, (Shard(0), Replicate()))),
                  (dparams, distribute_tensor(x, mesh, (Shard(1), Replicate())))):
        try:
            M._on_local_shards(p, dx, cfg)
        except ValueError as e:
            assert "whole groups and experts" in str(e), e
        else:
            raise AssertionError("a split placement ran")
    dist.destroy_process_group()
    print("ok", rank)
""")


def test_local_shards_of_a_mesh_hold_whole_groups_and_experts():
    """On a 2-rank gloo mesh: x split by batch rows runs the layer on each
    rank's rows, equal to the whole layer and placed as x; experts split
    over the mesh, or x split along the sequence, raise."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", LOCAL_SHARDS, str(r), port], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240))
        finally:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and out.startswith(f"ok {r}"), out + err[-4000:]


def test_route_through_the_kernels_refuses_a_cpu_tensor():
    cfg = layer_cfg(32, 8, 2, 16, "bfloat16")
    with pytest.raises(ValueError, match="unsupported device"):
        M.route(layer_params(cfg, 0, "cpu"), layer_input(cfg, 1, 8, 1, "cpu"), cfg, card=True)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: each MoE cell's layer: (d, E, k, d_ff) and its prefill (B, S) and decode
#: (B, 1) shapes
CELLS = {"granite_moe_3b.long_prompt": ((1536, 40, 8, 512), (4, 3840)),
         "granite_h_small.rag_8k": ((4096, 72, 10, 768), (2, 8192))}
SHAPES = [(cell, phase) for cell in sorted(CELLS) for phase in ("prefill", "decode")]


def card_case(cell, phase, device, seed=0):
    (d, E, k, f), (B, S) = CELLS[cell]
    cfg = layer_cfg(d, E, k, f, "bfloat16")
    S = S if phase == "prefill" else 1
    return cfg, layer_params(cfg, seed, device), layer_input(cfg, B, S, seed + 1, device)


def assert_within_one_rounding(got, want32):
    """bf16 output against its float32 value: within the rounding to bf16
    (half an ulp, at most 2^-8 of it) plus float32 sums in another order."""
    torch.testing.assert_close(got.float(), want32, rtol=2 ** -8, atol=1e-5)


def combine_f32(r: M.Routing, ye: torch.Tensor, dtype) -> torch.Tensor:
    """Each token's gated sum of its kept pairs' rows in float32, from the
    one-hot definition (gates cast to ``dtype`` first, as both paths do)."""
    E, _, d = ye.shape
    B_, n, g, k = r.topi.shape
    ye = ye.float().reshape(E, B_, n, r.C, d).permute(1, 2, 0, 3, 4).reshape(B_, n, E * r.C, d)
    w = torch.where(r.keep, r.topv.to(dtype).float(), 0)
    slot = torch.where(r.keep, r.topi * r.C + r.pos, 0).reshape(B_, n, g * k, 1)
    picked = torch.gather(ye, 2, slot.expand(-1, -1, -1, d)).reshape(B_, n, g, k, d)
    return (w.unsqueeze(-1) * picked).sum(3).reshape(B_, n * g, d)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,phase", SHAPES)
def test_positions_and_dispatch_equal_the_plain_path(cuda_device, cell, phase):
    cfg, params, x = card_case(cell, phase, cuda_device)
    E, k = cfg.n_experts, cfg.n_experts_active
    with torch.inference_mode():
        r = M.route(params, x, cfg, card=True)
        pr = plain_routing(r, E)
        assert r.inverse is not None
        assert r.pos.dtype == pr.pos.dtype and torch.equal(r.pos, pr.pos)
        assert torch.equal(r.keep, pr.keep)
        assert torch.equal(r.slot.long(), torch.where(pr.keep, r.topi * r.C + r.pos, -1))
        B_, n, g, _ = r.topi.shape
        filled = r.inverse.reshape(B_ * n, -1)
        assert int((filled >= 0).sum()) == int(r.keep.sum())
        kept = r.slot.reshape(B_ * n, -1)
        for grp in (0, B_ * n - 1):
            p = (kept[grp] >= 0).nonzero().squeeze(1)
            assert torch.equal(filled[grp, kept[grp, p].long()].long(), p)
        if phase == "prefill":
            assert torch.equal(r.topi[0, 0], torch.arange(k, device=cuda_device).expand(g, k))
            assert not r.keep[0, 1].all() and r.keep[0, 0, :r.C].all()
            assert (r.topi[0, 1] == r.topi[0, 1, :1]).all()
        xe = ops.moe_dispatch(x, r.inverse, E, k)
        want, _slot = M.dispatch(pr, x, E)
        assert xe.dtype == want.dtype and torch.equal(xe, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,phase", SHAPES)
def test_combine_and_apply_moe_match_the_plain_path(cuda_device, monkeypatch, cell, phase):
    """Combine (ye from the seed) and the whole layer, kernels against the
    plain path on the card; both within one rounding of the float32 value."""
    cfg, params, x = card_case(cell, phase, cuda_device, seed=5)
    E = cfg.n_experts
    with torch.inference_mode():
        r = M.route(params, x, cfg, card=True)
        pr = plain_routing(r, E)
        _xe, slot = M.dispatch(pr, x, E)
        gen = torch.Generator(device=cuda_device).manual_seed(6)
        ye = torch.randn(_xe.shape, generator=gen, device=cuda_device).to(x.dtype)
        got = ops.moe_combine(ye, r.slot, r.topv)
        plain = M.combine(pr, ye, slot, x.dtype)
        want32 = combine_f32(pr, ye, x.dtype)
        assert got.dtype == x.dtype and got.shape == x.shape
        assert_within_one_rounding(got, want32)
        assert_within_one_rounding(plain, want32)
        layer = M.apply_moe(params, x, cfg)
        monkeypatch.setattr(M, "on_card", lambda _p, _x: False)
        plain_layer = M.apply_moe(params, x, cfg)
    torch.testing.assert_close(layer.float(), plain_layer.float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,phase", SHAPES)
def test_two_launches_give_the_same_bits_and_are_counted(cuda_device, cell, phase):
    cfg, params, x = card_case(cell, phase, cuda_device, seed=7)
    E, k = cfg.n_experts, cfg.n_experts_active
    B_, S, d = x.shape
    g = M.group_size(cfg, S)
    C = M.capacity(cfg, g)
    keys = {"moe_positions": (B_ * S // g, g, k, E, C),
            "moe_dispatch": (B_ * S // g, g, k, E, C, d, "bfloat16"),
            "moe_combine": (B_ * S // g, g, k, E, C, d, "bfloat16")}
    before = {key: (ops.COUNTS[key].launches, ops.COUNTS[key].shapes.get(keys[key], 0))
              for key in keys}
    with torch.inference_mode():
        r = M.route(params, x, cfg, card=True)
        topi = r.topi.contiguous()
        again = ops.moe_positions(topi, E, C)
        assert all(torch.equal(a, b) for a, b in zip(again, (r.pos, r.keep, r.slot, r.inverse)))
        xe = ops.moe_dispatch(x, r.inverse, E, k)
        assert torch.equal(ops.moe_dispatch(x, r.inverse, E, k), xe)
        out = ops.moe_combine(xe, r.slot, r.topv)
        assert torch.equal(ops.moe_combine(xe, r.slot, r.topv), out)
    torch.cuda.synchronize()
    for key, (launches, at_key) in before.items():
        assert ops.COUNTS[key].launches == launches + 2
        assert ops.COUNTS[key].shapes[keys[key]] == at_key + 2


@pytest.mark.cuda
def test_autograd_on_the_card_keeps_the_plain_path(cuda_device):
    cfg, params, x = card_case("granite_moe_3b.long_prompt", "decode", cuda_device)
    for p in params.values():
        p.requires_grad_(True)
    before = {key: ops.COUNTS[key].launches for key in COUNT_KEYS}
    assert not M.on_card(params, x)
    M.apply_moe(params, x, cfg).float().sum().backward()
    assert {key: ops.COUNTS[key].launches for key in COUNT_KEYS} == before
    with torch.no_grad():
        assert M.on_card(params, x)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_moe_3b", "granite_h_small"])
def test_granite_greedy_tokens_through_the_kernels_equal_the_plain_path(cuda_device,
                                                                      monkeypatch, arch):
    """Both MoE cells' models scaled down in float32 (so the order of
    combine's sum cannot flip a near tie), 4 x 64 prompt tokens and 8
    greedy steps: the tokens through the kernels, one launch of each a MoE
    layer a prefill and a step, equal those of the plain path on the card."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype="float32")
    moe_layers = sum(layer.moe for layer in T.schedule(cfg))
    assert moe_layers == cfg.n_layers
    model = get_model(cfg, cuda_device)
    params = model.init(0)
    batch = make_batch(cfg, ShapeConfig("t", 64, 4, "prefill"))

    def launched(before):
        return [ops.COUNTS[key].launches - before[i] for i, key in enumerate(COUNT_KEYS)]

    def greedy():
        with torch.inference_mode():
            before = [ops.COUNTS[key].launches for key in COUNT_KEYS]
            logits, cache = model.prefill(params, batch)
            counts = [launched(before)]
            toks = []
            for _ in range(8):
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(token)
                before = [ops.COUNTS[key].launches for key in COUNT_KEYS]
                logits, cache = model.decode_step(params, cache, token)
                counts.append(launched(before))
            return torch.cat(toks, dim=1).cpu(), counts

    kernel, counts = greedy()
    assert all(c == [moe_layers] * 3 for c in counts)
    monkeypatch.setattr(M, "on_card", lambda _p, _x: False)
    plain, counts = greedy()
    assert all(c == [0, 0, 0] for c in counts)
    assert torch.equal(kernel, plain)


@pytest.mark.cuda
def test_a_one_card_mesh_runs_the_kernels_on_its_shards(cuda_device):
    """A DTensor layer on a (1, 1) mesh (an NCCL group of one; the experts
    placed as the EP rule places them, x by batch rows) launches each
    kernel once on its local shards and gives the plain tensors' output
    bit for bit, placed as x."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import one_card_mesh
    cfg, params, x = card_case("granite_moe_3b.long_prompt", "prefill", cuda_device, seed=9)
    with torch.inference_mode():
        want = M.apply_moe(params, x, cfg)
    try:
        mesh = one_card_mesh(torch.device("cuda", torch.cuda.current_device()))
        dparams = {key: distribute_tensor(t, mesh, (Replicate(), Replicate()) if key == "router"
                                          else (Replicate(), Shard(0)))
                   for key, t in params.items()}
        dx = distribute_tensor(x, mesh, (Shard(0), Replicate()))
        before = [ops.COUNTS[key].launches for key in COUNT_KEYS]
        with torch.inference_mode():
            got = M.apply_moe(dparams, dx, cfg)
        assert [ops.COUNTS[key].launches for key in COUNT_KEYS] == [n + 1 for n in before]
        assert isinstance(got, DTensor) and tuple(got.placements) == tuple(dx.placements)
        assert torch.equal(got.to_local(), want)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
