"""The port's cost walker (``repro_torch.launch.opcost``) on hand-countable
programs, the counterparts of tests/test_sharding_hlocost.py:64-104 (a
chain of products, a nested loop) and tests/test_multidevice.py:158 (a
psum at several mesh sizes, held to the reference's ``hlo_cost`` of the
same program on n virtual devices); each collective by its formula under
torch's fake process group; the node boundary (NVLink inside a node of 8
cards, the network across); the flash operator on fake CUDA tensors; the
breakdown by scope, backward included; DTensor's own shape propagation
left out; and the live-storage peak."""
import json
import textwrap

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.launch.opcost import OpCost
from repro_torch.utils import cost_scope
from tests.test_multidevice import run_with_devices

FP32 = 4


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference_psum():
    """The reference's ``hlo_cost`` of a psum of (n, 1,024) fp32 over n
    virtual devices, n = 2, 4, 8 (tests/test_multidevice.py:158)."""
    out = run_with_devices(textwrap.dedent("""
        import json
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.launch.hlocost import hlo_cost
        from repro.utils import make_mesh_compat, shard_map_compat
        got = {}
        for n in (2, 4, 8):
            mesh = make_mesh_compat((n,), ("d",))
            f = jax.jit(shard_map_compat(lambda x: jax.lax.psum(x, "d"),
                                         mesh=mesh, in_specs=P("d"),
                                         out_specs=P()))
            c = f.lower(jax.ShapeDtypeStruct((n, 1024), jnp.float32)).compile()
            got[n] = hlo_cost(c.as_text())["ici_bytes"]
        print("JSON", json.dumps(got))
    """))
    line = [ln for ln in out.splitlines() if ln.startswith("JSON")][0]
    return {int(k): v for k, v in json.loads(line[5:]).items()}


def test_torch_opcost_counts_a_chain_of_products():
    x = torch.randn(64, 64)
    ws = torch.randn(7, 64, 64)

    def chain(x, ws):
        for w in ws:
            x = x @ w
        return x
    with OpCost() as walker:
        chain(x, ws)
    cost = walker.result()
    assert cost["flops"] == pytest.approx(7 * 2 * 64 ** 3, rel=1e-6)
    # each product reads its two operands and writes its output, and the
    # walk over ``ws`` is views: the operand traffic exactly, where the
    # reference's HLO adds its fusions' copies on top
    assert cost["bytes"] == 7 * (3 * 64 * 64 * FP32)


def test_torch_opcost_counts_every_trip_of_a_nested_loop():
    x = torch.randn(32, 32)
    w = torch.randn(32, 32)
    with OpCost() as walker:
        for i in range(5):
            with cost_scope(f"outer{i}"):
                for _ in range(3):
                    with cost_scope("inner"):
                        x = x @ w
    assert walker.result()["flops"] == pytest.approx(5 * 3 * 2 * 32 ** 3,
                                                     rel=1e-6)
    rows = {r["scope"]: r for r in walker.breakdown()}
    assert set(rows) == {f"outer{i}/inner" for i in range(5)}
    assert all(r["flops"] == 3 * 2 * 32 ** 3 for r in rows.values())


def test_torch_opcost_files_backward_under_its_forward_scope():
    """Each backward operation lands under the scope of the forward
    operation whose node runs it; a checkpointed layer's recompute under
    that layer."""
    from torch.utils.checkpoint import checkpoint

    x = torch.randn(8, 16)
    ws = [torch.randn(16, 16, requires_grad=True) for _ in range(2)]

    def mlp(h, w):
        with cost_scope("mlp"):
            return torch.tanh(h @ w)
    with OpCost() as walker:
        h = x
        for i, w in enumerate(ws):
            with cost_scope(f"layer{i}"):
                h = (checkpoint(mlp, h, w, use_reentrant=False) if i
                     else mlp(h, w))
        torch.autograd.grad(h.sum(), ws)
    flops = {r["scope"]: r["flops"] for r in walker.breakdown()}
    one = 2 * 8 * 16 * 16
    assert flops["layer0/mlp"] == one and flops["layer1/mlp"] == one
    assert flops["layer1/recompute"] == one
    # the weight's gradient, and the input's where it requires grad
    assert flops["layer1/mlp/backward"] == 2 * one
    assert flops["layer0/mlp/backward"] == one


def test_torch_opcost_views_move_nothing_and_broadcasts_read_once():
    x = torch.randn(4, 256)
    with OpCost() as walker:
        x.view(16, 64).t()
        x.expand(8, 4, 256) + 1.0
    # the add reads the 4 x 256 source once and writes 8 x 4 x 256
    assert walker.result()["bytes"] == (4 + 32) * 256 * FP32


@pytest.mark.parametrize("n", [2, 4, 8])
def test_torch_opcost_all_reduce_equals_the_reference(fake_group,
                                                      reference_psum, n):
    fake_group(n)
    t = torch.ones(1024)
    with OpCost() as walker:
        dist.all_reduce(t)
    cost = walker.result()
    want = 2 * 4096 * (n - 1) / n
    assert abs(cost["nvlink_bytes"] - want) < 1
    assert abs(cost["nvlink_bytes"] - reference_psum[n]) < 1
    assert cost["network_bytes"] == 0
    assert cost["collectives"] == {"all_reduce": want}


def _gather(t, n):
    out = torch.empty(n * t.numel())
    dist.all_gather_into_tensor(out, t)


def _scatter(t, n):
    out = torch.empty(t.numel() // n)
    dist.reduce_scatter_tensor(out, t)


def _all_to_all(t, n):
    dist.all_to_all_single(torch.empty_like(t), t)


def _send(t, n):
    dist.send(t, 1)


def _recv(t, n):
    dist.recv(t, 1)


def _functional_all_reduce(t, n):
    funcol.wait_tensor(funcol.all_reduce(t, "sum", dist.group.WORLD))


def _functional_gather(t, n):
    funcol.wait_tensor(funcol.all_gather_tensor(t, 0, dist.group.WORLD))


# kind -> (the call, the wire bytes of 1,024 fp32 at world n)
FORMULAS = {
    "all_gather": (_gather, lambda b, n: n * b * (n - 1) / n),
    "reduce_scatter": (_scatter, lambda b, n: b * (n - 1) / n),
    "all_to_all": (_all_to_all, lambda b, n: b * (n - 1) / n),
    "send": (_send, lambda b, n: b),
    "recv": (_recv, lambda b, n: b),
    "functional all_reduce": (_functional_all_reduce,
                              lambda b, n: 2 * b * (n - 1) / n),
    "functional all_gather": (_functional_gather,
                              lambda b, n: n * b * (n - 1) / n),
}


@pytest.mark.parametrize("kind", list(FORMULAS))
def test_torch_opcost_collectives_by_their_formulas(fake_group, kind):
    n = 4
    fake_group(n)
    call, formula = FORMULAS[kind]
    t = torch.ones(1024)
    with OpCost() as walker:
        call(t, n)
    cost = walker.result()
    assert cost["nvlink_bytes"] == pytest.approx(formula(4096, n), abs=1)
    assert sum(cost["collectives"].values()) == cost["nvlink_bytes"]


@pytest.mark.parametrize("ranks,peer,link", [
    (list(range(8)), 3, "nvlink_bytes"),
    ([0, 8], 8, "network_bytes"),
    (list(range(4, 12)), 9, "network_bytes")])
def test_torch_opcost_node_boundary(fake_group, ranks, peer, link):
    """At world 16, two nodes of 8: a group inside node 0 is NVLink, one
    across nodes the network; so is a send to a card of the other node."""
    fake_group(16)
    group = dist.new_group(ranks) if 0 in ranks else None
    t = torch.ones(256)
    with OpCost() as walker:
        if group is not None:
            dist.all_reduce(t, group=group)
        dist.send(t, peer)
    cost = walker.result()
    other = ({"nvlink_bytes", "network_bytes"} - {link}).pop()
    n = len(ranks)
    want = (2 * 1024 * (n - 1) / n if group is not None else 0) + 1024
    assert cost[link] == pytest.approx(want)
    assert cost[other] == 0


def test_torch_opcost_flash_operator_on_fake_cuda_tensors():
    B, S, H, hd = 2, 128, 4, 64
    with FakeTensorMode():
        q, k, v = (torch.empty((B, S, H, hd), dtype=torch.bfloat16,
                               device="cuda") for _ in range(3))
        with OpCost() as walker:
            o = fa_kernel.flash_attention(q, k, v)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert o.device.type == "cuda"
    cost = walker.result()
    assert cost["flops"] == 4 * B * H * hd * S * (S + 1) // 2
    assert cost["flops"] == fa_kernel.flash_flops(B, S, H, hd)
    assert cost["bytes"] == 4 * B * S * H * hd * 2     # q, k, v and o
    assert cost["kernel_calls"] == {"flash_attention": 1}
    assert fa_kernel.flash_attention.launches == 0


def test_torch_flash_flop_formula_reaches_flop_counter():
    """The operator's registered formula, as ``FlopCounterMode`` reads it:
    17.20 GFLOP at B·H 64, S 1,024, hd 128 (the kernel table's bound)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        q = torch.empty((4, 1024, 16, 128), dtype=torch.bfloat16,
                        device="cuda")
        with FlopCounterMode(display=False) as counter:
            fa_kernel.flash_attention(q, q, q)
    assert counter.get_total_flops() == 17_196_646_400


def test_torch_opcost_leaves_dtensor_propagation_out(fake_group):
    """A DTensor product at world 4 counts the local product only, not the
    global-shape one DTensor's sharding propagation runs on fake
    tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    fake_group(4)
    mesh = init_device_mesh("cpu", (4,))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0)])
        w = distribute_tensor(torch.empty(32, 16), mesh, [Replicate()])
        with OpCost() as walker:
            x @ w
    assert walker.result()["flops"] == 2 * 16 * 32 * 16


def test_torch_opcost_follows_the_live_peak():
    walker = OpCost(memory=True)
    kept = torch.ones(256)
    assert walker.track(kept) == 256 * FP32
    with walker:
        a = torch.ones(1000)
        b = torch.ones(2000)
        del a
        c = torch.ones(500)
        peak = walker.peak_bytes
    assert peak == (256 + 1000 + 2000) * FP32
    assert walker.live_bytes == (256 + 2000 + 500) * FP32
    del b, c
    assert walker.live_bytes == 256 * FP32
