"""The port's sharding rules, cost analysis and training launcher, in
process, held against the JAX package: twins of ``test_distributed.py``'s
``test_sharding_divisibility_rules`` and ``test_zero_spec_picks_divisible_
dim``, of ``test_hlo_analysis.py``'s FLOP and byte cases (the port counts
a traced torch step where the reference parses HLO), spec parity for every
family on the production 16x16 mesh, DTensor placements of the specs, and
``launch.train`` against the reference's ``Trainer``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro import configs as rconfigs
from repro.distributed import sharding as rshr
from repro_torch import configs
from repro_torch.distributed import sharding as shr
from repro_torch.distributed.sharding import P
from repro_torch.launch.hlo_analysis import collective_bytes, hlo_cost, trace

from torch_twin import port_params


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class Names:
    """Just the dim names, as ``placements`` reads them."""
    def __init__(self, *names):
        self.mesh_dim_names = names


LM_ARCHS = ("olmoe_1b_7b", "granite_moe_1b_a400m", "starcoder2_3b",
            "qwen2_1_5b", "stablelm_3b")


def _same(port, ref):
    """Spec trees equal entry for entry (the port's specs are tuples)."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, list):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _same(a, b)
    else:
        assert isinstance(ref, RP) and isinstance(port, P)
        assert tuple(port) == tuple(ref), (port, ref)
        assert ref == port


def test_sharding_divisibility_rules():
    cfg = configs.get("qwen2_1_5b").config()     # 12 heads: NOT divisible
    specs = shr.lm_param_specs(cfg, FakeMesh())
    assert specs["layers"]["wq"] == P(None, None, None)
    assert specs["layers"]["w_in"][2] == "model"  # d_ff 8960 divisible
    cfg2 = configs.get("stablelm_3b").config()   # 32 heads: divisible
    specs2 = shr.lm_param_specs(cfg2, FakeMesh())
    assert specs2["layers"]["wq"][2] == "model"


def test_zero_spec_picks_divisible_dim():
    s = shr.zero_spec(P(None, None, "model"), (30, 3072, 128), FakeMesh())
    assert s == P(None, "data", "model")


def test_partition_spec_behaves_as_the_reference():
    assert P(("a",)) == P("a") == RP("a")
    assert P("a") != P("a", None) and RP("a") != RP("a", None)
    assert P(("pod", "data"), None) == RP(("pod", "data"), None)
    assert repr(P(("pod", "data"), None)) == repr(RP(("pod", "data"), None))
    assert hash(P("a", None)) == hash(P(("a",), None))


@pytest.mark.parametrize("mesh", [FakeMesh, FakePodMesh])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_specs_match_reference(arch, mesh):
    cfg, rcfg = configs.get(arch).config(), rconfigs.get(arch).config()
    _same(shr.lm_param_specs(cfg, mesh()), rshr.lm_param_specs(rcfg, mesh()))
    for seq in (False, True):
        _same(shr.lm_cache_specs(cfg, mesh(), seq),
              rshr.lm_cache_specs(rcfg, mesh(), seq))
    _same(shr.lm_batch_spec(mesh()), rshr.lm_batch_spec(mesh()))
    assert shr.dp_axes(mesh()) == rshr.dp_axes(mesh())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_opt_state_specs_match_reference(arch):
    from repro.models import transformer as rtfm
    from repro_torch.launch.specs import eval_shape
    from repro_torch.models import transformer as tfm
    cfg, rcfg = configs.get(arch).config(), rconfigs.get(arch).config()
    shapes = eval_shape(lambda: tfm.init_params(
        torch.Generator().manual_seed(0), cfg))
    rshapes = jax.eval_shape(lambda: rtfm.init_params(jax.random.PRNGKey(0),
                                                      rcfg))
    for zero in (True, False):
        _same(shr.opt_state_specs(shr.lm_param_specs(cfg, FakeMesh()),
                                  shapes, FakeMesh(), zero),
              rshr.opt_state_specs(rshr.lm_param_specs(rcfg, FakeMesh()),
                                   rshapes, FakeMesh(), zero))


def test_gnn_and_recsys_specs_match_reference():
    from repro.models import recsys as rrecsys
    from repro.models.gnn import build as rbuild
    from repro.models.gnn import gatedgcn as rgatedgcn
    from repro.models.gnn import mace as rmace
    from repro_torch.launch.specs import eval_shape
    from repro_torch.models import recsys
    from repro_torch.models.gnn import build, gatedgcn, mace
    for mesh in (FakeMesh(), FakePodMesh()):
        for rep in (True, False):
            _same(shr.gnn_data_specs(mesh, rep),
                  rshr.gnn_data_specs(mesh, rep))
    cfg = configs.get("wide_deep").config()
    shapes = eval_shape(lambda: recsys.init_params(
        torch.Generator().manual_seed(0), cfg))
    rshapes = jax.eval_shape(lambda: rrecsys.init_params(
        jax.random.PRNGKey(0), rconfigs.get("wide_deep").config()))
    _same(shr.recsys_param_specs(shapes, FakeMesh()),
          rshr.recsys_param_specs(rshapes, FakeMesh()))
    for m, rm, arch in ((gatedgcn, rgatedgcn, "gatedgcn"),
                        (mace, rmace, "mace")):
        shapes = eval_shape(lambda: m.init_params(
            torch.Generator().manual_seed(0), configs.get(arch).config()))
        rshapes = jax.eval_shape(lambda: rm.init_params(
            jax.random.PRNGKey(0), rconfigs.get(arch).config()))
        _same(build._param_specs(shapes, FakeMesh()),
              rbuild._param_specs(rshapes, FakeMesh()))


def test_placements_split_pod_data_major_to_minor():
    from torch.distributed.tensor import Replicate, Shard
    mesh = Names("pod", "data", "model")
    assert shr.placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert shr.placements(P(None, ("data", "model")), mesh) == (
        Replicate(), Shard(1), Shard(1))
    assert shr.placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="two dims"):
        shr.placements(P("data", "data"), mesh)


def test_layout_helpers_leave_plain_tensors_alone():
    """The mesh layer's DTensor layouts compute what the plain code does on
    plain tensors, bit for bit: a single device's results do not change."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, generator=g)
    idx = torch.randint(0, 5, (6, 1), generator=g)
    assert shr.keep_batch(x) is x and shr.keep_split(x, (1,)) is x
    assert shr.whole(x) is x and shr.split_over(x, 0, ("pod", "data")) is x
    assert torch.equal(shr.take_sharded(
        lambda t, i: t.gather(-1, i), x, -1, idx), x.gather(-1, idx))
    a, b = torch.randn(4, 3, 2, generator=g), torch.randn(2, generator=g)
    roles = ("n", None, "c")
    assert torch.equal(shr.on_shards(lambda u, v: u * v, (a, b),
                                     (roles, ("c",)), roles), a * b)
    dst = torch.tensor([0, 2, 2, 1, 0, 2])

    def scatter(m, d):
        return torch.full((3, 5), float("-inf")).scatter_reduce(
            0, d[:, None].expand_as(m), m, "amax", include_self=False)

    assert torch.equal(shr.scatter_extremum(scatter, x, dst, "amax"),
                       scatter(x, dst))


# ---------------------------------------------------------------------------
# Cost analysis (twins of test_hlo_analysis.py)
# ---------------------------------------------------------------------------


def test_scan_flops_trip_count():
    x, ws = torch.ones(128, 128), torch.ones(7, 128, 128)

    def scanned(x, ws):
        for w in ws:                   # eager: each trip runs and counts
            x = x @ w
        return x

    _, rec = trace(scanned, x, ws)
    assert hlo_cost(rec)["flops"] == 7 * 2 * 128 ** 3


def test_nested_scan_flops():
    x, ws = torch.ones(64, 64), torch.ones(5, 64, 64)

    def outer(x, ws):
        for _ in range(3):
            for w in ws:
                x = x @ w
        return x

    _, rec = trace(outer, x, ws)
    assert hlo_cost(rec)["flops"] == 3 * 5 * 2 * 64 ** 3


def test_products_listed_by_operand_shapes():
    """Each operation with FLOPs is tallied by its name and operands'
    shapes, so a product whole over a mesh dim shows beside a split one;
    elementwise work is not listed."""
    def step(x, w, v):
        return torch.sin(x @ w) @ v + x @ w

    _, rec = trace(step, torch.ones(8, 4), torch.ones(4, 6),
                   torch.ones(6, 6))
    assert dict(rec.by_product) == {
        "mm (8,4)x(4,6)": {"count": 2, "flops": 2 * 2 * 8 * 4 * 6,
                           "bytes": 2 * 4 * (32 + 24 + 48)},
        "mm (8,6)x(6,6)": {"count": 1, "flops": 2 * 8 * 6 * 6,
                           "bytes": 4 * (48 + 36 + 48)}}
    assert rec.top_ops("flops", 1, "by_product")[0][0] == "mm (8,4)x(4,6)"


def test_reference_dot_count_per_trip():
    """The reference's HLO read per loop trip (the small cells' child,
    ``torch_dryrun_ref_checks.dots_by_shape``): a ``lax.scan`` of 7
    products counts 7 of them. Its own count (``hlo_cost``) skips a
    ``while`` whose carried tuple has an ``/*index=5*/`` comment (six or
    more elements, as GatedGCN's layer scan has): a reference fault the
    port's tests read around."""
    from repro.launch.hlo_analysis import hlo_cost as ref_cost
    from torch_dryrun_ref_checks import dots_by_shape

    def body(carry, w):
        x, *rest = carry
        return (x @ w, *[jnp.sin(r) for r in rest]), None

    def f(x, ws, *rest):
        return jax.lax.scan(body, (x, *rest), ws)[0]

    x, ws = jnp.ones((16, 32)), jnp.ones((7, 32, 32))
    small = jax.jit(f).lower(x, ws).compile().as_text()
    wide = jax.jit(f).lower(x, ws, *[jnp.ones(3)] * 5).compile().as_text()
    one = 2 * 16 * 32 * 32
    assert "/*index=5*/" in wide and "/*index=5*/" not in small
    for text in (small, wide):
        dots, flops = dots_by_shape(text)
        assert flops == 7 * one
        assert dots == {"f32[16,32] <- f32[16,32] x f32[32,32]": [7, 7 * one]}
    assert ref_cost(small)["flops"] == 7 * one
    assert ref_cost(wide)["flops"] == 0


def test_bytes_positive_and_bounded():
    _, rec = trace(lambda x: torch.sin(x) + 1, torch.ones(1024))
    b = hlo_cost(rec)["bytes"]
    assert 4096 <= b <= 64 * 4096
    assert collective_bytes(rec) == {"total_bytes": 0}


def test_flops_counted_on_local_tensors_only():
    """On fake tensors of a fake world, a DTensor product counts one rank's
    share: (262144 / 16) x 512 @ 512 x (65536 / 16)."""
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import distribute_tensor
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.distributed.sharding import P, placements
        from repro_torch.launch.hlo_analysis import hlo_cost, trace
        from repro_torch.launch.mesh import make_production_mesh
        dist.init_process_group("fake", store=FakeStore(), world_size=256,
                                rank=0)
        mesh = make_production_mesh(device="cpu")
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(262144, 512), mesh,
                                  placements(P("data", None), mesh))
            w = distribute_tensor(torch.empty(512, 65536), mesh,
                                  placements(P(None, "model"), mesh))
            _, rec = trace(lambda a, b: a @ b, x, w)
        print(hlo_cost(rec)["flops"])
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert float(r.stdout.split()[-1]) == 2 * 16384 * 512 * 4096


# ---------------------------------------------------------------------------
# launch.train against the reference's Trainer
# ---------------------------------------------------------------------------


def test_train_launcher_matches_reference_trainer(tmp_path):
    from repro.data.lm import TokenStream as RStream
    from repro.models import transformer as rtfm
    from repro.train.loop import Trainer as RTrainer
    from repro.train.loop import TrainerConfig as RConfig
    from repro.train.optimizer import AdamWConfig as RAdam
    from repro_torch.launch import train

    rcfg = dataclasses.replace(rconfigs.get("qwen2_1_5b").smoke_config(),
                               dtype=jnp.float32)
    cfg, _ = train.build("qwen2_1_5b", "smoke", "cpu")
    p = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    pp = port_params(p)               # before the reference donates p
    stream = RStream(vocab=rcfg.vocab, batch=4, seq=16)

    def data_at(step):
        b = stream.batch_at(step)
        return {"tokens": jnp.asarray(b["tokens"]),
                "labels": jnp.asarray(b["labels"])}

    ref = RTrainer(lambda pp, b: rtfm.loss_fn(pp, b, rcfg), p, data_at,
                   RConfig(total_steps=3, ckpt_every=50,
                           ckpt_dir=str(tmp_path / "ref")),
                   opt_cfg=RAdam(lr=3e-4)).run_with_restarts()
    got = train.run(cfg, pp, steps=3, batch=4, seq=16,
                    ckpt_dir=str(tmp_path / "port"))
    ref_losses = [m["loss"] for m in ref["metrics"]]
    got_losses = [m["loss"] for m in got["metrics"]]
    assert len(got_losses) == len(ref_losses) >= 1
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-4, atol=1e-5)


def test_train_launcher_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--device", "cpu", "--preset", "smoke", "--steps", "3",
                "--batch", "2", "--seq", "16", "--ckpt-dir",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] qwen2-smoke" in out and '"final_loss"' in out
