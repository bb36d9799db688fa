"""Twins of ``tests/test_recsys_ckpt.py`` on the port: Wide & Deep
(training improves, top-k retrieval against brute force, wide hash in
range), the checkpoint and fault-tolerance tests
(``checkpoint.CheckpointManager``, ``distributed.fault``) and the elastic
reshard; checkpoints written by either package restored by the other, and
the Trainer's restart path: a run that fails at a step and restarts from
its checkpoint ends where an uninterrupted run ends. Wide & Deep's parity
with the reference is in ``test_torch_recsys.py``."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.lm import TokenStream
from repro_torch.distributed.fault import (FailureInjector, StepWatchdog,
                                           run_with_restarts)
from repro_torch.models import recsys
from repro_torch.models.transformer import (TransformerConfig, init_params,
                                            loss_fn, params_from_arrays)
from repro_torch.train.loop import Trainer, TrainerConfig, value_and_grad
from repro_torch.train.optimizer import adamw_init, tree_leaves, tree_map


@pytest.fixture(scope="module")
def rs():
    cfg = configs.get("wide_deep").smoke_config()
    p = recsys.init_params(torch.Generator().manual_seed(0), cfg)
    return cfg, p


def test_recsys_train_improves(rs):
    cfg, p = rs
    batch = recsys.random_batch(cfg, 256, seed=1, device="cpu")
    # plant signal: label = f(first sparse field)
    batch = dict(batch, labels=(batch["sparse"][:, 0] % 2).float())
    loss0 = float(recsys.loss_fn(p, batch, cfg))
    for _ in range(30):
        _, g = value_and_grad(recsys.loss_fn, p, batch, cfg)
        p = tree_map(lambda a, gr: a - 0.5 * gr, p, g)
    loss1 = float(recsys.loss_fn(p, batch, cfg))
    assert loss1 < loss0 - 0.05


def test_retrieval_topk_matches_bruteforce(rs):
    cfg, p = rs
    batch = recsys.random_batch(cfg, 4, seed=2, device="cpu")
    cands = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (300, cfg.tower_dim)), dtype=torch.float32)
    vals, idx = recsys.retrieval_step(p, batch["dense"], batch["sparse"],
                                      cands, cfg, top_k=10)
    q = recsys.user_tower(p, batch["dense"], batch["sparse"], cfg).numpy()
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cn = cands.numpy() / np.linalg.norm(cands.numpy(), axis=1, keepdims=True)
    brute = qn @ cn.T
    for b in range(4):
        expect = set(np.argsort(-brute[b])[:10].tolist())
        assert set(idx[b].tolist()) == expect


def test_wide_hash_in_range(rs):
    cfg, p = rs
    batch = recsys.random_batch(cfg, 64, seed=4, device="cpu")
    ids = recsys._hash_cross(batch["sparse"], cfg.wide_hash)
    assert int(ids.min()) >= 0 and int(ids.max()) < cfg.wide_hash


def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(5, dtype=torch.float32),
             "nested": {"b": torch.ones((2, 3))}, "lst": [torch.zeros(2)]}
    cm.save(3, state, metadata={"note": "x"})
    target = tree_map(torch.zeros_like, state)
    restored, meta = cm.restore(target)
    assert meta["step"] == 3 and meta["note"] == "x"
    assert isinstance(restored["lst"], list)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_rotation_and_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, {"x": torch.full((2,), s, dtype=torch.float32)})
    steps = [s for s, _ in cm.checkpoints()]
    assert steps == [3, 4]
    assert cm.latest_step() == 4


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"x": torch.zeros(4)}, blocking=False)
    cm.wait()
    names = os.listdir(tmp_path)
    assert all(not n.endswith(".tmp.npz") for n in names)
    assert any(n == "step_0000000001.npz" for n in names)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"x": torch.zeros((4,))})
    with pytest.raises(ValueError):
        cm.restore({"x": torch.zeros((5,))})


def test_checkpoint_snapshot_and_target_dtype(tmp_path):
    """``save`` copies the tensors at once (a later in-place write does
    not reach the file, also when the write runs in the background); a
    bf16 leaf is stored as fp32 and each leaf comes back in its target's
    dtype."""
    cm = CheckpointManager(str(tmp_path))
    x = torch.arange(6, dtype=torch.float32)
    h = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    cm.save(1, {"x": x, "h": h}, blocking=False)
    x.add_(100)
    cm.wait()
    with np.load(tmp_path / "step_0000000001.npz") as z:
        assert z["h"].dtype == np.float32
    restored, _ = cm.restore({"x": torch.zeros(6, dtype=torch.float64),
                              "h": torch.zeros(2, dtype=torch.bfloat16)})
    assert restored["x"].dtype == torch.float64
    assert torch.equal(restored["x"], torch.arange(6, dtype=torch.float64))
    assert torch.equal(restored["h"], h)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0, warmup=2)
    for i in range(10):
        wd.observe(i, 0.1)
    assert wd.observe(10, 1.0)
    assert not wd.observe(11, 0.11)
    assert wd.straggler_steps == [10]


def test_failure_injector_fires_once():
    fi = FailureInjector(fail_at=(5,))
    fi.maybe_fail(4)
    with pytest.raises(RuntimeError):
        fi.maybe_fail(5)
    fi.maybe_fail(5)  # second pass is clean (restart can proceed)


def test_elastic_reshard_identity():
    from repro_torch.distributed.elastic import reshard_state
    state = {"w": torch.arange(8.0)}
    sh = {"w": torch.device("cpu")}
    out = reshard_state(state, sh)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(8.0))


def test_run_with_restarts_retries_then_gives_up():
    calls = []

    def flaky(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise RuntimeError("worker lost")
        return 7
    assert run_with_restarts(flaky) == 7 and calls == [None] * 3
    with pytest.raises(ZeroDivisionError):
        run_with_restarts(lambda _: 1 / 0, max_restarts=1)


CFG = TransformerConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                        d_ff=32, vocab=64, n_experts=4, top_k=2)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """An MoE model's parameters and AdamW state saved by one package
    restore in the other: the same keys, shapes and values."""
    jcfg = jtf.TransformerConfig(**{
        f: getattr(CFG, f) for f in CFG.__dataclass_fields__
        if f != "dtype"}, dtype=jnp.float32)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = {"params": jp, "opt": jopt.adamw_init(jp)}
    jstate["opt"]["step"] = jnp.int32(5)
    jstate["opt"]["m"] = jax.tree.map(lambda a: a * 0.5, jp)
    tp = params_from_arrays(jax.tree.map(np.asarray, jp))
    tstate = {"params": tp, "opt": adamw_init(tp)}
    tstate["opt"]["step"] = torch.tensor(5, dtype=torch.int32)
    tstate["opt"]["m"] = tree_map(lambda t: t * 0.5, tstate["params"])
    if writer == "reference":
        JaxCheckpointManager(str(tmp_path)).save(9, jstate,
                                                 metadata={"by": writer})
        got, meta = CheckpointManager(str(tmp_path)).restore(
            tree_map(torch.zeros_like, tstate))
        want = jax.tree.leaves(jstate)
        got = [t.numpy() for t in tree_leaves(got)]
    else:
        CheckpointManager(str(tmp_path)).save(9, tstate,
                                              metadata={"by": writer})
        got, meta = JaxCheckpointManager(str(tmp_path)).restore(
            jax.tree.map(jnp.zeros_like, jstate))
        want = [t.numpy() for t in tree_leaves(tstate)]
        got = jax.tree.leaves(got)
    assert meta == {"by": writer, "step": 9}
    assert len(got) == len(want) == len(jax.tree.leaves(jstate))
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_trainer_restarts_from_its_checkpoint(tmp_path):
    """Failure injected at step 3 with a checkpoint every 2 steps (written
    in the background): ``run_with_restarts`` restores step 1's checkpoint,
    replays steps 2-4 from the deterministic stream, and ends with the
    weights of an uninterrupted run."""
    cfg = dataclasses.replace(CFG, dtype=torch.float32)
    stream = TokenStream(vocab=64, batch=4, seq=16)

    def trainer(name, injector=None):
        return Trainer(lambda p, b: loss_fn(p, b, cfg),
                       init_params(torch.Generator().manual_seed(0), cfg),
                       lambda s: {k: torch.as_tensor(v)
                                  for k, v in stream.batch_at(s).items()},
                       TrainerConfig(total_steps=5, ckpt_every=2,
                                     ckpt_dir=str(tmp_path / name),
                                     log_every=1),
                       failure_injector=injector)
    plain = trainer("plain")
    plain.run(resume=False)
    failing = trainer("failing", FailureInjector(fail_at=(3,)))
    failing.run_with_restarts()
    assert [m["step"] for m in failing.metrics] == [0, 1, 2, 2, 3, 4]
    assert failing.ckpt.latest_step() == 3
    for a, b in zip(tree_leaves(failing.params), tree_leaves(plain.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(failing.opt_state["step"]) == 5
