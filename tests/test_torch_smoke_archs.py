"""Twins of ``tests/test_smoke_archs.py`` on the port: per assigned
architecture, a reduced same-family config runs one forward and one train
step on the CPU (output shapes, no NaNs), and the registry covers the 40
assigned cells (5 skipped, 35 that run). Also: the new archs' published
and smoke configs, SHAPES and families equal the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import tree_leaves

LM_ARCHS = ["olmoe_1b_7b", "granite_moe_1b_a400m", "starcoder2_3b",
            "qwen2_1_5b", "stablelm_3b"]
GNN_FEATURE_ARCHS = ["gatedgcn", "pna"]
GNN_EQUIV_ARCHS = ["mace", "equiformer_v2"]


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke(arch):
    from repro_torch.models import transformer as tfm
    cfg = configs.get(arch).smoke_config()
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    logits, aux = tfm.forward(params, toks, cfg)
    assert logits.shape == (2, 16, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    # one train step
    batch = {"tokens": toks, "labels": toks}
    (loss, nll), grads = value_and_grad(lambda p: tfm.loss_fn(p, batch, cfg),
                                        params, has_aux=True)
    assert np.isfinite(float(loss))
    assert _finite(grads)
    # decode step
    cache = tfm.init_cache(cfg, 2, 24)
    _, cache = tfm.forward(params, toks, cfg, cache=cache,
                           cache_lengths=torch.zeros(2, dtype=torch.int32))
    nl, _ = tfm.serve_step(params, cache, toks[:, :1],
                           torch.full((2,), 16, dtype=torch.int32), cfg)
    assert nl.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(nl).all())


@pytest.mark.parametrize("arch", GNN_FEATURE_ARCHS)
def test_gnn_feature_smoke(arch):
    from repro_torch.data.graphs import random_feature_graph
    cfg = configs.get(arch).smoke_config()
    if arch == "gatedgcn":
        from repro_torch.models.gnn import gatedgcn as mod
    else:
        from repro_torch.models.gnn import pna as mod
    g, labels = random_feature_graph(40, 160, cfg.d_in, cfg.n_classes,
                                     device="cpu")
    p = mod.init_params(torch.Generator().manual_seed(0), cfg)
    logits = mod.forward(p, g, cfg)
    assert logits.shape == (40, cfg.n_classes)
    assert bool(torch.isfinite(logits).all())
    loss, grads = value_and_grad(mod.loss_fn, p, g, labels, cfg)
    assert np.isfinite(float(loss))
    assert _finite(grads)


@pytest.mark.parametrize("arch", GNN_EQUIV_ARCHS)
def test_gnn_equivariant_smoke(arch):
    from repro_torch.data.graphs import random_molecule_batch
    cfg = configs.get(arch).smoke_config()
    if arch == "mace":
        from repro_torch.models.gnn import mace as mod
    else:
        from repro_torch.models.gnn import equiformer_v2 as mod
    g, energies = random_molecule_batch(4, 8, 20, n_species=cfg.n_species,
                                        device="cpu")
    p = mod.init_params(torch.Generator().manual_seed(0), cfg)
    pred = mod.forward(p, g, cfg)
    assert pred.shape == (4,)
    assert bool(torch.isfinite(pred).all())
    loss, grads = value_and_grad(mod.loss_fn, p, g, energies, cfg)
    assert np.isfinite(float(loss))
    assert _finite(grads)


def test_recsys_smoke():
    from repro_torch.models import recsys
    cfg = configs.get("wide_deep").smoke_config()
    p = recsys.init_params(torch.Generator().manual_seed(0), cfg)
    batch = recsys.random_batch(cfg, 32, device="cpu")
    scores = recsys.serve_step(p, batch["dense"], batch["sparse"], cfg)
    assert scores.shape == (32,)
    assert bool(torch.isfinite(scores).all())
    loss, grads = value_and_grad(recsys.loss_fn, p, batch, cfg)
    assert np.isfinite(float(loss))
    assert _finite(grads)


def test_registry_covers_all_cells():
    cells = list(configs.all_cells(include_skipped=True))
    assert len(cells) == 40, f"expected 40 assigned cells, got {len(cells)}"
    skipped = [c for c in cells if c[2].get("skip")]
    assert len(skipped) == 5  # long_500k for the 5 full-attention LMs
    runnable = list(configs.all_cells())
    assert len(runnable) == 35


@pytest.mark.parametrize("arch", GNN_FEATURE_ARCHS + GNN_EQUIV_ARCHS
                         + ["wide_deep"])
def test_configs_match_reference(arch):
    """The port's published and smoke configs carry the reference's
    fields, and its SHAPES and FAMILY are the reference's."""
    mod, ref = configs.get(arch), ref_configs.get(arch)
    for name in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(mod, name)()) \
            == dataclasses.asdict(getattr(ref, name)())
    assert mod.SHAPES == ref.SHAPES
    assert mod.FAMILY == ref.FAMILY
    assert configs.ARCHS == tuple(ref_configs.ARCHS)
