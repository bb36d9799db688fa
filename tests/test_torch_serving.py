"""The port's serving path: continuous batching equals isolated greedy
decoding with mid-flight slot refill (twins of ``tests/test_serving.py``),
its tokens equal the JAX package's ``ContinuousBatcher``'s on the same
weights and requests, and ``python -m repro_torch.launch.serve`` runs on
the CPU without JAX, printing the tokens the reference's serve loop gives
for the same weights and prompts."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro_torch.launch import serve
from repro_torch.models.transformer import (TransformerConfig, forward,
                                            init_cache, init_params,
                                            params_from_arrays, serve_step)
from repro_torch.serving import ContinuousBatcher, Request

ROOT = Path(__file__).resolve().parents[1]
CFG = TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=97, dtype=torch.float32,
                        attn_impl="dense")


def _standalone_greedy(params, prompt, max_new, cfg=CFG):
    P = len(prompt)
    cache = init_cache(cfg, 1, 128)
    logits, cache = forward(params, torch.as_tensor(prompt)[None], cfg,
                            cache=cache,
                            cache_lengths=torch.zeros(1, dtype=torch.int32))
    out = [int(torch.argmax(logits[0, P - 1]))]
    lengths = torch.tensor([P], dtype=torch.int32)
    for _ in range(max_new - 1):
        logits, cache = serve_step(params, cache, torch.tensor([[out[-1]]]),
                                   lengths, cfg)
        out.append(int(torch.argmax(logits[0])))
        lengths = lengths + 1
    return out


def _requests(n=7):
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 97, rng.integers(4, 20)).astype(np.int32),
             int(rng.integers(3, 10))) for i in range(n)]


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_continuous_batching_matches_standalone(impl):
    cfg = dataclasses.replace(CFG, attn_impl=impl)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    reqs = [Request(rid=i, prompt=p, max_new=m) for i, p, m in _requests()]
    batcher = ContinuousBatcher(params, cfg, n_slots=3, max_len=128)
    completions = batcher.serve(list(reqs))
    assert [c.rid for c in completions] == list(range(7))
    for req, comp in zip(reqs, completions):
        expect = _standalone_greedy(params, req.prompt, req.max_new, cfg)
        assert comp.tokens == expect, (req.rid, comp.tokens, expect)
    # continuous refill actually happened: more prefills than slots
    assert batcher.stats["prefills"] == 7
    assert max(batcher.stats["slot_occupancy"]) == 3


def test_eos_frees_slot_early():
    params = init_params(torch.Generator().manual_seed(1), CFG)
    prompt = (np.arange(5) % 97).astype(np.int32)
    ref = _standalone_greedy(params, prompt, 16)
    eos = ref[2]  # force early stop at the 3rd generated token
    batcher = ContinuousBatcher(params, CFG, n_slots=2, max_len=128)
    comp = batcher.serve([Request(rid=0, prompt=prompt, max_new=16,
                                  eos_id=eos)])[0]
    assert comp.tokens[-1] == eos
    assert len(comp.tokens) <= 16
    assert batcher.active == [None, None]


def test_batcher_tokens_equal_reference_batcher():
    jcfg = jtf.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=96, vocab=97,
                                 dtype=jnp.float32, attn_impl="dense")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_arrays(jax.tree.map(np.asarray, jp))
    want = JaxBatcher(jp, jcfg, n_slots=3, max_len=128).serve(
        [JaxRequest(rid=i, prompt=p, max_new=m) for i, p, m in _requests()])
    got = ContinuousBatcher(params, CFG, n_slots=3, max_len=128).serve(
        [Request(rid=i, prompt=p, max_new=m) for i, p, m in _requests()])
    assert [(c.rid, c.tokens, c.prefill_len, c.steps) for c in got] == \
        [(c.rid, c.tokens, c.prefill_len, c.steps) for c in want]


def test_serve_cli_on_cpu_matches_reference_loop():
    """The port's serve, in a fresh process on the CPU: loads neither JAX
    nor the reference and prints the greedy tokens that the reference's
    serve loop (``repro.launch.serve``: jit'd prefill, then serve_step)
    gives for the port's weights and prompts."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--device', 'cpu', '--preset', 'smoke'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    printed = re.search(r"\[serve\] sample: \[([0-9, ]+)\]", res.stdout)
    assert printed, res.stdout
    sample = [int(t) for t in printed.group(1).split(",")]

    cfg, params = serve.build("qwen2-1.5b", "smoke", "cpu")
    assert cfg.attn_impl == "chunked" and cfg.dtype == torch.float32
    B, P, G = 4, 32, 32
    prompts = torch.randint(0, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(1))
    jcfg = jtf.TransformerConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__ if f != "dtype"},
        dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray,
                      jax.tree.map(lambda t: t.numpy(), params))
    # the reference's serve loop (src/repro/launch/serve.py), same weights
    cache = jtf.init_cache(jcfg, B, P + G)
    prefill = jax.jit(lambda p, c, t: jtf.forward(
        p, t, jcfg, cache=c, cache_lengths=jnp.zeros((B,), jnp.int32)))
    decode = jax.jit(lambda p, c, t, l: jtf.serve_step(p, c, t, l, jcfg))
    logits, cache = prefill(jp, cache, jnp.asarray(prompts.numpy()))
    next_tok = jnp.argmax(logits[:, -1], -1)[:, None]
    lengths = jnp.full((B,), P, jnp.int32)
    out = [next_tok]
    for _ in range(G - 1):
        logits, cache = decode(jp, cache, next_tok, lengths)
        next_tok = jnp.argmax(logits, -1)[:, None]
        lengths = lengths + 1
        out.append(next_tok)
    want = np.asarray(jnp.concatenate(out, axis=1))[0, :16].tolist()
    assert sample == want


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        assert serve.resolve_device(None, who="serve").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="serve runs on a CUDA device"):
        serve.main(["--preset", "smoke"])
