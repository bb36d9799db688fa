"""Shared by the port's twin tests (``tests/test_torch_*.py``): one namespace
per package — the JAX package (the reference) and the port — holding the
modules a scenario needs under the same names, so one scenario function
runs through both packages and what it returns (fingerprints, explain text,
rewrite logs, counters, estimates) can be compared.

    ref, port = both(scenario, ...)    # scenario(P, ...) for P in (REF, PORT)
    assert ref == port

``P.Engine(db, **kw)`` is ``GredoEngine``, ``P.ExecContext(db, **kw)``
``physical.ExecContext`` and ``P.replay(db, path, **kw)``
``observe.replay``; the port's run on the CPU (``device="cpu"``: the plain
PyTorch versions of the kernels)."""
from __future__ import annotations

import importlib
import re
from types import SimpleNamespace

import numpy as np

CORE = ("analytics", "cost", "deltastore", "engine", "index", "interbuffer",
        "join", "observe", "optimizer", "pattern", "pattern_jit", "physical",
        "planner", "schema", "shard", "sqlpgq", "storage", "telemetry",
        "traversal", "verify")


def _namespace(root: str, engine_kw: dict) -> SimpleNamespace:
    core = importlib.import_module(f"{root}.core")
    ns = SimpleNamespace(name=root, core=core,
                         m2bench=importlib.import_module(f"{root}.data.m2bench"),
                         **{m: importlib.import_module(f"{root}.core.{m}")
                            for m in CORE})

    def engine(db, **kw):
        return core.GredoEngine(db, **engine_kw, **kw)
    ns.Engine = engine
    ns.ExecContext = lambda db, **kw: ns.physical.ExecContext(
        db, **engine_kw, **kw)
    ns.replay = lambda db, path, **kw: ns.observe.replay(db, path,
                                                         **engine_kw, **kw)
    ns.fingerprint = ns.observe.result_fingerprint
    return ns


REF = _namespace("repro", {})
PORT = _namespace("repro_torch", {"device": "cpu"})
PKGS = (REF, PORT)


def both(scenario, *args, **kw):
    """``scenario`` run through the reference, then through the port."""
    return scenario(REF, *args, **kw), scenario(PORT, *args, **kw)


def host(x) -> np.ndarray:
    """A device value of either package (jax array, torch tensor) as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rows_multiset(t) -> list:
    """A relation's rows as a sorted list of tuples (columns by name;
    dictionary columns by code)."""
    cols = sorted(t.columns)
    out = []
    for i in range(t.nrows):
        row = []
        for c in cols:
            col = t.col(c)
            v = col.codes[i] if hasattr(col, "codes") else np.asarray(col)[i]
            row.append(v.item() if hasattr(v, "item") else v)
        out.append(tuple(row))
    return sorted(out)


def op_summary(stats) -> list:
    """``ExecStats.operators`` without the wall-clock seconds."""
    return [{k: v for k, v in o.items() if k != "seconds"}
            if isinstance(o, dict) else o for o in stats.operators]


_TIMES = re.compile(r"\b(ms|pct|seconds|\w*_s|\w*_ms)=[-+\d.e]+%?,? ?")
# health lines read the process-wide traversal-kernel counters
# (``pattern_jit.metrics``), which count every device match run earlier in
# the process by either package; the port's join-path counters
# (``join.metrics``: registry keys ``join.*``, explain's ``join (this
# query)`` line) are process-wide too, and the reference has none
_PROCESS_WIDE = ("kernel_retries:", "traversal_kernels", "join (this query)",
                 "join_direct", "join_sorted")


def fresh_matcher_counters(monkeypatch) -> None:
    """Give each package's device matcher fresh counters for one test: they
    are process-wide and feed the ``kernel_retries`` health rule, so a
    health check would otherwise depend on the device matches (and
    overflow retries) that earlier tests in the process ran."""
    for P in (REF, PORT):
        monkeypatch.setattr(P.pattern_jit, "COUNTERS",
                            P.pattern_jit._Counters())


def untimed(text: str) -> str:
    """Explain/trace text without its wall-clock fields (``ms=``, ``pct=``,
    ``*_s=`` and ``*_ms=`` counters such as ``queue_wait_s``) and without
    the lines that read process-wide counters."""
    return "\n".join(_TIMES.sub("", line) for line in text.splitlines()
                     if not any(k in line for k in _PROCESS_WIDE))


def port_params(tree):
    """The reference's parameter tree (nested dicts and lists of jax
    arrays) carried into the port, on the CPU."""
    import jax
    from repro_torch.models import params_from_arrays
    return params_from_arrays(jax.tree.map(np.asarray, tree))


def assert_trees_close(port, ref, rtol, atol) -> None:
    """Leaf by leaf, in the order both packages walk a tree (dict keys
    sorted, ``None`` an empty subtree): the port's tree against the
    reference's."""
    import jax
    from repro_torch.train.optimizer import tree_leaves
    a, b = tree_leaves(port), jax.tree.leaves(ref)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(host(x), np.asarray(y), rtol=rtol,
                                   atol=atol, err_msg=f"leaf {i}")

