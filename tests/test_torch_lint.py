"""The port's lint pass (``repro_torch.analysis.lint``): one snippet per
rule, the retargeted GDL002 (``synchronize`` outside the telemetry fence;
``np.asarray``/``np.array`` and a tensor's ``.cpu()``/``.numpy()``/
``.item()``/``.tolist()`` inside a GCDA operator's ``run()``), agreement
with the JAX package's linter on the rules it keeps as they are, and the
repository gate against the port's baseline."""
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parents[1]

GCDA_OP = """
import numpy as np


class MatMul:
    kind = "MatMul"

    def run(self, ctx, x):
        {line}
        return x
"""

# rule -> {case: (source, expected number of findings of that rule)}
CASES = {
    "GDL001": {
        "dict_display": ("CACHE = {}\n", 1),
        "list_constructor": ("ITEMS = list()\n", 1),
        "annotated_set": ("SEEN: set = set()\n", 1),
        "all_is_exempt": ("__all__ = ['a']\n", 0),
        "inside_function": ("def f():\n    x = {}\n    return x\n", 0),
        "immutable": ("NAMES = ('a', 'b')\n", 0),
    },
    "GDL002": {
        "cuda_synchronize": ("import torch\n\ndef f():\n"
                             "    torch.cuda.synchronize()\n", 1),
        "event_synchronize": ("def f(ev):\n    ev.synchronize()\n", 1),
        "stream_synchronize": ("import torch\n\ndef f():\n"
                               "    torch.cuda.current_stream()"
                               ".synchronize()\n", 1),
        "np_asarray_in_gcda_run": (GCDA_OP.format(line="np.asarray(x)"), 1),
        "np_array_in_gcda_run": (GCDA_OP.format(line="np.array(x)"), 1),
        "cpu_in_gcda_run": (GCDA_OP.format(line="x = x.cpu()"), 1),
        "numpy_in_gcda_run": (GCDA_OP.format(line="x.numpy()"), 1),
        "item_in_gcda_run": (GCDA_OP.format(line="x.sum().item()"), 1),
        "tolist_in_gcda_run": (GCDA_OP.format(line="x.tolist()"), 1),
        "item_outside_gcda_run": ("def f(x):\n    return x.item()\n", 0),
        "item_in_non_gcda_run": ("class Select:\n    kind = 'Select'\n\n"
                                 "    def run(self, ctx, x):\n"
                                 "        return x.item()\n", 0),
        "np_asarray_outside_gcda_run": ("import numpy as np\n\n"
                                        "def f(x):\n"
                                        "    return np.asarray(x)\n", 0),
    },
    "GDL003": {
        "nested_with": ("def f(self):\n    with self._lock:\n"
                        "        with self.other_lock:\n"
                        "            pass\n", 1),
        # kept from the JAX package's rule: its .acquire() branch tests
        # the called attribute's own name ("acquire") for a lock hint, not
        # its receiver's, so it never fires
        "acquire_inside_with": ("def f(self):\n    with self._lock:\n"
                                "        self._pool_lock.acquire()\n", 0),
        "sequential": ("def f(self):\n    with self._lock:\n        pass\n"
                       "    with self._lock:\n        pass\n", 0),
    },
    "GDL004": {
        "bare_except": ("try:\n    pass\nexcept:\n    pass\n", 1),
        "named_except": ("try:\n    pass\nexcept ValueError:\n    pass\n", 0),
    },
    "GDL005": {
        "list_default": ("def f(x=[]):\n    return x\n", 1),
        "dict_kw_default": ("def f(*, x={}):\n    return x\n", 1),
        "none_default": ("def f(x=None):\n    return x\n", 0),
    },
}
PARAMS = [(rule, case) for rule in sorted(CASES) for case in sorted(CASES[rule])]


def _lint(module, tmp_path, source, rel="src/repro_torch/snippet.py"):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return module.lint_file(path, tmp_path)


@pytest.mark.parametrize("rule,case", PARAMS)
def test_rule_snippet(tmp_path, rule, case):
    source, n = CASES[rule][case]
    found = [f for f in _lint(lint, tmp_path, source) if f.rule == rule]
    assert len(found) == n, [f.render() for f in found]
    for f in found:
        assert f.path == "repro_torch/snippet.py"


def test_synchronize_in_the_telemetry_fence_is_exempt(tmp_path):
    src = "import torch\n\ndef fence():\n    torch.cuda.synchronize()\n"
    assert _lint(lint, tmp_path, src,
                 "src/repro_torch/core/telemetry.py") == []
    # the exemption is the port's telemetry module, not the reference's
    assert [f.rule for f in _lint(lint, tmp_path, src,
                                  "src/repro/core/telemetry.py")] == ["GDL002"]


@pytest.mark.parametrize("rule,case", [(r, c) for r, c in PARAMS
                                       if r != "GDL002"])
def test_unchanged_rules_agree_with_reference(tmp_path, rule, case):
    source, _ = CASES[rule][case]

    def keys(module):
        return [(f.rule, f.line, f.scope, f.snippet)
                for f in _lint(module, tmp_path, source)]
    assert keys(lint) == keys(ref_lint)


@pytest.mark.parametrize("line", ["np.asarray(x)", "np.array(x)"])
def test_gcda_asarray_rule_agrees_with_reference(tmp_path, line):
    source = GCDA_OP.format(line=line)
    assert [f.key() for f in _lint(lint, tmp_path, source)] == \
        [f.key() for f in _lint(ref_lint, tmp_path, source)]


def test_baseline_is_a_multiset(tmp_path):
    found = _lint(lint, tmp_path, "A = {}\nB = {}\n")
    new, old = lint.split_by_baseline(found, [found[0].key()])
    assert [f.line for f in old] == [1] and [f.line for f in new] == [2]


def test_repository_gate(monkeypatch, capsys):
    """The port's tree against its baseline: nothing new, and every
    baseline entry still matches a finding."""
    monkeypatch.chdir(ROOT)
    assert lint.main([]) == 0
    out = capsys.readouterr().out
    assert "lint: 0 new," in out
    findings = lint.lint_paths([lint.DEFAULT_PATH], ROOT)
    baseline = lint.load_baseline(lint.DEFAULT_BASELINE)
    new, old = lint.split_by_baseline(findings, baseline)
    assert new == [] and len(old) == len(baseline)
