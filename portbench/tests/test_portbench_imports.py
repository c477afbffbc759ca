"""Import checks by whole top-level module name: nothing of the harness
imports JAX or the JAX package, and the reference imports nothing of the
program."""

import ast
import os
import sys

from conftest import ROOT
from portbench.harness import cli

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "safelife_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, names in os.walk(base):
        for n in names:
            if n.endswith(".py") and "tests" not in d.split(os.sep):
                yield os.path.join(d, n)


def test_no_jax_in_the_harness():
    for f in _files():
        assert not set(_imports(f)) & FORBIDDEN, f


def test_the_reference_imports_no_program():
    for f in _files("reference"):
        tops = set(_imports(f))
        assert "safelife_torch" not in tops and not tops & FORBIDDEN, f


def test_the_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "safelife_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert not set(cli.forbidden_modules()) & {"safelife_torch", "jaxish"}
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in cli.forbidden_modules()


def test_a_run_loads_no_jax():
    """The program and the harness as a run imports them: no JAX."""
    import subprocess
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.entries import train, eval\n"
            "from portbench import control\n"
            "import safelife_torch.training.driver, safelife_torch.benchmarking\n"
            "from portbench.harness import cli\n"
            "print(cli.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
