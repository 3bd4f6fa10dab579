"""What a run may load: no module whose top-level name (the part before the
first dot, compared whole) is JAX's, its libraries' or the JAX package's;
and the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys
import textwrap

from conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")


def _imports(path):
    """Top-level names of every module a file imports."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub):
    for dirpath, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def test_the_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        names = set(_imports(path))
        assert not names & {"action_detection_torch",
                            "action_detection_tpu", "jax"}, (path, names)


def test_the_forbidden_names_are_compared_whole():
    sys.path.insert(0, BENCH)
    try:
        import run
    finally:
        sys.path.remove(BENCH)
    saved = dict(sys.modules)
    try:
        sys.modules["action_detection_torchlike"] = object()
        sys.modules["jaxfoo.bar"] = object()
        assert run.loaded_forbidden() == []
        sys.modules["orbax.checkpoint"] = object()
        assert run.loaded_forbidden() == ["orbax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """A tiny run on the CPU, in a process of its own, then the names the
    benchmark refuses."""
    code = textwrap.dedent(f"""
        import sys, time
        start = time.perf_counter()
        sys.path[:0] = [{ROOT!r}, {os.path.join(BENCH, 'tests')!r},
                        {BENCH!r}]
        from conftest import tiny_cell
        from portbench.harness.execute import execute
        from run import loaded_forbidden
        cell = tiny_cell("ssn_bninception_rgb_thumos14",
                         "score_thumos14_decoded")
        result = execute({ROOT!r}, cell, 7, 0.01, False, "cpu", start)
        assert result["attempted"] == 2, result
        print("FORBIDDEN", loaded_forbidden())
    """)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]
