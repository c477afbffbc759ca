"""The time limit on each test phase (the repository's root ``conftest.py``).

Each case runs pytest in a subprocess, under a deadline, on a small test
module in ``tmp_path`` beside a copy of the root ``conftest.py`` whose
limit and grace are cut to 2 s each:

* A set-up, call or tear-down that runs past the limit fails its test with
  the main thread's stack and leaves every thread's stack in a file; the
  next test passes.
* A test that blocks ``SIGALRM`` is ended with its worker by the second
  stage; pytest-xdist runs the rest on a new worker and reaches its end.
* Tests under the limit leave the ``SIGALRM`` handler as it was, and no
  timer thread, alarm or faulthandler dump armed.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap
import xml.etree.ElementTree as ET

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT_S, GRACE_S = 2, 2
DEADLINE_S = 60


def run_pytest(tmp_path, module, *args):
    """Run pytest on ``module`` in ``tmp_path``; return its exit code, its
    output and the junit XML's test cases by name."""
    conftest = (ROOT / "conftest.py").read_text()
    for name, value in (("LIMIT_S", LIMIT_S), ("GRACE_S", GRACE_S)):
        conftest, n = re.subn(rf"^{name} = \d+$", f"{name} = {value}",
                              conftest, flags=re.M)
        assert n == 1, name
    (tmp_path / "conftest.py").write_text(conftest)
    (tmp_path / "pytest.ini").write_text("")  # the root of the inner run
    (tmp_path / "test_mod.py").write_text(textwrap.dedent(module))
    (tmp_path / "tmp").mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(PYTEST_DISABLE_PLUGIN_AUTOLOAD="1",
               TMPDIR=str(tmp_path / "tmp"))
    # timeout(1) signals its whole process group: xdist's workers too.
    proc = subprocess.run(
        ["timeout", "-k", "5", str(DEADLINE_S), sys.executable, "-m",
         "pytest", "-p", "no:cacheprovider", "--junitxml=out.xml",
         "test_mod.py", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=DEADLINE_S + 10)
    out = proc.stdout + proc.stderr
    assert (tmp_path / "out.xml").exists(), out
    cases = {c.get("name"): c
             for c in ET.parse(tmp_path / "out.xml").iter("testcase")}
    return proc.returncode, out, cases


def report(case):
    """A test case's failure or error text, or None if it passed."""
    bad = [e for e in case if e.tag in ("failure", "error", "skipped")]
    return "\n".join(f"{e.get('message')}\n{e.text}" for e in bad) or None


def stalls(tmp_path):
    d = tmp_path / "tmp" / "tier1_stalls"
    return {p.name: p.read_text() for p in d.iterdir()} if d.exists() else {}


def test_a_phase_past_the_limit_fails_its_test_with_stacks(tmp_path):
    rc, out, cases = run_pytest(tmp_path, """
        import time
        import pytest

        @pytest.fixture
        def slow_setup():
            time.sleep(30)

        @pytest.fixture
        def slow_teardown():
            yield
            time.sleep(30)

        def test_setup(slow_setup):
            pass

        def test_after_setup():
            pass

        def test_call():
            time.sleep(30)

        def test_after_call():
            pass

        def test_teardown(slow_teardown):
            pass

        def test_after_teardown():
            pass
        """)
    assert rc == 1, out
    files = stalls(tmp_path)
    assert len(files) == 3, (files, out)
    for phase, where in (("setup", "slow_setup"), ("call", "test_call"),
                         ("teardown", "slow_teardown")):
        test = "test_" + phase
        said = report(cases[test])
        assert said is not None, (test, out)
        assert f"test_mod.py::{test}: {phase} ran past its 2 s limit" \
            in said, said
        assert "The main thread's stack" in said and \
            f"in {where}" in said, said
        assert report(cases["test_after_" + phase]) is None, out
        (name, dump), = [(n, t) for n, t in files.items()
                         if n.endswith(f"test_mod.py_{test}.txt")]
        assert name.startswith("main-") and f"in {where}" in dump, dump
        assert "Thread 0x" in dump and "Current thread" in dump, dump


def test_a_blocked_signal_ends_the_worker_and_the_run_goes_on(tmp_path):
    rc, out, cases = run_pytest(tmp_path, """
        import signal
        import time

        def test_blocked():
            signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
            time.sleep(30)

        def test_after():
            pass
        """, "-p", "xdist", "-n", "1")
    assert rc == 1, out
    said = report(cases["test_blocked"])
    assert said is not None and "crashed" in said, out
    assert report(cases["test_after"]) is None, out
    assert "Timeout (0:00:04)!" in out, out  # the second stage's dump
    files = stalls(tmp_path)
    assert [n for n in files if n.startswith("gw0-")
            and n.endswith("test_mod.py_test_blocked.txt")], (files, out)


def test_tests_under_the_limit_leave_nothing_armed(tmp_path):
    (tmp_path / "watch.py").write_text(textwrap.dedent(f"""
        import json
        import signal
        import threading
        import time

        calls = []

        def before(signum, frame):
            calls.append(signum)

        def pytest_configure(config):
            signal.signal(signal.SIGALRM, before)

        def pytest_sessionfinish(session):
            time.sleep({LIMIT_S + GRACE_S + 1})  # past both stages
            with open("left.json", "w") as f:
                json.dump({{
                    "handler": signal.getsignal(signal.SIGALRM) is before,
                    "calls": calls,
                    "threads": [t.name for t in threading.enumerate()],
                    "alarm": signal.getitimer(signal.ITIMER_REAL),
                }}, f)
        """))
    rc, out, cases = run_pytest(tmp_path, """
        import threading
        import pytest

        def armed():
            return any(isinstance(t, threading.Timer)
                       for t in threading.enumerate())

        @pytest.fixture
        def phases():
            assert armed()
            yield
            assert armed()

        def test_quick(phases):
            assert armed()

        def test_quick_too():
            assert armed()
        """, "-p", "watch")
    assert rc == 0, out
    assert all(report(c) is None for c in cases.values()), out
    assert len(cases) == 2, out
    left = json.loads((tmp_path / "left.json").read_text())
    assert left == {"handler": True, "calls": [], "threads": ["MainThread"],
                    "alarm": [0.0, 0.0]}, left
    assert "Timeout" not in out and not stalls(tmp_path), out
