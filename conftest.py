"""One time limit for each phase of every test in the repository.

A test's set-up, call or tear-down that runs past ``LIMIT_S`` fails that
test, and the run goes on to its end:

1. At the limit a watchdog thread writes every thread's stack to
   ``<tmp>/tier1_stalls/<worker>-<pid>-<test>.txt`` and to the stderr the
   process started with, then sends ``SIGALRM`` to the main thread.  Its
   handler fails the test with the main thread's stack, and the test's
   tear-down runs.
2. Where the main thread cannot take the signal (a wait in C that never
   returns to Python, a blocked signal, a tear-down that hangs again),
   faulthandler writes the stacks to that stderr ``GRACE_S`` later and
   ends the process.  pytest-xdist then reports the test as crashed and
   starts a new worker; under ``--dist loadfile`` it gives that worker the
   rest of the file, the crashed test included.

A phase that ends under the limit keeps its outcome; both stages are
cancelled and the previous ``SIGALRM`` handler restored after every phase.
The signal goes to the main thread alone (``pthread_kill``): a process-wide
alarm could land on one of XLA's or torch's threads and leave the main
thread's wait uninterrupted.  ``--noconftest`` skips this file.
"""

import contextlib
import faulthandler
import os
import re
import signal
import sys
import tempfile
import threading
import traceback

import pytest

# 3.4 times the slowest test of a whole run (88.2 s), and above the longest
# deadline a test gives the processes it starts (240 s).
LIMIT_S = 300
# How long past the limit a process whose main thread has not taken the
# signal runs before it is ended.
GRACE_S = 60

_STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    # The process's own stderr, copied before any test redirects it, as
    # pytest's faulthandler plugin keeps it.  xdist replaces sys.stderr in
    # its workers with an object that has no file descriptor.
    try:
        fd = sys.stderr.fileno()
    except (AttributeError, ValueError):
        fd = sys.__stderr__.fileno()
    config.stash[_STDERR] = os.dup(fd)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


@contextlib.contextmanager
def _limit(item, phase):
    if not hasattr(signal, "pthread_kill"):
        yield
        return
    stderr = item.config.stash[_STDERR]
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    name = re.sub(r"[^\w.-]+", "_", item.nodeid)[:200]
    path = os.path.join(tempfile.gettempdir(), "tier1_stalls",
                        f"{worker}-{os.getpid()}-{name}.txt")
    said = f"{item.nodeid}: {phase} ran past its {LIMIT_S} s limit"
    ended = threading.Event()

    def stall():
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as f:
                f.write(said + "\n")
                f.flush()
                faulthandler.dump_traceback(f, all_threads=True)
            os.write(stderr, f"\n{said}; stacks in {path}\n".encode())
            faulthandler.dump_traceback(stderr, all_threads=True)
        finally:
            if not ended.is_set():
                signal.pthread_kill(threading.main_thread().ident,
                                    signal.SIGALRM)

    def fail(signum, frame):
        if not ended.is_set():
            pytest.fail(f"{said}; every thread's stack is in {path}\n"
                        "The main thread's stack:\n"
                        + "".join(traceback.format_stack(frame)))

    previous = signal.signal(signal.SIGALRM, fail)
    timer = threading.Timer(LIMIT_S, stall)
    timer.start()
    faulthandler.dump_traceback_later(LIMIT_S + GRACE_S, exit=True,
                                      file=stderr)
    try:
        yield
    finally:
        ended.set()
        timer.cancel()
        timer.join()  # the second stage still ends a dump that hangs
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _limit(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _limit(item, "call"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    with _limit(item, "teardown"):
        yield
