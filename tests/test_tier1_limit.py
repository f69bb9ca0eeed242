"""The per-test time limit of ``tests/conftest.py``: a deadlocked test
fails after its limit with every thread's stack on stderr, and the tests
after it in the same file still run.

Each case runs an inner pytest, without xdist, over a temporary
directory that holds a copy of the conftest and one test file."""

import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

CONFTEST = Path(__file__).with_name("conftest.py")

# a plain deadlock: the test takes a non-reentrant lock twice
DEADLOCK = """
    import threading

    import pytest


    @pytest.mark.time_limit(2)
    def test_hangs():
        lock = threading.Lock()
        lock.acquire()
        lock.acquire()  # HANGS HERE


    def test_after():
        pass
"""

# the JAX package's fault in small: the collector frees a cycle inside a
# section that holds a non-reentrant lock, and the cycle's __del__ asks
# for that lock; the interpreter swallows what a __del__ raises
IN_DEL = """
    import gc
    import threading

    import pytest

    lock = threading.Lock()


    class Cache:
        def __init__(self):
            self.me = self

        def __del__(self):
            with lock:  # HANGS HERE
                pass


    @pytest.mark.time_limit(2)
    def test_hangs():
        gc.disable()
        try:
            Cache()
            with lock:
                gc.collect()
        finally:
            gc.enable()


    def test_after():
        assert not lock.locked()
"""

# the test hangs, and then so does its fixture's teardown: the limit
# fires again there
IN_TEARDOWN = """
    import threading

    import pytest


    def hang():
        lock = threading.Lock()
        lock.acquire()
        lock.acquire()  # HANGS HERE


    @pytest.fixture
    def stuck():
        yield
        hang()


    @pytest.mark.time_limit(2)
    def test_hangs(stuck):
        hang()


    def test_after():
        pass
"""

# a worker thread deadlocks holding its lock: the limit frees the main
# thread's wait, not the worker, so a later test that waits on the same
# lock fails at its own limit too, and one that does not passes
IN_THREAD = """
    import threading

    import pytest

    lock = threading.Lock()


    def hold():
        lock.acquire()
        lock.acquire()  # HANGS HERE


    @pytest.mark.time_limit(2)
    def test_hangs():
        worker = threading.Thread(target=hold, daemon=True)
        worker.start()
        worker.join()


    @pytest.mark.time_limit(2)
    def test_waits_on_the_held_lock():
        with lock:
            pass


    def test_after():
        pass
"""


@pytest.mark.parametrize("body, summary, failed", [
    (DEADLOCK, "1 failed, 1 passed", ["test_hangs"]),
    (IN_DEL, "1 failed, 1 passed", ["test_hangs"]),
    (IN_TEARDOWN, "1 failed, 1 passed, 1 error", ["test_hangs"]),
    (IN_THREAD, "2 failed, 1 passed",
     ["test_hangs", "test_waits_on_the_held_lock"]),
], ids=["deadlock", "in-del", "in-teardown", "in-thread"])
def test_deadlocked_test_fails_and_the_file_runs_on(tmp_path, body,
                                                    summary, failed):
    shutil.copy(CONFTEST, tmp_path / "conftest.py")
    src = textwrap.dedent(body)
    (tmp_path / "test_inner.py").write_text(src)
    lines = [i for i, text in enumerate(src.splitlines(), start=1)
             if "HANGS HERE" in text]
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-q", "-rfE",
         "test_inner.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=60)
    assert run.returncode != 0, run.stdout
    assert re.search(rf"\b{summary}(, \d+ warnings?)? in ", run.stdout), \
        run.stdout
    for name in failed:
        assert f"FAILED test_inner.py::{name}" in run.stdout, run.stdout
        assert f"test_inner.py::{name} ran over its time limit of 2 s" \
            in run.stderr, run.stderr
    for line in lines:
        assert f'test_inner.py", line {line} in ' in run.stderr, run.stderr
