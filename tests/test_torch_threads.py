# The port's CPU tests under pytest-xdist share the machine's cores: each
# worker process would otherwise run torch with one intra-op thread per
# core, and six workers then oversubscribe the cores many times over (a
# test that takes seconds alone took minutes so).  Every tests/test_torch_*.py
# calls ``cap_torch_threads()`` at import: under xdist it caps torch's
# intra-op threads at the worker's share of the cores, os.cpu_count() //
# PYTEST_XDIST_WORKER_COUNT (at least 1); a file run without xdist keeps
# torch's default.  Tests that start a Python subprocess pass
# ``subprocess_env(...)``, which carries the same cap as OMP_NUM_THREADS.
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

WORKER_COUNT = "PYTEST_XDIST_WORKER_COUNT"


def thread_share(environ=None) -> Optional[int]:
    """The intra-op threads of one xdist worker, or None outside xdist."""
    n = (os.environ if environ is None else environ).get(WORKER_COUNT)
    if not n:
        return None
    return max(1, (os.cpu_count() or 1) // int(n))


def cap_torch_threads() -> Optional[int]:
    n = thread_share()
    if n is not None and torch.get_num_threads() != n:
        torch.set_num_threads(n)
    return n


def subprocess_env(**extra: str) -> Dict[str, str]:
    """os.environ with ``extra``, and under xdist OMP_NUM_THREADS set to the
    worker's share, for a Python subprocess of a test."""
    env = dict(os.environ, **extra)
    n = thread_share()
    if n is not None:
        env["OMP_NUM_THREADS"] = str(n)
    return env


cap_torch_threads()


def test_thread_share_under_xdist_and_alone():
    cores = os.cpu_count() or 1
    assert thread_share({}) is None
    assert thread_share({WORKER_COUNT: "1"}) == cores
    assert thread_share({WORKER_COUNT: "6"}) == max(1, cores // 6)
    assert thread_share({WORKER_COUNT: str(4 * cores)}) == 1


def test_torch_threads_capped_in_a_worker():
    n = thread_share()
    if n is None:
        assert os.environ.get(WORKER_COUNT) is None
    else:
        assert torch.get_num_threads() == n


def test_subprocess_env_carries_the_cap(monkeypatch):
    monkeypatch.setenv(WORKER_COUNT, "6")
    env = subprocess_env(PYTHONPATH="src")
    assert env["PYTHONPATH"] == "src"
    assert env["OMP_NUM_THREADS"] == str(max(1, (os.cpu_count() or 1) // 6))
    monkeypatch.delenv(WORKER_COUNT)
    assert subprocess_env().get("OMP_NUM_THREADS") == os.environ.get("OMP_NUM_THREADS")
