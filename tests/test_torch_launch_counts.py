"""The launch counter every kernel wrapper calls once a launch.

Replicas of a fleet step from a thread each, and a wrapper's ``ctypes``
call releases the GIL, so the count must hold under threads.
"""
from __future__ import annotations

import collections
import threading
import types

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_launch_count_helper_is_exact_under_threads():
    """``_build.count`` is what every wrapper calls once a launch: from
    four threads at once it loses no update, ``launches_by`` included."""
    mod = types.SimpleNamespace(launches=0,
                                launches_by=collections.Counter())
    n = 2000

    def work(i):
        for _ in range(n):
            _build.count(mod, ("gram", str(i % 2)))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert mod.launches == 4 * n
    assert mod.launches_by == {("gram", "0"): 2 * n, ("gram", "1"): 2 * n}
