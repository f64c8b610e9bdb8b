"""`torch_mesh_worker.spawn` stops ranks that outlive its deadline.

Ranks stuck in a collective would otherwise hold their pytest-xdist worker
until gloo's 30-minute timeout, longer than the whole suite's time limit.
Here two ranks sleep for an hour; spawn, its deadline set to 10 s, must raise
TimeoutError naming the case and both ranks within the deadline + 30 s, and
leave no rank process alive.

One test (see test_torch_isolation.py)."""
import multiprocessing
import os
import time

import pytest

import torch_mesh_worker as W

DEADLINE, GRACE = 10.0, 30.0


def sleep_case(mesh, tmpdir, arg):
    time.sleep(3600)
    return {}


def test_spawn_stops_ranks_past_its_deadline(tmp_path, monkeypatch):
    monkeypatch.setattr(W, "SPAWN_DEADLINE_S", DEADLINE)
    before = {p.pid for p in multiprocessing.active_children()}
    pids = []

    def ranks():
        pids.extend(p.pid for p in multiprocessing.active_children() if p.pid not in before)

    start = time.monotonic()
    with pytest.raises(TimeoutError, match=r"sleep_case: ranks \[0, 1\] of 2"):
        W.spawn(sleep_case, 2, str(tmp_path), meanwhile=ranks)
    assert time.monotonic() - start < DEADLINE + GRACE
    assert len(pids) == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
