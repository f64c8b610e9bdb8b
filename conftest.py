"""Order in which `--dist loadfile` hands test files to the xdist workers.

xdist sorts files by test count, largest first, so one-test files go last.
The two below hold one test each but are the suite's longest: each compiles
the JAX package's 8-device sharded sort engine in Pallas interpret mode
(`test_skew.py` 950-1,120 s, `test_send_cap.py` 610-780 s on 6 workers of
an 8-core machine). Sent last, they end long after every other file. They are
sent first instead; every other file keeps xdist's own order. No test is
added, dropped, marked or skipped: only the order changes.
"""
from collections import Counter

import pytest

LONG_FIRST = ("tests/test_skew.py", "tests/test_send_cap.py")


def pytest_configure(config):
    # dispatch in the collection order set below, not by test count
    if config.pluginmanager.hasplugin("xdist"):
        config.option.loadscopereorder = False


def _file(item):
    return item.nodeid.split("::", 1)[0]  # xdist's loadfile scope


@pytest.hookimpl(trylast=True)  # after `-m` deselects: count what xdist counts
def pytest_collection_modifyitems(config, items):
    counts = Counter(map(_file, items))

    def key(item):  # list.sort is stable: a file's tests stay in their order
        f = _file(item)
        return LONG_FIRST.index(f) if f in LONG_FIRST else len(LONG_FIRST), -counts[f]

    items.sort(key=key)
