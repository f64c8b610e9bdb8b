"""The root `conftest.py` makes `--dist loadfile` send its `LONG_FIRST` files
first, and drops no test.

A dummy suite in a temporary directory (two one-test files named as the long
ones, three files of three short tests) runs on two xdist workers, once with a
copy of the root `conftest.py` and once without it as the control: without it
xdist sends the one-test files only after a short test has ended."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

TEST = '''
import time


def _run(request, seconds):
    start = time.monotonic()
    time.sleep(seconds)
    with open({log!r}, "a") as f:
        f.write(f"{{request.node.nodeid}} {{start}} {{time.monotonic()}}\\n")
'''


def _suite(tmp_path):
    """Write the dummy suite; return its log path and its long files."""
    log = tmp_path / "schedule.log"
    (tmp_path / "pytest.ini").write_text(
        "[pytest]\ntestpaths = tests\naddopts = -n 2 --dist loadfile\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    head = TEST.format(log=str(log))
    long_files = ("test_skew.py", "test_send_cap.py")
    for name in long_files:
        (tests / name).write_text(head + "\n\ndef test_long(request):\n    _run(request, 1.0)\n")
    for name in ("test_a.py", "test_b.py", "test_c.py"):
        body = "".join(f"\n\ndef test_{i}(request):\n    _run(request, 0.1)\n" for i in range(3))
        (tests / name).write_text(head + body)
    return log, tuple(f"tests/{name}" for name in long_files)


def _run_suite(tmp_path, log):
    log.unlink(missing_ok=True)
    # xdist alone: the other installed plugins cost each worker seconds to import
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_ADDOPTS"}
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "xdist", "-p", "no:cacheprovider"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "11 passed" in proc.stdout, proc.stdout[-3000:]
    runs = {}
    for line in log.read_text().splitlines():
        nodeid, start, end = line.split()
        runs[nodeid] = (float(start), float(end))
    assert len(runs) == 11
    return runs


def _starts_and_first_short_end(runs, long_files):
    long_starts = [s for n, (s, _) in runs.items() if n.split("::")[0] in long_files]
    short_ends = [e for n, (_, e) in runs.items() if n.split("::")[0] not in long_files]
    assert len(long_starts) == 2 and len(short_ends) == 9
    return long_starts, min(short_ends)


def test_long_files_are_sent_first(tmp_path):
    log, long_files = _suite(tmp_path)
    shutil.copy(ROOT / "conftest.py", tmp_path / "conftest.py")
    starts, first_end = _starts_and_first_short_end(_run_suite(tmp_path, log), long_files)
    assert max(starts) < first_end, (starts, first_end)

    # control: without the conftest xdist sends the one-test files last
    (tmp_path / "conftest.py").unlink()
    starts, first_end = _starts_and_first_short_end(_run_suite(tmp_path, log), long_files)
    assert min(starts) > first_end, (starts, first_end)
