"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name: the cell in
BENCHMARK.json, its configuration in the file BENCHMARK.json names, its
traffic in traffic/<traffic>.json (whose `kind` picks kinds/<kind>.py), its
limits in workloads/<cell>.json, each per-layer metric in
metrics/<metric>.json (whose `reader` picks readers/<reader>.py). See
README.md.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(*parts):
    with open(os.path.join(*parts), encoding="utf8") as f:
        return json.load(f)


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cell_context(name: str, bench: dict) -> dict:
    """The cell's entries: BENCHMARK.json's workload, its configuration file
    and the program configuration in it, its traffic and its limits."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = load(ROOT, entry["file"])
    return {"cell": cell, "conf": conf, "cfg": conf["config"],
            "traffic": load(HERE, "traffic", cell["traffic"] + ".json"),
            "limits": load(HERE, "workloads", name + ".json")["limits"]}


def metrics_of(bench: dict, name: str, trace: bool):
    """The cell's metrics: its end-to-end ones, or with --trace 1 the
    per-layer ones listed for it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or name in m["workloads"]]


def read_metrics(bench: dict, name: str, trace: bool, out: dict) -> dict:
    result = {}
    for m in metrics_of(bench, name, trace):
        if not trace:
            value = out["e2e"].get(m["name"])
        else:
            spec = load(HERE, "metrics", m["name"] + ".json")
            reader = importlib.import_module("readers." + spec["reader"])
            value = reader.read(spec, out)
        if value is not None:
            result[m["name"]] = {"value": value, "unit": m["unit"]}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    bench = load(ROOT, "BENCHMARK.json")
    ctx = cell_context(args.workload, bench)
    chips = ctx["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"torch.cuda.is_available() = {torch.cuda.is_available()}")
    try:
        importlib.import_module("wildgaussians_torch")
    except ImportError as exc:
        fail(f"the program is not here: {exc}")
    # one process with one CPU thread: the program's host work runs on the
    # main thread, and an idle thread pool would only contend with it
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from harness import common
    kind = importlib.import_module("kinds." + ctx["traffic"]["kind"])
    ctx.update(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
               device=torch.device("cuda", 0), t_start=T_START)
    out, checks = kind.run(ctx)
    found = common.forbidden_modules()
    if found:
        fail(f"modules that no run may load were loaded: {found}", 3)
    for p in out.get("problems", ()):
        print(f"portbench: {p}", file=sys.stderr)
    device = dict(common.card(), memory_peak_bytes=int(out["peak"]))
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": read_metrics(bench, args.workload, bool(args.trace), out),
              "device": device}
    if args.trace:
        prof = out["profile"]
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = common.breakdown(prof)
    common.emit(result, checks)


if __name__ == "__main__":
    main()
