"""A kernel group's share of its roofline, in %: the least time the work
needs (work.py, from the reference's walk) over the group's device time in
the profiled window, by kernel name. Nothing when the group did not run."""
import work


def read(spec: dict, out: dict):
    p, w = out.get("profile"), out.get("work")
    if not p or not w:
        return None
    us = sum(t for name, (t, _n) in p["kernels"].items()
             if any(k in name for k in spec["kernels"]))
    if us <= 0:
        return None
    passes = w["passes"] if spec["passes"] == "cell" else int(spec["passes"])
    least = sum(work.least_s(*getattr(work, part)(w, passes)) for part in spec["work"])
    return 100.0 * least * out["profile_units"] / (us * 1e-6)
