"""The whole unit's share of the card's FP32 peak, in %: the operations a
step or a request needs (work.py) over its time in the profiled window."""
import work


def read(spec: dict, out: dict):
    p, w = out.get("profile"), out.get("work")
    if not p or not w:
        return None
    if spec["unit"] == "step":
        ops = work.step_ops(w, w["appearance"], w["uncertainty"])
    else:
        ops = work.request_ops(w, w["appearance"])
    per_unit_s = p["window_s"] / out["profile_units"]
    return 100.0 * ops / (per_unit_s * work.PEAK_FP32)
