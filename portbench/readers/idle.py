"""The device's idle share of the profiled window, in %: 1 - the union of
its operations' intervals over the window."""


def read(spec: dict, out: dict):
    p = out.get("profile")
    if not p:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
