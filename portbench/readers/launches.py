"""Device operations launched in the profiled window, per unit."""


def read(spec: dict, out: dict):
    p = out.get("profile")
    if not p:
        return None
    return p["launches"] / out["profile_units"]
