"""Device ms per unit (step or request) of the program's named spans,
summed (`SpanTimer.ms()`: each span's device timeline, CUDA events)."""


def read(spec: dict, out: dict):
    spans = out.get("spans") or {}
    found = [spans[s][0] for s in spec["spans"] if s in spans]
    if not found:
        return None
    return sum(found) / out["units"]
