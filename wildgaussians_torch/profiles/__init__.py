"""Measurement probes of the port, run on the card as modules:

    python -m wildgaussians_torch.profiles.probe_cfin [--scene random|surfel]
    python -m wildgaussians_torch.profiles.probe_sortdesign

Counterparts of the JAX package's `tools/profiles/probe_cfin.py` (P1, the
early-exit probe) and `tools/profiles/probe_sortdesign.py` (the sort
primitives, and P2, the run-scatter probe)."""
