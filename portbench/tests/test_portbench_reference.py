"""The reference against the program's CPU path at a tiny size: a sound
run of each cell comes out correct under the cell's own limits, with its
numbers at rounding level; the training cell also with appearance off
(one pass, no MLP: the NeRF On-the-go step)."""
import pytest

import tiny
from kinds import serve, train


@pytest.mark.parametrize("cell,appearance", [("pt-train", True), ("pt-train", False),
                                             ("pt-serve", True)])
def test_reference_agrees_with_the_program_on_the_cpu(cell, appearance):
    ctx = tiny.context(cell)
    ctx["cfg"]["appearance_enabled"] = appearance
    kind = serve if ctx["traffic"]["kind"] == "serve" else train
    out, checks = kind.run(ctx)
    assert out["correct"], (checks, out["problems"])
    assert all(c["value"] <= 1e-5 for c in checks.values()), checks
    assert out["attempted"] >= 1 and out["failed"] == 0
