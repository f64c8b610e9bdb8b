"""A run whose timed path is broken underneath comes out not correct,
for each fault the cell can have: a step that leaves the state unchanged,
one group of tensors stepped at twice its learning rate, half of the
image's pixels left out with the mean over the rest, an image altered
where it is produced. (No cell runs on several chips, so there is
no exchange to leave out.) The look for a card is skipped: the program runs
on the CPU at a tiny size."""
import numpy as np
import pytest

import tiny
from kinds import serve, train


def unchanged_state(monkeypatch):
    from wildgaussians_torch.models import gaussian_store as gs
    monkeypatch.setattr(gs, "adam_update", lambda params, grads, state, *a, **k: state)


def group_lr_doubled(monkeypatch, group):
    from wildgaussians_torch.models import gaussian_store as gs
    real = gs.param_learning_rates

    def doubled(*args, **kwargs):
        lrs = dict(real(*args, **kwargs))
        lrs[group] = lrs[group] * 2
        return lrs
    monkeypatch.setattr(gs, "param_learning_rates", doubled)


def half_batch(model):
    for m in model._pixmask:
        m[m.shape[0] // 2:] = 0.0


def altered_answer(model):
    render = model.render

    def broken(*args, **kwargs):
        out = render(*args, **kwargs)
        out["color"] = out["color"].copy()
        out["color"][:16, :16] = 1.0 - out["color"][:16, :16]
        return out
    model.render = broken


@pytest.mark.parametrize("cell,fault", [("pt-train", "unchanged_state"),
                                        ("pt-train", "half_batch"),
                                        ("pt-train", "appearance_mlp_lr_doubled"),
                                        ("pt-train", "uncertainty_lr_doubled"),
                                        ("pt-train", "opacities_lr_doubled"),
                                        ("pt-serve", "altered_answer")])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    ctx = tiny.context(cell)
    if fault == "unchanged_state":
        unchanged_state(monkeypatch)
    elif fault.endswith("_lr_doubled"):
        group_lr_doubled(monkeypatch, fault[:-len("_lr_doubled")])
    else:
        ctx["fault"] = {"half_batch": half_batch, "altered_answer": altered_answer}[fault]
    kind = serve if ctx["traffic"]["kind"] == "serve" else train
    out, checks = kind.run(ctx)
    assert not out["correct"], checks
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
    assert np.isfinite([c["value"] for c in checks.values()]).all()
