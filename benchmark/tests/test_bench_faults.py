"""A run with the timed path broken underneath comes out not correct: the
cell's own limits against each fault it can have, on the CPU at a small
size (the look for a card skipped). One chip, so no exchange between
chips to leave out."""
import numpy as np
import pytest

from benchmark import run
from bench_util import one_thread, shrink


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    prev = one_thread()
    yield
    torch.set_num_threads(prev)


def _train_fault(monkeypatch, kind):
    from se3_equi_graph_registration_tpu_torch.train import engine

    make = engine.make_train_step

    def broken(model, optimizer, cfg, mesh=None):
        step = make(model, optimizer, cfg, mesh)

        def unchanged(state, batch):          # returns its state as it came
            import torch
            with torch.no_grad():
                lb = engine.train_loss(model, cfg, batch)
            return state, {k: v.detach() for k, v in lb._asdict().items()}

        def half(state, batch):               # the mean over the first half of the pairs
            b = batch["src_pts"].shape[0] // 2
            return step(state, {k: v[:b] for k, v in batch.items()})

        def frozen(state, batch):             # Adam's moments move, the parameters do not
            import torch
            before = [p.detach().clone() for p in model.parameters()]
            out = step(state, batch)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return out

        return {"unchanged": unchanged, "half": half, "frozen": frozen}[kind]

    monkeypatch.setattr(engine, "make_train_step", broken)


def _serve_fault(monkeypatch, kind):
    from se3_equi_graph_registration_tpu_torch import serving

    register = serving.Registrar.register

    def broken(self, src_pts, src_feat, tgt_pts, tgt_feat, **kw):
        if kind == "half":                    # answers for half of the pairs, repeated
            b = len(src_pts) // 2
            R, t, info = register(self, src_pts[:b], src_feat[:b], tgt_pts[:b], tgt_feat[:b],
                                  **kw)
            info["pose_covariance"] = np.concatenate([info["pose_covariance"]] * 2)
            return np.concatenate([R, R]), np.concatenate([t, t]), info
        R, t, info = register(self, src_pts, src_feat, tgt_pts, tgt_feat, **kw)
        t = t.copy()
        t[0] += 0.01                          # one answer moved by a centimetre
        return R, t, info

    monkeypatch.setattr(serving.Registrar, "register", broken)


@pytest.mark.parametrize("cell", ["3dmatch-train-b64", "kitti-train-b64"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "frozen"])
def test_a_broken_train_step_is_not_correct(monkeypatch, cell, kind):
    _train_fault(monkeypatch, kind)
    code, result, table = run.run(cell, 31, 0.3, False, device="cpu", edit=shrink(cell, 4))
    assert code == 0 and result["correct"] is False, table


@pytest.mark.parametrize("cell", ["3dmatch-eval-b64", "kitti-eval-b64"])
@pytest.mark.parametrize("kind", ["altered", "half"])
def test_a_broken_register_is_not_correct(monkeypatch, cell, kind):
    _serve_fault(monkeypatch, kind)
    code, result, table = run.run(cell, 32, 0.3, False, device="cpu", edit=shrink(cell, 4))
    assert code == 0 and result["correct"] is False, table
