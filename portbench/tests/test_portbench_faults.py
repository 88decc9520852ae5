"""The check against faults planted under a run, at a tiny size on the CPU:
with the timed path broken, ``correct`` comes out false. Also the control
(the reference in float8 in the program's place) reads several times what
the program does; at the cells' own sizes that is read on the card
(``calibrate.py``) and by the ``card`` test below."""

import pytest
import torch

from conftest import SERVE, TRAIN

import run as harness

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "change_diff")


def _run(name, over, extra=None):
    return harness.run_cell(name, 2**32 + 5, 1.0, False, torch.device("cpu"),
                            overrides=over, extra=extra)


def _altered_token(monkeypatch):
    """Every slot's decode token replaced by the next id where it is
    produced."""
    from ray_tpu_torch.llm import _engine

    make = _engine._make_decode_step

    def make_altered(cfg, ecfg):
        step = make(cfg, ecfg)

        def altered(*a):
            out = step(*a)
            return (out + 1) % cfg.vocab_size
        return altered

    monkeypatch.setattr(_engine, "_make_decode_step", make_altered)


def _state_unchanged(monkeypatch):
    """The step returns its state unchanged: the optimizer never steps."""
    from ray_tpu_torch.models import llama

    adamw = llama.adamw

    def frozen(leaves, lr):
        opt = adamw(leaves, lr)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(llama, "adamw", frozen)


def _update_sign_flipped(monkeypatch):
    """The update applied with the wrong sign: each step moves the
    parameters back by what AdamW would move them forward. The norms of
    the first gradient and of the change stay as they were."""
    from ray_tpu_torch.models import llama

    adamw = llama.adamw

    def flipped(leaves, lr):
        opt = adamw(leaves, lr)
        step = opt.step

        def step_back(*a, **k):
            before = [p.detach().clone() for p in leaves]
            out = step(*a, **k)
            with torch.no_grad():
                for p, b in zip(leaves, before):
                    p.copy_(2 * b - p)
            return out

        opt.step = step_back
        return opt

    monkeypatch.setattr(llama, "adamw", flipped)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from ray_tpu_torch.models import llama

    loss = llama.compute_loss

    def half(cfg, params, tokens, *a, **k):
        return loss(cfg, params, tokens[: tokens.shape[0] // 2], *a, **k)

    monkeypatch.setattr(llama, "compute_loss", half)


@pytest.mark.parametrize("name,over,plant", [
    ("mistral7b.chat.long", SERVE, _altered_token),
    ("yi6b.train.s4096", TRAIN, _state_unchanged),
    ("yi6b.train.s4096", TRAIN, _half_batch),
    ("yi6b.train.s4096", TRAIN, _update_sign_flipped),
])
def test_planted_fault_is_not_correct(monkeypatch, name, over, plant):
    assert _run(name, over)["correct"]
    plant(monkeypatch)
    res = _run(name, over)
    assert not res["correct"], res["checks"]


def test_control_reads_over_the_program():
    serve = _run("mistral7b.chat.short", SERVE, extra={"control": True})
    g = serve["_extra"]["gaps"]
    assert g["control_gap"] > 3 * g["widest_gap"]
    train = _run("yi6b.train.s1024", TRAIN, extra={"control": True})
    ex = train["_extra"]
    assert any(ex["control"][k] > 3 * ex["gaps"][k] for k in NUMBERS)
    assert ex["half_batch"]["grad_gap"] > 10 * ex["gaps"]["grad_gap"]
    # the flipped change lies opposite the reference's: twice its norm
    assert ex["sign_flipped"]["change_diff"] > 1.9


@pytest.mark.card
@pytest.mark.parametrize("name", ["yi6b.train.s4096", "mistral7b.chat.long",
                                  "mistral7b.chat.short", "yi6b.train.s1024"])
def test_control_fails_the_cell_on_the_card(card, name):
    """At the cell's own size: the program is correct, and the control's
    reading breaks one of the cell's limits."""
    harness.cache_env()
    res = harness.run_cell(name, 2**31 + 99, 30.0, False, card,
                           extra={"control": True})
    assert res["correct"], res["checks"]
    lim = harness.load_json("workloads", f"{name}.json")["check"]
    ex = res["_extra"]
    if "control" in ex:
        assert any(ex["control"][k] > lim[k] for k in lim)
    else:
        assert ex["gaps"]["control_gap"] > lim["widest_gap"]
