"""The comparison that decides ``correct`` fails a run whose timed path is
broken underneath, each fault planted where the program produces it, the
rest of the run driven as on the card (on the CPU, at test size); and the
control — the reference in float8 put in the program's place — fails too."""
import time

import pytest
import torch

from erdabench import cell as cells
from erdabench import control, run, serve, train

CPU = torch.device("cpu")


def execute(root, w, **faults):
    return run.execute(cells.load(w, root), 1, 0.3, False, CPU, time.perf_counter(), **faults)


def altered_token(model):
    """Decode step 3 of every batch puts another token first."""
    decode, seen = model.decode_step, {"n": 0}

    def step(params, cache, token):
        logits, new = decode(params, cache, token)
        seen["n"] += 1
        if seen["n"] % 5 == 3:
            logits = logits.clone()
            logits[..., 7] = logits.max() + 1.0
        return logits, new
    model.decode_step = step
    return model


def stale_cache(model):
    """Decode steps return the cache they were given."""
    decode = model.decode_step
    model.decode_step = lambda params, cache, token: (decode(params, cache, token)[0], cache)
    return model


@pytest.mark.parametrize("w", ["olmo_tiny.tiny_chat", "olmo_tiny.tiny_preempt"])
@pytest.mark.parametrize("fault", [altered_token, stale_cache])
def test_serve_fault_is_not_correct(tiny_root, w, fault):
    assert execute(tiny_root, w)["correct"]
    assert not execute(tiny_root, w, wrap_model=fault)["correct"]


def test_restore_of_an_older_state_is_not_correct(tiny_root, monkeypatch):
    """A resume that hands back its template (the state at the preemption)
    instead of the snapshot."""
    from repro_torch.serving import kv_store
    monkeypatch.setattr(kv_store.ErdaKVPageStore, "restore_cache",
                        lambda self, seq, template: template)
    r = execute(tiny_root, "olmo_tiny.tiny_preempt")
    assert not r["correct"] and r["checks"]["page_diff"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "long_step",
                                   "no_bias_correction"])
def test_train_fault_is_not_correct(tiny_root, fault):
    hp = cells.load("olmo_tiny.tiny_train", tiny_root).mix["adamw"]
    wrap = control.train_faults(hp)[fault]
    assert not execute(tiny_root, "olmo_tiny.tiny_train", wrap_step=wrap)["correct"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_control_is_not_correct(tiny_root, seed):
    c = cells.load("olmo_tiny.tiny_chat", tiny_root)
    out = serve.run(c, seed, 0.3, False, CPU, time.perf_counter())
    prompts, served = out["runner"].sample()
    assert out["values"]["logit_gap"] <= c.limits["logit_gap"]
    low = out["runner"].logit_gaps(prompts, served, "fp8")
    assert low["logit_gap"] > c.limits["logit_gap"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_train_control_is_not_correct(tiny_root, seed):
    c = cells.load("olmo_tiny.tiny_train", tiny_root)
    ref = train.reference_readings(c.model, c.mix, seed, CPU)
    low = train.compare(train.reference_readings(c.model, c.mix, seed, CPU, "fp8"), ref)
    assert any(low[k] > lim for k, lim in c.limits.items()), low
