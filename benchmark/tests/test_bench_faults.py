"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at tiny widths (tiny.py), once a fault each cell can have.
The exchange between cards is no fault of these one-card cells."""
import pytest

from benchmark import harness
from benchmark.tests import tiny

SEED = 2 ** 31 + 11


def _run(name):
    return harness.run_cell(tiny.cell(name), SEED, 0.5, False, "cpu")


@pytest.mark.parametrize("name", ["bert-large.train-s512",
                                  "gpt2-medium.offline-closed"])
def test_sound_run_is_correct(name):
    assert _run(name)["correct"]


@pytest.mark.parametrize("name", ["bert-large.train-s512",
                                  "bert-large.train-s128"])
def test_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from flexflow_tpu_torch.runtime import optimizers

    monkeypatch.setattr(optimizers.AdamOptimizer, "update",
                        lambda self, params, grads, state, config=None:
                        None)
    result = _run(name)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] > 0.9


@pytest.mark.parametrize("name", ["bert-large.train-s512",
                                  "bert-large.train-s128"])
def test_half_the_batch_left_out(name, monkeypatch):
    from flexflow_tpu_torch.runtime import losses

    full = losses.sparse_categorical_crossentropy

    def half(logits, labels):
        n = logits.shape[0] // 2
        return full(logits[:n], labels[:n])

    monkeypatch.setattr(losses, "sparse_categorical_crossentropy", half)
    result = _run(name)
    assert not result["correct"]
    assert result["checks"]["grad_gap"]["value"] > \
        result["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("name", ["gpt2-medium.chat-poisson",
                                  "gpt2-medium.offline-closed"])
def test_token_altered_where_produced(name, monkeypatch):
    from flexflow_tpu_torch.serving.sched import continuous

    emit = continuous.ContinuousBatcher._emit_token

    def altered(self, s, tok):
        if len(s.req.tokens) == 1:
            tok = (tok + 1) % 101
        return emit(self, s, tok)

    monkeypatch.setattr(continuous.ContinuousBatcher, "_emit_token", altered)
    result = _run(name)
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] > \
        result["checks"]["logit_gap"]["limit"]
