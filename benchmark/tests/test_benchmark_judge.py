"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a tiny size (``tiny.py``, with its limits): a sound run
is correct; each fault a cell can have, planted where the program works,
and the control (the float8 reference in the program's place) are not."""

import time

import pytest
import torch

from benchmark.harness import cli
from benchmark.tests import tiny


def run(name, seed=1, trace=False):
    return cli.run_cell(tiny.cell(name), seed, 0.0, trace, torch.device("cpu"),
                        "cpu", time.time())


def test_a_sound_eval_run_is_correct():
    r = run("small.eval-long")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 4
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"max_gap", "logprob_gap"}


def test_an_altered_token_is_not_correct(monkeypatch):
    import whisper_ipa_torch.decode.decoding as dec

    real = dec.decode

    def altered(*a, **k):
        out = real(*a, **k)
        for r in out:
            r.tokens[2] = (r.tokens[2] + 1 + 137) % 50257
        return out

    monkeypatch.setattr(dec, "decode", altered)
    r = run("small.eval-long")
    assert not r["correct"] and r["checks"]["max_gap"]["value"] > 1e-3
    assert r["checks"]["logprob_gap"]["value"] > 1.1e-3


def test_a_wrong_greedy_choice_with_consistent_logprobs_is_not_correct():
    # the loop serves the second-best token and reports that token's own
    # log-probability: avg_logprob agrees with the reference, max_gap does not
    from benchmark import calibrate

    with calibrate.second_best_tokens():
        r = run("small.eval-long")
    assert not r["correct"]
    assert r["checks"]["max_gap"]["value"] > r["checks"]["max_gap"]["limit"]


def test_half_the_rows_left_out_is_not_correct(monkeypatch):
    import whisper_ipa_torch.decode.decoding as dec

    real = dec.decode
    monkeypatch.setattr(dec, "decode", lambda *a, **k: real(*a, **k)[::2])
    r = run("small.eval-long")
    assert not r["correct"] and r["failed"] == 2


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float8_control_reads_above_the_limits(seed):
    for name in ("small.eval-long", "small.finetune"):
        drv = tiny.driver(name, seed)
        drv.setup()
        drv.window(0.0, False)
        drv.release()
        r = drv.check(control=True)
        limits = tiny.LIMITS[drv.mix["kind"]]
        control = {n: r["control_" + n] for n in limits}
        assert all(r[n] <= limits[n] for n in limits), (name, r)
        assert any(control[n] > limits[n] for n in limits), (name, r)


def test_the_programs_int8_path_serves_rows_the_reference_can_judge():
    # calibrate.py's second witness: the program's own int8 linears
    from whisper_ipa_torch.models.layers import use_int8_activations

    drv = tiny.driver("small.eval-long", 1)
    drv.setup()
    try:
        drv.use_int8()
        drv.window(0.0, False)
    finally:
        use_int8_activations(False)
    drv.release()
    r = drv.check()
    assert len(drv.sample_tokens) == 3
    assert 0.0 < r["logprob_gap"] < 0.1 and r["max_gap"] < 0.1


def test_a_sound_finetune_run_is_correct_and_traced():
    r = run("small.finetune", trace=True)
    assert r["correct"], r["checks"]
    assert {"step_ms.train"} <= set(r["metrics"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from whisper_ipa_torch.train.optimizer import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self, *a, **k: False)
    r = run("small.finetune")
    assert not r["correct"]
    assert r["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    import whisper_ipa_torch.train.step as step

    real = step.train_step

    def half(state, mel, tokens, *a, **k):
        h = mel.shape[0] // 2
        return real(state, mel[:h], tokens[:h], *a, **k)

    monkeypatch.setattr(step, "train_step", half)
    r = run("small.finetune")
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] > r["checks"]["grad_gap"]["limit"]


def test_a_chunk_that_misstacks_its_batches_is_not_correct(monkeypatch):
    # every step past a chunk's second reruns the second batch: a fault of
    # the chunked path alone, which the checked chunk of the window's
    # length has to show
    import whisper_ipa_torch.train.step as step

    real = step.train_chunk

    def misstacked(state, mels, tokens, *a, **k):
        if mels.shape[0] > 2:
            mels = torch.cat([mels[:2], mels[1:2].expand(mels.shape[0] - 2, *mels.shape[1:])])
            tokens = torch.cat([tokens[:2],
                                tokens[1:2].expand(tokens.shape[0] - 2, *tokens.shape[1:])])
        return real(state, mels, tokens, *a, **k)

    monkeypatch.setattr(step, "train_chunk", misstacked)
    r = run("small.finetune")
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


def test_calibrate_plants_half_a_batch_in_the_programs_step():
    from benchmark import calibrate

    r = calibrate.half_batch(tiny.cell("small.finetune"), 1, torch.device("cpu"))
    limits = tiny.LIMITS["finetune"]
    assert r["grad_gap"] > limits["grad_gap"] and r["loss_gap"] > limits["loss_gap"]
