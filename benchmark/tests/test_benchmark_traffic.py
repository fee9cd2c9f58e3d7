"""The traffic generators are deterministic per seed and keep to their
ranges; every seed gets the same set of sizes in another order."""

import torch

from benchmark.harness import audio
from benchmark.reference.tokens import special_ids, transcribe_prefix
from benchmark.tests import tiny

SEED = 3_000_000_123  # over 2**31, as the driver's are


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_lengths_are_one_stratified_set_in_a_seeded_order():
    a = audio.stratified_lengths(64, 3.0, 8.0, gen(SEED))
    b = audio.stratified_lengths(64, 3.0, 8.0, gen(SEED))
    c = audio.stratified_lengths(64, 3.0, 8.0, gen(SEED + 1))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(a.sort().values, c.sort().values)
    assert float(a.min()) > 3.0 and float(a.max()) < 8.0
    assert abs(float(a.sum()) - 64 * 5.5) < 1e-9


def test_speech_is_deterministic_and_zero_padded_after_each_utterance():
    lengths = torch.tensor([0.5, 2.0, 7.25], dtype=torch.float64)
    x = audio.speech_batch(lengths, gen(SEED), "cpu")
    y = audio.speech_batch(lengths, gen(SEED), "cpu")
    assert x.shape == (3, audio.WINDOW_SAMPLES) and x.dtype == torch.float32
    assert torch.equal(x, y)
    for row, sec in zip(x, lengths.tolist()):
        n = round(sec * audio.SAMPLE_RATE)
        assert float(row[n:].abs().max()) == 0.0
        assert 0.05 < float(row[:n].std()) < 0.2


def test_finetune_targets_keep_the_prefix_lengths_and_vocabulary():
    drv = tiny.driver("small.finetune", SEED)
    n_vocab = drv.dims["n_vocab"]
    drv.eot = special_ids(n_vocab)["eot"]
    lo, hi = drv.mix["target_tokens"]
    rows = drv._targets(gen(SEED))
    again = drv._targets(gen(SEED))
    prefix = transcribe_prefix(n_vocab)
    assert torch.equal(rows, again)
    assert rows.shape == (drv.mix["batch"], len(prefix) + hi + 1)
    assert (rows[:, :len(prefix)] == torch.tensor(prefix)).all()
    body = rows[:, len(prefix):]
    lengths = (body != drv.eot).sum(1)
    for r, n in enumerate(lengths.tolist()):
        assert (body[r, :n] < drv.eot).all() and (body[r, n:] == drv.eot).all()
    want = sorted(round(lo + (hi - lo) * i / (drv.mix["batch"] - 1))
                  for i in range(drv.mix["batch"]))
    assert sorted(lengths.tolist()) == want
    assert drv.input_lengths == [len(prefix) + n for n in
                                 [round(lo + (hi - lo) * i / (drv.mix["batch"] - 1))
                                  for i in range(drv.mix["batch"])]]


def test_an_eval_run_serves_the_same_rows_for_the_same_seed():
    def served(seed):
        drv = tiny.driver("small.eval-long", seed)
        drv.setup()
        out = drv.window(0.0, False)
        drv.release()
        return out["attempted"], drv.sample_tokens, drv.sample_waves

    a, b = served(SEED), served(SEED)
    assert a[0] == b[0] == 4
    assert a[1] == b[1] and torch.equal(a[2], b[2])
    assert all(len(row) == 6 for row in a[1])
