"""The audio language model's cell (``omni.eval-long``, Uni-MoE-2.0-Omni's
speech-to-text path): its files, its driver run through the rest of a run
on the CPU at a tiny size, its readers on fabricated facts, Whisper's
readers finding nothing in its facts and its readers nothing in Whisper's,
the near-tie rule, and each fault
planted where the program works making ``correct`` false.

The tiny size keeps the published cell's traffic kind and layout with a
64-wide model: 2 layers, 4 query and 2 K/V heads, routed experts of width
32, two shared experts of width 16, one null expert, a vocabulary of 512
(special ids from 500), 8 audio tokens from a 2-layer 64-wide tower; 4
rows a batch, 6 tokens. Limits set from readings of this size (the
program in bfloat16 on the CPU, seeds 1-8; the float8 control and the
faults, seeds 1-3):

  max_gap       program 0-0.0276; control 0.264-0.552; second-best
                0.624-1.179; renormalised 0.185-0.626; null expert
                computing 0.102-0.207; shared expert dropped 1.33-2.57 -> 0.06
  logprob_gap   program 0.0035-0.0100; control 0.036-0.157 -> 0.025
  forced_routes program 0-3; control 6-9 -> 5 (a handful of routing
                decisions at this size: 3 rows x 15 positions x 2 layers)
"""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import calibrate_omni
from benchmark.harness import cli, registry
from benchmark.harness.trace import Stretch
from benchmark.reference import uni_moe_omni as ref

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, dynamic_intermediate_size=32,
            shared_intermediate_size=16, mlp_fixed_expert_num=2, vocab_size=512,
            first_special_id=500, eos_token_id=501, whisper_hidden_size=64,
            whisper_query_tokens_size=8, d_model=64, encoder_layers=2,
            encoder_attention_heads=2, encoder_ffn_dim=256, decoder_layers=2,
            decoder_attention_heads=4, decoder_ffn_dim=32)
LIMITS = {"max_gap": 0.06, "logprob_gap": 0.025, "forced_routes": 5}


def cell():
    c = registry.cell("omni.eval-long")
    c["config_file"] = dict(c["config_file"], **TINY)
    c["mix"] = dict(c["mix"], batch=4, sample_len=6, prompt_before=3, prompt_after=2,
                    distinct_batches=2, check_rows=3)
    c["limits"] = LIMITS
    return c


def _make_driver(c, seed, device, name):
    """``cli.make_driver`` with the tiny configuration handed over (the
    driver otherwise reads the published file by name)."""
    ctx = SimpleNamespace(seed=seed, device=device, device_name=name,
                          dims=registry.dims(c["config_file"]), mix=c["mix"],
                          config_name=c["config"], config_file=c["config_file"])
    return registry.driver(c["mix"]["kind"]).Driver(ctx)


def driver(seed):
    return _make_driver(cell(), seed, torch.device("cpu"), "cpu")


def run(monkeypatch, seed=1, trace=False):
    monkeypatch.setattr(cli, "make_driver", _make_driver)
    return cli.run_cell(cell(), seed, 0.0, trace, torch.device("cpu"), "cpu",
                        time.time())


def test_the_registry_loads_the_cell_and_its_configuration():
    c = registry.cell("omni.eval-long")
    assert c["chips"] == 1 and c["mix"]["kind"] == "audio_llm_batch"
    assert c["report_as"] == {"audio_s_per_s": "audio_s_per_s.large"}
    assert set(c["limits"]) == {"max_gap", "logprob_gap", "forced_routes"}
    f = c["config_file"]
    assert f["source"] == "https://huggingface.co/HIT-TMG/Uni-MoE-2.0-Omni/blob/main/config.json"
    assert f["reduced"] == [] and "connector" in f["assumed"]
    assert (f["num_hidden_layers"], f["hidden_size"], f["num_key_value_heads"],
            f["vocab_size"], f["dynamic_intermediate_size"]) == (28, 3584, 4, 152064, 18944)
    d = registry.dims(f)
    assert (d["d_model"], d["n_mels"], d["encoder_layers"], d["decoder_layers"]) == \
        (1280, 128, 32, 28)
    assert registry.e2e(c) == {"audio_s_per_s.large": ("audio_s_per_s", "audio-s/s")}
    mix = c["mix"]
    assert (mix["batch"], mix["sample_len"], mix["prompt_before"], mix["prompt_after"]) == \
        (64, 64, 20, 16)


def test_a_sound_run_is_correct(monkeypatch):
    r = run(monkeypatch)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 4
    assert set(r["metrics"]) == {"audio_s_per_s.large", "setup_s"}
    assert set(r["checks"]) == set(LIMITS) and list(r)[-1] == "checks"


def test_a_traced_run_reads_the_counter(monkeypatch):
    r = run(monkeypatch, trace=True)
    assert r["correct"]
    got = r["metrics"]["expert_rows_per_token.omni"]["value"]
    assert 1.0 <= got <= 4.0
    assert r["metrics"]["decode_step_ms.omni"]["value"] > 0
    # stream times need CUDA events: on the CPU the host's readers only
    assert {"encode_ms.large", "step_host_ms.large", "launches_per_step.omni"} <= \
        set(r["metrics"])
    assert set(r["metrics"]) - {"audio_s_per_s.large", "setup_s"} <= _listed()


def test_an_altered_token_is_not_correct(monkeypatch):
    import whisper_ipa_torch.decode.decoding as dec

    real = dec.decode

    def altered(*a, **k):
        out = real(*a, **k)
        for x in out:
            x.tokens[2] = (x.tokens[2] + 1 + 137) % 500
        return out

    monkeypatch.setattr(dec, "decode", altered)
    r = run(monkeypatch)
    assert not r["correct"] and r["checks"]["max_gap"]["value"] > LIMITS["max_gap"]


@pytest.mark.parametrize("fault", ["second_best", "renormalised", "null_expert_computes",
                                   "shared_dropped"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    with calibrate_omni.FAULTS[fault]():
        r = run(monkeypatch)
    assert not r["correct"]


def test_half_the_rows_left_out_is_not_correct(monkeypatch):
    import whisper_ipa_torch.decode.decoding as dec

    real = dec.decode
    monkeypatch.setattr(dec, "decode", lambda *a, **k: real(*a, **k)[::2])
    r = run(monkeypatch)
    assert not r["correct"] and r["failed"] == 2


def test_the_float8_control_is_not_correct():
    d = driver(1)
    d.setup()
    d.window(0.0, False)
    d.release()
    r = d.check(control=True)
    assert all(r[k] <= LIMITS[k] for k in LIMITS)
    assert any(r["control_" + k] > LIMITS[k] for k in LIMITS)


def _probe(p):
    p = torch.tensor(p, dtype=torch.float32)
    return torch.log(p), torch.eye(p.shape[1])


C = SimpleNamespace(top_k=2, top_p=0.7)


@pytest.mark.parametrize("p,taken,forced", [
    ([[0.69, 0.2, 0.05, 0.03, 0.03]], [[0, 5]], 1),   # 0.01 under 0.7: inside eps
    ([[0.65, 0.2, 0.05, 0.05, 0.05]], [[0, 5]], 0),   # 0.05 under: outside
    ([[0.40, 0.30, 0.29, 0.005, 0.005]], [[0, 2]], 1),  # 2nd and 3rd 0.01 apart
    ([[0.40, 0.30, 0.20, 0.05, 0.05]], [[0, 2]], 0),  # 0.1 apart: outside
    ([[0.40, 0.30, 0.29, 0.005, 0.005]], [[1, 0]], 0),  # the same set: nothing to force
])
def test_the_near_tie_rule_forces_only_inside_eps(p, taken, forced):
    from benchmark.harness.omni_judge import EPS
    from benchmark.reference.precision import FP32

    n, gate = _probe(p)
    w, got, slots = ref.route(n, gate, C, FP32, torch.tensor(taken), EPS)
    assert got == forced
    own = ref.route(n, gate, C, FP32)[2]
    want = torch.tensor(taken) if forced else own
    assert sorted(slots[0].tolist()) == sorted(want[0].tolist())
    pp = torch.tensor(p[0] + [0.0])
    assert torch.allclose(w[0], torch.zeros(5).index_add(
        0, slots[0].clamp(max=4), pp[slots[0]] * (slots[0] < 5)))


def _facts(**extra):
    """Fabricated facts of the cell: a 2-layer model of 4 routed experts,
    one traced call with its counter."""
    from whisper_ipa_torch.models.audio_llm import RoutingRecord

    llm = dict(hidden_size=3584, num_hidden_layers=2, num_attention_heads=28,
               num_key_value_heads=4, vocab_size=152064, shared_intermediate_size=2368,
               dynamic_intermediate_size=18944, mlp_fixed_expert_num=2,
               mlp_dynamic_expert_num=4, mlp_dynamic_null_expert_num=1,
               whisper_hidden_size=1280, whisper_query_tokens_size=200)
    # prefill: 100 tokens, 150 non-null picks; decode: 2 steps x 8 rows, every
    # routed expert computed for every row
    pre = [[40, 40, 30, 40, 20, 30, 150, 100]] * 2
    dec = [[5, 5, 5, 5, 4, 0, 64, 16]] * 2
    rec = RoutingRecord(7, pre, dec)
    return dict({"kind": "audio_llm_batch", "batch": 8, "new_tokens": 3, "n_prompt": 50,
                 "llm": llm, "dims": registry.dims(registry.cell("omni.eval-long")["config_file"]),
                 "routing": [rec], "stretch": Stretch(spans=[("decode", 0.0, 1.0)]),
                 "walls": [2.0, 2.0], "device_name": "NVIDIA H100 80GB HBM3",
                 "spans": {"encode": [0.5]}}, **extra)


class _Rec(SimpleNamespace):
    pass


def _spans(names_ms):
    """Program span records (id, call, stream and host ms), as
    ``_program.stretch_spans`` returns them."""
    return {name: [(_Rec(id=i, call=7, stream_ms=ms, host_ms=ms), float(i), float(i) + 1)
                   for i, ms in enumerate(mss)] for name, mss in names_ms.items()}


def test_each_new_reader_reads_fabricated_facts(monkeypatch):
    import benchmark.metrics._omni as om
    import benchmark.metrics._program as prog
    from benchmark.roofline import omni, peaks

    spans = _spans({"llm.prefill": [700.0, 900.0], "llm.connector": [0.5],
                    "llm.prefill.moe": [10.0, 14.0]})
    spans["decode"] = [(_Rec(id=7, call=7, stream_ms=1.0), 0.0, 1000.0)]
    # two layers' MoE spans, each on the host for 100 us, launching kernels
    # of 30 + 50 us that run later on the device; a kernel launched outside
    # them is not the MoE's
    spans["llm.decode.moe"] = [(_Rec(id=8, call=7), 0.0, 100.0),
                               (_Rec(id=9, call=7), 200.0, 300.0)]

    def fake(facts, name):
        return spans.get(name, [])

    monkeypatch.setattr(prog, "stretch_spans", fake)
    monkeypatch.setattr(om, "stretch_spans", fake)
    launches = [(10.0, 400.0, 430.0), (50.0, 430.0, 480.0), (150.0, 480.0, 980.0),
                (210.0, 500.0, 530.0), (250.0, 530.0, 580.0)]
    st = Stretch(device=[("k", s, e) for _, s, e in launches],
                 spans=[("decode", 0.0, 1000.0)])
    facts = _facts(stretch=st, launches=launches)
    rows = registry.metric("expert_rows_per_token.omni").read(facts)
    assert rows == pytest.approx((150 + 64) * 2 / ((100 + 16) * 2))
    b, f = omni.moe_decode_layer(facts["llm"], 8, 4, 20 / 2)
    bound = peaks.bound_s("NVIDIA H100 80GB HBM3", b, f)
    assert registry.metric("moe_roofline.omni").read(facts) == \
        pytest.approx(100.0 * 2 * bound / 160e-6)
    assert 2 * 3 * 3584 * 4 * 18944 < b < 1.1 * 2 * 3 * 3584 * (4 * 18944 + 2 * 2368)
    assert registry.metric("moe_roofline.omni").read(dict(facts, launches=[])) is None
    assert registry.metric("prefill_ms.omni").read(facts) == pytest.approx(800.0)
    assert registry.metric("connector_ms.omni").read(facts) == pytest.approx(0.5)
    assert registry.metric("prefill_moe_ms.omni").read(facts) == pytest.approx(12.0)
    picks = (150 + 20) * 2
    flops = omni.batch_flops(facts["llm"], facts["dims"], 8, 50, 3, picks)
    assert registry.metric("mfu.omni").read(facts) == \
        pytest.approx(100.0 * flops / 2.0 / 989e12)


def _listed(cell="omni.eval-long"):
    """The per-layer metrics ``BENCHMARK.json`` lists for ``cell``."""
    import json

    spec = json.loads((registry.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    return {m["name"] for m in spec["per_layer"] if cell in m["workloads"]}


def test_the_whisper_only_readers_find_nothing_in_the_cells_facts(monkeypatch):
    """The cell reports ``audio_s_per_s.large``, so the registry asks it
    every reader that moves that rate. The shared readers of the tower, the
    loop's steps and the device read its facts; Whisper's decoder readers
    (``mfu.large``, ``k4_roofline.large``, ``cache_init_ms.large``,
    ``decode_step_ms.large``, ``launches_per_step.large``) find nothing, and
    every reading is of a metric listed for the cell."""
    import benchmark.metrics._graph as graph
    import benchmark.metrics._program as prog

    spans = _spans({"llm.init_cache": [0.25], "decode.step": [20.0, 22.0]})
    spans["decode"] = [(_Rec(id=7, call=7, stream_ms=1.0), 0.0, 1000.0)]
    spans["decode.replay"] = spans["decode.step"][1:]
    for mod in (prog, graph):
        monkeypatch.setattr(mod, "stretch_spans", lambda facts, name: spans.get(name, []))
    st = Stretch(device=[("k", 10.0, 20.0), ("k", 30.0, 40.0), ("k", 2000.0, 2010.0)],
                 spans=[("encode", 0.0, 5.0), ("decode", 5.0, 1000.0)])
    facts = _facts(stretch=st, spans={"encode": [0.8], "decode": [3.0]})
    moves = list(registry.e2e(registry.cell("omni.eval-long")))
    assert moves == ["audio_s_per_s.large"]
    got = registry.read_metrics(facts, moves)
    assert set(got) <= _listed()
    whisper_only = {n for n in registry.metric_names() if n.endswith(".large")} - _listed()
    assert whisper_only == {"mfu.large", "k4_roofline.large", "cache_init_ms.large",
                            "decode_step_ms.large", "launches_per_step.large"}
    for name in whisper_only:
        assert registry.metric(name).read(facts) is None, name
    assert got["decode_step_ms.omni"]["value"] == pytest.approx(1e3 * 3.0 / 3)
    assert got["launches_per_step.omni"]["value"] == pytest.approx(2 / 3)
    assert got["encode_ms.large"]["value"] == pytest.approx(800.0)
    assert got["cache_init_ms.omni"]["value"] == pytest.approx(0.25)
    assert got["step_stream_ms.large"]["value"] == pytest.approx(21.0)
    assert got["graph_step_pct.large"]["value"] == pytest.approx(50.0)


def test_the_cells_readers_find_nothing_in_whispers_facts(monkeypatch):
    """``large-v3.eval-long`` reports the same rate, so the registry asks it
    this cell's readers too: on Whisper's facts, spans of the same names
    included, each returns None."""
    import benchmark.metrics._program as prog

    spans = _spans({"llm.init_cache": [0.25], "llm.prefill": [800.0],
                    "llm.connector": [0.5], "llm.prefill.moe": [12.0]})
    spans["decode"] = [(_Rec(id=7, call=7, stream_ms=1.0), 0.0, 1000.0)]
    monkeypatch.setattr(prog, "stretch_spans", lambda facts, name: spans.get(name, []))
    facts = dict(_facts(stretch=Stretch(device=[("k", 10.0, 20.0)],
                                        spans=[("decode", 0.0, 1000.0)]),
                        spans={"encode": [0.8], "decode": [3.0]}),
                 kind="eval_batch", sample_len=3, n_prefix=4)
    ours = [n for n in registry.metric_names() if n.endswith(".omni")]
    assert set(ours) == _listed() - {n for n in registry.metric_names()
                                     if n.endswith(".large")}
    for name in ours:
        assert registry.metric(name).MOVES == "audio_s_per_s.large"
        assert registry.metric(name).read(facts) is None, name

