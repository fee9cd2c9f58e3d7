"""PyTorch port: the inference entry points against the JAX package's, on
the CPU.

Seeded WAVs and a JSON split written here; base weights and a
decoder-only checkpoint saved by the JAX package (so both packages load
the same tensors: random init differs between them). ``evaluate_model``
(``--device cpu``, f32 as the CLIs' default ``DecodingOptions``) gives the
JAX CLI's hypotheses, PER and PFER; ``transcribe_single`` its text;
``evaluate_ipa`` its stdout; ``convert_weights`` round-trips; the HTTP
server over a CPU service answers /healthz, /stats, /transcribe and
/transcribe_stream with ``decode()``'s texts; every unported flag exits
with its message. ``cli.serve --continuous`` answers /transcribe,
/transcribe_stream (one line a token) and /stats as the JAX CLI's handler
over the JAX package's engine does, 503 past ``--max-pending``, and refuses
``--beam-size``, ``--kv-int4`` and ``--tp`` with ``--quant-bits`` with the
JAX CLI's messages; with ``--draft-model tiny``, ``ngram`` and ``medusa
--medusa-tree`` (in f32) the engine speculates and answers with
``decode()``'s tokens. With ``--beam-size``, ``evaluate_model`` gives the JAX
CLI's report and the server ``decode()``'s beam texts; ``cli.transcribe
--json`` prints the JAX CLI's JSON lines. ``error_analysis`` prints and
writes the JAX CLI's report, from saved predictions and from the
checkpoint. ``cli.train_medusa`` writes heads, their snapshot and their
accuracy file, which the JAX package reads; ``cli.distill_draft`` writes a
checkpoint both packages load with the full overlay; ``cli.serve
--draft-model ngram`` (a plain service, as the reference's) and
``--draft-model medusa --medusa-tree`` answer with ``decode()``'s text.
"""

import io
import json
import os
import threading
import urllib.request
from contextlib import redirect_stdout
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whisper_ipa_tpu.config as jax_config
import whisper_ipa_torch.config as port_config
from whisper_ipa_tpu.cli import error_analysis as jax_error_analysis
from whisper_ipa_tpu.cli import evaluate_ipa as jax_evaluate_ipa
from whisper_ipa_tpu.cli import evaluate_model as jax_evaluate_model
from whisper_ipa_tpu.cli import transcribe as jax_transcribe_cli
from whisper_ipa_tpu.cli import transcribe_single as jax_transcribe_single
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.convert import (
    load_safetensors_flat as jax_load_flat,
)
from whisper_ipa_tpu.models.convert import save_safetensors as jax_save
from whisper_ipa_torch.audio import (
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio_bytes,
    pad_or_trim,
    write_wav,
)
from whisper_ipa_torch.cli import (
    convert_weights,
    error_analysis,
    evaluate_ipa,
    evaluate_model,
)
from whisper_ipa_torch.cli import serve as serve_cli
from whisper_ipa_torch.cli import transcribe as transcribe_cli
from whisper_ipa_torch.cli import transcribe_single
from whisper_ipa_torch.decode import decode
from whisper_ipa_torch.ops import log_mel_spectrogram
from whisper_ipa_torch.serve import TranscriptionService

torch.set_num_threads(1)

MODEL = "test-tiny-cli"  # test-tiny with a short text context
IPAS = ["kæt", "bʌtn̩", "ə̥tʃ"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both packages know MODEL; WAVs, a split, base weights and a
    decoder-only checkpoint on disk."""
    mp = pytest.MonkeyPatch()
    for mod in (jax_config, port_config):
        mp.setitem(mod.CONFIGS, MODEL, replace(
            mod.CONFIGS["test-tiny"], name=MODEL, n_text_ctx=48))
    root = str(tmp_path_factory.mktemp("cli"))
    rng = np.random.default_rng(0)
    entries = []
    for i, ipa in enumerate(IPAS):
        t = np.arange(int((1.0 + 0.5 * i) * SAMPLE_RATE)) / SAMPLE_RATE
        audio = (0.3 * np.sin(2 * np.pi * (180.0 + 60.0 * i) * t)
                 + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        path = os.path.join(root, f"utt{i}.wav")
        write_wav(path, audio)
        entries.append({"audio_path": path, "ipa_transcription": ipa,
                        "speaker_id": f"spk{i}"})
    split = os.path.join(root, "test.json")
    with open(split, "w") as f:
        json.dump(entries, f, ensure_ascii=False)
    cfg = jax_config.CONFIGS[MODEL]
    weights = os.path.join(root, "base.safetensors")
    jax_save(weights, jax_init_params(cfg, seed=0))
    run = os.path.join(root, "run")
    ckpt = os.path.join(run, "checkpoint-5")
    os.makedirs(ckpt)
    # a decoder whose text-token embeddings are 0 except the 256 byte
    # tokens: its greedy output is byte tokens, which the byte-fallback
    # vocabulary decodes to text (random text ids would decode to nothing)
    trained = jax_init_params(cfg, seed=2)
    emb = np.array(trained["decoder"]["token_embedding"])
    emb[256:50257] = 0.0
    trained["decoder"]["token_embedding"] = jnp.asarray(emb)
    jax_save(os.path.join(ckpt, "model.safetensors"), trained)
    with open(os.path.join(run, "training_config.json"), "w") as f:
        json.dump({"training_args": {"freeze_encoder": True}}, f)
    yield dict(root=root, split=split, weights=weights, ckpt=ckpt,
               wavs=[e["audio_path"] for e in entries])
    mp.undo()


def _stdout(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = fn(argv)
    return buf.getvalue(), result


def _report(text):
    """The lines of an evaluation report that carry results."""
    keep = ("Loaded", "Reference:", "Hypothesis:", "PER:", "PFER:", "Samples:")
    return [ln.strip() for ln in text.splitlines() if ln.strip().startswith(keep)]


def test_evaluate_model_matches_jax(setup):
    argv = ["--skip-base", "--base-model", MODEL, "--weights", setup["weights"],
            "--checkpoint", setup["ckpt"], "--test-data", setup["split"],
            "--num-samples", "0", "--batch-size", "2"]
    jax_out, _ = _stdout(jax_evaluate_model.main, argv)
    assert "Error transcribing" not in jax_out
    out, results = _stdout(evaluate_model.main, argv + ["--device", "cpu"])
    assert _report(out) == _report(jax_out)
    n_dec = sum(k.startswith("decoder.") for k in jax_flatten_params(
        jax_init_params(jax_config.CONFIGS[MODEL], seed=0)))
    assert f"Loaded {n_dec} tensors from {setup['ckpt']}" in out
    assert len(results["hypotheses"]) == len(IPAS)
    assert all(results["hypotheses"])
    hyps = [ln.split("Hypothesis:")[1].strip() for ln in jax_out.splitlines()
            if "Hypothesis:" in ln]
    assert results["hypotheses"] == hyps


def test_evaluate_model_beam_matches_jax(setup):
    """--beam-size 3: the JAX CLI's hypotheses, PER and PFER."""
    argv = ["--skip-base", "--base-model", MODEL, "--weights", setup["weights"],
            "--checkpoint", setup["ckpt"], "--test-data", setup["split"],
            "--num-samples", "0", "--batch-size", "2", "--beam-size", "3"]
    jax_out, _ = _stdout(jax_evaluate_model.main, argv)
    assert "Error transcribing" not in jax_out
    out, results = _stdout(evaluate_model.main, argv + ["--device", "cpu"])
    assert _report(out) == _report(jax_out)
    assert len(results["hypotheses"]) == len(IPAS) and all(results["hypotheses"])


def test_transcribe_cli_matches_jax(setup):
    """cli.transcribe --json prints the JAX CLI's lines, one a file (a 70 s
    file: three windows)."""
    long_path = os.path.join(setup["root"], "long70.wav")
    rng = np.random.default_rng(5)
    t = np.arange(70 * SAMPLE_RATE) / SAMPLE_RATE
    write_wav(long_path, (0.3 * np.sin(2 * np.pi * 200.0 * t)
                          + 0.05 * rng.standard_normal(t.shape)).astype(np.float32))
    argv = ["--model", MODEL, "--weights", setup["weights"], "--checkpoint",
            setup["ckpt"], "--json", setup["wavs"][0], long_path]
    jax_out, _ = _stdout(jax_transcribe_cli.main, argv)
    out, _ = _stdout(transcribe_cli.main, argv + ["--device", "cpu"])
    want = [json.loads(ln) for ln in jax_out.splitlines() if ln.startswith("{")]
    got = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(got) == len(want) == 2
    assert [len(g["segments"]) for g in got] == [1, 3]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["text"] == w["text"] and g["text"]
        for a, b in zip(g["segments"], w["segments"]):
            assert a.keys() == b.keys()
            for k in a:
                if isinstance(a[k], float):
                    assert a[k] == pytest.approx(b[k], abs=1e-4), k
                else:
                    assert a[k] == b[k], k


def test_transcribe_single_matches_jax(setup):
    argv = ["--base-model", MODEL, "--weights", setup["weights"],
            "--checkpoint", setup["ckpt"], "--audio", setup["wavs"][1]]
    jax_out, _ = _stdout(jax_transcribe_single.main, argv)
    out, text = _stdout(transcribe_single.main, argv + ["--device", "cpu"])
    want = [ln for ln in jax_out.splitlines() if ln.startswith("Prediction:")]
    assert text and want == [f"Prediction: {text}"]
    assert [ln for ln in out.splitlines() if ln.startswith("Prediction:")] == want


def test_evaluate_ipa_matches_jax():
    jax_out, _ = _stdout(jax_evaluate_ipa.main, None)
    out, _ = _stdout(evaluate_ipa.main, None)
    assert out == jax_out
    assert "All tests passed!" in out


@pytest.mark.parametrize("layout", ["mlx", "hf"])
def test_convert_weights_roundtrip(setup, tmp_path, layout):
    from safetensors.numpy import save_file

    from tests.test_checkpoint_fixtures import to_hf_flat

    src = jax_init_params(jax_config.CONFIGS[MODEL], seed=2)
    inp = str(tmp_path / "in.safetensors")
    if layout == "hf":
        save_file(to_hf_flat(src), inp)
    else:
        jax_save(inp, src)
    dst = str(tmp_path / "out.safetensors")
    out, _ = _stdout(convert_weights.main,
                     ["--input", inp, "--model", MODEL, "--output", dst,
                      "--verify"])
    assert f"Detected source format: {layout}" in out
    assert "Verification passed" in out
    from whisper_ipa_tpu.models.convert import params_from_flat

    got = jax_flatten_params(params_from_flat(jax_load_flat(dst)))
    want = jax_flatten_params(src)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _wav_bytes(audio: np.ndarray) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, audio)
    return buf.getvalue()


def _expected_texts(service, windows):
    """decode() over one fixed batch of these windows, silence-padded as
    the service pads it."""
    group = [pad_or_trim(w) for w in windows]
    group += [np.zeros(N_SAMPLES, np.float32)] * (service.batch_size - len(group))
    with torch.inference_mode():
        mel = log_mel_spectrogram(torch.from_numpy(np.stack(group)),
                                  n_mels=service.cfg.n_mels)
    res = decode(service.params, service.cfg, mel, service.options,
                 tokenizer=service.tokenizer)
    return [r.text for r in res[:len(windows)]]


def test_http_server(setup):
    server, service = serve_cli.build_server(
        ["--model", MODEL, "--weights", setup["weights"], "--checkpoint",
         setup["ckpt"], "--device", "cpu", "--port", "0", "--batch-size", "2",
         "--max-wait-ms", "10"])
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}

        rng = np.random.default_rng(7)
        clip = (0.1 * rng.standard_normal(2 * SAMPLE_RATE)).astype(np.float32)
        body = _wav_bytes(clip)
        req = urllib.request.Request(f"{url}/transcribe", data=body,
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=300) as r:
            by_body = json.loads(r.read())
        from whisper_ipa_torch.audio import load_audio_bytes

        decoded = load_audio_bytes(body)
        assert by_body["text"] == _expected_texts(service, [decoded])[0]

        req = urllib.request.Request(
            f"{url}/transcribe", data=json.dumps({"path": setup["wavs"][0]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            by_path = json.loads(r.read())
        from whisper_ipa_torch.audio import load_audio

        assert by_path["text"] and by_path["text"] == _expected_texts(
            service, [load_audio(setup["wavs"][0])])[0]

        long_clip = (0.1 * rng.standard_normal(40 * SAMPLE_RATE)).astype(np.float32)
        body = _wav_bytes(long_clip)
        req = urllib.request.Request(f"{url}/transcribe_stream", data=body,
                                     headers={"Content-Type": "audio/wav"})
        lines = []
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            for raw in r:
                if raw.strip():
                    lines.append(json.loads(raw))
        assert [next(iter(ln)) for ln in lines] == ["partial", "partial", "final"]
        decoded = load_audio_bytes(body)
        want = _expected_texts(service, [decoded[:N_SAMPLES], decoded[N_SAMPLES:]])
        assert [ln["partial"]["text"] for ln in lines[:2]] == want
        assert lines[2]["final"]["text"] == "".join(want)
        assert [s["text"] for s in lines[2]["final"]["segments"]] == want

        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats == {"requests": 3, "batches": 3, "windows": 4}

        req = urllib.request.Request(f"{url}/transcribe", data=b"not a wav",
                                     headers={"Content-Type": "audio/wav"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 500
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    assert not thread.is_alive() and not service._thread.is_alive()


def test_http_server_beam(setup):
    """cli.serve --beam-size 2 answers a request with decode()'s beam text."""
    server, service = serve_cli.build_server(
        ["--model", MODEL, "--weights", setup["weights"], "--checkpoint",
         setup["ckpt"], "--device", "cpu", "--port", "0", "--batch-size", "2",
         "--max-wait-ms", "10", "--beam-size", "2"])
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"{url}/transcribe",
            data=json.dumps({"path": setup["wavs"][2]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    from whisper_ipa_torch.audio import load_audio

    assert service.options.beam_size == 2
    assert got["text"] and got["text"] == _expected_texts(
        service, [load_audio(setup["wavs"][2])])[0]


def _serve_in_thread(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}", thread


def _post(url, body):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return [json.loads(ln) for ln in r.read().splitlines() if ln.strip()]


ENGINE_ARGV = ["--continuous", "--batch-size", "2", "--max-new-tokens", "8",
               "--steps-per-sync", "2"]


def test_http_server_continuous(setup):
    """cli.serve --continuous against the JAX CLI's handler over the JAX
    package's engine built as its --continuous branch builds it (bf16, the
    int8 cross cache), on the same weights and WAVs: the same /transcribe
    tokens and keys, one /transcribe_stream line a token then the final
    result, the same /stats counts."""
    from whisper_ipa_tpu.cli import serve as jax_serve_cli
    from whisper_ipa_tpu.models import load_checkpoint_auto as jax_load_ckpt
    from whisper_ipa_tpu.serve_continuous import ContinuousBatcher as JaxEngine
    from whisper_ipa_tpu.train.loop import load_or_init_params as jax_load

    from http.server import ThreadingHTTPServer

    server, service = serve_cli.build_server(
        ["--model", MODEL, "--weights", setup["weights"], "--checkpoint",
         setup["ckpt"], "--device", "cpu", "--port", "0"] + ENGINE_ARGV)
    jcfg = jax_config.CONFIGS[MODEL]
    jparams, _ = jax_load_ckpt(setup["ckpt"],
                               jax_load(MODEL, jcfg, setup["weights"]))
    jengine = JaxEngine(jparams, jcfg, slots=2, max_new_tokens=8,
                        steps_per_sync=2, language="en", bf16=True,
                        kv_int8=True)
    jserver = ThreadingHTTPServer(("127.0.0.1", 0),
                                  jax_serve_cli.make_handler(jengine))
    url, thread = _serve_in_thread(server)
    jurl, jthread = _serve_in_thread(jserver)
    try:
        rng = np.random.default_rng(9)
        short = _wav_bytes((0.1 * rng.standard_normal(2 * SAMPLE_RATE)).astype(
            np.float32))
        long_ = _wav_bytes((0.1 * rng.standard_normal(40 * SAMPLE_RATE)).astype(
            np.float32))
        got, want = (_post(f"{u}/transcribe", short)[0] for u in (url, jurl))
        assert got.keys() == want.keys()
        same = ("text", "tokens", "n_windows", "truncated", "timed_out")
        assert {k: got[k] for k in same} == {k: want[k] for k in same}
        assert got["tokens"]  # the checkpoint decodes byte tokens

        lines, jlines = (_post(f"{u}/transcribe_stream", long_)
                         for u in (url, jurl))
        assert [next(iter(ln)) for ln in lines] == (
            ["partial"] * (len(lines) - 1) + ["final"])
        final = lines[-1]["final"]
        assert final["n_windows"] == 2
        assert [ln["partial"]["token"] for ln in lines[:-1]] == final["tokens"]
        assert [ln["partial"] for ln in lines[:-1]] == [
            ln["partial"] for ln in jlines[:-1]]
        assert {k: final[k] for k in same} == {
            k: jlines[-1]["final"][k] for k in same}

        stats = [json.loads(urllib.request.urlopen(f"{u}/stats",
                                                   timeout=30).read())
                 for u in (url, jurl)]
        assert set(stats[1]) <= set(stats[0])
        counts = ("requests", "joins", "rejected", "cancelled", "timed_out",
                  "pending", "active_slots")
        assert {k: stats[0][k] for k in counts} == {k: stats[1][k] for k in counts}
        assert stats[0]["requests"] == 2 and stats[0]["joins"] == 3
        # the engine called directly answers as over HTTP
        assert service.transcribe(load_audio_bytes(short),
                                  timeout=300)["tokens"] == got["tokens"]
    finally:
        for srv in (server, jserver):
            srv.shutdown()
            srv.server_close()
        service.close()
        jengine.close()
        thread.join(timeout=30)
        jthread.join(timeout=30)
    assert not service._thread.is_alive()


def test_http_continuous_backpressure(setup):
    """Past --max-pending the engine refuses and the server answers 503,
    on both routes, and serves on."""
    server, service = serve_cli.build_server(
        ["--model", MODEL, "--weights", setup["weights"], "--device", "cpu",
         "--port", "0", "--max-pending", "0"] + ENGINE_ARGV)
    url, thread = _serve_in_thread(server)
    body = _wav_bytes(np.zeros(SAMPLE_RATE, np.float32))
    try:
        for route in ("/transcribe", "/transcribe_stream"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url + route, body)
            assert err.value.code == 503
            assert "max_pending=0" in json.loads(err.value.read())["error"]
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        assert service.stats()["rejected"] == 2
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)


@pytest.mark.parametrize("argv", [
    ["--beam-size", "2"],
    ["--kv-int4"],
    ["--tp", "2", "--quant-bits", "8"],
])
def test_serve_continuous_refusals_match_jax(setup, argv):
    """The engine's refused combinations exit with the JAX CLI's messages."""
    from whisper_ipa_tpu.cli import serve as jax_serve_cli

    base = ["--model", MODEL, "--weights", setup["weights"], "--continuous"]
    with pytest.raises(SystemExit) as want:
        jax_serve_cli.main(base + argv)
    with pytest.raises(SystemExit) as got:
        serve_cli.build_server(base + argv + ["--device", "cpu"])
    assert str(got.value.code) == str(want.value.code)
    assert "--continuous" in str(got.value.code)


@pytest.mark.parametrize("argv,item", [
    (["--continuous", "--dp", "2"], "item 18"),
    (["--continuous", "--tp", "2"], "item 18"),
    (["--continuous", "--draft-model", "ngram", "--tp", "2"], "item 18"),
])
def test_serve_unported_flags_exit(argv, item):
    with pytest.raises(SystemExit) as e:
        serve_cli.build_server(argv + ["--device", "cpu"])
    assert f"ROADMAP queue 1 {item}" in str(e.value.code)


# the reference's engine and speculative-decoding options, with what the
# reference's parser makes of them
ENGINE_FLAGS = [
    (["--draft-weights", "d.safetensors"], "draft_weights", "d.safetensors",
     "item 10"),
    (["--draft-checkpoint", "run/checkpoint-9"], "draft_checkpoint",
     "run/checkpoint-9", "item 10"),
    (["--draft-k", "6"], "draft_k", 6, "item 10"),
    (["--max-new-tokens", "64"], "max_new_tokens", 64, "item 9"),
    (["--steps-per-sync", "8"], "steps_per_sync", 8, "item 9"),
    (["--adaptive-sync"], "adaptive_sync", True, "item 9"),
    (["--no-join-fast-sync"], "join_fast_sync", False, "item 9"),
    (["--max-pending", "32"], "max_pending", 32, "item 9"),
]


@pytest.mark.parametrize("mode", ["tiny", "ngram", "medusa-tree"])
def test_http_continuous_speculative(setup, tmp_path, mode, monkeypatch):
    """cli.serve --continuous --draft-model tiny (a random whisper-tiny
    draft), ngram, and medusa with a heads file, its accuracy file and
    --medusa-tree: the engine speculates, and /transcribe and
    /transcribe_stream answer with decode()'s tokens and text. The engine
    runs in f32 here, where speculation gives greedy decoding's tokens
    exactly (in bf16 a verification block may leave it at a near-tie,
    which the card's smoke test bounds)."""
    from whisper_ipa_torch.audio import load_audio
    from whisper_ipa_torch.cli.train_medusa import write_accuracy
    from whisper_ipa_torch.decode import DecodingOptions
    from whisper_ipa_torch.decode.medusa_tree import optimize_tree
    from whisper_ipa_torch.models.medusa import init_medusa_params, save_medusa

    engine = serve_cli.ContinuousBatcher
    monkeypatch.setattr(serve_cli, "ContinuousBatcher",
                        lambda *a, **kw: engine(*a, **(kw | {"bf16": False})))
    argv = ["--model", MODEL, "--weights", setup["weights"], "--checkpoint",
            setup["ckpt"], "--device", "cpu", "--port", "0", "--draft-k", "3",
            "--warmup"] + ENGINE_ARGV
    probs = [[0.6, 0.2, 0.1, 0.05], [0.4, 0.2, 0.1, 0.0], [0.3, 0.1, 0.0, 0.0]]
    if mode == "medusa-tree":
        heads = str(tmp_path / "heads.safetensors")
        save_medusa(heads, init_medusa_params(port_config.CONFIGS[MODEL], 3, seed=4))
        write_accuracy(heads, probs)
        argv += ["--draft-model", "medusa", "--medusa-weights", heads,
                 "--medusa-tree"]
    else:
        argv += ["--draft-model", mode]
    server, service = serve_cli.build_server(argv)
    url, thread = _serve_in_thread(server)
    try:
        got = _post(f"{url}/transcribe", _wav_bytes(
            load_audio(setup["wavs"][1])))[0]
        lines = _post(f"{url}/transcribe_stream", _wav_bytes(
            load_audio(setup["wavs"][2])))
        stats = service.stats()
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    assert not thread.is_alive() and not service._thread.is_alive()
    tree = optimize_tree(probs, 12)
    assert service.draft_k == {"medusa-tree": max(3, len(probs) + 2)}.get(mode, 3)
    assert (service.draft_cfg is not None) == (mode == "tiny")
    assert service.medusa_tree == (tree if mode == "medusa-tree" else None)
    assert stats["spec_rounds"] > 0 and stats["requests"] == 3  # and --warmup
    options = DecodingOptions(language="en", without_timestamps=True,
                              sample_len=8, kv_int8=True)
    want = []
    for wav in setup["wavs"][1:]:
        with torch.inference_mode():
            mel = log_mel_spectrogram(torch.from_numpy(pad_or_trim(
                load_audio(wav))), n_mels=service.cfg.n_mels)[None]
        want.append(decode(service.params, service.cfg, mel, options,
                           tokenizer=service.tokenizer)[0])
    final = lines[-1]["final"]
    assert got["tokens"] and got["tokens"] == want[0].tokens
    assert got["text"] == want[0].text
    assert final["tokens"] == want[1].tokens and final["text"] == want[1].text
    assert [ln["partial"]["token"] for ln in lines[:-1]] == final["tokens"]


@pytest.mark.parametrize("argv,dest,value,item", ENGINE_FLAGS)
def test_serve_engine_flags_parse(argv, dest, value, item, monkeypatch):
    """Each flag parses with the reference's type and default and is inert
    alone. With --draft-model (item 10, ported) the value reaches the draft
    model's loaders and the service; with --continuous (item 9, ported) it
    reaches the engine."""
    defaults = dict(draft_weights=None, draft_checkpoint=None, draft_k=4,
                    max_new_tokens=128, steps_per_sync=4, adaptive_sync=False,
                    join_fast_sync=True, max_pending=None)
    args = serve_cli.build_parser().parse_args(argv)
    assert {k: getattr(args, k) for k in defaults} == defaults | {dest: value}
    serve_cli._refuse_unported(args)  # alone: accepted
    if item == "item 10":
        seen = {}
        load = serve_cli.load_or_init_params

        def load_or_init(name, cfg, weights, device=None):
            seen["draft_weights"] = weights  # the draft model loads last
            return load(name, cfg, None, device=device)

        def load_ckpt(path, base, full=None):
            seen["draft_checkpoint"] = path
            return base, 0

        class Service:
            def __init__(self, params, cfg, **kw):
                seen["draft_k"] = kw["draft_k"]
                assert kw["draft_cfg"].name == "test-tiny"

            def close(self):
                pass

        monkeypatch.setattr(serve_cli, "load_or_init_params", load_or_init)
        monkeypatch.setattr(serve_cli, "load_checkpoint_auto", load_ckpt)
        monkeypatch.setattr(serve_cli, "TranscriptionService", Service)
        server, _ = serve_cli.build_server(
            argv + ["--draft-model", "test-tiny", "--model", "test-tiny",
                    "--port", "0", "--device", "cpu"])
        server.server_close()
        assert seen[dest] == value
        return
    seen = {}

    class Engine:
        def __init__(self, params, cfg, **kw):
            seen.update(kw)

        def close(self):
            pass

    monkeypatch.setattr(serve_cli, "ContinuousBatcher", Engine)
    server, _ = serve_cli.build_server(
        argv + ["--continuous", "--model", "test-tiny", "--port", "0",
                "--device", "cpu"])
    server.server_close()
    assert seen[dest] == value


def test_evaluate_positional_order_and_one_device_data_parallel(setup):
    """``data_parallel`` is the 8th parameter, as in the reference: a call
    in the reference's positional order (..., "en", False) decodes
    greedily (it once bound False to ``beam_size``, a beam of width 0),
    with the JAX call's PER/PFER; True on one process runs the
    single-device path, and so does ``--data-parallel``."""
    from whisper_ipa_tpu.models.convert import load_checkpoint_auto as jax_load
    from whisper_ipa_torch.models import load_checkpoint_auto
    from whisper_ipa_torch.train.loop import load_or_init_params

    cfg = port_config.CONFIGS[MODEL]
    base = load_or_init_params(MODEL, cfg, setup["weights"], device="cpu")
    params, _ = load_checkpoint_auto(setup["ckpt"], base, False)
    greedy = evaluate_model.evaluate_model(params, cfg, setup["split"], None,
                                           "M", 2, language="en")
    positional = evaluate_model.evaluate_model(params, cfg, setup["split"],
                                               None, "M", 2, "en", False)
    assert positional["hypotheses"] == greedy["hypotheses"]
    assert all(greedy["hypotheses"])
    dp = evaluate_model.evaluate_model(params, cfg, setup["split"], None, "M",
                                       2, "en", True)
    assert dp["hypotheses"] == greedy["hypotheses"]
    jcfg = jax_config.CONFIGS[MODEL]
    jparams, _ = jax_load(setup["ckpt"], jax_init_params(jcfg, seed=0), False)
    want = jax_evaluate_model.evaluate_model(jparams, jcfg, setup["split"],
                                             None, "M", 2, "en", False)
    assert positional["per"] == pytest.approx(want["per"], abs=1e-9)
    assert positional["pfer"] == pytest.approx(want["pfer"], abs=1e-9)
    argv = ["--skip-base", "--base-model", MODEL, "--weights", setup["weights"],
            "--checkpoint", setup["ckpt"], "--test-data", setup["split"],
            "--num-samples", "0", "--batch-size", "2", "--device", "cpu"]
    _, flagged = _stdout(evaluate_model.main, argv + ["--data-parallel"])
    assert flagged["hypotheses"] == greedy["hypotheses"]


@pytest.mark.parametrize("argv", [["--dp", "2"], ["--tp", "2"],
                                  ["--dp", "2", "--tp", "2"]])
def test_serve_mesh_needs_the_world(argv):
    """--dp x --tp must equal the torchrun world (1 here)."""
    with pytest.raises(SystemExit) as e:
        serve_cli.build_server(argv + ["--model", "test-tiny", "--device",
                                       "cpu"])
    assert "must equal the number of processes (1)" in str(e.value.code)


def test_cuda_is_the_default_device():
    """Without a card, the service and the model CLIs refuse the default
    device instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.models import init_params

    with pytest.raises(RuntimeError, match="is_available"):
        TranscriptionService(init_params(CONFIGS["test-tiny"], seed=0),
                             CONFIGS["test-tiny"])
    for main in (evaluate_model.main, transcribe_single.main):
        with pytest.raises(RuntimeError, match="is_available"):
            main(["--base-model", "test-tiny"])


ANALYSIS_PAIRS = [
    {"reference": "kæt", "hypothesis": "kɛt"},
    {"reference": "mus", "hypothesis": "muːst"},
    {"reference": "tasa", "hypothesis": "ta"},
    {"reference": "", "hypothesis": ""},
    {"reference": "ami", "hypothesis": ""},
    {"reference": "ðɪs ɪz", "hypothesis": "dɪs iz"},
]


def _analysis(fn, argv, out_path):
    """(stdout without the report path, the report JSON written)."""
    text, _ = _stdout(fn, argv + ["--output", out_path])
    with open(out_path, encoding="utf-8") as f:
        written = json.load(f)
    return text.replace(out_path, "<out>"), written


def test_error_analysis_predictions_matches_jax(tmp_path):
    preds = str(tmp_path / "preds.json")
    with open(preds, "w", encoding="utf-8") as f:
        json.dump(ANALYSIS_PAIRS, f, ensure_ascii=False)
    argv = ["--predictions", preds]
    jax_text, jax_report = _analysis(jax_error_analysis.main, argv,
                                     str(tmp_path / "jax.json"))
    text, report = _analysis(error_analysis.main, argv,
                             str(tmp_path / "port.json"))
    assert text == jax_text and "Top substitutions" in text
    assert report == jax_report and report["num_pairs"] == len(ANALYSIS_PAIRS)


def test_error_analysis_checkpoint_matches_jax(setup, tmp_path):
    argv = ["--checkpoint", setup["ckpt"], "--test-data", setup["split"],
            "--base-model", MODEL, "--weights", setup["weights"],
            "--batch-size", "2"]
    jax_text, jax_report = _analysis(jax_error_analysis.main, argv,
                                     str(tmp_path / "jax.json"))
    text, report = _analysis(error_analysis.main, argv + ["--device", "cpu"],
                             str(tmp_path / "port.json"))
    assert text == jax_text
    assert report == jax_report and report["num_pairs"] == len(IPAS)
    # the decoder emits text, so the report is not all deletions
    assert report["phone_accuracy"] < 1.0 and report["per"]["worst"] > 0


def test_error_analysis_cuda_is_the_default_device(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="is_available"):
        error_analysis.main(["--base-model", MODEL, "--test-data",
                             setup["split"]])


# -- speculative decoding: the two trainers and the server ---------------------

def test_train_medusa_cli(setup, tmp_path):
    """cli.train_medusa on the checkpoint: the heads, the .partial snapshot
    and the accuracy file, which both packages read; --measure-only writes
    the file again for the saved heads."""
    from whisper_ipa_tpu.decode.medusa_tree import tree_for_heads as jax_tree
    from whisper_ipa_tpu.models.medusa import load_medusa as jax_load_medusa
    from whisper_ipa_torch.cli import train_medusa
    from whisper_ipa_torch.decode.medusa_tree import tree_for_heads
    from whisper_ipa_torch.models.medusa import load_medusa

    out = str(tmp_path / "heads.safetensors")
    argv = ["--model", MODEL, "--weights", setup["weights"], "--checkpoint",
            setup["ckpt"], "--train-data", setup["split"], "--batch-size", "2",
            "--n-heads", "2", "--output", out, "--device", "cpu"]
    text, probs = _stdout(train_medusa.main, argv + [
        "--steps", "3", "--log-every", "1", "--save-every", "2",
        "--steps-per-call", "4"])
    assert "step 3/3: head loss" in text and "Loaded" in text
    assert os.path.isfile(out + ".partial")
    heads, theirs = load_medusa(out), jax_load_medusa(out)
    assert len(heads["heads"]) == len(theirs["heads"]) == 2
    for h, t in zip(heads["heads"], theirs["heads"]):
        for k in ("w1", "b1", "w2", "b2"):
            assert np.array_equal(h[k].numpy(), np.asarray(t[k]))
    assert not torch.equal(heads["heads"][0]["w2"], torch.zeros_like(
        heads["heads"][0]["w2"]))  # trained
    with open(out + ".accuracy.json") as f:
        side = json.load(f)
    assert side["top_c"] == 4 and np.shape(side["head_topk_accuracy"]) == (2, 4)
    assert side["head_topk_accuracy"] == probs
    assert all(0.0 <= p <= 1.0 for row in probs for p in row)
    assert tree_for_heads(out) == jax_tree(out)
    _, again = _stdout(train_medusa.main, argv + ["--measure-only"])
    assert again == probs


def test_distill_draft_cli(setup, tmp_path):
    """cli.distill_draft: a test-tiny student from the checkpoint's
    teacher; the checkpoint loads in both packages, with the full overlay
    (the run records freeze_encoder: false)."""
    from whisper_ipa_tpu.models.convert import (
        checkpoint_overlay_mode as jax_overlay_mode,
    )
    from whisper_ipa_tpu.models.convert import (
        load_checkpoint_model as jax_load_checkpoint,
    )
    from whisper_ipa_torch.cli import distill_draft
    from whisper_ipa_torch.models import (
        checkpoint_overlay_mode,
        init_params,
        load_checkpoint_auto,
        params_to_numpy,
    )

    out = str(tmp_path / "draft")
    text, path = _stdout(distill_draft.main, [
        "--student", MODEL, "--teacher", MODEL, "--teacher-checkpoint",
        setup["ckpt"], "--train-data", setup["split"], "--output-dir", out,
        "--steps", "2", "--batch-size", "2", "--token-len", "16",
        "--save-every", "0", "--log-every", "1", "--steps-per-call", "2",
        "--device", "cpu"])
    assert "step 2/2: distill loss" in text
    assert path == os.path.join(out, "checkpoint-2")
    assert checkpoint_overlay_mode(path) is True and jax_overlay_mode(path) is True
    cfg = port_config.CONFIGS[MODEL]
    ours, n = load_checkpoint_auto(path, init_params(cfg, seed=3))
    theirs, m = jax_load_checkpoint(path, jax_init_params(
        jax_config.CONFIGS[MODEL], seed=3), full=True)
    assert n == m == len(params_to_numpy(ours))
    theirs = {k: np.asarray(v) for k, v in jax_flatten_params(theirs).items()}
    for k, v in params_to_numpy(ours).items():
        assert np.array_equal(v, theirs[k]), k


@pytest.mark.parametrize("mode", ["ngram", "medusa-tree"])
def test_http_server_speculative(setup, tmp_path, mode, monkeypatch):
    """cli.serve --draft-model ngram, and --draft-model medusa with a heads
    file, its accuracy file and --medusa-tree: /transcribe answers with
    decode()'s text on the same batch. n-gram drafts serve only in the
    in-flight engine, so under ngram the service decodes plainly (bf16, as
    the reference's). The Medusa service runs in f32 here, where
    speculation gives greedy decoding's tokens exactly (in bf16 a block
    verification may leave it at a near-tie, which the card's smoke test
    bounds)."""
    import functools

    if mode != "ngram":
        monkeypatch.setattr(serve_cli, "TranscriptionService",
                            functools.partial(TranscriptionService, bf16=False))
    from whisper_ipa_torch.cli.train_medusa import write_accuracy
    from whisper_ipa_torch.decode.medusa_tree import DEFAULT_TREE, optimize_tree
    from whisper_ipa_torch.models.medusa import init_medusa_params, save_medusa

    argv = ["--model", MODEL, "--weights", setup["weights"], "--checkpoint",
            setup["ckpt"], "--device", "cpu", "--port", "0", "--batch-size",
            "2", "--max-wait-ms", "10", "--draft-k", "3"]
    probs = [[0.6, 0.2, 0.1, 0.05], [0.4, 0.2, 0.1, 0.0], [0.3, 0.1, 0.0, 0.0]]
    if mode == "ngram":
        argv += ["--draft-model", "ngram"]
    else:
        heads = str(tmp_path / "heads.safetensors")
        save_medusa(heads, init_medusa_params(port_config.CONFIGS[MODEL], 3, seed=4))
        write_accuracy(heads, probs)
        argv += ["--draft-model", "medusa", "--medusa-weights", heads,
                 "--medusa-tree"]
    server, service = serve_cli.build_server(argv)
    url, thread = _serve_in_thread(server)
    try:
        req = urllib.request.Request(
            f"{url}/transcribe",
            data=json.dumps({"path": setup["wavs"][1]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    from whisper_ipa_torch.audio import load_audio

    if mode == "ngram":
        assert service.options.fp16 and service.draft_k == 3
        assert (service.draft_params, service.medusa_params,
                service.medusa_tree) == (None, None, None)
    else:
        assert service.medusa_tree == optimize_tree(probs, 12) != DEFAULT_TREE
    assert got["text"] and got["text"] == _expected_texts(
        service, [load_audio(setup["wavs"][1])])[0]


@pytest.mark.parametrize("argv,message", [
    (["--medusa-tree"], "--medusa-tree requires --draft-model medusa"),
    (["--draft-model", "ngram", "--medusa-tree"],
     "--medusa-tree requires --draft-model medusa"),
])
def test_serve_medusa_tree_needs_medusa(argv, message):
    with pytest.raises(SystemExit) as e:
        serve_cli.build_server(argv + ["--device", "cpu"])
    assert str(e.value.code) == message


def test_serve_untrained_heads_warn(capsys, monkeypatch):
    """--draft-model medusa without --medusa-weights serves --draft-k
    untrained heads and says so."""
    seen = {}

    class Service:
        def __init__(self, params, cfg, **kw):
            seen.update(kw)

        def close(self):
            pass

    monkeypatch.setattr(serve_cli, "TranscriptionService", Service)
    server, _ = serve_cli.build_server(
        ["--model", "test-tiny", "--draft-model", "medusa", "--draft-k", "3",
         "--port", "0", "--device", "cpu"])
    server.server_close()
    assert "WARNING: untrained Medusa heads" in capsys.readouterr().out
    assert len(seen["medusa_params"]["heads"]) == 3
    assert seen["medusa_tree"] is None and seen["draft_params"] is None
