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
with its message.
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
from whisper_ipa_tpu.cli import evaluate_ipa as jax_evaluate_ipa
from whisper_ipa_tpu.cli import evaluate_model as jax_evaluate_model
from whisper_ipa_tpu.cli import transcribe_single as jax_transcribe_single
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.convert import (
    load_safetensors_flat as jax_load_flat,
)
from whisper_ipa_tpu.models.convert import save_safetensors as jax_save
from whisper_ipa_torch.audio import N_SAMPLES, SAMPLE_RATE, pad_or_trim, write_wav
from whisper_ipa_torch.cli import convert_weights, evaluate_ipa, evaluate_model
from whisper_ipa_torch.cli import serve as serve_cli
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


@pytest.mark.parametrize("argv,item", [
    (["--continuous"], "item 9"),
    (["--draft-model", "tiny"], "item 10"),
    (["--medusa-tree"], "item 10"),
    (["--medusa-weights", "heads.safetensors"], "item 10"),
    (["--dp", "2"], "item 12"),
    (["--tp", "2"], "item 12"),
    (["--beam-size", "5"], "item 6"),
])
def test_serve_unported_flags_exit(argv, item):
    with pytest.raises(SystemExit) as e:
        serve_cli.build_server(argv + ["--device", "cpu"])
    assert f"ROADMAP queue 1 {item}" in str(e.value.code)


# the reference's engine and speculative-decoding options, with what the
# reference's parser makes of them
ENGINE_FLAGS = [
    (["--draft-weights", "d.safetensors"], "draft_weights", "d.safetensors", "item 10"),
    (["--draft-checkpoint", "run/checkpoint-9"], "draft_checkpoint",
     "run/checkpoint-9", "item 10"),
    (["--draft-k", "6"], "draft_k", 6, "item 10"),
    (["--max-new-tokens", "64"], "max_new_tokens", 64, "item 9"),
    (["--steps-per-sync", "8"], "steps_per_sync", 8, "item 9"),
    (["--adaptive-sync"], "adaptive_sync", True, "item 9"),
    (["--no-join-fast-sync"], "join_fast_sync", False, "item 9"),
    (["--max-pending", "32"], "max_pending", 32, "item 9"),
]


@pytest.mark.parametrize("argv,dest,value,item", ENGINE_FLAGS)
def test_serve_engine_flags_parse(argv, dest, value, item):
    """Each flag parses with the reference's type and default and is inert
    alone; with the option it belongs to, the run exits naming the item."""
    defaults = dict(draft_weights=None, draft_checkpoint=None, draft_k=4,
                    max_new_tokens=128, steps_per_sync=4, adaptive_sync=False,
                    join_fast_sync=True, max_pending=None)
    args = serve_cli.build_parser().parse_args(argv)
    assert {k: getattr(args, k) for k in defaults} == defaults | {dest: value}
    serve_cli._refuse_unported(args)  # alone: accepted
    owner = ["--draft-model", "tiny"] if item == "item 10" else ["--continuous"]
    with pytest.raises(SystemExit) as e:
        serve_cli.build_server(argv + owner + ["--device", "cpu"])
    assert f"ROADMAP queue 1 {item}" in str(e.value.code)


@pytest.mark.parametrize("argv,item", [
    (["--beam-size", "5"], "item 6"),
    (["--data-parallel"], "item 12"),
])
def test_evaluate_unported_flags_exit(argv, item):
    with pytest.raises(SystemExit) as e:
        evaluate_model.main(argv + ["--device", "cpu"])
    assert f"ROADMAP queue 1 {item}" in str(e.value.code)


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
