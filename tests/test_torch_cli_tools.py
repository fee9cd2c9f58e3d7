"""PyTorch port: the data, zero-shot, benchmark and profiling CLIs against
the JAX package's, on the CPU.

- ``cli.calculate_real_speed``: the console-parse contract on the port's
  ``console_step_line``, checkpoint discovery, this process's runtime, and
  ``calculate_real_estimate`` equal to JAX's on the same inputs.
- ``cli.prepare_datasets`` (verify, combine, g2p, analyze),
  ``cli.parse_zeroshot_test``, ``cli.compute_iaa`` and ``cli.check_vocab``:
  the JAX CLI's files and report.
- ``utils.flops``: every FLOP count equal to JAX's for every config; the
  peak table keyed by CUDA device name.
- ``cli.benchmark_models``: parameter counts of tiny, base and small equal
  to the JAX package's (its tree's shapes); ``--measure`` at test-tiny.
- ``cli.evaluate_zeroshot`` at test-tiny on JAX-written safetensors
  (``--weights`` and a checkpoint): the JAX CLI's hypotheses, PER and PFER,
  with the language given and detected.
- ``cli.profile_inference --device cpu`` prints its table, greedy and train.
- Each model CLI refuses the default device where there is no card.
"""

import io
import json
import os
import re
import wave
from contextlib import redirect_stdout
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whisper_ipa_tpu.config as jax_config
import whisper_ipa_torch.config as port_config
from whisper_ipa_tpu.cli import calculate_real_speed as jax_speed
from whisper_ipa_tpu.cli import check_vocab as jax_check_vocab
from whisper_ipa_tpu.cli import compute_iaa as jax_compute_iaa
from whisper_ipa_tpu.cli import evaluate_zeroshot as jax_evaluate_zeroshot
from whisper_ipa_tpu.cli import parse_zeroshot_test as jax_parse_zeroshot
from whisper_ipa_tpu.cli import prepare_datasets as jax_prepare
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.convert import save_safetensors as jax_save
from whisper_ipa_tpu.models.whisper import count_parameters as jax_count
from whisper_ipa_tpu.utils import flops as jax_flops
from whisper_ipa_torch.audio import SAMPLE_RATE, write_wav
from whisper_ipa_torch.cli import (
    benchmark_models,
    calculate_real_speed,
    check_vocab,
    compute_iaa,
    evaluate_zeroshot,
    parse_zeroshot_test,
    prepare_datasets,
    profile_inference,
)
from whisper_ipa_torch.train.logger import console_step_line
from whisper_ipa_torch.utils import flops, timing
from whisper_ipa_torch.utils.xlsx import write_xlsx

torch.set_num_threads(1)

MODEL = "test-tiny-zs"  # test-tiny with a short text context


def _stdout(fn, *args, **kwargs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = fn(*args, **kwargs)
    return buf.getvalue(), result


# -- calculate_real_speed ------------------------------------------------------

def _training_run(root, steps=(100, 500, 250)):
    for step in steps:
        d = root / f"checkpoint-{step}"
        d.mkdir()
        (d / "training_state.json").write_text(
            json.dumps({"step": step, "loss": 1.0 / step}))
    log = root / "train.log"
    lines = ["Loading weights", "Step garbage | Time: x | Samples/sec: y"]
    lines += [console_step_line(s, 1000, 2.5, 0.4 + s / 1e4, 8)
              for s in range(10, 310, 10)]
    log.write_text("\n".join(lines) + "\n")
    return log


def test_speed_monitor_log_parse_contract(tmp_path):
    log = tmp_path / "train.log"
    log.write_text("\n".join(
        console_step_line(step, 100, 2.5, 0.5, 8) for step in (10, 20, 30))
        + "\n")
    steps = calculate_real_speed.parse_log_for_steps(log)
    assert [s["step"] for s in steps] == [10, 20, 30]
    assert steps[0]["samples_per_sec"] == pytest.approx(16.0)
    assert steps == jax_speed.parse_log_for_steps(log)
    assert calculate_real_speed.parse_log_for_steps(tmp_path / "none") == []


def test_speed_monitor_checkpoints_and_runtime(tmp_path):
    _training_run(tmp_path)
    latest = calculate_real_speed.get_latest_checkpoint(tmp_path)
    assert latest["step"] == 500 and latest["loss"] == pytest.approx(1 / 500)
    theirs = jax_speed.get_latest_checkpoint(tmp_path)
    assert {k: latest[k] for k in ("step", "path", "loss")} == {
        k: theirs[k] for k in ("step", "path", "loss")}
    assert calculate_real_speed.get_latest_checkpoint(tmp_path / "no") is None
    rt = calculate_real_speed.get_process_runtime(os.getpid())
    assert rt is not None and rt >= 0
    assert _stdout(calculate_real_speed.get_process_runtime, -5)[1] is None


@pytest.mark.parametrize("batch", [8, 16])
def test_speed_monitor_estimate_matches_jax(tmp_path, monkeypatch, batch):
    log = _training_run(tmp_path)
    for mod in (calculate_real_speed, jax_speed):
        monkeypatch.setattr(mod, "get_process_runtime", lambda pid: 3725)
    argv = [str(os.getpid()), str(tmp_path), "1000", str(batch),
            "--log-file", str(log)]
    out, _ = _stdout(calculate_real_speed.main, argv)
    jax_out, _ = _stdout(jax_speed.main, argv)
    assert out == jax_out
    ours = _stdout(calculate_real_speed.calculate_real_estimate, 1,
                   tmp_path, 1000, batch, log_file=log)[1]
    assert ours == _stdout(jax_speed.calculate_real_estimate, 1, tmp_path,
                           1000, batch, log_file=log)[1]
    assert ours["step"] == 500
    assert ours["samples_per_sec"] == pytest.approx(batch / (3725 / 500))
    # the mean of the last 20 logged rates, computed here from the lines
    rates = [float(ln.rsplit("Samples/sec:", 1)[1])
             for ln in log.read_text().splitlines()
             if re.match(r"Step \d+/", ln)][-20:]
    assert ours["recent_samples_per_sec"] == pytest.approx(np.mean(rates))


# -- host CLIs -----------------------------------------------------------------

def test_check_vocab_matches_jax():
    out, rc = _stdout(check_vocab.main, [])
    jax_out, _ = _stdout(jax_check_vocab.main, [])
    assert rc == 0 and out == jax_out
    assert "All IPA strings round-trip" in out


def test_prepare_datasets_verify_and_combine(tmp_path):
    import unicodedata

    ds = tmp_path / "d.json"
    ds.write_text(json.dumps([
        {"ipa_transcription": "kæt"},
        {"ipa_transcription": unicodedata.normalize("NFD", "kẽt")}]))
    out, _ = _stdout(prepare_datasets.main, ["verify", str(ds), "--fix"])
    fixed = (tmp_path / "d_normalized.json").read_bytes()
    jax_out, _ = _stdout(jax_prepare.main, ["verify", str(ds), "--fix"])
    assert out == jax_out and "Needs normalization: 1" in out
    assert fixed == (tmp_path / "d_normalized.json").read_bytes()

    for side, main in (("p", prepare_datasets.main), ("j", jax_prepare.main)):
        d = tmp_path / side
        d.mkdir()
        for name in ("timit_train_ipa.json", "timit_test_ipa.json",
                     "metu_turkish_ipa.json", "ogi_spelled_ipa.json"):
            (d / name).write_text(
                json.dumps([{"audio_path": "x", "ipa_transcription": "a"}]))
        _stdout(main, ["combine", "--processed-dir", str(d)])
    for name in ("combined_train_ipa.json", "combined_test_ipa.json"):
        assert (tmp_path / "p" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes()


def _wav(path, seconds, rate=100):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(b"\x00\x00" * int(seconds * rate))


def test_prepare_datasets_g2p_and_analyze_match_jax(tmp_path):
    """The g2p subcommand on a small CommonVoice-style tree (quoted and
    empty cells, a duplicate, a long clip), and analyze."""
    rows = {
        "fi": ["kissa istuu", "äiti", "vesi", "kengät", "kissa istuu",
               '"sanoi ""hei"""', "", "x", "talo https://a.fi", "pitkä"],
        "pl": ["szczur", "łódź", "rzeka", "przy", "nie", "", "kot", "pies",
               "dom", "las"],
    }
    for lang, sents in rows.items():
        d = tmp_path / "cv" / lang
        (d / "clips").mkdir(parents=True)
        for split in ("train", "dev", "test"):
            lines = ["client_id\tpath\tsentence\tdown_votes"]
            for i, s in enumerate(sents):
                lines.append(f"c{i}\t{i}.wav\t{s}\t{i % 3 if i != 4 else ''}")
            (d / f"{split}.tsv").write_text("\n".join(lines) + "\n", "utf-8")
        for i in range(len(sents)):
            _wav(d / "clips" / f"{i}.wav", 7.0 if i == 9 else 2.0)
    common = ["g2p", "--dataset-root", str(tmp_path / "cv"), "--languages",
              "fi", "pl", "--train-n", "4", "--val-n", "2", "--test-n", "2"]
    out, _ = _stdout(prepare_datasets.main,
                     common + ["--output-dir", str(tmp_path / "p")])
    jax_out, _ = _stdout(jax_prepare.main,
                         common + ["--output-dir", str(tmp_path / "j")])
    assert out.replace(str(tmp_path / "p"), "") == jax_out.replace(
        str(tmp_path / "j"), "")
    for name in os.listdir(tmp_path / "j"):
        assert (tmp_path / "p" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes()
    argv = ["analyze", "--dataset-root", str(tmp_path / "cv"),
            "--languages", "fi", "pl"]
    assert _stdout(prepare_datasets.main, argv)[0] == _stdout(
        jax_prepare.main, argv)[0]


def test_zeroshot_clis_match_jax(tmp_path):
    a = [["ID", "IPA", "Elapsed Time (sec)"], [1.0, "ta", 1.0],
         [2.0, "ta", 2.0], [3.0, "pabu", 3.0], [41.0, "ma", 4.0]]
    h = [["ID", "IPA", "Elapsed Time (sec)"], [1.0, "ta", 1.0],
         [2.0, "da", 2.0], [3.0, "pabɯ", 3.0], [41.0, "na", 4.0]]
    write_xlsx(str(tmp_path / "a.xlsx"), a)
    write_xlsx(str(tmp_path / "h.xlsx"), h)
    (tmp_path / "t.csv").write_text("ID,IPA,Done\n1,ta,1\n2,ta,1.0\n3,pabu,\n")
    (tmp_path / "wav").mkdir()
    for i in (1, 2, 3):
        _wav(tmp_path / "wav" / f"{i}_x.wav", 0.1)
    files = {}
    for side, main in (("p", parse_zeroshot_test.main),
                       ("j", jax_parse_zeroshot.main)):
        files[side] = tmp_path / f"{side}.json"
        _stdout(main, ["--ariga-xlsx", str(tmp_path / "a.xlsx"),
                       "--hamanishi-xlsx", str(tmp_path / "h.xlsx"),
                       "--test-data-csv", str(tmp_path / "t.csv"),
                       "--wav-dir", str(tmp_path / "wav"),
                       "--output", str(files[side])])
    assert files["p"].read_bytes() == files["j"].read_bytes()
    out, _ = _stdout(compute_iaa.main, ["--input", str(files["p"])])
    jax_out, _ = _stdout(jax_compute_iaa.main, ["--input", str(files["j"])])
    assert out == jax_out and "Usable pairs: 3" in out


# -- utils.flops ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(port_config.CONFIGS))
def test_flops_match_jax(name):
    cfg, jcfg = port_config.CONFIGS[name], jax_config.CONFIGS[name]
    assert flops.mel_flops(cfg) == jax_flops.mel_flops(jcfg)
    assert flops.mel_flops(cfg, 1000) == jax_flops.mel_flops(jcfg, 1000)
    assert flops.encoder_flops(cfg) == jax_flops.encoder_flops(jcfg)
    for n, prefix in ((1, 4), (64, 4), (223, 3)):
        assert flops.decoder_flops(cfg, n, prefix) == jax_flops.decoder_flops(
            jcfg, n, prefix)
        for mel in (True, False):
            assert flops.inference_flops(cfg, n, prefix, mel) == (
                jax_flops.inference_flops(jcfg, n, prefix, mel))
    for length, frozen in ((32, True), (48, False)):
        assert flops.train_step_flops(cfg, length, frozen) == (
            jax_flops.train_step_flops(jcfg, length, frozen))


def test_peak_flops_by_cuda_name():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops("TPU v5 lite") is None
    assert flops.peak_flops("NVIDIA GeForce GTX 1080") is None


# -- benchmark_models ----------------------------------------------------------

def test_benchmark_models_counts_match_jax():
    out, reports = _stdout(benchmark_models.main, [
        "--models", "tiny", "base", "small", "--device", "cpu"])
    for r in reports:
        shapes = jax.eval_shape(lambda n=r["model"]: jax_init_params(
            jax_config.CONFIGS[n], seed=0))
        assert r["encoder_params"] == jax_count(shapes["encoder"])
        assert r["decoder_params"] == jax_count(shapes["decoder"])
    small = reports[2]
    assert small["decoder_params"] == 153_580_800  # the reference's count
    jax_out, _ = _stdout(jax_benchmark_tiny)
    assert out.splitlines()[0] == jax_out.splitlines()[0]


def jax_benchmark_tiny():
    from whisper_ipa_tpu.cli import benchmark_models as jax_benchmark

    jax_benchmark.main(["--models", "tiny"])


def test_benchmark_models_measure_on_cpu():
    out, (report,) = _stdout(benchmark_models.main, [
        "--models", "test-tiny", "--measure", "--batch-size", "2",
        "--device", "cpu"])
    assert report["train_step_sec"] > 0
    assert report["train_samples_per_sec"] == pytest.approx(
        2 / report["train_step_sec"])
    assert "train_mfu" not in report  # no device peak on the CPU
    assert "train step" in out and "cpu" in out


# -- evaluate_zeroshot ---------------------------------------------------------

@pytest.fixture(scope="module")
def zeroshot_setup(tmp_path_factory):
    """Both packages know MODEL; WAVs, a zero-shot JSON (two entries
    without audio or gold), base weights and a decoder-only checkpoint
    written by the JAX package."""
    mp = pytest.MonkeyPatch()
    for mod in (jax_config, port_config):
        mp.setitem(mod.CONFIGS, MODEL, replace(
            mod.CONFIGS["test-tiny"], name=MODEL, n_text_ctx=48))
    root = tmp_path_factory.mktemp("zs")
    rng = np.random.default_rng(0)
    entries = []
    for i, ipa in enumerate(["kæt", "bʌtn̩", "ə̥tʃ"]):
        t = np.arange(int((1.0 + 0.5 * i) * SAMPLE_RATE)) / SAMPLE_RATE
        audio = (0.3 * np.sin(2 * np.pi * (180.0 + 60.0 * i) * t)
                 + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        path = str(root / f"{i}_x.wav")
        write_wav(path, audio)
        entries.append({"id": i, "audio_path": path, "gold_ipa": ipa})
    entries += [{"id": 7, "audio_path": None, "gold_ipa": "a"},
                {"id": 8, "audio_path": entries[0]["audio_path"],
                 "gold_ipa": None}]
    data = root / "zeroshot_test.json"
    data.write_text(json.dumps(entries, ensure_ascii=False), "utf-8")
    cfg = jax_config.CONFIGS[MODEL]
    weights = str(root / "base.safetensors")
    jax_save(weights, jax_init_params(cfg, seed=0))
    run = root / "run"
    ckpt = run / "checkpoint-5"
    os.makedirs(ckpt)
    # text-token embeddings 0 except the 256 byte tokens: greedy output is
    # byte tokens, which decode to text
    trained = jax_init_params(cfg, seed=2)
    emb = np.array(trained["decoder"]["token_embedding"])
    emb[256:50257] = 0.0
    trained["decoder"]["token_embedding"] = jnp.asarray(emb)
    jax_save(str(ckpt / "model.safetensors"), trained)
    (run / "training_config.json").write_text(
        json.dumps({"training_args": {"freeze_encoder": True}}))
    yield dict(data=str(data), weights=weights, ckpt=str(ckpt))
    mp.undo()


@pytest.mark.parametrize("language", [None, "en"])
def test_evaluate_zeroshot_matches_jax(zeroshot_setup, monkeypatch, language):
    argv = ["--test-data", zeroshot_setup["data"], "--base-model", MODEL,
            "--weights", zeroshot_setup["weights"], "--checkpoint",
            zeroshot_setup["ckpt"], "--batch-size", "3"]
    if language:
        argv += ["--language", language]
    seen = {}
    real = jax_evaluate_zeroshot.evaluate_batch

    def spy(refs, hyps):
        seen.update(references=list(refs), hypotheses=list(hyps))
        return real(refs, hyps)

    monkeypatch.setattr(jax_evaluate_zeroshot, "evaluate_batch", spy)
    jax_out, theirs = _stdout(jax_evaluate_zeroshot.main, argv)
    out, ours = _stdout(evaluate_zeroshot.main, argv + ["--device", "cpu"])
    assert ours["hypotheses"] == seen["hypotheses"]
    assert ours["references"] == seen["references"]
    assert len(ours["hypotheses"]) == 3 and all(ours["hypotheses"])
    for k in ("per", "per_std", "pfer", "pfer_std"):
        assert ours[k] == pytest.approx(theirs[k], abs=1e-9)
    report = [ln for ln in out.splitlines()
              if ln.startswith(("Zero-shot entries", "Loaded", "PER:",
                                "PFER:", "  multipa", "  Human"))]
    assert report == [ln for ln in jax_out.splitlines()
                      if ln.startswith(("Zero-shot entries", "Loaded",
                                        "PER:", "PFER:", "  multipa",
                                        "  Human"))]
    assert "Zero-shot entries with gold IPA + audio: 3" in out


# -- profile_inference ---------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--train"]])
def test_profile_inference_prints_its_table_on_cpu(extra, tmp_path):
    out, result = _stdout(profile_inference.main, [
        "--device", "cpu", "--model", "test-tiny", "--batch", "2",
        "--sample-len", "4", "--top", "5", "--json",
        str(tmp_path / "ops.json"), "--logdir", str(tmp_path / "trace"),
        *extra])
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    lines = out.splitlines()
    assert lines[0].strip().startswith("total CPU ms:")
    assert lines[1].split() == ["self", "ms", "n", "op"]
    assert len(lines) == 2 + 5
    assert result["device"] == "cpu" and result["busy_share"] is None
    assert not any(r["op"].startswith("ProfilerStep") for r in result["rows"])
    assert result["port_kernels"] == {}
    assert result["total_ms"] == pytest.approx(
        sum(r["self_ms"] for r in result["rows"]))
    assert json.loads((tmp_path / "ops.json").read_text()) == result["rows"]
    want = "aten::mm" if extra else "aten::bmm"
    assert any(r["op"] == want for r in result["rows"])
    # the program's span markers are in the trace and out of the table
    span = "train.forward" if extra else "decode.step"
    marks = [timing.parse_marker(e.get("name", "")) for e in trace["traceEvents"]]
    assert any(m and m[0] == span for m in marks)
    assert not any(timing.parse_marker(r["op"]) for r in result["rows"])


# -- the default device --------------------------------------------------------

@pytest.mark.parametrize("main,argv", [
    (evaluate_zeroshot.main, ["--base-model", "test-tiny"]),
    (benchmark_models.main, ["--models", "test-tiny"]),
    (profile_inference.main, ["--model", "test-tiny"]),
])
def test_model_clis_need_a_card_by_default(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv)
