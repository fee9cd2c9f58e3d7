"""PyTorch port: corpus preparation (``whisper_ipa_torch.data.prep``) and the
XLSX reader/writer against the JAX package's, on the same inputs.

- Every case of ``tests/test_data_prep.py`` through the port, each also
  held to the JAX package's result on the same input.
- ``text_to_ipa`` for the seven languages on seeded strings over each
  converter's graphemes: the same IPA, or the same exception.
- The pandas-free readers: ``data.prep.tables.read_table`` types every
  cell of seeded tables as ``pandas.read_csv`` does (missing-value words,
  integer / float / bool / text columns, quoting); ``process_language``,
  ``create_datasets`` and ``analyze_language`` equal JAX's (which run on
  pandas here) on a TSV with every trap: empty cells, a missing
  ``client_id``, an empty ``down_votes``, quoted fields, duplicates, URLs,
  short sentences, clips over 6 s, sampling; ``parse_test_data_csv`` with
  ``1``, ``1.0`` and empty ``Done`` values in numeric and text columns.
- ``build_zeroshot_json`` / ``compute_iaa`` equal JAX's (records equal,
  metrics within 1e-9); ``derive_ja_readings`` on a small fixture; the
  reading table byte-identical to JAX's; the kanji dictionary's env var in
  a subprocess (it mutates module state).
"""

import io
import json
import os
import subprocess
import sys
import unicodedata
import wave
from contextlib import redirect_stdout

import numpy as np
import pandas as pd
import pytest

import whisper_ipa_tpu.data.prep as jprep
import whisper_ipa_tpu.data.prep.g2p.japanese as jax_jm
import whisper_ipa_torch.data.prep as prep
import whisper_ipa_torch.data.prep.g2p.japanese as jm
from whisper_ipa_tpu.data.prep import preprocess as jax_preprocess
from whisper_ipa_tpu.data.prep import zeroshot as jax_zeroshot
from whisper_ipa_tpu.utils import xlsx as jax_xlsx
from whisper_ipa_torch.data.prep import preprocess, tables, zeroshot
from whisper_ipa_torch.utils import xlsx

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANGS = ("ja", "pl", "mt", "hu", "fi", "el", "ta")


def quiet(fn, *args, **kwargs):
    with redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def test_public_names_match_jax():
    assert prep.__all__ == jprep.__all__
    for name in prep.__all__:
        assert callable(getattr(prep, name)) == callable(getattr(jprep, name))


# -- test_data_prep.py's cases ----------------------------------------------

def test_phonesets_match_jax():
    assert len(prep.TIMIT_ARPABET_TO_IPA) == 61
    for c in ("bcl", "dcl", "kcl", "pau", "h#"):
        assert prep.TIMIT_ARPABET_TO_IPA[c] == ""
    assert prep.TIMIT_ARPABET_TO_IPA["nx"] == "ɾ̃"
    assert prep.METUBET_TO_IPA["GG"] == "ɟ"
    for name in ("TIMIT_ARPABET_TO_IPA", "OGI_ARPABET_TO_IPA",
                 "METUBET_TO_IPA"):
        assert getattr(prep, name) == getattr(jprep, name)
    alignment = [(0, 1, "h#"), (1, 2, "k"), (2, 3, "ae"), (3, 4, "t"),
                 (4, 5, "h#"), (5, 6, "zz")]
    assert quiet(prep.labels_to_ipa, alignment,
                 prep.TIMIT_ARPABET_TO_IPA) == "kæt"


def _wav(path, seconds, rate=100):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(b"\x00\x00" * int(seconds * rate))


def test_corpora_match_jax(tmp_path):
    """TIMIT, METU and OGI layouts, .phn/.ptl parsing, combine."""
    utt = tmp_path / "timit" / "TRAIN" / "DR1" / "FAKE0"
    utt.mkdir(parents=True)
    (utt / "SA1.PHN").write_text(
        "0 100 h#\n100 200 k\n200 300 ae\n300 400 t\n400 500 h#\n")
    (utt / "SA1.TXT").write_text("0 500 cat\n")
    _wav(utt / "SA1.WAV", 0.01)
    metu = tmp_path / "metu" / "data"
    (metu / "speech-text" / "s1").mkdir(parents=True)
    (metu / "alignments" / "s1").mkdir(parents=True)
    _wav(metu / "speech-text" / "s1" / "u1.wav", 0.01)
    (metu / "speech-text" / "s1" / "u1.txt").write_text("gül", "utf-8")
    (metu / "alignments" / "s1" / "u1.phn").write_text(
        "0 1 SIL\n1 2 GG\n2 3 UE\n3 4 LL\n")
    ogi = tmp_path / "ogi"
    (ogi / "handlabl" / "call" / "a").mkdir(parents=True)
    (ogi / "speech" / "call" / "a").mkdir(parents=True)
    (ogi / "handlabl" / "call" / "a" / "x.ptl").write_text(
        "MillisecondsPerFrame: 3.0\nEND OF HEADER\n0 100 h#\n100 200 k\n"
        "200 300 ao-r\n300 400 glot\n")
    _wav(ogi / "speech" / "call" / "a" / "x.wav", 0.01)

    phn = utt / "SA1.PHN"
    assert prep.parse_phn_file(phn)[1] == (100, 200, "k")
    assert prep.parse_phn_file(phn) == jprep.parse_phn_file(phn)
    ptl = ogi / "handlabl" / "call" / "a" / "x.ptl"
    assert prep.parse_ptl_file(ptl)[:2] == [(0, 100, "h#"), (100, 200, "k")]
    assert prep.parse_ptl_file(ptl) == jprep.parse_ptl_file(ptl)

    for pkg, side in ((prep, "port"), (jprep, "jax")):
        out = tmp_path / side
        quiet(pkg.prepare_timit, tmp_path / "timit",
              out / "timit_train_ipa.json", split="TRAIN")
        quiet(pkg.prepare_timit, tmp_path / "timit",
              out / "timit_test_ipa.json", split="TRAIN")
        quiet(pkg.prepare_metu, tmp_path / "metu", out / "metu_turkish_ipa.json")
        quiet(pkg.prepare_ogi, ogi, out / "ogi_spelled_ipa.json")
        quiet(pkg.combine_datasets, out)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert "combined_train_ipa.json" in names
    for name in names:
        ours = json.loads((tmp_path / "port" / name).read_text("utf-8"))
        theirs = json.loads((tmp_path / "jax" / name).read_text("utf-8"))
        assert ours == theirs, name
    timit = json.loads((tmp_path / "port" / "timit_train_ipa.json")
                       .read_text("utf-8"))
    assert timit[0]["ipa_transcription"] == "kæt"
    assert timit[0]["orthographic_text"] == "cat"
    assert timit[0]["phoneme_count"] == 3
    train = json.loads((tmp_path / "port" / "combined_train_ipa.json")
                       .read_text("utf-8"))
    assert {e["dataset_source"] for e in train} == {
        "timit", "metu_turkish", "ogi_spelled"}


@pytest.mark.parametrize("word,lang,ipa", [
    ("kissa", "fi", "kisːɑ"), ("äiti", "fi", "æiti"), ("vesi", "fi", "ʋesi"),
    ("kengät", "fi", "keŋːæt"), ("szép", "hu", "seːp"),
    ("gyerek", "hu", "ɟɛrɛk"), ("család", "hu", "t͡ʃɒlaːd"),
    ("szczur", "pl", "ʂt͡ʂur"), ("łódź", "pl", "wut͡ɕ"),
    ("rzeka", "pl", "ʐɛka"), ("przy", "pl", "pʂɨ"), ("nie", "pl", "ɲɛ"),
    ("καλημέρα", "el", "kalimeɾa"), ("θάλασσα", "el", "θalasa"),
    ("αυριο", "el", "avɾio"), ("ευχαριστώ", "el", "efxaɾisto"),
    ("xemx", "mt", "ʃɛmʃ"), ("qattus", "mt", "ʔatːus"),
    ("ねこ", "ja", "ne̞ko̞"), ("きょう", "ja", "kjo̞ː"),
    ("がっこう", "ja", "ɡäkːo̞ː"), ("しんぶん", "ja", "ɕinbɯɴ"),
])
def test_g2p_known_answers(word, lang, ipa):
    assert prep.text_to_ipa(word, lang) == ipa
    assert jprep.text_to_ipa(word, lang) == ipa


def test_g2p_edge_cases_match_jax():
    assert prep.text_to_ipa("これは", "ja").endswith("wä")
    assert prep.text_to_ipa("はやく", "ja").startswith("hä")
    assert prep.text_to_ipa("日本", "ja") == jprep.text_to_ipa("日本", "ja")
    out = prep.text_to_ipa("அம்மா", "ta")
    assert out.startswith("am") and "aː" in out
    assert out == jprep.text_to_ipa("அம்மா", "ta")
    assert " " not in prep.text_to_ipa("kissa istuu", "fi")
    for pkg in (prep, jprep):
        with pytest.raises(ValueError):
            pkg.text_to_ipa("hello", "xx")
        with pytest.raises(ValueError):
            pkg.text_to_ipa("薔薇", "ja")


def _graphemes(lang):
    from whisper_ipa_torch.data.prep.g2p import languages, tamil

    if lang == "ja":
        return (list(jm._BASE) + list(jm._SMALL_VOWEL) + ["っ", "ー", "ッ",
                "カ", "ディ", "ファ"] + list(jm.KANJI_READINGS)[:40])
    if lang == "ta":
        return (list(tamil._INDEP) + list(tamil._CONS) + list(tamil._SIGNS)
                + [tamil._VIRAMA])
    return list(languages.CONVERTERS[lang].table)


def _seeded_sentences(lang, n, seed):
    rng = np.random.default_rng(seed)
    units = _graphemes(lang)
    extra = [" ", " ", ",", "。", "!", "X", "1"]
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 14))
        pieces = [units[i] for i in rng.integers(0, len(units), size=k)]
        pieces += [extra[i] for i in rng.integers(0, len(extra),
                                                  size=int(rng.integers(0, 3)))]
        rng.shuffle(pieces)
        s = "".join(pieces)
        out.append(s.upper() if rng.random() < 0.1 else s)
    return out


def _g2p(pkg, s, lang):
    try:
        return pkg.text_to_ipa(s, lang)
    except Exception as e:  # the same exception on both sides
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("lang", LANGS)
def test_text_to_ipa_matches_jax_on_seeded_strings(lang):
    sentences = _seeded_sentences(lang, 150, seed=LANGS.index(lang))
    ours = [_g2p(prep, s, lang) for s in sentences]
    theirs = [_g2p(jprep, s, lang) for s in sentences]
    assert ours == theirs
    assert sum(isinstance(x, str) and bool(x) for x in ours) > 30


def test_verify_and_iaa_match_jax(tmp_path):
    decomposed = unicodedata.normalize("NFD", "kẽt")
    path = tmp_path / "ds.json"
    path.write_text(json.dumps([{"ipa_transcription": "kæt"},
                                {"ipa_transcription": decomposed}]))
    needs, changes = quiet(prep.analyze_dataset, path)
    assert (needs, changes) == quiet(jprep.analyze_dataset, path)
    assert needs and len(changes) == 1
    out = quiet(prep.apply_normalization, path)
    assert not quiet(prep.analyze_dataset, out)[1]
    assert quiet(prep.check_normalization, "kæt")

    entries = [{"id": i, "ipa_ariga": a, "ipa_hamanishi": h,
                "has_both_annotators": True, "usable_for_iaa": True}
               for i, (a, h) in enumerate(
                   [("kæt", "kæt"), ("bʌtn̩", "bʌtn"), ("ətʃ", "ə̥tʃ")])]
    zs = tmp_path / "zeroshot_test.json"
    zs.write_text(json.dumps(entries))
    ours = quiet(prep.compute_iaa, zs)
    assert ours["num_pairs"] == 3 and len(ours["candidates"]) == 4
    assert ours["ariga_ref"]["per_scores"][0] == 0.0
    _assert_iaa_equal(ours, quiet(jprep.compute_iaa, zs))


def _assert_iaa_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for side in ("ariga_ref", "hamanishi_ref"):
        for k, v in theirs[side].items():
            np.testing.assert_allclose(ours[side][k], v, rtol=0, atol=1e-9)
    assert ours["num_pairs"] == theirs["num_pairs"]
    assert [c[0] for c in ours["candidates"]] == [
        c[0] for c in theirs["candidates"]]
    np.testing.assert_allclose([c[1] for c in ours["candidates"]],
                               [c[1] for c in theirs["candidates"]], atol=1e-9)
    assert ours["best"][0] == theirs["best"][0]


def test_mapping_csv_loader(tmp_path):
    from whisper_ipa_tpu.data.prep.g2p.engine import (
        from_mapping_csv as jax_from_csv,
    )
    from whisper_ipa_torch.data.prep.g2p.engine import from_mapping_csv

    csv_path = tmp_path / "xyz-Latn.csv"
    csv_path.write_text("Orth,Phon\na,ɑ\nsz,s\ns,ʃ\n")
    conv, jconv = from_mapping_csv(str(csv_path)), jax_from_csv(str(csv_path))
    assert conv("sza") == "sɑ" and conv("sa") == "ʃɑ"
    assert conv.table == jconv.table


def test_xlsx_round_trip_both_ways(tmp_path):
    rows = [["ID", "IPA", "Elapsed Time (sec)"], [1.0, "kæt", 12.5],
            [2.0, "tʰiː ʌ ə̥", None], [None, None, None], [3.0, "?", 0.0],
            [41.0, "a<b>&\"c'", 7]]
    for write, read in ((xlsx.write_xlsx, jax_xlsx.read_xlsx),
                        (jax_xlsx.write_xlsx, xlsx.read_xlsx),
                        (xlsx.write_xlsx, xlsx.read_xlsx)):
        path = str(tmp_path / "annot.xlsx")
        write(path, rows)
        back = read(path)
        assert back == jax_xlsx.read_xlsx(path)
        assert back[0] == rows[0] and back[1] == [1.0, "kæt", 12.5]
        assert back[2][1] == "tʰiː ʌ ə̥" and back[4] == [3.0, "?", 0.0]
        assert back[5] == [41.0, "a<b>&\"c'", 7.0]
    xlsx.write_xlsx(str(tmp_path / "r.xlsx"), [["ID", "IPA"], [7.0, "ba"]])
    assert xlsx.read_xlsx_records(str(tmp_path / "r.xlsx")) == [
        {"ID": 7.0, "IPA": "ba"}]


# -- zero-shot assembly -------------------------------------------------------

def _zeroshot_inputs(tmp_path, csv_text):
    ariga = [["ID", "IPA", "Elapsed Time (sec)"], [1.0, "ta", 10.0],
             [2.0, "ta", 11.0], [3.0, "pa", 12.0], [4.0, "tata", 13.0],
             [5.0, "ka", 9.0], [41.0, "ma", 8.0], [6.0, "?", None],
             ["x", "zz", 1.0], [75.0, "su", "slow"]]
    hama = [["ID", "IPA", "Elapsed Time (sec)"], [1.0, "ta", 20.0],
            [2.0, "da", 21.0], [3.0, "pa", 22.0], [4.0, "tata", 23.0],
            [41.0, "na", 18.0], [75.0, "sɯ", 3.0], [80.0, "o", 2.0]]
    a_path, h_path = tmp_path / "ariga.xlsx", tmp_path / "hamanishi.xlsx"
    xlsx.write_xlsx(str(a_path), ariga)
    xlsx.write_xlsx(str(h_path), hama)
    csv_path = tmp_path / "test_data.csv"
    csv_path.write_text(csv_text, "utf-8")
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i in (1, 2, 3, 4, 5, 41, 75):
        _wav(wav_dir / f"{i}_abc.wav", 0.01, rate=16000)
    _wav(wav_dir / "Copy of 3_abc.wav", 0.01)
    (wav_dir / "notes.txt").write_text("x")
    return a_path, h_path, csv_path, wav_dir


ZS_CSV = "ID,IPA,Done\n1,ta,1\n2,ta,1\n3,pa,1\n4,tata,1\n5,ka,1\n41,ma,1\n"


def test_zeroshot_pipeline_hand_computed_and_matches_jax(tmp_path):
    a, h, c, w = _zeroshot_inputs(tmp_path, ZS_CSV)
    ours = quiet(zeroshot.build_zeroshot_json, a, h, c, w,
                 tmp_path / "port.json")
    theirs = quiet(jax_zeroshot.build_zeroshot_json, a, h, c, w,
                   tmp_path / "jax.json")
    assert ours == theirs
    by_id = {e["id"]: e for e in ours}
    assert ours[0]["gold_annotator"] == "ariga" and by_id[2]["gold_ipa"] == "ta"
    assert by_id[41]["has_both_annotators"] and not by_id[41]["usable_for_iaa"]
    assert not by_id[5]["usable_for_iaa"]
    assert by_id[1]["audio_path"].endswith("1_abc.wav")
    iaa = quiet(zeroshot.compute_iaa, tmp_path / "port.json")
    assert iaa["num_pairs"] == 4
    assert iaa["ariga_ref"]["per"] == pytest.approx(12.5)
    assert iaa["ariga_ref"]["pfer_hamming"] == pytest.approx(
        100 * (1 / 24) / 2 / 4, abs=1e-6)
    _assert_iaa_equal(iaa, quiet(jax_zeroshot.compute_iaa,
                                 tmp_path / "jax.json"))


@pytest.mark.parametrize("csv_text", [
    "ID,IPA,Done\n1,ta,1\n2,ta,1.0\n3,pa,\n4,tata,0\n41.0,ma,1\n",
    "ID,IPA,Done\n1,ta,1\n2,ta,yes\n3,pa,1.0\n4,tata,\n5,ka,1\n",
    "ID,IPA,Done\n1.0,ta,1.0\n2.0,\"t,a\",1.0\n3.0,,\n,pa,1\n",
    "ID,IPA,Done\nx,ta,1\n2,NA,True\n3,pa,False\n4,\"ta\"\"ta\",true\n",
    "ID,IPA\n1,ta\n2,da\n",
    "IPA,Done,ID\nta,1,1\n  ,1, 2\n?,1,3\n",
    "ID,IPA,Done\n1,5,1\n2,,1.0\n41,,\n",  # all numeric: iterrows' floats
])
def test_parse_test_data_csv_matches_jax(tmp_path, csv_text):
    """Done as 1 / 1.0 / empty in numeric and text columns, float IDs,
    missing columns, quoting: the JAX function's records (it reads with
    pandas), the whole assembly too."""
    path = tmp_path / "test_data.csv"
    path.write_text(csv_text, "utf-8")
    ours = zeroshot.parse_test_data_csv(path)
    assert ours == jax_zeroshot.parse_test_data_csv(path)
    a, h, c, w = _zeroshot_inputs(tmp_path, csv_text)
    assert quiet(zeroshot.build_zeroshot_json, a, h, c, w,
                 tmp_path / "p.json") == quiet(
        jax_zeroshot.build_zeroshot_json, a, h, c, w, tmp_path / "j.json")


def test_parse_test_data_csv_done_values(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("ID,IPA,Done\n1,ta,1\n2,ta,1.0\n3,pa,\n41.0,ma,1\n")
    got = zeroshot.parse_test_data_csv(path)
    assert {k: v["done"] for k, v in got.items()} == {
        1: True, 2: True, 3: False, 41: True}
    path.write_text("ID,IPA,Done\n1,ta,1\n2,ta,1.0\n3,pa,yes\n")
    got = zeroshot.parse_test_data_csv(path)  # a text column: "1.0" fails
    assert {k: v["done"] for k, v in got.items()} == {
        1: True, 2: False, 3: False}


# -- the TSV / CSV reader against pandas ---------------------------------------

TRAP_CELLS = ["", "NA", "nan", "None", "null", "N/A", "1", "2", "-3", "+4",
              " 5", "6 ", "1.0", "2.5", ".5", "5.", "1e3", "inf", "-Inf",
              "True", "false", "TRUE", "yes", "x", "a b", "1_000", "0x10",
              "1,5", "  ", "ü", "\"q\"", "\"a\tb\"", "\"he said \"\"hi\"\"\"",
              "#N/A", "1.5e", "01"]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sep", [",", "\t"])
def test_read_table_types_cells_as_pandas(tmp_path, seed, sep):
    rng = np.random.default_rng(seed)
    n_rows, n_cols = int(rng.integers(1, 9)), int(rng.integers(1, 5))
    # each column draws from a narrow pool so every typing rule occurs
    pools = [["1", "2", "-3", "+4", " 5", "01"], ["1", "", "NA", "7"],
             ["1.0", "2.5", ".5", "1e3", "inf", ""], ["True", "false", ""],
             TRAP_CELLS]
    cols = [pools[int(rng.integers(0, len(pools)))] for _ in range(n_cols)]
    lines = [sep.join(f"c{j}" for j in range(n_cols))]
    for _ in range(n_rows):
        cells = [c[int(rng.integers(0, len(c)))] for c in cols]
        if sep == "," and any("," in x and not x.startswith('"')
                              for x in cells):
            cells = [x.replace(",", ";") for x in cells]
        lines.append(sep.join(cells))
    text = "\n".join(lines) + "\n"
    if rng.random() < 0.3:
        text = text.replace("\n", "\n\n", 1)  # a blank line
    path = tmp_path / "t.txt"
    path.write_text(text, "utf-8")
    df = pd.read_csv(path, sep=sep)
    header, rows = tables.read_table(path, sep=sep)
    assert header == list(df.columns)
    assert len(rows) == len(df)
    for col in header:  # the columns as typed
        for i, want in enumerate(df[col].tolist()):
            got = rows[i][col]
            if pd.isna(want):
                assert tables.isna(got), (col, i, got, text)
            else:
                assert type(got) is type(want) and got == want, (
                    col, i, got, want, text)
    rows = tables.iterrows(rows)
    for i, (_, row) in enumerate(df.iterrows()):
        for col in header:
            want, got = row[col], rows[i][col]
            if pd.isna(want):
                assert tables.isna(got), (col, i, got, text)
            else:
                assert not tables.isna(got) and str(got) == str(want), (
                    col, i, got, want, text)
                assert isinstance(got, bool) == isinstance(
                    want, (bool, np.bool_)), (col, i)


def test_read_table_refuses_a_row_longer_than_the_header(tmp_path):
    path = tmp_path / "t.tsv"
    path.write_text("a\tb\n1\t2\t3\n")
    with pytest.raises(ValueError, match="3 fields"):
        tables.read_table(path, sep="\t")


# -- CommonVoice preprocessing --------------------------------------------------

CV_HEADER = ["client_id", "path", "sentence", "up_votes", "down_votes"]


def _cv_tree(root, lang, rows):
    """A CommonVoice-style language dir: <lang>/{train,dev,test}.tsv and
    clips/ (WAVs whose header says their duration)."""
    d = root / lang
    (d / "clips").mkdir(parents=True, exist_ok=True)
    for split in ("train", "dev", "test"):
        with open(d / f"{split}.tsv", "w", newline="", encoding="utf-8") as f:
            f.write("\t".join(CV_HEADER) + "\n")
            for r in rows:
                f.write("\t".join(r) + "\n")
    for r in rows:
        seconds = float(r[3]) if r[3] else 2.0
        if r[1] and r[1] != "missing.wav":
            _wav(d / "clips" / r[1], seconds)


def _cv_rows(lang, n, seed):
    """Seeded rows over the language's graphemes plus every filter's case:
    a URL, a duplicate, a one-character sentence, down_votes 2, an empty
    sentence, an empty client_id, an empty down_votes, a quoted sentence,
    a 'NA' sentence, clips over 6 s and a missing clip. The up_votes
    column carries the clip's seconds."""
    rng = np.random.default_rng(seed)
    sents = _seeded_sentences(lang, n, seed)
    rows = []
    for i, s in enumerate(sents):
        s = s.replace("\t", " ").replace('"', "")
        secs = f"{rng.uniform(1.0, 8.0):.2f}"
        rows.append([f"spk{i % 5}", f"c{i}.wav", s, secs,
                     str(int(rng.integers(0, 2)))])
    rows += [
        ["spkU", "u.wav", sents[0] + " https://x.org", "2", "0"],
        ["spkD", "d.wav", sents[1], "2", "0"],  # duplicate
        ["spk1", "o.wav", sents[2][:1], "2", "0"],
        ["spk2", "v.wav", sents[3] + "v", "2", "2"],
        ["spk3", "e.wav", "", "2", "0"],
        ["spk3", "e2.wav", "", "2", "1"],
        ["", "n.wav", sents[4] + "n", "2", "0"],
        ["spk4", "dv.wav", sents[5] + "d", "2", ""],
        ["spk4", "q.wav", '"' + sents[6] + ' ""q"""', "2", "0"],
        ["spk4", "na.wav", "NA", "2", "0"],
        ["spk5", "long.wav", sents[7] + "l", "7.5", "0"],
        ["spk5", "missing.wav", sents[8] + "m", "2", "0"],
    ]
    return rows


@pytest.fixture(scope="module")
def cv_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cv")
    for k, lang in enumerate(LANGS):
        _cv_tree(root, lang, _cv_rows(lang, 24, seed=100 + k))
    return root


@pytest.mark.parametrize("mode", ["raw", "filtered", "improved"])
@pytest.mark.parametrize("lang", LANGS)
def test_process_language_matches_jax(cv_root, lang, mode):
    for n in (0, 9):
        ours = quiet(preprocess.process_language, lang, cv_root, n, mode=mode)
        theirs = quiet(jax_preprocess.process_language, lang, cv_root, n,
                       mode=mode)
        assert ours == theirs, (lang, mode, n)
    assert n == 9 and len(ours) <= 9


def test_process_language_traps(cv_root):
    """What pandas makes of the traps, checked directly: empty sentences
    and empty down_votes dropped by the filters, a missing client_id is
    the speaker 'nan', the quoted sentence unquoted, clips over 6 s and a
    missing clip dropped."""
    raw = quiet(preprocess.process_language, "fi", cv_root, 0, mode="raw")
    kept = quiet(preprocess.process_language, "fi", cv_root, 0)
    paths = {e["path"] for e in kept}
    assert {"e.wav", "e2.wav", "dv.wav", "u.wav", "o.wav", "v.wav", "d.wav",
            "long.wav", "missing.wav"}.isdisjoint(paths)
    assert {"n.wav", "q.wav", "na.wav"} <= {e["path"] for e in raw}
    by_path = {e["path"]: e for e in raw}
    assert by_path["n.wav"]["speaker_id"] == "nan"
    assert by_path["na.wav"]["sentence"] == "nan"
    assert "\"q\"" in by_path["q.wav"]["sentence"]
    assert by_path["e.wav"]["sentence"] == "nan"


def test_sampling_is_dataframe_sample(tmp_path):
    """DataFrame.sample(n, random_state=seed)'s rows, in its order."""
    rows = [[f"s{i}", f"c{i}.wav", f"kissa {i}", "1", "0"] for i in range(37)]
    _cv_tree(tmp_path, "fi", rows)
    ours = quiet(preprocess.process_language, "fi", tmp_path, 10, seed=42)
    df = pd.DataFrame({"i": range(37)}).sample(10, random_state=42)
    assert [e["path"] for e in ours] == [f"c{i}.wav" for i in df["i"]]


def test_create_datasets_and_analyze_match_jax(cv_root, tmp_path):
    langs = ["fi", "ja", "ta", "mt"]
    ours = quiet(preprocess.create_datasets, cv_root, tmp_path / "p",
                 languages=langs + ["xx"], train_n=8, val_n=4, test_n=3)
    theirs = quiet(jax_preprocess.create_datasets, cv_root, tmp_path / "j",
                   languages=langs + ["xx"], train_n=8, val_n=4, test_n=3)
    assert ours == theirs
    for name in os.listdir(tmp_path / "j"):
        assert (tmp_path / "p" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes(), name
    for lang in LANGS:
        assert quiet(preprocess.analyze_language, lang, cv_root) == quiet(
            jax_preprocess.analyze_language, lang, cv_root)
    report = quiet(preprocess.analyze_language, "fi", cv_root)
    assert report["urls"] == 1 and report["down_voted"] == 1
    assert report["missing_clips"] == 1 and report["duplicates"] >= 2


def test_commonvoice_conversion_matches_jax(tmp_path):
    inp = tmp_path / "in"
    inp.mkdir()
    audio = tmp_path / "audio"
    for k, lang in enumerate(("fi", "pl")):
        entries = [{"path": f"c{i}.wav", "ipa_transcription": ipa}
                   for i, ipa in enumerate(
                       ["kisːɑ", "a", "", "ʋesi " * 2, "x" * 600,
                        unicodedata.normalize("NFD", "kæ̃t")] * 3)]
        (inp / f"{lang}_train_ipa.json").write_text(json.dumps(entries))
        (audio / lang / "clips").mkdir(parents=True)
        for i in range(0, len(entries), 2):
            _wav(audio / lang / "clips" / f"c{i}.wav", 0.1)
    for pkg, side in ((prep, "p"), (jprep, "j")):
        quiet(pkg.prepare_commonvoice, inp, audio, tmp_path / side,
              languages=("fi", "pl"), train_per_lang=(1, 2), val_per_lang=1,
              test_per_lang=2)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p"))
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes(), name


# -- Japanese readings -------------------------------------------------------

def test_reading_table_is_a_byte_copy():
    def tsv(mod):
        return os.path.join(os.path.dirname(os.path.abspath(mod.__file__)),
                            "ja_readings_corpus.tsv")

    with open(tsv(jm), "rb") as a, open(tsv(jax_jm), "rb") as b:
        assert a.read() == b.read()
    table = jm._kanji_dict()
    n = sum(1 for ln in open(tsv(jm), encoding="utf-8")
            if not ln.startswith("#"))
    assert n > 500
    word = next(ln.split("\t")[0] for ln in open(tsv(jm), encoding="utf-8")
                if not ln.startswith("#"))
    assert word in table and jm.kana_to_ipa(word)


def test_kanji_readings_match_jax():
    for text in ("今日はいい天気です", "水を飲みます", "日本語", "発単"):
        assert jm.kanji_to_kana(text) == jax_jm.kanji_to_kana(text)
    assert jm.kanji_to_kana("日本語") == "にほんご"
    assert jm.kanji_to_kana("発単") == "はったん"
    ipa = jm.kana_to_ipa("私は学生です")
    assert ipa == jax_jm.kana_to_ipa("私は学生です")
    with pytest.raises(ValueError, match="kanji"):
        jm.kana_to_ipa("薔薇")


def test_external_dictionary_env_in_a_subprocess(tmp_path):
    """WHISPER_IPA_TPU_KANJI_DICT's entries load, in both packages (a
    subprocess: the table is module state)."""
    d = tmp_path / "kdict.tsv"
    d.write_text("薔薇\tばら\n# a comment\n", encoding="utf-8")
    code = (
        "import whisper_ipa_torch.data.prep.g2p.japanese as a\n"
        "import whisper_ipa_tpu.data.prep.g2p.japanese as b\n"
        "x, y = a.kana_to_ipa('薔薇'), b.kana_to_ipa('薔薇')\n"
        "assert x == y and 'bäɾä' in x, (x, y)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO_ROOT,
        env={**os.environ, "WHISPER_IPA_TPU_KANJI_DICT": str(d),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_derive_ja_readings_matches_jax(tmp_path):
    from whisper_ipa_tpu.data.prep.g2p import derive_ja_readings as jax_derive
    from whisper_ipa_torch.data.prep.g2p import derive_ja_readings as derive

    for ipa in ("ɡätsɯ", "ɲitɕi", "dʑɯː", "kjo̞ː", "ke̞ɴ", "tɕːɯː",
                "çiɾä", "ɕo̞ːɡäkːo̞ː"):
        kana = derive.ipa_to_kana(ipa)
        assert kana == jax_derive.ipa_to_kana(ipa)
        assert jm.kana_to_ipa(kana) == ipa

    entries = [
        {"sentence": "薔薇があります", "ipa_transcription":
         jm.kana_to_ipa("ばらがあります")},
        {"sentence": "薔薇と猫", "ipa_transcription":
         jm.kana_to_ipa("ばらとねこ")},
        {"sentence": "躑躅です", "ipa_transcription":
         jm.kana_to_ipa("つつじです")},
    ]
    data = tmp_path / "ja.json"
    data.write_text(json.dumps(entries, ensure_ascii=False), "utf-8")
    saved = {m: (dict(m.KANJI_READINGS), m._kanji_dict_loaded)
             for m in (jm, jax_jm)}
    try:
        quiet(derive.main, ["--data-json", str(data), "--out",
                            str(tmp_path / "p.tsv")])
        quiet(jax_derive.main, ["--data-json", str(data), "--out",
                                str(tmp_path / "j.tsv")])
    finally:
        for m, (table, loaded) in saved.items():
            m.KANJI_READINGS.clear()
            m.KANJI_READINGS.update(table)
            m._kanji_dict_loaded = loaded
    ours = (tmp_path / "p.tsv").read_text("utf-8")
    assert ours == (tmp_path / "j.tsv").read_text("utf-8")
    assert "薔薇\tばら" in ours


def test_chip_smoke_fixture_matches_jax_and_its_prediction(tmp_path):
    """chip_smoke.phase_prep's CommonVoice fixture (the card's data
    preparation gate): the port's create_datasets writes the JAX package's
    files (pandas here), and the per-language counts equal the fixture's
    prediction."""
    sys.path.insert(0, REPO_ROOT)
    import chip_smoke

    predicted = {}
    for k, lang in enumerate(chip_smoke.PREP_LANGS):
        rows = chip_smoke.write_cv_fixture(str(tmp_path / "cv"), lang, 900 + k)
        predicted[lang] = [chip_smoke.prep_prediction(lang, rows, n)
                           for _, n, _ in chip_smoke.PREP_SPLITS]
    kw = dict(languages=chip_smoke.PREP_LANGS, train_n=8, val_n=4, test_n=2)
    quiet(preprocess.create_datasets, tmp_path / "cv", tmp_path / "p", **kw)
    quiet(jax_preprocess.create_datasets, tmp_path / "cv", tmp_path / "j", **kw)
    got = {lang: [0, 0, 0] for lang in chip_smoke.PREP_LANGS}
    for i, (_, _, name) in enumerate(chip_smoke.PREP_SPLITS):
        ours = (tmp_path / "p" / name).read_bytes()
        assert ours == (tmp_path / "j" / name).read_bytes(), name
        for e in json.loads(ours):
            got[e["locale"]][i] += 1
    assert got == predicted
    assert predicted["ta"] != predicted["fi"]  # the ச row was drawn
