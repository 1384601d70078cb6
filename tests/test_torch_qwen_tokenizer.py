"""The port's QwenTokenizer against the JAX package's.

The JAX package's QwenTokenizer is transformers' AutoTokenizer on a
Hugging Face Qwen2 directory with the TTS special tokens added; the
port's reads the same directory with the standard library alone
(minimax_speech_torch/infer/qwen_tokenizer.py). Both read directories
written here, offline: a handwritten table (merges out of rank order,
one token made by two merges, a byte missing, added tokens of every
kind) and a seeded one of 20,000 merges (chip_smoke.write_qwen2_dir),
each in the tokenizer.json layout and in vocab.json + merges.txt. The
port splits with `regex` where it imports, else with split_qwen2; each
path is forced by hiding `regex` from the import system. Every
comparison is exact: ids, decoded text, pieces, special-token ids.

The fuzz draws characters Python's Unicode database assigns (Cn and Cs
left out): the port classes characters by that database (Unicode 15.0
on Python 3.12), `tokenizers` by its own, newer one, so a character
assigned since splits differently (the module's docstring says so).
"""
import json
import sys

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from minimax_speech_torch import config as t_cfg
from minimax_speech_torch.cli import serve as t_serve
from minimax_speech_torch.cli import synthesize as t_cli
from minimax_speech_torch.data import pipeline as t_dp
from minimax_speech_torch.infer import api as t_api
from minimax_speech_torch.infer import frontend as t_fe
from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.infer import qwen_tokenizer as t_qt
from minimax_speech_tpu.data import pipeline as j_dp
from minimax_speech_tpu.infer import frontend as j_fe
from tests.conftest import synthetic_audio
from tests import torch_cpu

pytest.importorskip("transformers")  # the JAX package's QwenTokenizer
torch_cpu.share_cores()

TINY = "configs/tiny.yaml"
SPECIALS = ["<|endoftext|>"] + t_qt.SPECIAL_TOKENS
ENC = t_qt.bytes_to_unicode()
CASES = [
    "", "hello world", "Hello World, hello world!", " hello  world ",
    "it's IT'S It'S we'RE they'Ve I'M you'LL he'D don't 's 'ſ 'K 'x",
    "12345 3.14 1,000,000 ½ ² Ⅻ ٣٤ x2y",
    "你好，世界。今天天气很"
    "不错！你好你好",
    "こんにちは、世界。カタ"
    "カナ",
    "\U0001f642\U0001f44d\U0001f3fd \U0001f468‍\U0001f469‍"
    "\U0001f467 ❤️",
    "café café é ñ Å Z͑ͫ 가",
    "a\r\n\r\nb\n\n\nc\r\rd \n x\n", "  lead  inner   trail  ",
    "\tx\t\ty \t\n　z w v\x85u",
    "abc xabc abcabc aabcc  abc abcd", "pizza zz z", "[mm] [mm]x x[mm]",
    "!!!??? ... --- *** ### (hello) \"hi\"",
    "<|endoftext|>", "<|im_start|><|im_end|><|endofprompt|>",
    "hello[breath]world", "x<|endofprompt|>y", "<|IM_START|> [Breath]",
    "<laughter>ha</laughter> <strong>loud</strong>[sigh][mm]",
    "A<|im_start|> [breath]b", "<tool>call</tool><tool>",
    "café café héllo wörld héllo wörldx",
    "<|endoftext|" "|>", "[vocalized-noise][quick_breath][clucking]",
    "".join(SPECIALS), "a<|extra|>b",
]


def _b2s(text: str) -> str:
    return "".join(ENC[b] for b in text.encode("utf-8"))


def _hand_table():
    """Bytes (all but 'z'), then merges: some out of rank order, "abc"
    from two pairs, digits and contractions, Chinese characters, runs of
    white space and "[mm]" as a regular token."""
    toks = [ENC[b] for b in range(256) if b != ord("z")]
    merges = [("abc", "abc"), ("h", "e"), ("l", "l"), ("he", "ll"),
              ("hell", "o"), ("Ġ", "w"), ("o", "r"), ("Ġw", "or"),
              ("l", "d"), ("Ġwor", "ld"), ("b", "c"), ("a", "b"),
              ("ab", "c"), ("a", "bc"), ("Ġ", "a"), ("Ġa", "bc"),
              ("'", "s"), ("r", "e"), ("'", "re"), ("1", "2"), ("Ġ", "Ġ"),
              ("ĠĠ", "Ġ"), ("Ċ", "Ċ"), ("č", "Ċ"), ("[", "m"), ("[m", "m"),
              ("[mm", "]"), ("Ġ", "h"), ("Ġh", "ello"), ("e", "llo"),
              ("ll", "o"), ("H", "ello")]
    for ch in "你好世界":
        s = _b2s(ch)
        merges += [(s[0], s[1]), (s[:2], s[2])]
    merges.append((_b2s("你"), _b2s("好")))
    for a, b in merges:
        toks += [t for t in (a, b, a + b) if t not in toks]
    return {t: i for i, t in enumerate(toks)}, merges


HAND_ADDED = [  # (content, special, normalized)
    ("<|endoftext|>", True, False), ("<tool>", False, False),
    ("<|im_start|>", True, False), ("café", False, True),
    ("[breath]", False, True), ("héllo wörld", False, False)]


def _write(root, vocab, merges, added, layout, cfg_extra=None,
           json_extra=None):
    """A Qwen2 directory of the given table in `layout`, the added tokens
    in tokenizer.json (that layout) and in tokenizer_config.json."""
    root.mkdir(parents=True, exist_ok=True)
    entries = [{"id": len(vocab) + i, "content": c, "single_word": False,
                "lstrip": False, "rstrip": False, "normalized": n,
                "special": s} for i, (c, s, n) in enumerate(added)]
    cfg = {"tokenizer_class": "Qwen2Tokenizer",
           "added_tokens_decoder": {str(e["id"]): {
               k: v for k, v in e.items() if k != "id"} for e in entries},
           "bos_token": None, "eos_token": "<|endoftext|>",
           "pad_token": "<|endoftext|>", "unk_token": None,
           "additional_special_tokens": ["<|im_start|>", "<|extra|>"],
           "clean_up_tokenization_spaces": False,
           "model_max_length": 32768, "split_special_tokens": False}
    cfg.update(cfg_extra or {})
    (root / "tokenizer_config.json").write_text(json.dumps(cfg))
    if layout == "vocab":
        (root / "vocab.json").write_text(json.dumps(vocab))
        (root / "merges.txt").write_text(
            "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
        return root
    bl = {"type": "ByteLevel", "add_prefix_space": False,
          "trim_offsets": False, "use_regex": False}
    tj = {"version": "1.0", "truncation": None, "padding": None,
          "added_tokens": entries, "normalizer": {"type": "NFC"},
          "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
              {"type": "Split", "pattern": {"Regex": t_qt.QWEN2_PAT},
               "behavior": "Isolated", "invert": False}, bl]},
          "post_processor": bl, "decoder": bl,
          "model": {"type": "BPE", "dropout": None, "unk_token": None,
                    "continuing_subword_prefix": "",
                    "end_of_word_suffix": "", "fuse_unk": False,
                    "byte_fallback": False, "ignore_merges": False,
                    "vocab": vocab,
                    "merges": [f"{a} {b}" for a, b in merges]}}
    for key, value in (json_extra or {}).items():
        node = tj
        *path, last = key.split(".")
        for p in path:
            node = node[int(p) if isinstance(node, list) else p]
        node[int(last) if isinstance(node, list) else last] = value
    (root / "tokenizer.json").write_text(json.dumps(tj))
    return root


TABLES = ["hand", "hand_clean", "seeded"]
LAYOUTS = ["tokenizer.json", "vocab"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{(table, layout): directory}, written once."""
    root = tmp_path_factory.mktemp("qwen")
    vocab, merges = _hand_table()
    out = {}
    for layout in LAYOUTS:
        out["hand", layout] = _write(root / f"hand_{layout}", vocab, merges,
                                     HAND_ADDED, layout)
        out["hand_clean", layout] = _write(
            root / f"clean_{layout}", vocab, merges, HAND_ADDED, layout,
            {"clean_up_tokenization_spaces": True})
        out["seeded", layout] = chip_smoke.write_qwen2_dir(
            root / f"seeded_{layout}", 256 + 20000, seed=1, layout=layout)
    return out


_REFS = {}


def _ref(d):
    """The JAX package's QwenTokenizer on directory d, built once."""
    if str(d) not in _REFS:
        _REFS[str(d)] = j_fe.QwenTokenizer(str(d))
    return _REFS[str(d)]


def _port(monkeypatch, d, path):
    with monkeypatch.context() as m:
        if path == "stdlib":
            m.setitem(sys.modules, "regex", None)
        tok = t_qt.QwenTokenizer(str(d))
    assert (tok._split is t_qt.split_qwen2) == (path == "stdlib")
    return tok


def _same(ours, ref, text):
    ids = ours.encode(text)
    assert ids == ref.encode(text), text
    assert ours.decode(ids) == ref.decode(ids), text
    return ids


@pytest.mark.parametrize("path", ["regex", "stdlib"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("table", TABLES)
def test_encode_decode_match_jax(monkeypatch, dirs, table, layout, path):
    """encode and decode over CASES and over seeded id lists (special and
    unknown ids among them) equal the JAX package's."""
    d = dirs[table, layout]
    ours, ref = _port(monkeypatch, d, path), _ref(d)
    for text in CASES:
        _same(ours, ref, text)
    rng = np.random.default_rng(7)
    for n in (1, 3, 8, 40):
        ids = rng.integers(0, ours.vocab_size + 3, n).tolist()
        assert ours.decode(ids) == ref.decode(ids), ids
    if table != "seeded":
        long = [i for t in CASES for i in ours.encode(t)]
        assert max(long) >= 256 and any(i > 300 for i in long)


FRAGMENTS = SPECIALS + [
    "<|", "|>", "[", "]", "'s", "'RE", "'ll", " ", "  ", "\r\n", "\n", "\t",
    "́", "̈", "abc", "hello", " world", "你好", "12",
    "café", "héllo wörld", "<tool>", "　", "\x85"]
TEXT = st.lists(st.one_of(
    st.text(st.characters(exclude_categories=("Cs", "Cn")), max_size=10),
    st.sampled_from(FRAGMENTS)), max_size=10).map("".join)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("table", ["hand", "seeded"])
def test_fuzz_matches_jax(dirs, table, layout):
    """A derandomized fuzz: the port's stdlib path (regex hidden) and
    the JAX package's agree on encode, decode and decode of drawn ids."""
    d = dirs[table, layout]
    saved = sys.modules.get("regex")
    sys.modules["regex"] = None
    try:
        ours = t_qt.QwenTokenizer(str(d))
    finally:
        sys.modules["regex"] = saved
    ref = _ref(d)

    @settings(max_examples=150, derandomize=True, deadline=None,
              database=None)
    @given(TEXT, st.lists(st.integers(0, ours.vocab_size + 2), max_size=12))
    def check(text, ids):
        _same(ours, ref, text)
        assert ours.decode(ids) == ref.decode(ids), ids
    check()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("table", ["hand", "seeded"])
def test_special_token_ids(dirs, table, layout):
    """Every special token's id is transformers'
    convert_tokens_to_ids: a token in the table keeps its id ("[mm]" in
    the handwritten table), new ones follow the last id in order."""
    d = dirs[table, layout]
    ours, ref = t_qt.QwenTokenizer(str(d)), _ref(d)
    for t in SPECIALS + [c for c, _, _ in HAND_ADDED] + ["<|extra|>"]:
        want = ref.tokenizer.convert_tokens_to_ids(t)
        if t in ours.added:
            assert ours.added[t] == want, t
        else:
            assert table == "seeded" and t not in ref.tokenizer.get_vocab()
    assert ours.vocab_size == len(ref.tokenizer)
    if table == "hand":
        assert ours.added["[mm]"] == ours.vocab["[mm]"] < 256 + 60
    else:
        assert [ours.added[t] for t in SPECIALS[:3]] == [20256, 20257,
                                                         20258]


@given(st.lists(st.one_of(
    st.text(st.characters(exclude_categories=("Cs", "Cn")), max_size=8),
    st.sampled_from(FRAGMENTS)), max_size=12).map("".join))
@settings(max_examples=400, derandomize=True, deadline=None, database=None)
def test_split_qwen2_matches_regex(text):
    """The stdlib scanner gives regex.findall's pieces of QWEN2_PAT."""
    assert t_qt.split_qwen2(text) == regex.findall(t_qt.QWEN2_PAT, text)


def test_split_qwen2_cases():
    pat = regex.compile(t_qt.QWEN2_PAT)
    for text in CASES + ["'ſ", "'S'T'RE'VE'M'LL'D", "K'K"]:
        assert t_qt.split_qwen2(text) == pat.findall(text), text
    assert t_qt.split_qwen2("I'M 2024 ok!\n\n x") == [
        "I", "'M", " ", "2", "0", "2", "4", " ok", "!\n\n", " x"]


def test_bytes_to_unicode_is_gpt2s():
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode
    assert t_qt.bytes_to_unicode() == bytes_to_unicode()


@pytest.mark.parametrize("path", ["regex", "stdlib"])
def test_frontend_matches_jax(monkeypatch, dirs, path):
    """get_tokenizer(dir) is the port's QwenTokenizer; Frontend's
    text_normalize and extract_text_tokens give JAX's on English and
    Chinese paragraphs long enough to split."""
    d = str(dirs["seeded", "tokenizer.json"])
    ref = j_fe.Frontend(d)
    with monkeypatch.context() as m:
        if path == "stdlib":
            m.setitem(sys.modules, "regex", None)
        ours = t_fe.Frontend(d)
    assert isinstance(ours.tokenizer, t_fe.QwenTokenizer)
    assert t_fe.QwenTokenizer is t_qt.QwenTokenizer
    assert t_fe.SPECIAL_TOKENS == j_fe.SPECIAL_TOKENS
    en = " ".join(["Hello world, it's the quick brown fox over the lazy "
                   "dog; they're here."] * 12)
    zh = "你好世界，今天天气很不错。" * 12
    for text in (en, zh, "Hello<|im_start|> [breath] world 123."):
        pieces = ours.text_normalize(text)
        assert pieces == ref.text_normalize(text)
        assert len(pieces) > 1 or text not in (en, zh)
        for piece in pieces:
            np.testing.assert_array_equal(ours.extract_text_tokens(piece),
                                          ref.extract_text_tokens(piece))


def test_split_paragraph_comma_split():
    """split_paragraph's comma_split, as JAX's."""
    tok = t_fe.ByteTokenizer()
    for text, lang in (("one, two, three four five, six. seven", "en"),
                       ("你好，世界，再见"
                        "。你好", "zh")):
        for kw in ({"comma_split": True, "token_max_n": 8,
                    "token_min_n": 2, "merge_len": 1}, {}):
            assert t_fe.split_paragraph(text, tok.encode, lang, **kw) == \
                j_fe.split_paragraph(text, tok.encode, lang, **kw)


def test_pipeline_tokenize_matches_jax(dirs):
    """data/pipeline.tokenize (cli/train.py's text stage) gives JAX's
    text_token on a directory's tokenizer."""
    d = str(dirs["seeded", "vocab"])
    ours, ref = t_fe.get_tokenizer(d), j_fe.get_tokenizer(d)
    samples = [{"text": t} for t in CASES]
    got = list(t_dp.tokenize([dict(s) for s in samples], ours))
    want = list(j_dp.tokenize([dict(s) for s in samples], ref))
    assert len(got) == len(want) == len(samples)
    for a, b in zip(got, want):
        assert a["text_token"].dtype == b["text_token"].dtype
        np.testing.assert_array_equal(a["text_token"], b["text_token"])


BAD = {  # tokenizer.json field -> a value the port does not implement
    "normalizer": {"type": "NFKC"},
    "pre_tokenizer.pretokenizers.0.pattern": {"Regex": r"\s+|\S+"},
    "pre_tokenizer.pretokenizers.0.behavior": "Removed",
    "pre_tokenizer.pretokenizers.1.add_prefix_space": True,
    "model.ignore_merges": True, "model.byte_fallback": True,
    "model.unk_token": "<unk>", "model.dropout": 0.1,
    "model.continuing_subword_prefix": "##", "decoder": {"type": "BPE"},
    "post_processor": {"type": "TemplateProcessing"},
    "truncation": {"max_length": 8},
    "added_tokens.0.lstrip": True, "added_tokens.1.rstrip": True,
    "added_tokens.2.single_word": True,
}
BAD_CONFIG = {"tokenizer_class": "GPT2Tokenizer",
              "split_special_tokens": True, "add_prefix_space": True}


@pytest.mark.parametrize("field", list(BAD) + [f"config.{k}"
                                               for k in BAD_CONFIG])
def test_unimplemented_fields_raise(tmp_path, field):
    """A setting outside Qwen2's raises a ValueError naming its field."""
    vocab, merges = _hand_table()
    if field.startswith("config."):
        key = field.split(".", 1)[1]
        _write(tmp_path, vocab, merges, HAND_ADDED, "tokenizer.json",
               cfg_extra={key: BAD_CONFIG[key]})
    else:
        key = field
        _write(tmp_path, vocab, merges, HAND_ADDED, "tokenizer.json",
               json_extra={field: BAD[field]})
    name = key.split(".")[-1]
    with pytest.raises(ValueError, match=name):
        t_qt.QwenTokenizer(str(tmp_path))


def test_missing_files_and_bad_merges_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        t_fe.get_tokenizer(str(tmp_path))
    vocab, merges = _hand_table()
    d = _write(tmp_path / "v", vocab, merges, HAND_ADDED, "vocab")
    (d / "merges.txt").unlink()
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        t_qt.QwenTokenizer(str(d))
    d = _write(tmp_path / "m", vocab, merges + [("q", "Q")], HAND_ADDED,
               "vocab")
    with pytest.raises(ValueError, match="lacks"):
        t_qt.QwenTokenizer(str(d))
    d = _write(tmp_path / "legacy", vocab, merges, HAND_ADDED, "vocab")
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    del cfg["added_tokens_decoder"]
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    (d / "added_tokens.json").write_text("{}")
    with pytest.raises(ValueError, match="added_tokens_decoder"):
        t_qt.QwenTokenizer(str(d))


def test_chip_smoke_golden_ids(tmp_path):
    """chip_smoke.QWEN_GOLDEN is the hash of the ids the JAX package's
    QwenTokenizer (transformers) gives QWEN_GOLDEN_TEXTS on the table
    phase 50 writes, at Qwen2's size; the port's ids are the same."""
    d = chip_smoke.write_qwen2_dir(tmp_path / "full")
    ref = j_fe.QwenTokenizer(str(d))
    assert chip_smoke.qwen_ids_digest(ref.encode) == chip_smoke.QWEN_GOLDEN
    ours = t_qt.QwenTokenizer(str(d))
    assert len(ours.vocab) == chip_smoke.QWEN_REGULAR
    assert [ours.added[t] for t in chip_smoke.QWEN_ADDED] == [151643, 151644,
                                                              151645]
    assert ours.vocab_size == len(ref.tokenizer) == 151643 + len(SPECIALS)
    assert chip_smoke.qwen_ids_digest(ours.encode) == chip_smoke.QWEN_GOLDEN
    for text in chip_smoke.qwen_timing_texts(400).values():
        _same(ours, ref, text)


def _record_text_ids(monkeypatch):
    """The text ids each Frontend.extract_text_tokens call gives."""
    seen, real = [], t_fe.Frontend.extract_text_tokens

    def extract(self, text):
        out = real(self, text)
        seen.extend(out.tolist())
        return out
    monkeypatch.setattr(t_fe.Frontend, "extract_text_tokens", extract)
    return seen


def test_callers_take_a_directory(monkeypatch, dirs, tmp_path):
    """Every entry point with a tokenizer path runs with a Qwen2
    directory at configs/tiny.yaml on the CPU: cli/synthesize.py,
    TTS(pipeline=..., tokenizer_path=) zero-shot, cli/serve.py's server
    and cli/train.py's parser; the ids the LM is given are the
    tokenizer's (some above 256, all under the tiny LM's 512)."""
    d = str(dirs["hand", "tokenizer.json"])
    seen = _record_text_ids(monkeypatch)
    audio = t_cli.main(["--random_init", "--device", "cpu", "--config", TINY,
                        "--tokenizer_path", d, "--text", "hello world abc.",
                        "--out", str(tmp_path / "out.wav"), "--override",
                        "model.max_speech_tokens=12"])
    assert len(audio) > 0 and 256 < max(seen) < 512
    seen.clear()
    cfg = t_cfg.load_tts_config(TINY, ["model.max_speech_tokens=12"])
    tts = t_api.TTS(pipeline=t_pl.TTSPipeline.from_random(cfg,
                                                          device="cpu"),
                    tokenizer_path=d)
    assert isinstance(tts.frontend.tokenizer, t_qt.QwenTokenizer)
    prompt = synthetic_audio(np.random.default_rng(3), 0.5, 16000)
    out = list(tts.inference_zero_shot("hello world [breath] abc.",
                                       "hello", prompt))
    assert out and all(np.isfinite(o["tts_speech"]).all() for o in out)
    assert 256 < max(seen) < 512
    httpd, server, _ = t_serve.build_server(t_serve.parse_args(
        ["--random_init", "--config", TINY, "--device", "cpu", "--port",
         "0", "--no_warm", "--tokenizer_path", d]))
    try:
        assert isinstance(server.tts.frontend.tokenizer, t_qt.QwenTokenizer)
    finally:
        httpd.server_close()
        server.close()
    from minimax_speech_torch.cli import train as t_train
    args = t_train.parse_args(["--model", "llm", "--tokenizer_path", d,
                               "--train_data", "x", "--model_dir", "y"])
    assert isinstance(t_fe.get_tokenizer(args.tokenizer_path),
                      t_qt.QwenTokenizer)



def test_chip_smoke_phase_50_on_the_cpu():
    """chip_smoke.py's phase 50 at configs/tiny.yaml on the CPU (a
    400-id table, so its ids fit the tiny LM; no golden hash): TTS
    zero-shot and cli/synthesize.py in a subprocess, the LM's text ids
    checked; the kernels' counters stay 0 on the CPU."""
    rec = chip_smoke.qwen_text_phase("cpu", device="cpu", config=TINY,
                                     lm_layers=2, max_tokens=12,
                                     n_regular=400, golden=False)
    assert rec["launches"] == {"qwen_text_zero_shot": 0,
                               "qwen_text_synth_cli": 0}
    assert set(rec["chars_per_s"]) == {"english", "chinese", "mixed"}



def test_characters_newer_than_pythons_unicode(monkeypatch, tmp_path):
    """U+1C89 (Unicode 16.0, a letter) is unassigned in Python 3.12's
    database; infer/qwen_unicode.py's table makes the stdlib splitter
    take it for a letter, as tokenizers (and the regex package) do:
    "a\u1c89b" is one piece on every path, and with a merge of "a" and
    U+1C89 in the table the ids agree with transformers'."""
    import unicodedata
    text = "a\u1c89b"
    assert unicodedata.category(text[1]) == "Cn"
    assert t_qt.split_qwen2(text) == [text]
    assert regex.findall(t_qt.QWEN2_PAT, text) == [text]
    vocab, merges = _hand_table()
    s = _b2s(text[1])
    merges += [(s[0], s[1]), (s[:2], s[2]), ("a", s)]
    for t in (s[:2], s, "a" + s):
        vocab.setdefault(t, len(vocab))
    d = _write(tmp_path, vocab, merges, HAND_ADDED, "tokenizer.json")
    ref = _ref(d).encode(text)
    assert ref == [vocab["a" + s], vocab["b"]]
    assert _port(monkeypatch, d, "stdlib").encode(text) == ref
    assert _port(monkeypatch, d, "regex").encode(text) == ref


def derive_kind_ranges():
    """infer/qwen_unicode.py's KIND_RANGES, derived from `tokenizers`:
    every code point but the surrogates, in chunks, through Split
    pre-tokenizers on \\s, \\p{L} and \\p{N} (Oniguruma, as the Qwen2
    pre-tokenizer's QWEN2_PAT) with the matches removed; a code point
    whose class there (white space first, as `_kind` tests) differs from
    `_kind`'s joins the table, as runs of one class."""
    from tokenizers import Regex, pre_tokenizers

    from minimax_speech_torch.infer.whisper_tokenizer import _kind

    probes = [(k, pre_tokenizers.Split(Regex(p), behavior="removed"))
              for k, p in (("s", r"\s"), ("L", r"\p{L}"), ("N", r"\p{N}"))]
    points = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
    ranges = []
    for i in range(0, len(points), 4096):
        chunk = "".join(map(chr, points[i: i + 4096]))
        kind = {}
        for k, probe in probes:
            kept = set("".join(p for p, _ in probe.pre_tokenize_str(chunk)))
            for ch in chunk:
                if ch not in kept:
                    kind.setdefault(ch, k)
        for ch in chunk:
            k, cp = kind.get(ch, "o"), ord(ch)
            if k == _kind(ch):
                continue
            if ranges and ranges[-1][1] == cp - 1 and ranges[-1][2] == k:
                ranges[-1] = (ranges[-1][0], cp, k)
            else:
                ranges.append((cp, cp, k))
    return tuple(ranges)


def test_qwen_unicode_table_matches_tokenizers():
    """The committed table equals a fresh derivation from the installed
    tokenizers (skips where it does not import); split_qwen2 then gives
    the regex package's pieces on a text of every code point the table
    names, between ASCII letters, digits and spaces."""
    pytest.importorskip("tokenizers")
    from minimax_speech_torch.infer import qwen_unicode

    assert derive_kind_ranges() == qwen_unicode.KIND_RANGES
    chars = [chr(c) for a, b, _ in qwen_unicode.KIND_RANGES
             for c in range(a, b + 1, max(1, (b - a) // 7))]
    text = "".join(f"{c}x1 {c}{c}" for c in chars)
    assert t_qt.split_qwen2(text) == regex.findall(t_qt.QWEN2_PAT, text)
