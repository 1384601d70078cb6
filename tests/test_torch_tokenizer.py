"""The port's Whisper tiktoken tokenizer against the JAX package's.

The port has three paths, the first that imports: tiktoken, the
pure-Python BPE with PAT_STR in the `regex` package, and the same BPE
with the stdlib scanner `split_pieces`. The JAX package has the first
two. Here both `tiktoken` and `regex` import, so each path is forced by
hiding modules from the import system (sys.modules[name] = None), in
both packages alike. Every comparison is exact: token ids, decoded
text, pieces.
"""
import base64
import sys
import unicodedata

import numpy as np
import pytest
import regex

from minimax_speech_torch.infer import frontend as t_fe
from minimax_speech_torch.infer import whisper_tokenizer as t_wt
from minimax_speech_tpu.infer import frontend as j_fe
from minimax_speech_tpu.infer import whisper_tokenizer as j_wt

# tiktoken's path, the regex fallback, the stdlib scanner: the modules
# each hides
PATHS = {"tiktoken": (), "regex": ("tiktoken",),
         "stdlib": ("tiktoken", "regex")}
CORPUS = [
    "hello world", "hello<|endoftext|> world", "h\u00e9llo!", "a b  c\nhello",
    "\u4f60\u597d\uff0c\u4e16\u754c\u3002\u4e2d\u6587English",
    "emoji \U0001f600\U0001f44d\U0001f3fd ZWJ "
    "\U0001f468\u200d\U0001f469\u200d\U0001f467",
    "\u00bd \u00b2 \u216b \u00b3\u2044\u2084 1/2 \u0663 \u096f 12,345.67",
    "e\u0301 n\u0303 a\u0308b Z\u0351\u036b",
    "tabs\t\there   three spaces\n\n\nnewlines \u3000wide\u00a0nbsp",
    "it's we're they've I'm you'll he'd don't 'S 'quoted' ''s",
    "  leading and trailing  ", " \n x", " line para\x85next\u2028",
    "!!!??? ... --- *** ###", " '", "x's 's", "",
    "".join(t_wt.special_token_list()),
    "<|zh|><|TTS/B|>\u4f60\u597d<|30.00|><|endoftext|>",
]


def _asset(path):
    """256 byte tokens and merges over ASCII words, a contraction and
    multi-byte characters; each merge splits into two earlier tokens."""
    ranks = {bytes([i]): i for i in range(256)}
    merges = [b"he", b"ll", b"llo", b"hello", b" w", b" wo", b" wor",
              b" worl", b" world", b"'s", b" t", b" th", b"th",
              "\u4e2d".encode()[:2], "\u4e2d".encode(),
              "\u4f60".encode()[:2], "\u4f60".encode(), "\u00bd".encode(),
              b"\n\n"]
    for i, m in enumerate(merges):
        ranks[m] = 256 + i
    with open(path, "w") as f:
        for token, rank in ranks.items():
            f.write(base64.b64encode(token).decode() + " " + str(rank) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def asset(tmp_path_factory):
    return _asset(tmp_path_factory.mktemp("tok") / "tiny.tiktoken")


def _hide(monkeypatch, names):
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def _jax_pair(monkeypatch, asset):
    """JAX's tokenizer on its tiktoken path and on its regex fallback."""
    fast = j_wt.WhisperTikTokenizer(asset)
    with monkeypatch.context() as m:
        _hide(m, ("tiktoken",))
        slow = j_wt.WhisperTikTokenizer(asset)
    assert fast._enc is not None and slow._enc is None
    return fast, slow


def _build(monkeypatch, path, asset):
    """The port's tokenizer on `path`."""
    with monkeypatch.context() as m:
        _hide(m, PATHS[path])
        tok = t_wt.WhisperTikTokenizer(asset)
    assert (tok._enc is None) == (path != "tiktoken")
    assert (path == "stdlib") == (tok._enc is None
                                  and tok._split is t_wt.split_pieces)
    return tok


@pytest.mark.parametrize("path", list(PATHS))
def test_encode_decode_match_jax(monkeypatch, asset, path):
    """Each port path against JAX's tiktoken path and against JAX's
    fallback: ids and both decodes identical over the corpus."""
    ours = _build(monkeypatch, path, asset)
    ref_fast, ref_slow = _jax_pair(monkeypatch, asset)
    assert ours.special_tokens == ref_fast.special_tokens
    assert ours.vocab_size == ref_fast.vocab_size
    for text in CORPUS:
        ids = ours.encode(text)
        assert ids == ref_fast.encode(text) == ref_slow.encode(text), text
        for skip in (True, False):
            assert ours.decode(ids, skip_special=skip) \
                == ref_fast.decode(ids, skip_special=skip), text
        assert ours.decode(ids, skip_special=False) == text


@pytest.mark.parametrize("path", list(PATHS))
def test_allowed_special_false_as_jax(monkeypatch, asset, path):
    """allowed_special false on a text that holds a special token: the
    tiktoken path raises in both packages, the fallbacks encode it as
    special in both (ROADMAP.md section 3, kept for parity)."""
    ours = _build(monkeypatch, path, asset)
    ref = _jax_pair(monkeypatch, asset)[path != "tiktoken"]
    text = "a<|endoftext|>b"
    plain = ours.encode("plain text", allowed_special=False)
    assert plain == ref.encode("plain text", allowed_special=False)
    if path == "tiktoken":
        for tok in (ours, ref):
            with pytest.raises(ValueError):
                tok.encode(text, allowed_special=False)
    else:
        ids = ours.encode(text, allowed_special=False)
        assert ids == ref.encode(text, allowed_special=False)
        assert ours.special_tokens["<|endoftext|>"] in ids


def test_split_pieces_equals_regex_findall():
    """The stdlib scanner against regex.findall(PAT_STR): the corpus, and
    12k random strings over the characters PAT_STR tells apart."""
    pat = regex.compile(t_wt.PAT_STR)
    for text in CORPUS:
        assert t_wt.split_pieces(text) == pat.findall(text), text
    alphabet = ["a", "Z", "\u00e9", "\u4e2d", " ", "  ", "\n", "\t",
                "\u3000", "\u00a0", "\x1c", "'", "s", "re", "ll", "1",
                "\u00bd", "\u00b2", "\u216b", "\U0001f600", "!", ".", "-",
                "\u0301", "\u200b", "\u2028"]
    rng = np.random.default_rng(0)
    for _ in range(12000):
        text = "".join(rng.choice(alphabet, rng.integers(0, 12)))
        assert t_wt.split_pieces(text) == pat.findall(text), repr(text)


def test_character_classes_equal_regex():
    """Every code point this Python's unicodedata assigns: the scanner's
    class (White_Space, \\p{L}, \\p{N}, the rest) is regex's."""
    cls = [(k, regex.compile(p)) for k, p in
           (("s", r"\s"), ("L", r"\p{L}"), ("N", r"\p{N}"))]
    bad = []
    for cp in range(0x110000):
        ch = chr(cp)
        if unicodedata.category(ch) == "Cn":
            continue
        want = next((k for k, p in cls if p.match(ch)), "o")
        if t_wt._kind(ch) != want:
            bad.append(hex(cp))
    assert not bad, bad[:20]


@pytest.mark.parametrize("path", list(PATHS))
def test_get_tokenizer_and_frontend(monkeypatch, asset, path, tmp_path):
    """get_tokenizer and Frontend on a .tiktoken path in each path, as
    JAX's; a directory with no Qwen2 tokenizer files raises, naming
    them."""
    ref = j_fe.Frontend(asset)
    _hide(monkeypatch, PATHS[path])
    tok = t_fe.get_tokenizer(asset)
    assert isinstance(tok, t_wt.WhisperTikTokenizer)
    assert (tok._enc is None) == (path != "tiktoken")
    ours = t_fe.Frontend(asset)
    for text in ("Hello world. It's a test!",
                 "\u4f60\u597d\uff0c\u4e16\u754c\u3002"):
        assert ours.text_normalize(text) == ref.text_normalize(text)
        for piece in ours.text_normalize(text):
            np.testing.assert_array_equal(ours.extract_text_tokens(piece),
                                          ref.extract_text_tokens(piece))
    with pytest.raises(FileNotFoundError, match="tokenizer_config.json"):
        t_fe.get_tokenizer(str(tmp_path))
