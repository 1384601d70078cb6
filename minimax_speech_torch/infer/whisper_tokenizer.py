"""Whisper-style tiktoken tokenizer with the TTS special tokens.

Port of minimax_speech_tpu/infer/whisper_tokenizer.py: a byte-level BPE
over a `.tiktoken` asset (base64 token and rank per line), extended with
the whisper language, audio-event, emotion and TTS-vocal special tokens
and 1501 timestamp tokens.

Three ways to split and merge, the first that imports:
  1. the `tiktoken` package (the JAX package's first choice too);
  2. the pure-Python BPE with PAT_STR compiled by the `regex` package
     (the JAX package's fallback);
  3. the same BPE with `split_pieces`, a scanner over
     `unicodedata.category` that gives `regex`'s pieces of PAT_STR with
     the standard library alone (the stdlib `re` has no \\p{L} or \\p{N},
     and its \\d and \\w do not cover \\p{N}).

Paths 1 and 2 differ where `allowed_special` is false and the text holds
a special token: tiktoken raises (its default `disallowed_special`), the
fallback encodes the token as special. Each is kept as the JAX package
has it; path 3 follows path 2.
"""
from __future__ import annotations

import base64
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List

LANGUAGES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue", "minnan", "wuyu", "dialect", "zh/en", "en/zh"]
AUDIO_EVENTS = ["ASR", "AED", "SER", "Speech", "/Speech", "BGM", "/BGM",
                "Laughter", "/Laughter", "Applause", "/Applause"]
EMOTIONS = ["HAPPY", "SAD", "ANGRY", "NEUTRAL"]
TTS_VOCAL = (["TTS/B", "TTS/O", "TTS/Q", "TTS/A", "TTS/CO", "TTS/CL",
              "TTS/H"] + [f"TTS/SP{i:02d}" for i in range(1, 14)])

PAT_STR = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
           r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")

# Unicode's White_Space property: what `regex` and tiktoken take as \s
# (str.isspace also counts U+001C-U+001F).
WHITE_SPACE = frozenset(
    "\t\n\v\f\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def special_token_list(num_languages: int = 99) -> List[str]:
    return (["<|endoftext|>", "<|startoftranscript|>"]
            + [f"<|{lang}|>" for lang in LANGUAGES[:num_languages]]
            + [f"<|{ev}|>" for ev in AUDIO_EVENTS]
            + [f"<|{em}|>" for em in EMOTIONS]
            + ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
               "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"]
            + [f"<|SPECIAL_TOKEN_{i}|>" for i in range(1, 31)]
            + [f"<|{t}|>" for t in TTS_VOCAL]
            + [f"<|{i * 0.02:.2f}|>" for i in range(1501)])


def load_ranks(asset_path: str) -> Dict[bytes, int]:
    """Parse a .tiktoken asset: 'base64token rank' per line."""
    ranks = {}
    with open(asset_path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token, rank = line.split()
            ranks[base64.b64decode(token)] = int(rank)
    return ranks


def _bpe_merge(ranks: Dict[bytes, int], piece: bytes) -> List[int]:
    """Byte-pair merge by ascending rank (tiktoken's semantics)."""
    parts = [piece[i: i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best, best_rank = None, None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best, best_rank = i, r
        if best is None:
            break
        parts = (parts[:best] + [parts[best] + parts[best + 1]]
                 + parts[best + 2:])
    out = []
    for p in parts:
        if p in ranks:
            out.append(ranks[p])
        else:  # unmergeable byte sequence: one id per byte
            out.extend(ranks.get(p[i: i + 1], 0) for i in range(len(p)))
    return out


def _kind(ch: str) -> str:
    """'s' (White_Space), 'L' (\\p{L}), 'N' (\\p{N}) or 'o' (the rest)."""
    if ch in WHITE_SPACE:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


def split_pieces(text: str) -> List[str]:
    """`regex.findall(PAT_STR, text)` with the standard library: at each
    position the first alternative of PAT_STR that matches, as the
    regex engine tries them."""
    kinds = [_kind(c) for c in text]
    n, out, i = len(text), [], 0

    def run(j, k):  # end of the run of kind k from j
        while j < n and kinds[j] == k:
            j += 1
        return j

    while i < n:
        if text[i] == "'":
            c = next((c for c in CONTRACTIONS
                      if text.startswith(c, i + 1)), None)
            if c is not None:
                out.append(text[i: i + 1 + len(c)])
                i += 1 + len(c)
                continue
        k = kinds[i]
        if text[i] == " " and i + 1 < n and kinds[i + 1] != "s":
            # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+' with the space
            j = run(i + 1, kinds[i + 1])
        elif k != "s":
            j = run(i, k)
        else:
            j = run(i, "s")
            # '\s+(?!\S)' backs off one so the next piece takes its space;
            # a run of one before a non-space falls to '\s+'
            if j < n and j - i > 1:
                j -= 1
        out.append(text[i:j])
        i = j
    return out


class WhisperTikTokenizer:
    """Byte-level BPE and the special tokens. encode's allowed_special
    "all" (truthy) encodes special tokens as such."""

    def __init__(self, asset_path: str, num_languages: int = 99):
        self.ranks = load_ranks(asset_path)
        n = len(self.ranks)
        self.special_tokens = {t: n + i for i, t in
                               enumerate(special_token_list(num_languages))}
        self.vocab_size = n + len(self.special_tokens)
        self._decode_map = {v: k for k, v in self.ranks.items()}
        self._special_by_id = {v: k for k, v in self.special_tokens.items()}
        try:
            import tiktoken
            self._enc = tiktoken.Encoding(
                name="whisper_tts", explicit_n_vocab=self.vocab_size,
                pat_str=PAT_STR, mergeable_ranks=self.ranks,
                special_tokens=self.special_tokens)
        except Exception:  # noqa: BLE001 - no tiktoken: the BPE below
            self._enc = None
            try:
                import regex
                self._split = regex.compile(PAT_STR).findall
            except ImportError:
                self._split = split_pieces
            self._special_pat = re.compile("|".join(
                re.escape(t) for t in sorted(self.special_tokens,
                                             key=len, reverse=True)))
            # a cache of this instance's pieces, gone with the instance
            self._encode_piece = lru_cache(maxsize=4096)(self._merge_piece)

    def _merge_piece(self, piece: str) -> tuple:
        b = piece.encode("utf-8")
        if b in self.ranks:
            return (self.ranks[b],)
        return tuple(_bpe_merge(self.ranks, b))

    def encode(self, text: str, allowed_special="all") -> List[int]:
        if self._enc is not None:
            return self._enc.encode(text, allowed_special="all"
                                    if allowed_special else set())
        out: List[int] = []
        pos = 0
        for m in self._special_pat.finditer(text):
            out.extend(self._encode_ordinary(text[pos: m.start()]))
            out.append(self.special_tokens[m.group(0)])
            pos = m.end()
        out.extend(self._encode_ordinary(text[pos:]))
        return out

    def _encode_ordinary(self, text: str) -> List[int]:
        out: List[int] = []
        for piece in self._split(text):
            out.extend(self._encode_piece(piece))
        return out

    def decode(self, ids, skip_special: bool = True) -> str:
        if self._enc is not None and not skip_special:
            return self._enc.decode(list(ids))
        chunks = []
        for i in ids:
            if i in self._special_by_id:
                if not skip_special:
                    chunks.append(self._special_by_id[i].encode())
            else:
                chunks.append(self._decode_map.get(i, b""))
        return b"".join(chunks).decode("utf-8", "replace")
