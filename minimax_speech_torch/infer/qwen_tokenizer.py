"""Qwen2's byte-level BPE tokenizer from a Hugging Face directory, with
the standard library alone (no `transformers`, no `tokenizers`).

It gives the ids and text that `AutoTokenizer.from_pretrained(dir)`
(Qwen2TokenizerFast) gives for a Qwen2 directory:
  * added tokens are cut out of the text first, leftmost-longest: those
    with `normalized: false` on the raw text, the others on the NFC text;
  * the rest is NFC-normalized, split by QWEN2_PAT (each match a piece),
    mapped byte by byte through GPT-2's byte-to-unicode table, and each
    piece merged by BPE: the adjacent pair of lowest merge rank first, as
    the `tokenizers` word merge does it (`bpe_merge`); a character the
    vocabulary lacks is dropped (no unknown token, no byte fallback);
  * decoding maps each token back to its bytes (a token with a character
    outside the table gives its own UTF-8) and decodes with "replace".
A token added to a table that already holds it keeps its id; a new one
takes the next id after the last (`_add`), as `tokenizers` numbers them.

The directory holds `tokenizer_config.json` and either `tokenizer.json`
(read first, as `AutoTokenizer` does) or `vocab.json` + `merges.txt`.
Any setting this module does not implement raises a ValueError naming
it, so a near match is never given in silence.

Splitting takes the `regex` package with QWEN2_PAT where it imports, else
`split_qwen2`, a scanner over `unicodedata` that gives regex's pieces.
Both class characters by the Unicode database of their own build; the
scanner's is Python's (Unicode 15.0 on Python 3.12), so a character
assigned after it splits as punctuation where `tokenizers` may see a
letter or a digit.
"""
from __future__ import annotations

import heapq
import json
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from minimax_speech_torch.infer.whisper_tokenizer import _kind

QWEN2_PAT = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"""
             r"""|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""")
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
QWEN2_CLASSES = ("Qwen2Tokenizer", "Qwen2TokenizerFast")
# the TTS special tokens added after `<|endoftext|>`, in this order
SPECIAL_TOKENS = [
    "<|im_start|>", "<|im_end|>", "<|endofprompt|>",
    "[breath]", "<strong>", "</strong>", "[noise]", "[laughter]",
    "[cough]", "[clucking]", "[accent]", "[quick_breath]",
    "<laughter>", "</laughter>", "[hissing]", "[sigh]", "[vocalized-noise]",
    "[lipsmack]", "[mm]",
]
# the special-token keys of tokenizer_config.json, in the order
# `transformers` adds them; Qwen2's defaults where the file is silent
SPECIAL_KEYS = {"bos_token": None, "eos_token": "<|endoftext|>",
                "unk_token": "<|endoftext|>", "sep_token": None,
                "pad_token": "<|endoftext|>", "cls_token": None,
                "mask_token": None}


def _fold(ch: str) -> str:
    """The case folding (?i:) gives the contractions' letters: ASCII, and
    U+017F (long s) to s."""
    return "s" if ch == "ſ" else ch.lower() if ch.isascii() else ch


def split_qwen2(text: str) -> List[str]:
    """`regex.findall(QWEN2_PAT, text)` with the standard library: at each
    position the first alternative of QWEN2_PAT that matches, as the
    regex engine tries them."""
    kinds = [_kind(c) for c in text]
    n, out, i = len(text), [], 0

    def run(j, k):  # end of the run of kind k from j
        while j < n and kinds[j] == k:
            j += 1
        return j

    while i < n:
        c, k = text[i], kinds[i]
        if c == "'":
            folded = "".join(_fold(x) for x in text[i + 1: i + 3])
            m = next((m for m in CONTRACTIONS if folded.startswith(m)), None)
            if m is not None:
                out.append(text[i: i + 1 + len(m)])
                i += 1 + len(m)
                continue
        if k == "L":  # '[^\r\n\p{L}\p{N}]?\p{L}+' without its lead
            j = run(i, "L")
        elif (k != "N" and c not in "\r\n" and i + 1 < n
              and kinds[i + 1] == "L"):  # ... with one
            j = run(i + 1, "L")
        elif k == "N":  # '\p{N}': one digit a piece
            j = i + 1
        elif k == "o" or (c == " " and i + 1 < n and kinds[i + 1] == "o"):
            # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
            j = run(i + (k == "s"), "o")
            while j < n and text[j] in "\r\n":
                j += 1
        else:  # white space
            e = run(i, "s")
            breaks = [p for p in range(i, e) if text[p] in "\r\n"]
            if breaks:  # '\s*[\r\n]+' ends at the run's last line break
                j = breaks[-1] + 1
            elif e == n or e - i == 1:  # '\s+(?!\S)' or '\s+'
                j = e
            else:  # '\s+(?!\S)' leaves the last one to the next piece
                j = e - 1
        out.append(text[i:j])
        i = j
    return out


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's table: each byte to a printable character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def clean_up_tokenization(text: str) -> str:
    """`transformers`' clean-up of spaces before punctuation and
    contractions (applied when tokenizer_config.json asks for it)."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def bpe_merge(ids: List[int], merges: Dict[Tuple[int, int], Tuple[int, int]]
              ) -> List[int]:
    """Merge one word's symbols as `tokenizers`' `Word::merge_all`: a heap
    of (rank, position) over adjacent pairs; the lowest is merged if its
    pair still makes the same token, then its new neighbours' pairs go on
    the heap."""
    n = len(ids)
    sym, nxt, prev = list(ids), list(range(1, n + 1)), list(range(-1, n - 1))
    nxt[-1] = -1
    alive = [True] * n
    heap = [(m[0], i, m[1]) for i in range(n - 1)
            if (m := merges.get((sym[i], sym[i + 1]))) is not None]
    heapq.heapify(heap)
    while heap:
        _, pos, new = heapq.heappop(heap)
        j = nxt[pos]
        if not alive[pos] or j == -1:
            continue
        m = merges.get((sym[pos], sym[j]))
        if m is None or m[1] != new:  # an expired entry
            continue
        sym[pos], alive[j] = new, False
        k = nxt[pos] = nxt[j]
        if k != -1:
            prev[k] = pos
        p = prev[pos]
        if p != -1 and (m := merges.get((sym[p], new))) is not None:
            heapq.heappush(heap, (m[0], p, m[1]))
        if k != -1 and (m := merges.get((new, sym[k]))) is not None:
            heapq.heappush(heap, (m[0], pos, m[1]))
    return [s for s, a in zip(sym, alive) if a]


def _json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _refuse(where: str, field: str, value, want) -> None:
    if value != want:
        raise ValueError(f"{where}: {field} {value!r} is not implemented "
                         f"(the Qwen2 tokenizer has {want!r})")


def _check_token(where: str, tok: dict) -> None:
    for flag in ("lstrip", "rstrip", "single_word"):
        if tok.get(flag):
            raise ValueError(f"{where}: added token {tok.get('content')!r} "
                             f"with {flag}: true is not implemented")


def _read_tokenizer_json(path: Path):
    """(vocab, merges as pairs, added tokens) of a tokenizer.json, its
    pipeline checked against Qwen2's; the NFC flag."""
    where = str(path)
    t = _json(path)
    model = t.get("model") or {}
    _refuse(where, "model.type", model.get("type"), "BPE")
    for field, want in (("dropout", None), ("unk_token", None),
                        ("byte_fallback", False), ("ignore_merges", False)):
        _refuse(where, f"model.{field}", model.get(field, want), want)
    for field in ("continuing_subword_prefix", "end_of_word_suffix"):
        _refuse(where, f"model.{field}", model.get(field) or "", "")
    for field in ("truncation", "padding"):
        _refuse(where, field, t.get(field), None)
    norm = t.get("normalizer")
    if norm is not None:
        _refuse(where, "normalizer", norm, {"type": "NFC"})
    pre = t.get("pre_tokenizer") or {}
    steps = pre.get("pretokenizers") if pre.get("type") == "Sequence" else None
    if not steps or len(steps) != 2:
        raise ValueError(f"{where}: pre_tokenizer {pre!r} is not implemented "
                         "(the Qwen2 tokenizer has a Sequence of Split and "
                         "ByteLevel)")
    split, byte = steps
    _refuse(where, "pre_tokenizer Split", {
        k: split.get(k) for k in ("type", "pattern", "behavior", "invert")},
        {"type": "Split", "pattern": {"Regex": QWEN2_PAT},
         "behavior": "Isolated", "invert": False})
    _refuse(where, "pre_tokenizer ByteLevel", {
        k: byte.get(k) for k in ("type", "add_prefix_space", "use_regex")},
        {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False})
    _refuse(where, "decoder.type", (t.get("decoder") or {}).get("type"),
            "ByteLevel")
    post = t.get("post_processor")
    if post is not None:
        _refuse(where, "post_processor.type", post.get("type"), "ByteLevel")
    merges = []
    for m in model.get("merges", []):
        pair = m.split(" ") if isinstance(m, str) else list(m)
        if len(pair) != 2:
            raise ValueError(f"{where}: model.merges entry {m!r} is not a "
                             "pair")
        merges.append(tuple(pair))
    added = []
    for tok in t.get("added_tokens", []):
        _check_token(where, tok)
        added.append((tok["content"], bool(tok.get("special")),
                      bool(tok.get("normalized", True))))
    return model.get("vocab", {}), merges, added, norm is not None


def _read_vocab_merges(vocab_file: Path, merges_file: Path):
    """vocab.json and merges.txt as the slow Qwen2Tokenizer reads them:
    the `#version` line and empty lines skipped, a repeated merge kept
    at its first place."""
    ranks = {}
    with open(merges_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if (i == 0 and line.startswith("#version:")) or not line:
                continue
            pair = tuple(line.split())
            if len(pair) != 2:
                raise ValueError(f"{merges_file}: line {i + 1} {line!r} is "
                                 "not a pair")
            ranks.setdefault(pair, len(ranks))
    return _json(vocab_file), list(ranks), [], True


class QwenTokenizer:
    """The Qwen2 tokenizer of a Hugging Face directory with the TTS
    special tokens added (`<|endoftext|>` as eos and pad, then
    frontend.SPECIAL_TOKENS); `encode` adds no BOS, `decode` drops the
    special tokens' ids when skip_special_tokens is set."""

    def __init__(self, token_path: str, skip_special_tokens: bool = True):
        d = Path(token_path)
        cfg_file, tok_file = d / "tokenizer_config.json", d / "tokenizer.json"
        vocab_file, merges_file = d / "vocab.json", d / "merges.txt"
        if not cfg_file.is_file() or not (tok_file.is_file() or (
                vocab_file.is_file() and merges_file.is_file())):
            raise FileNotFoundError(
                f"{token_path}: not a Qwen2 tokenizer directory: it needs "
                "tokenizer_config.json and either tokenizer.json or "
                "vocab.json + merges.txt")
        cfg = _json(cfg_file)
        where = str(cfg_file)
        if cfg.get("tokenizer_class") not in QWEN2_CLASSES:
            raise ValueError(f"{where}: tokenizer_class "
                             f"{cfg.get('tokenizer_class')!r} is not "
                             f"implemented (one of {QWEN2_CLASSES})")
        for field in ("split_special_tokens", "add_prefix_space"):
            _refuse(where, field, bool(cfg.get(field)), False)
        if "added_tokens_decoder" not in cfg:
            for legacy in ("added_tokens.json", "special_tokens_map.json"):
                if (d / legacy).is_file():
                    raise ValueError(
                        f"{d / legacy}: read only where {where} has no "
                        "added_tokens_decoder, which is not implemented")
        if tok_file.is_file():
            vocab, merges, added, self.nfc = _read_tokenizer_json(tok_file)
        else:
            vocab, merges, added, self.nfc = _read_vocab_merges(vocab_file,
                                                                merges_file)
        self.vocab = dict(vocab)
        self.merges = {}
        for rank, (a, b) in enumerate(merges):
            ids = [self.vocab.get(s) for s in (a, b, a + b)]
            if None in ids:
                raise ValueError(f"merge {rank} ({a!r}, {b!r}) names a token "
                                 "the vocabulary lacks")
            self.merges[ids[0], ids[1]] = (rank, ids[2])
        self.clean_up = bool(cfg.get("clean_up_tokenization_spaces", False))
        self.skip_special_tokens = skip_special_tokens

        self.added: Dict[str, int] = {}      # content -> id
        self.special: set = set()
        self._matched: List[Tuple[str, bool]] = []  # (content, normalized)
        self._add(added)  # tokenizer.json's own, in its order
        # then transformers' additions: tokenizer_config.json's added
        # tokens by id, its special tokens, and QwenTokenizer's
        entries = []
        for _, tok in sorted(cfg.get("added_tokens_decoder", {}).items(),
                             key=lambda kv: int(kv[0])):
            _check_token(where, tok)
            entries.append((tok["content"], bool(tok.get("special")),
                            bool(tok.get("normalized", True))))
        named = [cfg.get(k, default) for k, default in SPECIAL_KEYS.items()]
        named += cfg.get("additional_special_tokens") or []
        for tok in named:
            if isinstance(tok, dict):
                _check_token(where, tok)
                entries.append((tok["content"], True,
                                bool(tok.get("normalized", False))))
            elif tok:
                entries.append((tok, True, False))
        entries += [(t, True, False) for t in ["<|endoftext|>"]
                    + SPECIAL_TOKENS]
        self._add(entries)
        self.vocab_size = max([len(self.vocab)] + [
            i + 1 for i in self.added.values()])

        self._id_to_token = {i: s for s, i in self.vocab.items()}
        self._id_to_token.update({i: s for s, i in self.added.items()})
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._raw_pat = self._pattern(
            [s for s, normalized in self._matched if not normalized])
        self._norm_pat = self._pattern(
            [self._normalize(s) for s, normalized in self._matched
             if normalized])
        self._norm_ids = {self._normalize(s): self.added[s]
                          for s, normalized in self._matched if normalized}
        try:
            import regex
            self._split = regex.compile(QWEN2_PAT).findall
        except ImportError:
            self._split = split_qwen2
        # a cache of this instance's pieces, gone with the instance
        self._encode_piece = lru_cache(maxsize=10000)(self._merge_piece)

    def _add(self, tokens: Iterable[Tuple[str, bool, bool]]) -> None:
        """`tokenizers`' AddedVocabulary.add_tokens on (content, special,
        normalized): the special ones join the special set first; a token
        already added is left as it is; the others keep the vocabulary's
        id or take the next after the last."""
        tokens = list(tokens)
        for content, special, normalized in tokens:
            if special and content and content not in self.special:
                self.special.add(content)
                self._matched.append((content, normalized))
        for content, special, normalized in tokens:
            if not content or content in self.added:
                continue
            new = self.vocab.get(content)
            if new is None:
                top = max(self.added.values(), default=None)
                new = len(self.vocab) if top is None or (
                    top < len(self.vocab) and self.vocab) else top + 1
            self.added[content] = new
            if content not in self.special:
                self._matched.append((content, normalized))

    def _normalize(self, text: str) -> str:
        return unicodedata.normalize("NFC", text) if self.nfc else text

    @staticmethod
    def _pattern(contents: List[str]) -> Optional[re.Pattern]:
        """Leftmost-longest over the literals: at the first position that
        matches, the longest alternative first."""
        contents = sorted(set(contents), key=len, reverse=True)
        return re.compile("|".join(map(re.escape, contents))) \
            if contents else None

    @staticmethod
    def _cut(text: str, pattern, ids: Dict[str, int]):
        """(segment, None) and (token, id) in the order of the text."""
        pos = 0
        if pattern is not None:
            for m in pattern.finditer(text):
                if m.start() > pos:
                    yield text[pos: m.start()], None
                yield m.group(0), ids[m.group(0)]
                pos = m.end()
        if pos < len(text):
            yield text[pos:], None

    def _merge_piece(self, piece: str) -> Tuple[int, ...]:
        chars = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
        ids = [self.vocab[c] for c in chars if c in self.vocab]
        return tuple(bpe_merge(ids, self.merges)) if ids else ()

    def encode(self, text: str, **kw) -> List[int]:
        out: List[int] = []
        for seg, tid in self._cut(text, self._raw_pat, self.added):
            if tid is not None:
                out.append(tid)
                continue
            for part, pid in self._cut(self._normalize(seg), self._norm_pat,
                                       self._norm_ids):
                if pid is not None:
                    out.append(pid)
                    continue
                for piece in self._split(part):
                    out.extend(self._encode_piece(piece))
        return out

    def _token_bytes(self, token: str) -> bytes:
        try:
            return bytes(self._byte_dec[c] for c in token)
        except KeyError:  # not a byte-level token: its own text
            return token.encode("utf-8")

    def decode(self, ids) -> str:
        chunks = []
        for i in ids:
            token = self._id_to_token.get(int(i))
            if token is None or (self.skip_special_tokens
                                 and token in self.special):
                continue
            chunks.append(self._token_bytes(token))
        text = b"".join(chunks).decode("utf-8", "replace")
        return clean_up_tokenization(text) if self.clean_up else text
