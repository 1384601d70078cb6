"""Text frontend: normalization, sentence splitting, tokenization.

Port of minimax_speech_tpu/infer/frontend.py: `normalize_text`,
`split_paragraph` and `Frontend` (normalize -> split -> tokenize), with
the port's copy of the text normalizer (infer/textnorm.py), on the
hermetic byte tokenizer, the Whisper tiktoken tokenizer of a
`.tiktoken` asset (infer/whisper_tokenizer.py) or the Qwen2 tokenizer of
a Hugging Face directory with the TTS special tokens
(infer/qwen_tokenizer.py, without `transformers`).
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from minimax_speech_torch.infer.qwen_tokenizer import (  # noqa: F401
    SPECIAL_TOKENS, QwenTokenizer)
from minimax_speech_torch.infer.textnorm import (contains_chinese,
                                                 is_only_punctuation,
                                                 normalize_en, normalize_zh)


def normalize_text(text: str) -> str:
    """Language-routed normalization: the zh branch when the text holds
    Chinese characters, else the English one."""
    if contains_chinese(text):
        return normalize_zh(text)
    return normalize_en(text)


def split_paragraph(text: str, tokenize, lang: str = "en",
                    token_max_n: int = 80, token_min_n: int = 60,
                    merge_len: int = 20,
                    comma_split: bool = False) -> list[str]:
    """Sentence-boundary splitting with max/min token budgets and
    short-tail merging: zh counts characters and splits on zh and latin
    punctuation, en counts tokens and splits on latin sentence
    punctuation (both on commas too with comma_split). Closing quotes
    stay with the sentence before them."""
    if lang == "zh":
        pounc = ["。", "？", "！", "；", "：", "、", ".", "?", "!", ";"]
    else:
        pounc = [".", "?", "!", ";", ":"]
    if comma_split:
        pounc.extend(["，", ","])
    if not text:
        return []
    if text[-1] not in pounc:
        text += "。" if lang == "zh" else "."

    def length(s: str) -> int:
        return len(s) if lang == "zh" else len(tokenize(s))

    utts, st = [], 0
    for i, c in enumerate(text):
        if c in pounc:
            if len(text[st:i]) > 0:
                utts.append(text[st:i] + c)
            if i + 1 < len(text) and text[i + 1] in ['"', "”"]:
                if utts:
                    utts[-1] = utts[-1] + text[i + 1]
                st = i + 2
            else:
                st = i + 1

    final, cur = [], ""
    for utt in utts:
        if length(cur + utt) > token_max_n and length(cur) > token_min_n:
            final.append(cur)
            cur = ""
        cur = cur + utt
    if cur:
        if length(cur) < merge_len and final:
            final[-1] = final[-1] + cur
        else:
            final.append(cur)
    return [u.strip() for u in final if u.strip()]


class ByteTokenizer:
    """UTF-8 bytes + 1 (0 reserved for padding)."""
    vocab_size = 257

    def encode(self, text: str, **kw) -> list[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i - 1 for i in ids if i > 0).decode("utf-8", "ignore")


def get_tokenizer(token_path: Optional[str] = None):
    """None -> the byte tokenizer; a .tiktoken asset ->
    WhisperTikTokenizer; any other path -> QwenTokenizer of a Hugging
    Face Qwen2 tokenizer directory."""
    if token_path and str(token_path).endswith(".tiktoken"):
        from minimax_speech_torch.infer.whisper_tokenizer import \
            WhisperTikTokenizer
        return WhisperTikTokenizer(token_path)
    if token_path:
        return QwenTokenizer(token_path)
    return ByteTokenizer()


class Frontend:
    """normalize -> split -> tokenize."""

    def __init__(self, token_path: Optional[str] = None):
        self.tokenizer = get_tokenizer(token_path)

    def text_normalize(self, text: str, split: bool = True) -> list[str]:
        """Always a list; [normalized] when split is False."""
        if text == "":
            return [text]
        lang = "zh" if contains_chinese(text) else "en"
        norm = normalize_zh(text) if lang == "zh" else normalize_en(text)
        if not split:
            return [norm]
        texts = split_paragraph(norm, self.tokenizer.encode, lang=lang)
        return [t for t in texts if not is_only_punctuation(t)]

    def extract_text_tokens(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text), np.int32)
