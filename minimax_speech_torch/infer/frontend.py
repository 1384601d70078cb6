"""Text tokenizers for training.

Port of the hermetic part of minimax_speech_tpu/infer/frontend.py: the
byte tokenizer that `get_tokenizer(None)` returns. The Qwen and Whisper
tiktoken tokenizers are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Iterable, Optional


class ByteTokenizer:
    """UTF-8 bytes + 1 (0 reserved for padding)."""
    vocab_size = 257

    def encode(self, text: str, **kw) -> list[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i - 1 for i in ids if i > 0).decode("utf-8", "ignore")


def get_tokenizer(token_path: Optional[str] = None) -> ByteTokenizer:
    """None -> the byte tokenizer; a tokenizer path raises."""
    if token_path:
        raise NotImplementedError(
            f"tokenizer {token_path!r}: QwenTokenizer and WhisperTikTokenizer "
            "are not ported yet (ROADMAP.md, queue 1, training slice)")
    return ByteTokenizer()
