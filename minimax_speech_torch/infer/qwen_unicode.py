"""The code points whose class under QWEN2_PAT differs between Python's
Unicode database and `tokenizers`' pre-tokenizer.

QWEN2_PAT (infer/qwen_tokenizer.py) sorts characters into four classes:
white space (\\s), letters (\\p{L}), numbers (\\p{N}) and the rest.
`split_qwen2` takes them from `unicodedata` (Unicode 15.0 on Python
3.12); `tokenizers` (0.22.2, whose Oniguruma knows a newer Unicode) puts
5,004 code points unassigned in 15.0 (U+1C89, the Egyptian hieroglyphs
U+13460-U+143FA, ...) in another class. KIND_RANGES lists them, as
(first, last, class) with the class in `whisper_tokenizer._kind`'s
letters ('s', 'L', 'N', 'o'); `qwen_kind` looks one up. The table was
derived by probing `tokenizers` over every code point
(tests/test_torch_qwen_tokenizer.py `derive_kind_ranges`, which holds
it against a fresh derivation wherever `tokenizers` imports); the port
never imports `tokenizers`.
"""
from __future__ import annotations

from bisect import bisect_right

from minimax_speech_torch.infer.whisper_tokenizer import _kind

KIND_RANGES = (
    (0x1C89, 0x1C8A, "L"), (0xA7CB, 0xA7CD, "L"), (0xA7DA, 0xA7DC, "L"),
    (0x105C0, 0x105F3, "L"), (0x10D40, 0x10D49, "N"), (0x10D4A, 0x10D65, "L"),
    (0x10D6F, 0x10D85, "L"), (0x10EC2, 0x10EC4, "L"), (0x11380, 0x11389, "L"),
    (0x1138B, 0x1138B, "L"), (0x1138E, 0x1138E, "L"), (0x11390, 0x113B5, "L"),
    (0x113B7, 0x113B7, "L"), (0x113D1, 0x113D1, "L"), (0x113D3, 0x113D3, "L"),
    (0x116D0, 0x116E3, "N"), (0x11BC0, 0x11BE0, "L"), (0x11BF0, 0x11BF9, "N"),
    (0x13460, 0x143FA, "L"), (0x16100, 0x1611D, "L"), (0x16130, 0x16139, "N"),
    (0x16D40, 0x16D6C, "L"), (0x16D70, 0x16D79, "N"), (0x18CFF, 0x18CFF, "L"),
    (0x1CCF0, 0x1CCF9, "N"), (0x1E5D0, 0x1E5ED, "L"), (0x1E5F0, 0x1E5F0, "L"),
    (0x1E5F1, 0x1E5FA, "N"), (0x2EBF0, 0x2EE5D, "L"),
)
_STARTS = [r[0] for r in KIND_RANGES]


def qwen_kind(ch: str) -> str:
    """The class of `ch` under QWEN2_PAT as `tokenizers` sees it: 's',
    'L', 'N' or 'o'."""
    cp = ord(ch)
    i = bisect_right(_STARTS, cp) - 1
    if i >= 0 and cp <= KIND_RANGES[i][1]:
        return KIND_RANGES[i][2]
    return _kind(ch)
