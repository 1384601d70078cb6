"""Text normalization: English (wetext/inflect-equivalent subset) and
Chinese (wetext zh-equivalent subset), pure Python.

The port's own copy of minimax_speech_tpu/infer/textnorm.py (host-only
Python, unchanged), so the port imports nothing of the JAX package.

The reference normalizes via ttsfrd (C++) or WeTextProcessing FSTs +
inflect (reference: speech/cosyvoice/cli/frontend.py:121-149,
utils/frontend_utils.py:41-160); neither ships here, so the observable
behaviors are reimplemented natively:

  EN: integers (incl. 1,234 comma groups), decimals, ordinals,
      currency ($/£/€ with cents), percent, clock times, negatives.
  ZH: integer/decimal reading (万/亿 grouping), percent 百分之,
      currency ¥/元, years digit-by-digit, dates 年月日, clock times
      X点Y分, long digit strings digit-by-digit, plus the reference's
      text cleanups (replace_blank, corner marks, bracket removal,
      trailing-comma -> 。, '.' -> '。', ' - ' -> '，').
"""
from __future__ import annotations

import re

# ---------------------------------------------------------------- English

_ONES = ("zero one two three four five six seven eight nine ten eleven "
         "twelve thirteen fourteen fifteen sixteen seventeen eighteen "
         "nineteen").split()
_TENS = ("zero ten twenty thirty forty fifty sixty seventy eighty "
         "ninety").split()
_ORD_ONES = ("zeroth first second third fourth fifth sixth seventh eighth "
             "ninth tenth eleventh twelfth thirteenth fourteenth fifteenth "
             "sixteenth seventeenth eighteenth nineteenth").split()
_ORD_TENS = ("zeroth tenth twentieth thirtieth fortieth fiftieth sixtieth "
             "seventieth eightieth ninetieth").split()
_SCALES = ((10 ** 12, "trillion"), (10 ** 9, "billion"),
           (10 ** 6, "million"), (10 ** 3, "thousand"), (100, "hundred"))


def spell_number(n: int) -> str:
    """Integer -> English words (inflect number_to_words style, no
    'and')."""
    if n < 0:
        return "minus " + spell_number(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        return _TENS[n // 10] + ("" if n % 10 == 0 else " " + _ONES[n % 10])
    for div, name in _SCALES:
        if n >= div:
            rest = n % div
            head = spell_number(n // div) + " " + name
            return head if rest == 0 else head + " " + spell_number(rest)
    return _ONES[0]


def spell_ordinal(n: int) -> str:
    """21 -> twenty-first (wetext en ordinal verbalizer behavior)."""
    if n < 20:
        return _ORD_ONES[n]
    if n < 100:
        if n % 10 == 0:
            return _ORD_TENS[n // 10]
        return _TENS[n // 10] + "-" + _ORD_ONES[n % 10]
    base = spell_number(n)
    # replace the final word with its ordinal form
    words = base.split()
    last = words[-1]
    repl = {"one": "first", "two": "second", "three": "third",
            "five": "fifth", "eight": "eighth", "nine": "ninth",
            "twelve": "twelfth"}
    if last in repl:
        words[-1] = repl[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def _spell_digits(s: str) -> str:
    return " ".join(_ONES[int(c)] for c in s)


_EN_CURRENCY = {"$": ("dollar", "cent"), "£": ("pound", "penny"),
                "€": ("euro", "cent")}


def _en_currency(m: re.Match) -> str:
    sym, whole, frac = m.group(1), m.group(2).replace(",", ""), m.group(3)
    unit, sub = _EN_CURRENCY[sym]
    w = int(whole)
    out = spell_number(w) + " " + (unit if w == 1 else unit + "s")
    if frac:
        c = int(frac.ljust(2, "0")[:2])
        if c:
            out += " and " + spell_number(c) + " " + (
                sub if c == 1 else ("pennies" if sub == "penny" else sub + "s"))
    return out


def _en_time(m: re.Match) -> str:
    h, mi = int(m.group(1)), int(m.group(2))
    if mi == 0:
        return spell_number(h) + " o'clock"
    if mi < 10:
        return spell_number(h) + " oh " + spell_number(mi)
    return spell_number(h) + " " + spell_number(mi)


def _en_decimal(m: re.Match) -> str:
    whole, frac = m.group(1).replace(",", ""), m.group(2)
    return spell_number(int(whole)) + " point " + _spell_digits(frac)


def normalize_en(text: str) -> str:
    """English normalization: numbers & symbols -> words, punctuation
    unification, whitespace collapse."""
    text = text.strip()
    text = text.replace("“", '"').replace("”", '"')
    text = text.replace("‘", "'").replace("’", "'")
    # currency before generic numbers
    text = re.sub(r"([$£€])(\d[\d,]*)(?:\.(\d+))?", _en_currency, text)
    # percent
    text = re.sub(r"(\d[\d,]*(?:\.\d+)?)\s*%",
                  lambda m: _num_en(m.group(1)) + " percent", text)
    # clock time
    text = re.sub(r"\b(\d{1,2}):([0-5]\d)\b", _en_time, text)
    # ordinals
    text = re.sub(r"\b(\d+)(st|nd|rd|th)\b",
                  lambda m: spell_ordinal(int(m.group(1))), text)
    # decimals
    text = re.sub(r"\b(\d[\d,]*)\.(\d+)\b", _en_decimal, text)
    # negatives
    text = re.sub(r"(?<![\w.])-(\d[\d,]*)",
                  lambda m: " minus " + _num_en(m.group(1)), text)
    # plain integers (with comma groups)
    text = re.sub(r"\d[\d,]*",
                  lambda m: " " + _num_en(m.group(0)) + " ", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _num_en(s: str) -> str:
    return spell_number(int(s.replace(",", "")))


# ---------------------------------------------------------------- Chinese

_ZH_DIG = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]
_ZH_GROUPS = ["", "万", "亿", "万亿"]

chinese_char_pattern = re.compile(r"[一-鿿]+")


def contains_chinese(text: str) -> bool:
    """reference: utils/frontend_utils.py:21-22."""
    return bool(chinese_char_pattern.search(text))


def _zh_group(n: int) -> str:
    """0 <= n < 10000 -> chinese, without leading-zero handling."""
    if n == 0:
        return ""
    out, started_zero = [], False
    for i in range(3, -1, -1):
        d = (n // 10 ** i) % 10
        if d == 0:
            if out:
                started_zero = True
        else:
            if started_zero:
                out.append("零")
                started_zero = False
            out.append(_ZH_DIG[d] + _ZH_UNITS[i])
    return "".join(out)


def spell_number_zh(n: int) -> str:
    """Integer -> Chinese reading (万/亿 grouping; 一十 -> 十)."""
    if n < 0:
        return "负" + spell_number_zh(-n)
    if n == 0:
        return "零"
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    out = ""
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        part = _zh_group(g) + _ZH_GROUPS[i]
        if out and g < 1000:
            out += "零"
        out += part
    if out.startswith("一十"):
        out = out[1:]
    return out


def _zh_digits(s: str) -> str:
    return "".join(_ZH_DIG[int(c)] for c in s)


def _zh_number(s: str) -> str:
    s = s.replace(",", "")
    if "." in s:
        whole, frac = s.split(".", 1)
        return spell_number_zh(int(whole or 0)) + "点" + _zh_digits(frac)
    if len(s) > 10:  # phone-number-like: digit by digit
        return _zh_digits(s)
    return spell_number_zh(int(s))


def replace_blank(text: str) -> str:
    """Drop spaces unless both neighbors are non-space ascii
    (reference: utils/frontend_utils.py:123-133)."""
    out = []
    for i, c in enumerate(text):
        if c == " ":
            if (0 < i + 1 < len(text)
                    and text[i + 1].isascii() and text[i + 1] != " "
                    and text[i - 1].isascii() and text[i - 1] != " "):
                out.append(c)
        else:
            out.append(c)
    return "".join(out)


def replace_corner_mark(text: str) -> str:
    """reference: utils/frontend_utils.py:26-29."""
    return text.replace("²", "平方").replace("³", "立方")


def remove_bracket(text: str) -> str:
    """reference: utils/frontend_utils.py:33-38."""
    for ch in ("（", "）", "【", "】", "`"):
        text = text.replace(ch, "")
    return text.replace("——", " ")


def normalize_zh(text: str) -> str:
    """Chinese normalization mirroring the reference zh branch
    (frontend.py:131-141) with a native number verbalizer replacing the
    wetext FSTs."""
    text = text.strip().replace("\n", "")
    # dates: 2024年1月5日
    text = re.sub(r"(\d{4})年",
                  lambda m: _zh_digits(m.group(1)) + "年", text)
    text = re.sub(r"(\d{1,2})月",
                  lambda m: spell_number_zh(int(m.group(1))) + "月", text)
    text = re.sub(r"(\d{1,2})(日|号)",
                  lambda m: spell_number_zh(int(m.group(1))) + m.group(2),
                  text)
    # clock time 3:15 (no \b: CJK neighbors are word chars in re)
    text = re.sub(
        r"(?<!\d)(\d{1,2}):([0-5]\d)(?!\d)",
        lambda m: spell_number_zh(int(m.group(1))) + "点"
        + (spell_number_zh(int(m.group(2))) + "分" if int(m.group(2)) else ""),
        text)
    # percent
    text = re.sub(r"(\d[\d,]*(?:\.\d+)?)\s*%",
                  lambda m: "百分之" + _zh_number(m.group(1)), text)
    # currency
    text = re.sub(r"[¥￥](\d[\d,]*(?:\.\d+)?)",
                  lambda m: _zh_number(m.group(1)) + "元", text)
    # remaining numbers
    text = re.sub(r"\d[\d,]*(?:\.\d+)?", lambda m: _zh_number(m.group(0)),
                  text)
    text = replace_blank(text)
    text = replace_corner_mark(text)
    text = text.replace(".", "。").replace(" - ", "，")
    text = remove_bracket(text)
    text = re.sub(r"[，,、]+$", "。", text)
    return text


def is_only_punctuation(text: str) -> bool:
    """reference: utils/frontend_utils.py:157-160."""
    punct = r"[\s!\"#$%&'()*+,\-./:;<=>?@\[\]^_`{|}~。，！？；：“”‘’、…—]"
    return bool(re.fullmatch(f"{punct}*", text))
