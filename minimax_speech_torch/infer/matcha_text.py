"""Matcha text frontend: the Tacotron symbol set, cleaners, sequences.

Port of minimax_speech_tpu/infer/matcha_text.py: the keithito/tacotron
symbol table (pad + punctuation + letters + IPA),
text_to_sequence/sequence_to_text, the cleaner pipelines and
process_text (clean -> ids -> pad interspersed). english_cleaners2
phonemizes through espeak when the optional phonemizer package imports;
without it the cleaned grapheme string stands (every ascii letter is in
the table, so the ids stay valid model inputs; a model trained on
phonemes needs the phonemizer for matching output).
"""
from __future__ import annotations

import re
import unicodedata

_pad = "_"
_punctuation = ';:,.!?¡¿—…"«»“” '
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_letters_ipa = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
symbols = [_pad] + list(_punctuation) + list(_letters) + list(_letters_ipa)
SPACE_ID = symbols.index(" ")

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = dict(enumerate(symbols))

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full) for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def convert_to_ascii(text: str) -> str:
    """unidecode-lite: NFKD-fold accents, drop remaining non-ascii."""
    folded = unicodedata.normalize("NFKD", text)
    return folded.encode("ascii", "ignore").decode("ascii")


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


_phonemizer_backend = None


def _phonemize(text: str):
    """espeak phonemization if the optional phonemizer pkg exists."""
    global _phonemizer_backend
    if _phonemizer_backend is None:
        try:
            import phonemizer
            _phonemizer_backend = phonemizer.backend.EspeakBackend(
                language="en-us", preserve_punctuation=True,
                with_stress=True, language_switch="remove-flags")
        except Exception:
            _phonemizer_backend = False
    if _phonemizer_backend:
        return _phonemizer_backend.phonemize([text], strip=True, njobs=1)[0]
    return None


def expand_numbers(text: str) -> str:
    """Numbers, currency, ordinals and decimals verbalised by the English
    normaliser of infer/textnorm.py."""
    from minimax_speech_torch.infer.textnorm import normalize_en
    return normalize_en(text)


def english_cleaners2(text: str) -> str:
    """ascii-fold, lowercase, expand abbreviations+numbers, phonemize
    (the graphemes when espeak is unavailable)."""
    text = expand_abbreviations(lowercase(convert_to_ascii(text)))
    text = expand_numbers(text)
    phones = _phonemize(text)
    return collapse_whitespace(phones if phones is not None else text)


_CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners2": english_cleaners2,
}


def text_to_sequence(text: str, cleaner_names) -> list[int]:
    for name in cleaner_names:
        text = _CLEANERS[name](text)
    return [_symbol_to_id[s] for s in text if s in _symbol_to_id]


def sequence_to_text(sequence) -> str:
    return "".join(_id_to_symbol[int(i)] for i in sequence)


def intersperse(lst: list, item) -> list:
    """[a, b] -> [item, a, item, b, item]."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result


def process_text(text: str, cleaners=("english_cleaners2",)):
    """(ids with the pad id 0 interspersed, their symbols)."""
    seq = intersperse(text_to_sequence(text, list(cleaners)), 0)
    return seq, sequence_to_text(seq)
