"""uroman-style romanization for forced-alignment text preprocessing.

A copy of ``whisper_nemo_tpu/align/uroman.py``, carried so that the
port imports nothing of the JAX package.

The upstream ctc-forced-aligner shells out to uroman (a Perl rule
engine) before alignment (reference diarize.py:170-174 feeds the
transcript through ``preprocess_text(..., romanize=True)``); the
acoustic model's vocabulary is bare Latin, so non-Latin scripts must be
transliterated or every token degenerates to the ``<star>`` wildcard.

Host-side preprocessing (runs once per transcript — no reason to put
string munging on the TPU). Coverage, per script:

* Cyrillic (Russian + Ukrainian/Belarusian/Serbian extras) — table
* Greek — table, with the ``ου``→``ou`` digraph special-cased
* Hebrew, Arabic (incl. harakat vowel marks) — tables
* Japanese kana — Hepburn-style, handling small-``y`` digraphs
  (きゃ→kya, しゃ→sha), sokuon gemination (がっこう→gakkou) and the
  katakana long-vowel mark (トー→too)
* Hangul — exact Revised-Romanization decomposition of the syllable
  block (algorithmic, covers all 11,172 syllables)
* Devanagari — consonants with inherent ``a``, vowel signs, virama
* Han ideographs — toneless pinyin for the 1,500 most frequent
  simplified characters (``pinyin_data.PINYIN``); rarer hanzi pass
  through and fall back to ``<star>`` in the aligner dictionary,
  which keeps alignment well-defined
* Brahmic abugidas beyond Devanagari (Bengali, Gurmukhi, Gujarati,
  Oriya, Tamil, Telugu, Kannada, Malayalam), Sinhala, Thai, Lao,
  Khmer, Myanmar, Ethiopic — via ``uroman_ext`` (one ISCII-offset
  table covers the nine aligned Indic blocks; see that module)
"""

from __future__ import annotations

import unicodedata

from . import uroman_ext
from .pinyin_data import PINYIN

_CYRILLIC = {
    "а": "a", "б": "b", "в": "v", "г": "g", "д": "d", "е": "e",
    "ё": "yo", "ж": "zh", "з": "z", "и": "i", "й": "y", "к": "k",
    "л": "l", "м": "m", "н": "n", "о": "o", "п": "p", "р": "r",
    "с": "s", "т": "t", "у": "u", "ф": "f", "х": "kh", "ц": "ts",
    "ч": "ch", "ш": "sh", "щ": "shch", "ъ": "", "ы": "y", "ь": "",
    "э": "e", "ю": "yu", "я": "ya",
    # Ukrainian / Belarusian / Serbian / Macedonian extras
    "і": "i", "ї": "yi", "є": "ye", "ґ": "g", "ў": "u",
    "ђ": "dj", "ј": "j", "љ": "lj", "њ": "nj", "ћ": "c", "џ": "dz",
    "ѓ": "gj", "ќ": "kj", "ѕ": "dz",
}

_GREEK = {
    "α": "a", "β": "v", "γ": "g", "δ": "d", "ε": "e", "ζ": "z",
    "η": "i", "θ": "th", "ι": "i", "κ": "k", "λ": "l", "μ": "m",
    "ν": "n", "ξ": "x", "ο": "o", "π": "p", "ρ": "r", "σ": "s",
    "ς": "s", "τ": "t", "υ": "y", "φ": "f", "χ": "ch", "ψ": "ps",
    "ω": "o",
}

_HEBREW = {
    "א": "a", "ב": "b", "ג": "g", "ד": "d", "ה": "h", "ו": "v",
    "ז": "z", "ח": "kh", "ט": "t", "י": "y", "כ": "k", "ך": "k",
    "ל": "l", "מ": "m", "ם": "m", "נ": "n", "ן": "n", "ס": "s",
    "ע": "a", "פ": "p", "ף": "p", "צ": "ts", "ץ": "ts", "ק": "k",
    "ר": "r", "ש": "sh", "ת": "t",
}

_ARABIC = {
    "ا": "a", "ب": "b", "ت": "t", "ث": "th", "ج": "j", "ح": "h",
    "خ": "kh", "د": "d", "ذ": "dh", "ر": "r", "ز": "z", "س": "s",
    "ش": "sh", "ص": "s", "ض": "d", "ط": "t", "ظ": "z", "ع": "a",
    "غ": "gh", "ف": "f", "ق": "q", "ك": "k", "ل": "l", "م": "m",
    "ن": "n", "ه": "h", "و": "w", "ي": "y", "ء": "", "آ": "a",
    "أ": "a", "إ": "i", "ؤ": "u", "ئ": "i", "ة": "h", "ى": "a",
    "ٱ": "a", "پ": "p", "چ": "ch", "ژ": "zh", "گ": "g", "ک": "k",
    "ی": "y",  # Persian extras
    # harakat
    "َ": "a", "ِ": "i", "ُ": "u",
    "ً": "an", "ٍ": "in", "ٌ": "un",
    "ْ": "", "ّ": "", "ٰ": "a",
}

_HIRAGANA = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "さ": "sa", "し": "shi", "す": "su", "せ": "se", "そ": "so",
    "た": "ta", "ち": "chi", "つ": "tsu", "て": "te", "と": "to",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "を": "wo", "ん": "n",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゔ": "vu", "ゎ": "wa",
}
_SMALL_Y = {"ゃ": "ya", "ゅ": "yu", "ょ": "yo"}
_VOWELS = frozenset("aeiou")

# Hangul Revised Romanization jamo tables (U+AC00 block decomposition)
_HG_ONSET = ("g", "kk", "n", "d", "tt", "r", "m", "b", "pp", "s", "ss",
             "", "j", "jj", "ch", "k", "t", "p", "h")
_HG_VOWEL = ("a", "ae", "ya", "yae", "eo", "e", "yeo", "ye", "o", "wa",
             "wae", "oe", "yo", "u", "wo", "we", "wi", "yu", "eu", "ui",
             "i")
# codas use RR final-position pronunciation (한국 → hanguk, not hangug);
# compound codas reduce to their pronounced consonant (닭 → dak)
_HG_CODA = ("", "k", "k", "k", "n", "n", "n", "t", "l", "k", "m",
            "p", "l", "l", "p", "l", "m", "p", "p", "t", "t",
            "ng", "t", "t", "k", "t", "p", "t")

_DEVANAGARI_CONS = {
    "क": "k", "ख": "kh", "ग": "g", "घ": "gh", "ङ": "n",
    "च": "ch", "छ": "chh", "ज": "j", "झ": "jh", "ञ": "n",
    "ट": "t", "ठ": "th", "ड": "d", "ढ": "dh", "ण": "n",
    "त": "t", "थ": "th", "द": "d", "ध": "dh", "न": "n",
    "प": "p", "फ": "ph", "ब": "b", "भ": "bh", "म": "m",
    "य": "y", "र": "r", "ल": "l", "व": "v",
    "श": "sh", "ष": "sh", "स": "s", "ह": "h",
    "क़": "q", "ख़": "kh", "ग़": "gh", "ज़": "z", "ड़": "r",
    "ढ़": "rh", "फ़": "f",
}
_DEVANAGARI_VOWEL = {
    "अ": "a", "आ": "aa", "इ": "i", "ई": "ii", "उ": "u", "ऊ": "uu",
    "ऋ": "ri", "ए": "e", "ऐ": "ai", "ओ": "o", "औ": "au", "ऑ": "o",
}
_DEVANAGARI_MATRA = {
    "ा": "aa", "ि": "i", "ी": "ii", "ु": "u", "ू": "uu", "ृ": "ri",
    "े": "e", "ै": "ai", "ो": "o", "ौ": "au", "ॉ": "o",
}
_DEVANAGARI_VIRAMA = "्"
_DEVANAGARI_SIGN = {"ं": "n", "ँ": "n", "ः": "h", "़": ""}


def _fallback(ch: str) -> str:
    """Unmapped char: strip its own combining marks (Greek ά → α) and
    retry the tables on the base letter; otherwise pass the base
    through. Per-character only — a global NFD pass would destroy
    precomposed letters the tables need (й, ї, が, Hangul syllables)
    and delete functional marks (Devanagari virama, Arabic harakat)."""
    base = "".join(
        c for c in unicodedata.normalize("NFD", ch)
        if not unicodedata.combining(c)
    )
    if base and base != ch:
        for table in (_CYRILLIC, _GREEK, _HEBREW, _ARABIC):
            mapped = table.get(base)
            if mapped is not None:
                return mapped
        return base
    return ch


def _kana(out: list, ch: str, geminate: bool) -> bool:
    """Emit one kana; returns the new sokuon state (unused slot kept for
    symmetry — the caller manages state)."""
    roma = _HIRAGANA[ch]
    if geminate and roma[0] not in _VOWELS:
        roma = roma[0] + roma
    out.append(roma)
    return False


def romanize(text: str) -> str:
    """Best-effort uroman-equivalent transliteration to Latin."""
    text = unicodedata.normalize("NFC", text.lower())
    out: list = []
    geminate = False
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        cp = ord(ch)

        # Han ideograph: pinyin for the frequent-character table
        if 0x4E00 <= cp <= 0x9FFF:
            out.append(PINYIN.get(ch, ch))
            i += 1
            continue

        # Hangul syllable block: exact RR decomposition
        if 0xAC00 <= cp <= 0xD7A3:
            idx = cp - 0xAC00
            out.append(
                _HG_ONSET[idx // 588]
                + _HG_VOWEL[(idx % 588) // 28]
                + _HG_CODA[idx % 28]
            )
            i += 1
            continue

        # katakana → hiragana (shared table); keep long-vowel mark
        if 0x30A1 <= cp <= 0x30F6:
            ch = chr(cp - 0x60)
        if ch in ("っ", "ッ"):
            geminate = True
            i += 1
            continue
        if ch in _SMALL_Y:
            # きゃ→kya; しゃ/ちゃ/じゃ drop the y: sha/cha/ja
            if out and out[-1].endswith("i"):
                stem = out[-1][:-1]
                y = _SMALL_Y[ch]
                if stem.endswith(("sh", "ch", "j")):
                    y = y[1:]
                out[-1] = stem + y
            else:
                out.append(_SMALL_Y[ch][-1])
            i += 1
            continue
        if ch == "ー":
            if out and out[-1] and out[-1][-1] in _VOWELS:
                out.append(out[-1][-1])
            i += 1
            continue
        if ch in _HIRAGANA:
            geminate = _kana(out, ch, geminate)
            i += 1
            continue

        # extended scripts (Brahmic/Sinhala/Thai/Lao/Khmer/Myanmar/
        # Ethiopic) — uroman_ext owns those blocks entirely
        if uroman_ext.covers(cp):
            nxt = uroman_ext.handle(text, i, out)
            if nxt is not None:
                i = nxt
                continue

        # Devanagari: consonant + (matra | virama | inherent a)
        if 0x0900 <= cp <= 0x097F:
            if ch in _DEVANAGARI_CONS:
                out.append(_DEVANAGARI_CONS[ch])
                if i + 1 < n and text[i + 1] in _DEVANAGARI_MATRA:
                    out.append(_DEVANAGARI_MATRA[text[i + 1]])
                    i += 2
                    continue
                if i + 1 < n and text[i + 1] == _DEVANAGARI_VIRAMA:
                    i += 2
                    continue
                # schwa deletion: no inherent vowel on a word-final
                # consonant (भारत → bhaarat)
                if i + 1 < n and 0x0900 <= ord(text[i + 1]) <= 0x097F:
                    out.append("a")
            elif ch in _DEVANAGARI_VOWEL:
                out.append(_DEVANAGARI_VOWEL[ch])
            elif ch in _DEVANAGARI_SIGN:
                out.append(_DEVANAGARI_SIGN[ch])
            i += 1
            continue

        # Greek ου digraph before the plain table (υ alone is y)
        if ch == "ο" and i + 1 < n and text[i + 1] in ("υ", "ύ", "ϋ"):
            out.append("ou")
            i += 2
            continue

        for table in (_CYRILLIC, _GREEK, _HEBREW, _ARABIC):
            mapped = table.get(ch)
            if mapped is not None:
                out.append(mapped)
                break
        else:
            if unicodedata.combining(ch):  # stray accent (а́, etc.)
                i += 1
                continue
            out.append(_fallback(ch))
        i += 1
    return "".join(out)


def needs_romanization(text: str) -> bool:
    """True if any character falls in a script the tables cover."""
    for ch in text:
        cp = ord(ch)
        if (
            0x0370 <= cp <= 0x03FF  # Greek
            or 0x0400 <= cp <= 0x052F  # Cyrillic
            or 0x0590 <= cp <= 0x06FF  # Hebrew/Arabic
            or 0x0900 <= cp <= 0x097F  # Devanagari
            or 0x3040 <= cp <= 0x30FF  # kana
            or 0x4E00 <= cp <= 0x9FFF  # Han (pinyin table)
            or 0xAC00 <= cp <= 0xD7A3  # Hangul
            or uroman_ext.covers(cp)  # Brahmic/Sinhala/Thai/Lao/
            #                           Khmer/Myanmar/Ethiopic
        ):
            return True
    return False
