"""Extended script coverage for align.uroman: Brahmic abugidas beyond
Devanagari, Thai/Lao, Khmer, Myanmar, and Ethiopic.

A copy of ``whisper_nemo_tpu/align/uroman_ext.py``, carried so that the
port imports nothing of the JAX package.

The reference pipeline romanizes the full transcript before forced
alignment (reference diarize.py:170-174, ``preprocess_text(...,
romanize=True)`` backed by uroman, which covers essentially every
script). Without these handlers every token in Thai, Lao, Khmer,
Burmese, Sinhala, Amharic, and the non-Devanagari Indic languages of
``langs_to_iso`` degraded to the ``<star>`` wildcard — alignment in
those languages carried no acoustic anchor at all.

Design notes:

* **Brahmic (ISCII-aligned blocks).** Unicode lays out Devanagari,
  Bengali, Gurmukhi, Gujarati, Oriya, Tamil, Telugu, Kannada, and
  Malayalam on a common per-block offset grid inherited from ISCII:
  consonant ``ka`` is +0x15 from every block base, the ``aa`` matra is
  +0x3E, the virama +0x4D, and so on. One offset-keyed table therefore
  romanizes all nine scripts; per-script phonetic detail (Bengali's
  rounded inherent vowel, Tamil's missing aspirates) is beyond
  best-effort Latin anchoring and is ignored, exactly like uroman's
  own output. The inherent ``a`` follows the same schwa rules as the
  Devanagari handler in ``uroman.py``: suppressed by a matra or
  virama, and dropped word-finally.
* **Sinhala** has its own (non-ISCII) layout → dedicated tables, same
  abugida walk.
* **Thai/Lao.** Alphabets with preposed vowels (เ แ โ ใ ไ are *stored*
  before their consonant); the handler holds a preposed vowel and
  emits it after the following consonant. The Lao block mirrors the
  Thai layout at +0x80, so its tables are derived programmatically.
* **Khmer** treats the coeng (U+17D2, subscript-consonant marker) as a
  virama; **Myanmar** stores text in logical order (no reordering
  needed) and uses the asat (U+103A) as its vowel killer alongside the
  stacking virama (U+1039).
* **Ethiopic** is algorithmic like Hangul: each syllable is
  ``base-row + vowel-order`` with rows of 8 codepoints; one row table
  plus a vowel-order list covers the whole block.
"""

from __future__ import annotations

# --------------------------------------------------------------------
# Generic Brahmic: offset-keyed tables shared by the ISCII-aligned
# blocks. Keys are (codepoint - block_base).
# --------------------------------------------------------------------

_BRAHMIC_BASES = (
    0x0980,  # Bengali
    0x0A00,  # Gurmukhi
    0x0A80,  # Gujarati
    0x0B00,  # Oriya
    0x0B80,  # Tamil
    0x0C00,  # Telugu
    0x0C80,  # Kannada
    0x0D00,  # Malayalam
)

_BR_SIGN = {0x01: "n", 0x02: "n", 0x03: "h", 0x3C: ""}
# per-block sign extras where the shared grid runs out: Gurmukhi
# tippi/addak (ਪੰਜਾਬੀ needs the tippi's nasal)
_BR_SIGN_EXTRA = {0x0A00: {0x0A70: "n", 0x0A71: ""}}

_BR_VOWEL = {
    0x05: "a", 0x06: "aa", 0x07: "i", 0x08: "ii", 0x09: "u",
    0x0A: "uu", 0x0B: "ri", 0x0C: "li",
    # north blocks: 0x0F e / 0x10 ai / 0x13 o / 0x14 au; south blocks
    # add short e/o at 0x0E/0x12 — folding long/short to one vowel
    # works for both layouts
    0x0D: "e", 0x0E: "e", 0x0F: "e", 0x10: "ai",
    0x11: "o", 0x12: "o", 0x13: "o", 0x14: "au",
}

_BR_CONS = {
    0x15: "k", 0x16: "kh", 0x17: "g", 0x18: "gh", 0x19: "n",
    0x1A: "ch", 0x1B: "chh", 0x1C: "j", 0x1D: "jh", 0x1E: "n",
    0x1F: "t", 0x20: "th", 0x21: "d", 0x22: "dh", 0x23: "n",
    0x24: "t", 0x25: "th", 0x26: "d", 0x27: "dh", 0x28: "n",
    0x29: "n",  # Tamil nnna
    0x2A: "p", 0x2B: "ph", 0x2C: "b", 0x2D: "bh", 0x2E: "m",
    0x2F: "y", 0x30: "r", 0x31: "r", 0x32: "l", 0x33: "l",
    0x34: "l", 0x35: "v", 0x36: "sh", 0x37: "sh", 0x38: "s",
    0x39: "h",
}

_BR_MATRA = {
    0x3E: "aa", 0x3F: "i", 0x40: "ii", 0x41: "u", 0x42: "uu",
    0x43: "ri", 0x44: "ri",
    0x45: "e", 0x46: "e", 0x47: "e", 0x48: "ai",
    0x49: "o", 0x4A: "o", 0x4B: "o", 0x4C: "au",
    # Bengali/Oriya/Telugu/Kannada/Malayalam length marks
    0x55: "", 0x56: "ai", 0x57: "au",
    0x62: "li", 0x63: "li",
}

_BR_VIRAMA = 0x4D


# --------------------------------------------------------------------
# Sinhala (0x0D80-0x0DFF) — own layout, same abugida walk.
# --------------------------------------------------------------------

_SI_SIGN = {0x0D82: "n", 0x0D83: "h"}
_SI_VOWEL = {
    0x0D85: "a", 0x0D86: "aa", 0x0D87: "ae", 0x0D88: "aae",
    0x0D89: "i", 0x0D8A: "ii", 0x0D8B: "u", 0x0D8C: "uu",
    0x0D8D: "ri", 0x0D8E: "rii", 0x0D8F: "li", 0x0D90: "lii",
    0x0D91: "e", 0x0D92: "ee", 0x0D93: "ai", 0x0D94: "o",
    0x0D95: "oo", 0x0D96: "au",
}
_SI_CONS = {
    0x0D9A: "k", 0x0D9B: "kh", 0x0D9C: "g", 0x0D9D: "gh",
    0x0D9E: "ng", 0x0D9F: "ng", 0x0DA0: "ch", 0x0DA1: "chh",
    0x0DA2: "j", 0x0DA3: "jh", 0x0DA4: "ny", 0x0DA5: "gn",
    0x0DA6: "nj", 0x0DA7: "t", 0x0DA8: "th", 0x0DA9: "d",
    0x0DAA: "dh", 0x0DAB: "n", 0x0DAC: "nd", 0x0DAD: "t",
    0x0DAE: "th", 0x0DAF: "d", 0x0DB0: "dh", 0x0DB1: "n",
    0x0DB3: "nd", 0x0DB4: "p", 0x0DB5: "ph", 0x0DB6: "b",
    0x0DB7: "bh", 0x0DB8: "m", 0x0DB9: "mb", 0x0DBA: "y",
    0x0DBB: "r", 0x0DBD: "l", 0x0DC0: "v", 0x0DC1: "sh",
    0x0DC2: "sh", 0x0DC3: "s", 0x0DC4: "h", 0x0DC5: "l",
    0x0DC6: "f",
}
_SI_MATRA = {
    0x0DCF: "aa", 0x0DD0: "ae", 0x0DD1: "aae", 0x0DD2: "i",
    0x0DD3: "ii", 0x0DD4: "u", 0x0DD6: "uu", 0x0DD8: "ri",
    0x0DD9: "e", 0x0DDA: "ee", 0x0DDB: "ai", 0x0DDC: "o",
    0x0DDD: "oo", 0x0DDE: "au", 0x0DDF: "li", 0x0DF2: "ri",
    0x0DF3: "li",
}
_SI_VIRAMA = 0x0DCA  # al-lakuna


# --------------------------------------------------------------------
# Thai (0x0E00-0x0E7F) and Lao (0x0E80-0x0EFF, Thai layout at +0x80).
# Not an abugida walk: consonants carry no inherent-vowel mark, vowels
# are explicit, and five vowels are stored *before* their consonant.
# --------------------------------------------------------------------

_TH_CONS = {
    0x01: "k", 0x02: "kh", 0x03: "kh", 0x04: "kh", 0x05: "kh",
    0x06: "kh", 0x07: "ng", 0x08: "ch", 0x09: "ch", 0x0A: "ch",
    0x0B: "s", 0x0C: "ch", 0x0D: "y", 0x0E: "d", 0x0F: "t",
    0x10: "th", 0x11: "th", 0x12: "th", 0x13: "n", 0x14: "d",
    0x15: "t", 0x16: "th", 0x17: "th", 0x18: "th", 0x19: "n",
    0x1A: "b", 0x1B: "p", 0x1C: "ph", 0x1D: "f", 0x1E: "ph",
    0x1F: "f", 0x20: "ph", 0x21: "m", 0x22: "y", 0x23: "r",
    0x24: "rue", 0x25: "l", 0x26: "lue", 0x27: "w", 0x28: "s",
    0x29: "s", 0x2A: "s", 0x2B: "h", 0x2C: "l", 0x2D: "",
    0x2E: "h",
}
_TH_VOWEL = {  # stored after the consonant
    0x30: "a", 0x31: "a", 0x32: "aa", 0x33: "am", 0x34: "i",
    0x35: "ii", 0x36: "ue", 0x37: "uee", 0x38: "u", 0x39: "uu",
    0x45: "a", 0x4D: "n",
}
_TH_PREPOSED = {0x40: "e", 0x41: "ae", 0x42: "o", 0x43: "ai", 0x44: "ai"}
# tone marks, phinthu, maiyamok, maitaikhu, thanthakhat, yamakkan …
_TH_SILENT = {0x3A, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x4B, 0x4C, 0x4E, 0x4F}

# Lao overrides where its layout departs from the Thai grid (offsets
# relative to 0x0E80); everything else derives from the Thai tables.
_LO_CONS = {**_TH_CONS, 0x0D: "ny", 0x25: "l", 0x2C: ""}
_LO_VOWEL = {**_TH_VOWEL, 0x3B: "o", 0x3C: "l", 0x3D: "y"}


# --------------------------------------------------------------------
# Khmer (0x1780-0x17FF) — abugida; coeng U+17D2 acts as the virama.
# --------------------------------------------------------------------

_KM_CONS = {
    0x1780: "k", 0x1781: "kh", 0x1782: "k", 0x1783: "kh",
    0x1784: "ng", 0x1785: "ch", 0x1786: "chh", 0x1787: "ch",
    0x1788: "chh", 0x1789: "ny", 0x178A: "d", 0x178B: "th",
    0x178C: "d", 0x178D: "th", 0x178E: "n", 0x178F: "t",
    0x1790: "th", 0x1791: "t", 0x1792: "th", 0x1793: "n",
    0x1794: "b", 0x1795: "ph", 0x1796: "p", 0x1797: "ph",
    0x1798: "m", 0x1799: "y", 0x179A: "r", 0x179B: "l",
    0x179C: "v", 0x179D: "sh", 0x179E: "sh", 0x179F: "s",
    0x17A0: "h", 0x17A1: "l", 0x17A2: "",  # qa: glottal carrier
}
_KM_VOWEL = {  # independent vowels
    0x17A3: "a", 0x17A4: "aa", 0x17A5: "i", 0x17A6: "ii",
    0x17A7: "u", 0x17A8: "uk", 0x17A9: "uu", 0x17AA: "uu",
    0x17AB: "ri", 0x17AC: "rii", 0x17AD: "li", 0x17AE: "lii",
    0x17AF: "e", 0x17B0: "ai", 0x17B1: "o", 0x17B2: "o",
    0x17B3: "au",
}
_KM_MATRA = {
    0x17B6: "aa", 0x17B7: "i", 0x17B8: "ii", 0x17B9: "oe",
    0x17BA: "ue", 0x17BB: "u", 0x17BC: "uu", 0x17BD: "ua",
    0x17BE: "oe", 0x17BF: "eu", 0x17C0: "ie", 0x17C1: "e",
    0x17C2: "ae", 0x17C3: "ai", 0x17C4: "o", 0x17C5: "au",
}
_KM_SIGN = {0x17C6: "m", 0x17C7: "h", 0x17C8: ""}
_KM_VIRAMA = 0x17D2  # coeng


# --------------------------------------------------------------------
# Myanmar (0x1000-0x109F) — abugida in logical order; asat U+103A
# kills the inherent vowel on syllable-final consonants.
# --------------------------------------------------------------------

_MY_CONS = {
    0x1000: "k", 0x1001: "kh", 0x1002: "g", 0x1003: "gh",
    0x1004: "ng", 0x1005: "s", 0x1006: "hs", 0x1007: "z",
    0x1008: "zh", 0x1009: "ny", 0x100A: "ny", 0x100B: "t",
    0x100C: "ht", 0x100D: "d", 0x100E: "dh", 0x100F: "n",
    0x1010: "t", 0x1011: "ht", 0x1012: "d", 0x1013: "dh",
    0x1014: "n", 0x1015: "p", 0x1016: "hp", 0x1017: "b",
    0x1018: "bh", 0x1019: "m", 0x101A: "y", 0x101B: "r",
    0x101C: "l", 0x101D: "w", 0x101E: "th", 0x101F: "h",
    0x1020: "l",
}
_MY_VOWEL = {  # independent vowels
    0x1021: "a", 0x1023: "i", 0x1024: "ii", 0x1025: "u",
    0x1026: "uu", 0x1027: "e", 0x1029: "o", 0x102A: "au",
}
_MY_MATRA = {
    0x102B: "aa", 0x102C: "aa", 0x102D: "i", 0x102E: "ii",
    0x102F: "u", 0x1030: "uu", 0x1031: "e", 0x1032: "ai",
}
_MY_MEDIAL = {0x103B: "y", 0x103C: "y", 0x103D: "w", 0x103E: "h"}
_MY_SIGN = {0x1036: "n", 0x1037: "", 0x1038: ""}
_MY_VIRAMA = 0x1039
_MY_ASAT = 0x103A


# --------------------------------------------------------------------
# Ethiopic (0x1200-0x137F) — syllabary: rows of 8 = consonant x vowel
# order (like Hangul, fully algorithmic).
# --------------------------------------------------------------------

_ET_ROW = {
    0x1200: "h", 0x1208: "l", 0x1210: "h", 0x1218: "m",
    0x1220: "s", 0x1228: "r", 0x1230: "s", 0x1238: "sh",
    0x1240: "q", 0x1248: "qw", 0x1250: "q", 0x1258: "qw",
    0x1260: "b", 0x1268: "v", 0x1270: "t", 0x1278: "ch",
    0x1280: "h", 0x1288: "hw", 0x1290: "n", 0x1298: "ny",
    0x12A0: "",  # glottal row: the vowel carries the syllable
    0x12A8: "k", 0x12B0: "kw", 0x12B8: "k", 0x12C0: "kw",
    0x12C8: "w", 0x12D0: "",  # pharyngeal row
    0x12D8: "z", 0x12E0: "zh", 0x12E8: "y", 0x12F0: "d",
    0x12F8: "d", 0x1300: "j", 0x1308: "g", 0x1310: "gw",
    0x1318: "g", 0x1320: "t", 0x1328: "ch", 0x1330: "p",
    0x1338: "ts", 0x1340: "ts", 0x1348: "f", 0x1350: "p",
}
# vowel orders: ä u i a e ə o wa; the sixth order doubles as the bare
# consonant — emitting nothing matches uroman's practice closely
# enough for acoustic anchoring
_ET_ORDER = ("e", "u", "i", "a", "e", "", "o", "wa")


def _abugida(text: str, i: int, out: list, cons, vowel, matra, sign,
             virama, lo: int, hi: int, asat: int | None = None) -> int:
    """One step of a generic abugida walk (mirrors the Devanagari
    branch in ``uroman.romanize``). Returns the next index."""
    n = len(text)
    ch = text[i]
    cp = ord(ch)
    key = cp
    if key in cons:
        out.append(cons[key])
        j = i + 1
        # medial consonants (Myanmar) ride between base and vowel
        while j < n and ord(text[j]) in _MY_MEDIAL and lo == 0x1000:
            out.append(_MY_MEDIAL[ord(text[j])])
            j += 1
        if j < n and ord(text[j]) in matra:
            out.append(matra[ord(text[j])])
            return j + 1
        if j < n and ord(text[j]) == virama:
            return j + 1
        if asat is not None and j < n and ord(text[j]) == asat:
            return j + 1
        # schwa deletion: inherent vowel only before another same-block
        # char (word-final consonants stay bare, as in Devanagari).
        # Myanmar finals always carry the asat, so its inherent vowel
        # survives word-finally too.
        if asat is not None or (j < n and lo <= ord(text[j]) <= hi):
            out.append("a")
        return j
    if key in vowel:
        out.append(vowel[key])
    elif key in matra:
        out.append(matra[key])
    elif key in sign:
        out.append(sign[key])
    elif key == virama or key == asat:
        pass
    # anything else in-block (digits, rare signs): drop
    return i + 1


def _thai_lao(text: str, i: int, out: list, base: int) -> int:
    """Thai/Lao step; handles one preposed vowel + following consonant."""
    n = len(text)
    off = ord(text[i]) - base
    if base == 0x0E80:
        cons, vowel = _LO_CONS, _LO_VOWEL
    else:
        cons, vowel = _TH_CONS, _TH_VOWEL
    if off in _TH_PREPOSED:
        j = i + 1
        if j < n and (ord(text[j]) - base) in cons:
            out.append(cons[ord(text[j]) - base])
            out.append(_TH_PREPOSED[off])
            return j + 1
        out.append(_TH_PREPOSED[off])
        return i + 1
    if off in cons:
        out.append(cons[off])
    elif off in vowel:
        out.append(vowel[off])
    # tone marks / silent signs / digits: drop
    return i + 1


_BRAHMIC_CACHE: dict = {}


def _brahmic_tables(base: int):
    cached = _BRAHMIC_CACHE.get(base)
    if cached is None:
        cached = (
            {base + k: v for k, v in _BR_CONS.items()},
            {base + k: v for k, v in _BR_VOWEL.items()},
            {base + k: v for k, v in _BR_MATRA.items()},
            {base + k: v for k, v in _BR_SIGN.items()}
            | _BR_SIGN_EXTRA.get(base, {}),
        )
        _BRAHMIC_CACHE[base] = cached
    return cached


def handle(text: str, i: int, out: list) -> int | None:
    """Romanize one step if ``text[i]`` is in an extended-script block.

    Returns the next index, or None if the char belongs to none of the
    scripts this module covers (caller falls through to its own
    tables).
    """
    cp = ord(text[i])
    if 0x0980 <= cp <= 0x0D7F:  # ISCII-aligned Brahmic blocks
        base = 0x0980 + ((cp - 0x0980) // 0x80) * 0x80
        cons, vowel, matra, sign = _brahmic_tables(base)
        return _abugida(text, i, out, cons, vowel, matra,
                        sign, base + _BR_VIRAMA, base, base + 0x7F)
    if 0x0D80 <= cp <= 0x0DFF:  # Sinhala
        return _abugida(text, i, out, _SI_CONS, _SI_VOWEL, _SI_MATRA,
                        _SI_SIGN, _SI_VIRAMA, 0x0D80, 0x0DFF)
    if 0x0E00 <= cp <= 0x0E7F:  # Thai
        return _thai_lao(text, i, out, 0x0E00)
    if 0x0E80 <= cp <= 0x0EFF:  # Lao
        return _thai_lao(text, i, out, 0x0E80)
    if 0x1000 <= cp <= 0x109F:  # Myanmar
        return _abugida(text, i, out, _MY_CONS, _MY_VOWEL, _MY_MATRA,
                        _MY_SIGN, _MY_VIRAMA, 0x1000, 0x109F,
                        asat=_MY_ASAT)
    if 0x1780 <= cp <= 0x17FF:  # Khmer
        return _abugida(text, i, out, _KM_CONS, _KM_VOWEL, _KM_MATRA,
                        _KM_SIGN, _KM_VIRAMA, 0x1780, 0x17FF)
    if 0x1200 <= cp <= 0x137F:  # Ethiopic
        row = _ET_ROW.get(cp - cp % 8)
        if row is not None:
            out.append(row + _ET_ORDER[cp % 8])
        return i + 1
    return None


def covers(cp: int) -> bool:
    """True if ``handle`` claims this codepoint's block."""
    return (
        0x0980 <= cp <= 0x0DFF  # Brahmic + Sinhala
        or 0x0E00 <= cp <= 0x0EFF  # Thai/Lao
        or 0x1000 <= cp <= 0x109F  # Myanmar
        or 0x1200 <= cp <= 0x137F  # Ethiopic
        or 0x1780 <= cp <= 0x17FF  # Khmer
    )
