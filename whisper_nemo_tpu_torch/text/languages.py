"""Language tables and language-argument validation.

A copy of ``whisper_nemo_tpu/text/languages.py``, carried so that the
port imports nothing of the JAX package.

These are the standard public Whisper language tables (originally from
openai/whisper ``tokenizer.py``) plus the ISO-639-2/B mapping used by the
MMS forced aligner and the punctuation-model language gate. Behavioral
contract: reference helpers.py:10-249 and helpers.py:592-610.
"""

from __future__ import annotations

# Languages supported by the punctuation-restoration model
# (kredor/punctuate-all); reference helpers.py:10-23.
punct_model_langs = [
    "en", "fr", "de", "es", "it", "nl", "pt", "bg", "pl", "cs", "sk", "sl",
]

# Whisper language-code -> English-name table (public constant from
# openai/whisper); reference helpers.py:25-126.
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}

# Name -> code lookup with historical aliases; reference helpers.py:129-142.
TO_LANGUAGE_CODE = {
    **{name: code for code, name in LANGUAGES.items()},
    "burmese": "my", "valencian": "ca", "flemish": "nl", "haitian": "ht",
    "letzeburgesch": "lb", "pushto": "ps", "panjabi": "pa", "moldavian": "ro",
    "moldovan": "ro", "sinhalese": "si", "castilian": "es",
}

# Accepted values for the CLI --language flag; reference helpers.py:144-146.
whisper_langs = sorted(LANGUAGES.keys()) + sorted(
    k.title() for k in TO_LANGUAGE_CODE.keys()
)

# ISO-639-1 -> ISO-639-2/B (bibliographic) codes consumed by the forced
# aligner's text preprocessing; reference helpers.py:148-249.
langs_to_iso = {
    "af": "afr", "am": "amh", "ar": "ara", "as": "asm", "az": "aze",
    "ba": "bak", "be": "bel", "bg": "bul", "bn": "ben", "bo": "tib",
    "br": "bre", "bs": "bos", "ca": "cat", "cs": "cze", "cy": "wel",
    "da": "dan", "de": "ger", "el": "gre", "en": "eng", "es": "spa",
    "et": "est", "eu": "baq", "fa": "per", "fi": "fin", "fo": "fao",
    "fr": "fre", "gl": "glg", "gu": "guj", "ha": "hau", "haw": "haw",
    "he": "heb", "hi": "hin", "hr": "hrv", "ht": "hat", "hu": "hun",
    "hy": "arm", "id": "ind", "is": "ice", "it": "ita", "ja": "jpn",
    "jw": "jav", "ka": "geo", "kk": "kaz", "km": "khm", "kn": "kan",
    "ko": "kor", "la": "lat", "lb": "ltz", "ln": "lin", "lo": "lao",
    "lt": "lit", "lv": "lav", "mg": "mlg", "mi": "mao", "mk": "mac",
    "ml": "mal", "mn": "mon", "mr": "mar", "ms": "may", "mt": "mlt",
    "my": "bur", "ne": "nep", "nl": "dut", "nn": "nno", "no": "nor",
    "oc": "oci", "pa": "pan", "pl": "pol", "ps": "pus", "pt": "por",
    "ro": "rum", "ru": "rus", "sa": "san", "sd": "snd", "si": "sin",
    "sk": "slo", "sl": "slv", "sn": "sna", "so": "som", "sq": "alb",
    "sr": "srp", "su": "sun", "sv": "swe", "sw": "swa", "ta": "tam",
    "te": "tel", "tg": "tgk", "th": "tha", "tk": "tuk", "tl": "tgl",
    "tr": "tur", "tt": "tat", "uk": "ukr", "ur": "urd", "uz": "uzb",
    "vi": "vie", "yi": "yid", "yo": "yor", "yue": "yue", "zh": "chi",
}


def process_language_arg(language: str | None, model_name: str) -> str | None:
    """Normalize/validate a user-supplied language.

    Lowercases, resolves name aliases to codes, rejects unknown languages,
    and rejects any non-English language when an English-only ``*.en``
    model was requested. Contract: reference helpers.py:592-610.
    """
    if language is None:
        return None
    language = language.lower()
    if language not in LANGUAGES:
        if language not in TO_LANGUAGE_CODE:
            raise ValueError(f"Unsupported language: {language}")
        language = TO_LANGUAGE_CODE[language]
    if model_name.endswith(".en") and language != "en":
        raise ValueError(
            f"{model_name} is an English-only model but choosen language is"
            f" '{language}'"
        )
    return language
