"""Whisper tokenizer: byte-level BPE + the Whisper special-token layout.

A copy of ``whisper_nemo_tpu/text/tokenizer.py``, carried so that the
port imports nothing of the JAX package.

The reference leans on faster-whisper's HF tokenizer (diarize.py:127) and
openai-whisper's tiktoken vocab (main.py). Here the tokenizer is
self-contained: a byte-level BPE engine that loads ``vocab.json`` /
``merges.txt`` from a local model directory, plus a derived special-token
layout (languages, task, timestamps) that matches openai-whisper's ID
scheme for both multilingual and English-only models.

For fully offline operation (no vocab assets on disk) there is a
byte-fallback mode: the base vocabulary is exactly the 256 byte symbols,
while all special tokens keep their standard Whisper IDs, so decode-loop
logic (suppression, timestamp rules, task prompts) is identical either
way.
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import regex as re

from .languages import LANGUAGES

# GPT-2 pre-tokenization pattern (public constant).
_PRETOKENIZE = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

TIMESTAMP_RESOLUTION = 0.02
N_TIMESTAMPS = 1501  # <|0.00|> .. <|30.00|>


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map (public constant)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class ByteLevelBPE:
    """Minimal byte-level BPE encoder/decoder over vocab+merges."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.merge_ranks = {pair: r for r, pair in enumerate(merges)}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self._bpe_cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(
                pairs, key=lambda p: self.merge_ranks.get(p, float("inf"))
            )
            if best not in self.merge_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == best[0]
                    and parts[i + 1] == best[1]
                ):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._bpe_cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _PRETOKENIZE.findall(text):
            mapped = "".join(self.byte_enc[b] for b in word.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab[piece])
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.inv_vocab[i] for i in ids if i in self.inv_vocab)
        data = bytes(self.byte_dec[c] for c in text if c in self.byte_dec)
        return data.decode("utf-8", errors="replace")


class ByteFallbackBPE:
    """Offline fallback: base vocabulary = the 256 raw byte symbols.

    Token id b encodes byte b. Lossless for any text; used when no
    vocab.json/merges.txt assets exist (zero-egress environments) and for
    unit tests. Vocab is padded with unused placeholder symbols so the
    special-token layout can sit at the standard Whisper IDs.
    """

    def __init__(self, n_base_vocab: int):
        self.n_base_vocab = n_base_vocab
        byte_enc = bytes_to_unicode()
        self.vocab = {s: b for b, s in byte_enc.items()}
        for i in range(256, n_base_vocab):
            # digit-free placeholder names: a numeral in the name would
            # make find_numeral_symbol_tokens suppress the whole range
            suffix = []
            v = i
            while v:
                v, r = divmod(v, 26)
                suffix.append(chr(ord("a") + r))
            self.vocab[f"<unused_{''.join(suffix)}>"] = i
        self.inv_vocab = {i: t for t, i in self.vocab.items()}

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace"
        )


@dataclass(frozen=True)
class SpecialTokenLayout:
    """Whisper's special-token ID scheme, derived from the base vocab
    size and the number of language tokens.

    Multilingual models: eot=50257, sot=50258, 99 (or 100 for large-v3)
    language tokens, then translate/transcribe/startoflm/startofprev/
    nospeech/notimestamps, then 1501 timestamp tokens. English-only
    models: same layout shifted down by one (eot=50256).
    """

    n_base_vocab: int
    n_languages: int

    @property
    def eot(self) -> int:
        return self.n_base_vocab

    @property
    def sot(self) -> int:
        return self.n_base_vocab + 1

    @property
    def language_start(self) -> int:
        return self.n_base_vocab + 2

    @property
    def translate(self) -> int:
        return self.language_start + self.n_languages

    @property
    def transcribe(self) -> int:
        return self.translate + 1

    @property
    def startoflm(self) -> int:
        return self.transcribe + 1

    @property
    def startofprev(self) -> int:
        return self.startoflm + 1

    @property
    def nospeech(self) -> int:
        return self.startofprev + 1

    @property
    def notimestamps(self) -> int:
        return self.nospeech + 1

    @property
    def timestamp_begin(self) -> int:
        return self.notimestamps + 1

    @property
    def vocab_size(self) -> int:
        return self.timestamp_begin + N_TIMESTAMPS

    def special_tokens(self) -> Dict[str, int]:
        names = {
            "<|endoftext|>": self.eot,
            "<|startoftranscript|>": self.sot,
            "<|translate|>": self.translate,
            "<|transcribe|>": self.transcribe,
            "<|startoflm|>": self.startoflm,
            "<|startofprev|>": self.startofprev,
            "<|nospeech|>": self.nospeech,
            "<|notimestamps|>": self.notimestamps,
        }
        for i, code in enumerate(_language_codes(self.n_languages)):
            names[f"<|{code}|>"] = self.language_start + i
        for i in range(N_TIMESTAMPS):
            names[f"<|{i * TIMESTAMP_RESOLUTION:.2f}|>"] = (
                self.timestamp_begin + i
            )
        return names


def _language_codes(n: int) -> List[str]:
    codes = list(LANGUAGES.keys())  # insertion order = whisper order
    return codes[:n]


class WhisperTokenizer:
    """Tokenizer + special-token logic for Whisper decoding."""

    def __init__(
        self,
        bpe,
        layout: SpecialTokenLayout,
        multilingual: bool = True,
    ):
        self.bpe = bpe
        self.layout = layout
        self.multilingual = multilingual
        self._specials = layout.special_tokens()
        self._language_ids = {
            code: layout.language_start + i
            for i, code in enumerate(_language_codes(layout.n_languages))
        }

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_dir(cls, path: str, multilingual: bool = True) -> "WhisperTokenizer":
        """Load tokenizer assets from a local model directory.

        Accepts either ``vocab.json`` + ``merges.txt`` (GPT-2 layout) or
        a HF ``tokenizer.json`` (from which vocab and merges are
        extracted)."""
        vocab_path = os.path.join(path, "vocab.json")
        if not os.path.exists(vocab_path) and os.path.exists(
            os.path.join(path, "tokenizer.json")
        ):
            return cls._from_tokenizer_json(
                os.path.join(path, "tokenizer.json"), multilingual
            )
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        base_vocab = {
            t: i for t, i in vocab.items() if not t.startswith("<|")
        }
        n_base = max(base_vocab.values()) + 1
        n_langs = 100 if any("<|yue|>" in t for t in vocab) else 99
        layout = SpecialTokenLayout(n_base, n_langs)
        return cls(ByteLevelBPE(base_vocab, merges), layout, multilingual)

    @classmethod
    def _from_tokenizer_json(
        cls, path: str, multilingual: bool = True
    ) -> "WhisperTokenizer":
        """Build from a HF tokenizer.json (BPE model section)."""
        with open(path) as f:
            spec = json.load(f)
        model = spec.get("model", {})
        vocab = model.get("vocab", {})
        merges: List[Tuple[str, str]] = []
        for m in model.get("merges", []):
            if isinstance(m, str):
                a, b = m.split(" ")
            else:
                a, b = m
            merges.append((a, b))
        base_vocab = {t: i for t, i in vocab.items() if not t.startswith("<|")}
        n_base = max(base_vocab.values()) + 1
        added = {t["content"] for t in spec.get("added_tokens", [])}
        n_langs = 100 if "<|yue|>" in added else 99
        layout = SpecialTokenLayout(n_base, n_langs)
        return cls(ByteLevelBPE(base_vocab, merges), layout, multilingual)

    @classmethod
    def byte_fallback(
        cls, multilingual: bool = True, n_languages: int = 99
    ) -> "WhisperTokenizer":
        """Offline tokenizer with standard Whisper special-token IDs."""
        n_base = 50257 if multilingual else 50256
        layout = SpecialTokenLayout(n_base, n_languages)
        return cls(ByteFallbackBPE(n_base), layout, multilingual)

    # -- core -------------------------------------------------------------
    @property
    def eot(self) -> int:
        return self.layout.eot

    @property
    def sot(self) -> int:
        return self.layout.sot

    @property
    def no_speech(self) -> int:
        return self.layout.nospeech

    @property
    def no_timestamps(self) -> int:
        return self.layout.notimestamps

    @property
    def timestamp_begin(self) -> int:
        return self.layout.timestamp_begin

    @property
    def vocab_size(self) -> int:
        return self.layout.vocab_size

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text)

    def decode(self, ids: Iterable[int]) -> str:
        return self.bpe.decode(
            [i for i in ids if i < self.layout.n_base_vocab]
        )

    def decode_with_timestamps(self, ids: Iterable[int]) -> str:
        parts: List[str] = []
        chunk: List[int] = []
        for i in ids:
            if i >= self.timestamp_begin:
                parts.append(self.decode(chunk))
                chunk = []
                ts = (i - self.timestamp_begin) * TIMESTAMP_RESOLUTION
                parts.append(f"<|{ts:.2f}|>")
            else:
                chunk.append(i)
        parts.append(self.decode(chunk))
        return "".join(parts)

    def get_vocab(self) -> Dict[str, int]:
        """Full token→id map (base vocab + specials), the surface
        ``find_numeral_symbol_tokens`` scans (reference helpers.py:521)."""
        vocab = dict(self.bpe.vocab)
        vocab.update(self._specials)
        return vocab

    # -- prompts ----------------------------------------------------------
    def language_token(self, language: str) -> int:
        try:
            return self._language_ids[language]
        except KeyError:
            raise ValueError(f"no token for language {language!r}") from None

    def sot_sequence(
        self,
        language: Optional[str] = "en",
        task: str = "transcribe",
        without_timestamps: bool = True,
    ) -> List[int]:
        """``<|startoftranscript|>[<|lang|><|task|>][<|notimestamps|>]``."""
        seq = [self.sot]
        if self.multilingual and language is not None:
            seq.append(self.language_token(language))
            seq.append(
                self.layout.translate
                if task == "translate"
                else self.layout.transcribe
            )
        if without_timestamps:
            seq.append(self.no_timestamps)
        return seq

    def non_speech_tokens(self) -> List[int]:
        """Token ids for common non-speech annotations (♪, parenthesized
        noise tags, speaker brackets) suppressed during decoding.

        Mirrors openai-whisper's ``Tokenizer.non_speech_tokens`` exactly
        — the list ``suppress_tokens=[-1]`` expands into (the
        reference's default: diarize.py:126-130 passes ``[-1]`` to
        faster-whisper, and main.py:381-391 relies on openai-whisper's
        ``"-1"`` default):

        - single-token symbol spellings, bare and space-prefixed;
        - the U+2640–U+267F miscellaneous music symbols, whose FIRST
          token is suppressed even in multi-token spellings (they share
          UTF-8 prefix bytes, so the first token is safely specific);
        - hyphen/apostrophe only in word-initial (space-prefixed) form,
          keeping them legal between words.
        """
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        miscellaneous = set("♩♪♫♬♭♮♯")

        # allow hyphens "-" and single quotes "'" between words, but not
        # at the beginning of a word
        result = {self.encode(" -")[0], self.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for ids in (self.encode(symbol), self.encode(" " + symbol)):
                if len(ids) == 1 or symbol in miscellaneous:
                    result.add(ids[0])
        return sorted(result)


def get_suppressed_tokens(
    tokenizer: "WhisperTokenizer", suppress_tokens
) -> Tuple[int, ...]:
    """Expand the user-facing ``suppress_tokens`` option into the id
    list actually masked during text generation.

    Reproduces faster-whisper's ``get_suppressed_tokens`` and
    openai-whisper's ``_get_suppress_tokens`` (the engines behind
    reference diarize.py:126-130 and main.py:381-391):

    - a string ("-1" is openai-whisper's default) parses as
      comma-separated ids;
    - ``-1`` expands to :meth:`WhisperTokenizer.non_speech_tokens`;
    - the task/special tokens (translate, transcribe, sot, startofprev,
      startoflm) are ALWAYS suppressed, plus nospeech (openai-whisper
      collects its probability separately at the SOT step — as does
      ``engine.decode``)."""
    if suppress_tokens is None:
        out: List[int] = []
    elif isinstance(suppress_tokens, str):
        out = (
            [int(t) for t in suppress_tokens.split(",")]
            if suppress_tokens
            else []
        )
    else:
        out = list(suppress_tokens)
    if -1 in out:
        out = [t for t in out if t >= 0]
        out.extend(tokenizer.non_speech_tokens())
    layout = tokenizer.layout
    out.extend(
        [
            layout.translate,
            layout.transcribe,
            tokenizer.sot,
            layout.startofprev,
            layout.startoflm,
            tokenizer.no_speech,
        ]
    )
    return tuple(sorted(set(out)))


def find_numeral_symbol_tokens(tokenizer) -> List[int]:
    """Token ids containing digits or currency symbols, for
    ``suppress_tokens`` (contract: reference helpers.py:517-525)."""
    ids = [-1]
    for token, token_id in tokenizer.get_vocab().items():
        if any(c in "0123456789%$£" for c in token):
            ids.append(token_id)
    return ids
