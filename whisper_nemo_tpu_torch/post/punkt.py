"""The sentence-break predicate of an untrained Punkt tokenizer.

``text_contains_sentbreak(text)`` answers as
``nltk.tokenize.PunktSentenceTokenizer().text_contains_sentbreak(text)``
does: the tokenizer made with no training, so its parameters are empty (no
abbreviation types, collocations or frequent sentence starters, and no
orthographic context). ``post/speaker_map.py`` starts a new sentence where
it answers True, as the JAX package's copy of that module does through
nltk. The port keeps this copy so that it needs no nltk, which the card
lacks.

Adapted from NLTK 3.10.0, ``nltk/tokenize/punkt.py`` (Apache License 2.0;
Copyright (C) 2001-2026 NLTK Project; algorithm by Kiss and Strunk, 2006;
authors Willy, Steven Bird, Edward Loper, Joel Nothman, Arthur Darcet and
Tom Aarsen): ``PunktLanguageVars``' word tokenizer and sentence-end
characters, ``PunktToken``'s properties, ``_tokenize_words``, the first
and second annotation passes with the orthographic heuristic, and the loop
of ``text_contains_sentbreak`` that ignores the last token. With empty
parameters, the collocation and sentence-starter rules never fire, and
the orthographic heuristic never answers True. nltk's word regex has
changed between versions: ``tests/test_torch_post.py`` holds this copy
against the nltk installed beside the JAX package.
"""

from __future__ import annotations

import re
from typing import Iterator, Optional, Union

# PunktLanguageVars
SENT_END_CHARS = (".", "?", "!")
_RE_WORD_START = r"[^\(\"\`{\[:;&\#\*@\)}\]\-,]"
_RE_NON_WORD_CHARS = r"(?:[)\";}\]\*:@\'\({\[%s])" % re.escape("?!")
_RE_MULTI_CHAR_PUNCT = r"(?:\-{2,}|\.{2,}|(?:\.\s){2,}\.)"
_WORD_TOKENIZE_FMT = r"""(
        %(MultiChar)s
        |
        (?=%(WordStart)s)\S+?  # Accept word characters until end is found
        (?= # Sequences marking a word's end
            \s|                                 # White-space
            $|                                  # End-of-string
            %(NonWord)s|%(MultiChar)s|          # Punctuation
            ,(?=$|\s|%(NonWord)s|%(MultiChar)s) # Comma if at end of word
        )
        |
        \S
    )"""
_WORD_TOKENIZER = re.compile(
    _WORD_TOKENIZE_FMT % {"NonWord": _RE_NON_WORD_CHARS, "MultiChar": _RE_MULTI_CHAR_PUNCT,
                          "WordStart": _RE_WORD_START},
    re.UNICODE | re.VERBOSE,
)

# PunktSentenceTokenizer.PUNCTUATION: sentences don't start with these
PUNCTUATION = tuple(";:,.!?")

_RE_ELLIPSIS = re.compile(r"\.\.+$")
_RE_NUMERIC = re.compile(r"^-?[\.,]?\d[\d,\.-]*\.?$")
_RE_INITIAL = re.compile(r"[^\W\d]\.$", re.UNICODE)


class _Token:
    """``PunktToken``: a word token, its case-normalised type (numbers as
    ``##number##``) and the annotations the two passes set."""

    __slots__ = ("tok", "type", "period_final", "sentbreak")

    def __init__(self, tok: str):
        self.tok = tok
        self.type = _RE_NUMERIC.sub("##number##", tok.lower())
        self.period_final = tok.endswith(".")
        self.sentbreak = None

    @property
    def type_no_period(self) -> str:
        if len(self.type) > 1 and self.type[-1] == ".":
            return self.type[:-1]
        return self.type

    @property
    def first_upper(self) -> bool:
        return self.tok[0].isupper()

    @property
    def first_lower(self) -> bool:
        return self.tok[0].islower()

    @property
    def is_ellipsis(self) -> bool:
        return bool(_RE_ELLIPSIS.match(self.tok))

    @property
    def is_initial(self) -> bool:
        return bool(_RE_INITIAL.match(self.tok))


def _tokenize_words(text: str) -> Iterator[_Token]:
    """Word tokens of each non-blank line (the paragraph and line-start
    flags nltk also records are read by no rule below)."""
    for line in text.split("\n"):
        if line.strip():
            for tok in _WORD_TOKENIZER.findall(line):
                yield _Token(tok)


def _first_pass_annotation(aug_tok: _Token) -> None:
    """Type-based: a sentence-end character or a word ending in one period
    is a sentence break (no abbreviation is known); an ellipsis is none."""
    tok = aug_tok.tok
    if tok in SENT_END_CHARS:
        aug_tok.sentbreak = True
    elif aug_tok.period_final and not aug_tok.is_ellipsis and not tok.endswith(".."):
        aug_tok.sentbreak = True


def _ortho_heuristic(aug_tok: _Token) -> Union[bool, str]:
    """Whether ``aug_tok`` starts a sentence, with no orthographic context:
    never True; False for punctuation and for a lower-case word."""
    if aug_tok.tok in PUNCTUATION:
        return False
    if aug_tok.first_lower:
        return False
    return "unknown"


def _second_pass_annotation(aug_tok1: _Token, aug_tok2: Optional[_Token]) -> None:
    """Token-based: an initial or a number ending in a period is no
    sentence break when the next word does not start one, and an initial
    is none before a capitalised word either (as in "J. Bach")."""
    if aug_tok2 is None or not aug_tok1.period_final:
        return
    tok_is_initial = aug_tok1.is_initial
    if tok_is_initial or aug_tok1.type_no_period == "##number##":
        is_sent_starter = _ortho_heuristic(aug_tok2)
        if is_sent_starter is False or (
            is_sent_starter == "unknown" and tok_is_initial and aug_tok2.first_upper
        ):
            aug_tok1.sentbreak = False


def _annotate_tokens(tokens: Iterator[_Token]) -> Iterator[_Token]:
    prev = None
    for tok in tokens:
        _first_pass_annotation(tok)
        if prev is not None:
            _second_pass_annotation(prev, tok)
            yield prev
        prev = tok
    if prev is not None:
        _second_pass_annotation(prev, None)
        yield prev


def text_contains_sentbreak(text: str) -> bool:
    """True if ``text`` holds a sentence break before its last token."""
    found = False  # a break on the last token is ignored
    for tok in _annotate_tokens(_tokenize_words(text)):
        if found:
            return True
        if tok.sentbreak:
            found = True
    return False
