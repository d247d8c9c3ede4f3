"""Request/response schemas for the serverless transcription API.

Counterpart of ``whisper_nemo_tpu/serving/schemas.py`` without pydantic,
on which the port does not depend: dataclasses with the same field
names, defaults, language allow-list and speaker-count knobs (the
reference's serverless contract, main.py:58-83). A request checks and coerces its fields as the
JAX package's pydantic model does (lax mode: ``"2"`` and ``2.0`` are the
int 2, ``"yes"`` and ``1`` are True) and ignores unknown ones; invalid
input raises ``ValueError``. ``audio_url`` is held to what pydantic's
``HttpUrl`` accepts: an absolute http or https URL with a host, written
back normalized (scheme and host lower-case, the host IDNA-encoded, a
default port dropped, a bare host given the path ``/``, the path's spaces
and non-ASCII characters percent-encoded), since ``str(audio_url)`` is
what the handler downloads.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import urllib.parse
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

VALID_LANGUAGES = ["fr", "en", "es", "de", "it", "auto"]

_DEFAULT_PORTS = {"http": 80, "https": 443}
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
# characters a URL keeps as they are; the rest is percent-encoded
_URL_SAFE = "!#$%&'()*+,-./:;=?@[]_~"


def http_url(value: Any) -> str:
    """``value`` as pydantic's ``HttpUrl`` writes it, or ``ValueError``."""
    if not isinstance(value, str):
        raise ValueError("URL input should be a string or URL")
    if not value:
        raise ValueError("Input should be a valid URL, input is empty")
    parts = urllib.parse.urlsplit(value.strip())
    if not parts.scheme:
        raise ValueError("Input should be a valid URL, relative URL without a base")
    scheme = parts.scheme.lower()
    if scheme not in _DEFAULT_PORTS:
        raise ValueError("URL scheme should be 'http' or 'https'")
    host = parts.hostname
    if not host:
        raise ValueError("Input should be a valid URL, empty host")
    try:
        port = parts.port
    except ValueError:
        raise ValueError("Input should be a valid URL, invalid port number") from None
    if host.startswith("[") or ":" in host:  # an IPv6 literal
        try:
            host = f"[{ipaddress.IPv6Address(host.strip('[]'))}]"
        except ValueError:
            raise ValueError("Input should be a valid URL, invalid IPv6 address") from None
    else:
        try:
            host = host.encode("idna").decode("ascii")
        except UnicodeError:
            raise ValueError("Input should be a valid URL, invalid international domain name") \
                from None
        if any(c.isspace() for c in host):
            raise ValueError("Input should be a valid URL, invalid international domain name")
    netloc = host if port in (None, _DEFAULT_PORTS[scheme]) else f"{host}:{port}"
    if parts.username is not None:
        userinfo = parts.username + (f":{parts.password}" if parts.password is not None else "")
        netloc = f"{userinfo}@{netloc}"
    path = urllib.parse.quote(parts.path, safe=_URL_SAFE) or "/"
    url = f"{scheme}://{netloc}{path}"
    if parts.query:
        url += "?" + urllib.parse.quote(parts.query, safe=_URL_SAFE)
    if parts.fragment:
        url += "#" + urllib.parse.quote(parts.fragment, safe=_URL_SAFE)
    return url


def _optional_int(value: Any) -> Optional[int]:
    if value is None or isinstance(value, int):
        return None if value is None else int(value)  # a bool is 0 or 1
    if isinstance(value, str):
        text = value.strip()
        try:
            return int(text)
        except ValueError:
            try:
                value = float(text)
            except ValueError:
                raise ValueError("Input should be a valid integer, unable to parse string as an"
                                 " integer") from None
    if isinstance(value, float):
        if not value.is_integer():
            raise ValueError("Input should be a valid integer, got a number with a fractional"
                             " part")
        return int(value)
    raise ValueError("Input should be a valid integer")


def _optional_bool(value: Any) -> Optional[bool]:
    if value is None or isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
        return value.strip().lower() in _TRUE
    raise ValueError("Input should be a valid boolean, unable to interpret input")


def _language(value: Any) -> Optional[str]:
    if value not in VALID_LANGUAGES:
        raise ValueError(f"Invalid language. Choose from: {VALID_LANGUAGES}")
    return value


@dataclass
class TranscriptionRequest:
    audio_url: str
    language: Optional[str] = "fr"
    num_speakers: Optional[int] = None
    min_speakers: Optional[int] = 1
    max_speakers: Optional[int] = 4
    transcription_only: Optional[bool] = False

    def __post_init__(self):
        errors = []
        for name, check in (("audio_url", http_url), ("language", _language),
                            ("num_speakers", _optional_int), ("min_speakers", _optional_int),
                            ("max_speakers", _optional_int), ("transcription_only", _optional_bool)):
            try:
                setattr(self, name, check(getattr(self, name)))
            except ValueError as exc:
                errors.append(f"{name}: {exc}")
        if errors:
            raise ValueError(
                f"{len(errors)} validation error{'s' if len(errors) > 1 else ''} for"
                f" TranscriptionRequest: " + "; ".join(errors))

    @classmethod
    def from_input(cls, data: Dict[str, Any]) -> "TranscriptionRequest":
        """A request from a job's ``input``, unknown keys ignored, as the
        pydantic model ignores them."""
        if "audio_url" not in data:
            raise ValueError("1 validation error for TranscriptionRequest: audio_url: Field"
                             " required")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})


@dataclass(kw_only=True)
class TranscriptionResponse:
    success: bool
    model: str
    transcription_brute: str
    transcription_formatee: Optional[str] = None
    segments_detailles: Optional[List[Dict[str, Any]]] = None
    parametres: Dict[str, Any]
    statistiques: Dict[str, Any]
    processing_time: float
    error: Optional[str] = None
