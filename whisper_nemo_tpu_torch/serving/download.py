"""Async audio download with the reference's guard rails.

A copy of ``whisper_nemo_tpu/serving/download.py``, carried so that the
port imports nothing of the JAX package, but for its aiohttp import,
which moved into ``download_audio_file``: the module imports where
aiohttp is absent, and the call raises an ImportError naming it.

Contract (main.py:317-359): aiohttp GET with a 300 s total timeout, a
500 MB size cap, content-type–based extension sniffing over the same
format list, temp-file persistence, and ValueError-wrapped failures.
"""

from __future__ import annotations

import asyncio
import tempfile

MAX_FILE_SIZE = 500 * 1024 * 1024  # 500 MB
DOWNLOAD_TIMEOUT = 300  # seconds

_CONTENT_TYPE_SUFFIXES = (
    (("mp3", "mpeg"), ".mp3"),
    (("mp4",), ".mp4"),
    (("m4a",), ".m4a"),
    (("ogg",), ".ogg"),
    (("flac",), ".flac"),
    (("webm",), ".webm"),
)


def suffix_for_content_type(content_type: str) -> str:
    content_type = (content_type or "").lower()
    for keys, suffix in _CONTENT_TYPE_SUFFIXES:
        if any(k in content_type for k in keys):
            return suffix
    return ".wav"


async def download_audio_file(url: str) -> str:
    """Download ``url`` to a temp file; returns the path."""
    try:
        import aiohttp
    except ImportError as exc:
        raise ImportError("downloading a job's audio needs aiohttp") from exc

    timeout = aiohttp.ClientTimeout(total=DOWNLOAD_TIMEOUT)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        try:
            async with session.get(str(url)) as response:
                if response.status != 200:
                    raise ValueError(
                        f"HTTP {response.status}: {response.reason}"
                    )
                content = await response.read()
                if len(content) > MAX_FILE_SIZE:
                    raise ValueError(
                        f"File too large: {len(content)} bytes"
                        f" (max: {MAX_FILE_SIZE})"
                    )
                suffix = suffix_for_content_type(
                    response.headers.get("content-type", "")
                )
                tmp = tempfile.NamedTemporaryFile(
                    delete=False, suffix=suffix
                )
                tmp.write(content)
                tmp.close()
                return tmp.name
        except asyncio.TimeoutError:
            raise ValueError("Download timeout")
        except ValueError:
            raise
        except Exception as exc:
            raise ValueError(f"Download failed: {exc}") from exc
