"""Segment fetchers dispatched by download-URI scheme (port of
``pinot_tpu.segment.fetcher``, trimmed to ``file://`` and ``http(s)://``).

Both server starters resolve a segment's ``downloadUri`` through
``DEFAULT_FACTORY``: a local path or ``file://`` URI is copied, an
``http://`` one is downloaded with full-jitter exponential-backoff
retries.  With an expected CRC the fetched copy is parsed and verified
before it is renamed into place, so bad bytes are never installed.
Other schemes (the reference's ``hdfs://``) raise ``ValueError`` unless a
fetcher is registered for them.
"""
from __future__ import annotations

import os
import shutil
import urllib.parse
import urllib.request
from typing import Dict, Optional

from pinot_tpu_torch.segment.format import (
    SEGMENT_FILE_NAME,
    SegmentIntegrityError,
    SegmentStaleError,
    read_segment,
    verify_segment_crc,
)
from pinot_tpu_torch.utils.retry import ExponentialBackoffRetryPolicy


class SegmentFetcher:
    """Copy the segment file at ``uri`` to the local file ``dest_path``."""

    def fetch(self, uri: str, dest_path: str) -> None:
        raise NotImplementedError


class LocalFileSegmentFetcher(SegmentFetcher):
    """``file://`` URIs and bare paths (a segment directory or its file)."""

    def fetch(self, uri: str, dest_path: str) -> None:
        parsed = urllib.parse.urlparse(uri)
        src = parsed.path if parsed.scheme == "file" else uri
        if os.path.isdir(src):
            src = os.path.join(src, SEGMENT_FILE_NAME)
        shutil.copyfile(src, dest_path)


class HttpSegmentFetcher(SegmentFetcher):
    """``http(s)://`` download with full-jitter retries.  The body streams
    into ``dest_path + ".part"`` and only a complete one (its length
    checked against Content-Length) is renamed into place."""

    def __init__(self, timeout_s: float = 120.0, attempts: int = 3) -> None:
        self.timeout_s = timeout_s
        self.policy = ExponentialBackoffRetryPolicy(attempts, 0.2, jitter=True)

    def fetch(self, uri: str, dest_path: str) -> None:
        def once():
            tmp = dest_path + ".part"
            try:
                with urllib.request.urlopen(uri, timeout=self.timeout_s) as r:
                    expected = r.headers.get("Content-Length")
                    with open(tmp, "wb") as f:
                        shutil.copyfileobj(r, f)
                if expected is not None and os.path.getsize(tmp) != int(expected):
                    raise IOError(f"truncated download from {uri}: {os.path.getsize(tmp)} of {expected} bytes")
                os.replace(tmp, dest_path)
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise

        self.policy.attempt(once)


class SegmentFetcherFactory:
    """scheme -> fetcher registry (SegmentFetcherFactory.java)."""

    def __init__(self) -> None:
        local, http = LocalFileSegmentFetcher(), HttpSegmentFetcher()
        self._fetchers: Dict[str, SegmentFetcher] = {"": local, "file": local, "http": http, "https": http}

    def register(self, scheme: str, fetcher: SegmentFetcher) -> None:
        self._fetchers[scheme] = fetcher

    def for_uri(self, uri: str) -> SegmentFetcher:
        scheme = urllib.parse.urlparse(uri).scheme
        f = self._fetchers.get(scheme)
        if f is None:
            raise ValueError(f"no segment fetcher registered for scheme {scheme!r} ({uri})")
        return f

    def fetch(self, uri: str, dest_path: str, expected_crc: Optional[int] = None, suspect_cb=None):
        """Fetch ``uri`` to ``dest_path``.  With ``expected_crc`` the copy
        lands in a side file, is parsed and CRC-verified, and only then
        renamed into place; a corrupt copy raises ``SegmentIntegrityError``
        (a consistent copy of another version ``SegmentStaleError``) and
        leaves ``dest_path`` untouched.  Returns the parsed, verified
        segment on that path (None without a CRC).  ``suspect_cb(uri,
        exc)`` hears of fetched bytes that failed verification."""
        os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
        if expected_crc is None:
            self.for_uri(uri).fetch(uri, dest_path)
            return None
        tmp = dest_path + ".verify"
        self.for_uri(uri).fetch(uri, tmp)
        try:
            try:
                seg = read_segment(tmp)
            except Exception as e:  # unparseable: corrupt beyond the CRC
                raise SegmentIntegrityError(
                    f"fetched segment from {uri} is unreadable: {type(e).__name__}: {e}"
                ) from e
            verify_segment_crc(seg, source=uri)
            if seg.metadata.crc and seg.metadata.crc != expected_crc:
                raise SegmentStaleError(
                    f"fetched segment from {uri}: metadata CRC {seg.metadata.crc} != "
                    f"expected {expected_crc} (stale copy)"
                )
        except BaseException as exc:
            try:
                os.remove(tmp)
            except OSError:
                pass
            if suspect_cb is not None and isinstance(exc, SegmentIntegrityError) \
                    and not isinstance(exc, SegmentStaleError):
                try:
                    suspect_cb(uri, exc)
                except Exception:
                    pass  # reporting never masks the fetch error
            raise
        os.replace(tmp, dest_path)
        return seg


DEFAULT_FACTORY = SegmentFetcherFactory()
