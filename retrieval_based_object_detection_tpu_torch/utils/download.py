"""Shared streaming download helper for checkpoint caches.

One implementation of the fetch-on-demand flow both model families use
(the reference downloads SAM from fbaipublicfiles, 22a:24-38, and CLIP
via ``clip.load``, 31:23-27): stream to a ``.part`` file with a progress
meter, optionally SHA256-verify, rename into place on success — an
interrupted or corrupted fetch never leaves a truncated file behind.
"""

from __future__ import annotations

import hashlib
import sys
import urllib.error
import urllib.request
from pathlib import Path


class DownloadError(RuntimeError):
    """Streaming fetch failed or the payload failed verification."""


def fetch_with_cache(url: str, dest: Path, expected_sha256: str | None = None,
                     quiet: bool = False, label: str = "checkpoint") -> Path:
    """Return ``dest``, downloading from ``url`` if absent.

    Streams via ``dest.part`` (renamed on completion), prints a progress
    meter when the server sends Content-Length, and — when
    ``expected_sha256`` is given — refuses to cache a payload whose
    digest mismatches. Raises DownloadError on any failure; the cache
    never holds a partial or unverified file."""
    dest = Path(dest)
    if dest.exists():
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    part = dest.with_suffix(dest.suffix + ".part")
    if not quiet:
        print(f"[rbod] downloading {label} from {url} -> {dest}",
              file=sys.stderr)
    try:
        digest = hashlib.sha256()
        with urllib.request.urlopen(url, timeout=30) as resp, \
                open(part, "wb") as f:
            total = int(resp.headers.get("Content-Length") or 0)
            done = 0
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
                digest.update(chunk)
                done += len(chunk)
                if not quiet and total:
                    pct = 100 * done / total
                    print(f"\r[rbod]   {done >> 20} MiB / {total >> 20} MiB"
                          f" ({pct:.0f}%)", end="", file=sys.stderr)
        if not quiet and total:
            print(file=sys.stderr)
        if expected_sha256 is not None and digest.hexdigest() != expected_sha256:
            part.unlink(missing_ok=True)
            raise DownloadError(
                f"downloaded {label} failed SHA256 verification (got "
                f"{digest.hexdigest()}, expected {expected_sha256}) — "
                f"refusing to cache it")
        part.rename(dest)
        return dest
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        part.unlink(missing_ok=True)
        raise DownloadError(
            f"{label} download from {url} failed ({e})") from e
