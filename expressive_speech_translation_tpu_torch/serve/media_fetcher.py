"""Media fetchers for URL ingestion — the yt-dlp role (the JAX package's
``serve/media_fetcher.py``; host code, no device).

The reference shells into yt-dlp with platform-tuned options
(services/audio_link_routes.py:83-180: bestaudio format ladder, FFmpeg
wav postprocessor, TikTok extractor args) then loads the wav. This module
implements the same seam with two concrete fetchers behind
``default_fetcher``:

- :func:`ytdlp_fetcher` — shells out to a ``yt-dlp`` binary when one is on
  PATH (deployments install it next to the server; tests gate on its
  availability), extracting bestaudio to wav exactly like the reference.
- :func:`http_media_fetcher` — direct download of a media URL (streaming,
  size-capped) decoded through the native libav shim — covers direct links
  to .wav/.mp3/.mp4/... that need no site extractor.

``default_fetcher`` prefers yt-dlp for platform pages and falls back to the
direct downloader; with neither applicable it raises the same clear
MediaError the injectable seam always raised. ``urllib3`` and ``certifi`` are
imported by the direct downloader when it runs, never at module level.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

from ..core.errors import MediaError

log = logging.getLogger(__name__)

MAX_DOWNLOAD_BYTES = 100 * 1024 * 1024
DOWNLOAD_TIMEOUT_S = 120.0
YTDLP_TIMEOUT_S = 300.0

_MEDIA_SUFFIXES = (".wav", ".mp3", ".m4a", ".aac", ".ogg", ".opus", ".flac",
                   ".mp4", ".mov", ".webm", ".mkv")


def ytdlp_available() -> bool:
    return shutil.which("yt-dlp") is not None


def ytdlp_fetcher(url: str) -> Tuple[np.ndarray, int]:
    """bestaudio → wav via the yt-dlp binary (audio_link_routes.py:88-103
    option parity: bestaudio format ladder + FFmpegExtractAudio to wav)."""
    if not ytdlp_available():
        raise MediaError(
            "yt-dlp is not installed on this host",
            user_message="URL ingestion from this platform requires yt-dlp on the server",
        )
    with tempfile.TemporaryDirectory(prefix="est_ytdlp_") as tmp:
        out = Path(tmp) / "audio"
        cmd = [
            "yt-dlp", "-f", "bestaudio[ext=m4a]/bestaudio/best",
            "-x", "--audio-format", "wav", "--audio-quality", "192",
            "--no-warnings", "--no-playlist", "-o", str(out), url,
        ]
        try:
            proc = subprocess.run(cmd, capture_output=True, timeout=YTDLP_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise MediaError("yt-dlp timed out",
                             user_message="Media download timed out") from e
        if proc.returncode != 0:
            tail = proc.stderr.decode("utf-8", "replace")[-300:]
            raise MediaError(f"yt-dlp failed: {tail}",
                             user_message="Could not download media from this URL")
        wav = out.with_suffix(".wav")
        if not wav.exists():
            candidates = list(Path(tmp).glob("audio*"))
            if not candidates:
                raise MediaError("yt-dlp produced no output",
                                 user_message="Could not download media from this URL")
            wav = candidates[0]
        from ..media import native

        return native.decode_audio(str(wav), target_rate=16_000, target_channels=1)


def _resolve_public_host(url: str) -> str:
    """SSRF guard: resolve the URL's host ONCE, refuse anything non-global
    (private/loopback/link-local/reserved/CGNAT...), and return the
    validated IPs in resolver preference order. The caller must CONNECT TO
    A RETURNED IP (Host/SNI set to the hostname) — re-resolving at connect
    time reopens the check to DNS rebinding (a low-TTL name that alternates
    public ↔ 169.254.169.254 passes a check-then-refetch sequence).
    Applied per redirect hop."""
    import ipaddress
    import socket
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    if parts.scheme not in ("http", "https"):
        raise MediaError(f"refusing non-http(s) URL: {url[:80]}",
                         user_message="Only http/https media URLs are supported")
    host = parts.hostname or ""
    try:
        infos = socket.getaddrinfo(host, None)
    except socket.gaierror as e:
        raise MediaError(f"cannot resolve host {host!r}",
                         user_message="Could not download media from this URL") from e
    addrs = []
    for info in infos:
        ip = ipaddress.ip_address(info[4][0])
        # is_global is the authoritative test (it also covers special-use
        # ranges the individual flags miss — e.g. CGNAT 100.64.0.0/10, which
        # is neither private nor reserved yet routes to cloud-internal
        # networks); the explicit flags stay for clarity and as belt+braces
        if (not ip.is_global or ip.is_private or ip.is_loopback
                or ip.is_link_local or ip.is_reserved or ip.is_multicast
                or ip.is_unspecified):
            raise MediaError(
                f"host {host!r} resolves to non-public address {ip}",
                user_message="Could not download media from this URL")
        addrs.append(info[4][0])
    # dedupe preserving getaddrinfo's (RFC 6724) preference order
    return list(dict.fromkeys(addrs))


def _open_pinned(url: str, ip: str, timeout: float):
    """GET ``url`` connecting to the pinned ``ip`` (no second DNS lookup):
    TLS SNI + certificate hostname checks still run against the URL's
    hostname via urllib3's server_hostname/assert_hostname."""
    from urllib.parse import urlsplit

    import urllib3

    parts = urlsplit(url)
    host = parts.hostname or ""
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    t = urllib3.Timeout(connect=min(timeout, 30.0), read=timeout)
    default_port = 443 if parts.scheme == "https" else 80
    port = parts.port or default_port
    # http.client appends non-default ports automatically; a hand-built
    # Host header must do the same or port-based virtual hosts misroute
    host_hdr = host if port == default_port else f"{host}:{port}"
    if parts.scheme == "https":
        import certifi

        pool = urllib3.HTTPSConnectionPool(
            ip, port, server_hostname=host,
            assert_hostname=host, cert_reqs="CERT_REQUIRED",
            ca_certs=certifi.where(), timeout=t, maxsize=1)
    else:
        pool = urllib3.HTTPConnectionPool(ip, port, timeout=t, maxsize=1)
    resp = pool.urlopen("GET", path, headers={"Host": host_hdr},
                        redirect=False, preload_content=False,
                        retries=False)
    return pool, resp


def http_media_fetcher(
    url: str, *, max_bytes: int = MAX_DOWNLOAD_BYTES,
    timeout: float = DOWNLOAD_TIMEOUT_S, max_redirects: int = 5,
    allow_private_hosts: bool = False,
) -> Tuple[np.ndarray, int]:
    """Direct streaming download of a media file, decoded via the native
    libav shim (handles every container the shim does). Redirects are
    followed manually; every hop resolves the host once, validates the
    address, and connects to that pinned IP (the SSRF guard + the DNS-rebinding
    TOCTOU: a resolve-then-refetch sequence can be rebound between the
    check and the connect)."""
    from urllib.parse import urljoin, urlsplit

    import urllib3

    import time as _time

    deadline = _time.monotonic() + timeout
    pool = resp = None
    total = 0
    try:
        try:
            for _ in range(max_redirects + 1):
                if allow_private_hosts:  # test servers bind loopback
                    ips = [urlsplit(url).hostname or ""]
                    if urlsplit(url).scheme not in ("http", "https"):
                        raise MediaError(
                            f"refusing non-http(s) URL: {url[:80]}",
                            user_message="Only http/https media URLs are supported")
                else:
                    ips = _resolve_public_host(url)
                # dual-stack hosts: the first validated address may be a
                # family this egress cannot reach (AAAA-first on an
                # IPv4-only network) — try each in order
                last_err = None
                for ip in ips:
                    try:
                        pool, resp = _open_pinned(url, ip, timeout)
                        break
                    except OSError as e:
                        last_err = e
                        if pool is not None:
                            pool.close()
                            pool = resp = None
                else:
                    raise last_err or OSError("no address connected")
                nxt = resp.get_redirect_location()
                if nxt:
                    resp.release_conn()
                    pool.close()
                    pool = resp = None
                    url = urljoin(url, nxt)
                    continue
                break
            else:
                raise MediaError(
                    "too many redirects",
                    user_message="Could not download media from this URL")
        except (urllib3.exceptions.HTTPError, OSError) as e:
            raise MediaError(f"download failed: {e}",
                             user_message="Could not download media from this URL") from e
        if resp is None or resp.status != 200:
            code = "no response" if resp is None else f"HTTP {resp.status}"
            raise MediaError(f"download failed: {code}",
                             user_message="Could not download media from this URL")
        suffix = Path(url.split("?", 1)[0]).suffix.lower() or ".bin"
        # stream straight into the temp file (buffering the whole download
        # and then joining it doubled peak memory at the 100 MB cap), with a
        # WALL-CLOCK deadline: urllib3's read timeout is per-socket-read, so
        # a slow-trickling server would otherwise pin a worker for hours
        with tempfile.NamedTemporaryFile(suffix=suffix) as f:
            try:
                for chunk in resp.stream(1 << 20):
                    if _time.monotonic() > deadline:
                        raise MediaError(
                            f"download exceeded {timeout:.0f}s wall clock",
                            user_message="Media download timed out")
                    total += len(chunk)
                    if total > max_bytes:
                        raise MediaError(
                            f"download exceeds {max_bytes} bytes",
                            user_message="Media file is too large to import from URL")
                    f.write(chunk)
            except (urllib3.exceptions.HTTPError, OSError) as e:
                raise MediaError(f"download failed: {e}",
                                 user_message="Could not download media from this URL") from e
            if total == 0:
                raise MediaError("empty download",
                                 user_message="The URL returned no media data")
            f.flush()
            from ..media import native

            try:
                return native.decode_audio(f.name, target_rate=16_000,
                                           target_channels=1)
            except MediaError:
                raise
            except Exception as e:
                raise MediaError(
                    f"downloaded data is not decodable media: {e}",
                    user_message="The URL did not return a playable audio/video file",
                ) from e
    finally:
        if resp is not None:
            resp.release_conn()
        if pool is not None:
            pool.close()


def default_fetcher(url: str) -> Tuple[np.ndarray, int]:
    """yt-dlp for platform pages when installed; direct download for plain
    media links; a clear error otherwise."""
    path = url.split("?", 1)[0].lower()
    direct = path.endswith(_MEDIA_SUFFIXES)
    if direct:
        return http_media_fetcher(url)
    if ytdlp_available():
        return ytdlp_fetcher(url)
    raise MediaError(
        "no fetcher can handle this URL (yt-dlp not installed, not a direct media link)",
        user_message="URL ingestion from this platform requires yt-dlp on the server",
    )
