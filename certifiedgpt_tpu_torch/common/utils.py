"""URL-or-path checkpoint resolution with a local download cache.

A copy of ``certifiedgpt_tpu/common/utils.py`` (standard library only): the
model loaders resolve each configured checkpoint through
``resolve_checkpoint``, which passes a local path through and downloads a
URL once into the cache directory.
"""

from __future__ import annotations

import hashlib
import logging
import os
import urllib.parse
import urllib.request

logger = logging.getLogger(__name__)

DEFAULT_CACHE_DIR = os.path.expanduser("~/.cache/certifiedgpt_tpu_torch")


def is_url(path_or_url: str) -> bool:
    scheme = urllib.parse.urlparse(str(path_or_url)).scheme
    return scheme in ("http", "https")


def get_abs_path(rel_path: str, root: str | None = None) -> str:
    root = root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, rel_path)


def cached_download(url: str, cache_dir: str | None = None) -> str:
    """Download ``url`` once into the cache dir; return the local path."""
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    name = os.path.basename(urllib.parse.urlparse(url).path) or "download"
    digest = hashlib.sha256(url.encode()).hexdigest()[:16]
    target = os.path.join(cache_dir, f"{digest}_{name}")
    if os.path.exists(target):
        return target
    logger.info("Downloading %s -> %s", url, target)
    tmp = target + ".tmp"
    urllib.request.urlretrieve(url, tmp)
    os.replace(tmp, target)
    return target


def resolve_checkpoint(path_or_url: str, cache_dir: str | None = None) -> str:
    """Local path passthrough; URLs download-and-cache."""
    if is_url(path_or_url):
        return cached_download(path_or_url, cache_dir)
    return str(path_or_url)
