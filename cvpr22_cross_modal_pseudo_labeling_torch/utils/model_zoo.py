"""URL weight cache and the ``MODEL.WEIGHT`` resolution chain.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
model_zoo.py`` (reference utils/model_zoo.py:20 cache_url and
utils/checkpoint.py:132-154).  ``MODEL.WEIGHT`` may be a local path, a ``catalog://`` key
(``data/paths_catalog.py::ModelCatalog``) or an http(s) URL.  URLs
resolve through the cache ``$CMPL_TPU_MODEL_ZOO`` (default
``~/.cache/cmpl_tpu/models``), keyed by the URL's file name; Detectron's
shared ``model_final.pkl`` names are flattened with their path, as the
reference does.  A URL that is not in the cache is downloaded once, by
rank 0 while the other ranks wait at a barrier; a failed download raises
on every rank after it.
"""

import os
import re
from urllib.parse import urlparse

from ..parallel.dist import barrier, is_primary

_HASH_RE = re.compile(r"-([a-f0-9]*)\.")


def default_cache_dir() -> str:
    return os.environ.get(
        "CMPL_TPU_MODEL_ZOO", os.path.join(os.path.expanduser("~"), ".cache", "cmpl_tpu", "models")
    )


def cached_name(url: str) -> str:
    """The cache's file name for ``url``."""
    parts = urlparse(url)
    filename = os.path.basename(parts.path)
    if filename == "model_final.pkl":
        # Detectron zoo: every model is model_final.pkl -- flatten the
        # path into the name (reference model_zoo.py:46-48)
        filename = parts.path.replace("/", "_")
    return filename


def cache_url(url: str, model_dir: str = None, progress: bool = True) -> str:
    """The local path of ``url``, downloaded into the cache on first
    use."""
    model_dir = model_dir or default_cache_dir()
    os.makedirs(model_dir, exist_ok=True)
    cached_file = os.path.join(model_dir, cached_name(url))
    error = None
    if not os.path.exists(cached_file) and is_primary():
        error = _download(url, cached_file, progress)
    barrier()
    if not os.path.exists(cached_file):
        if error and error.startswith("hash mismatch"):
            # corrupt or tampered download: distinct from a cache miss
            raise ValueError(f"weight URL {url}: {error}")
        detail = f": {error}" if error else " on rank 0"
        raise FileNotFoundError(
            f"weight URL {url} not in cache {model_dir} and download failed{detail}; "
            "pre-populate the cache on this host"
        )
    return cached_file


def _download(url: str, dst: str, progress: bool):
    """Downloads ``url`` to ``dst`` through a temporary file; returns
    None, or the failure's message."""
    import shutil
    import sys
    import tempfile
    import urllib.request

    sys.stderr.write(f'Downloading: "{url}" to {dst}\n')
    tmp_fd, tmp_path = tempfile.mkstemp(dir=os.path.dirname(dst))
    os.close(tmp_fd)
    try:
        try:
            with urllib.request.urlopen(url, timeout=60) as r, open(tmp_path, "wb") as f:
                shutil.copyfileobj(r, f)
        except Exception as e:  # network-layer failure: report, don't mask
            return f"{type(e).__name__}: {e}"
        try:
            _verify_hash(tmp_path, dst)
        except ValueError as e:
            return str(e)
        os.replace(tmp_path, dst)
        return None
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def _verify_hash(path: str, dst: str) -> None:
    """torch-zoo convention: filename-<sha256prefix>.ext (prefix >= 6
    chars; Caffe2 names carry shorter non-hash suffixes, skipped like
    the reference, model_zoo.py:53-59)."""
    m = _HASH_RE.search(os.path.basename(dst))
    if not m or len(m.group(1)) < 6:
        return
    import hashlib

    sha = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha.update(chunk)
    digest = sha.hexdigest()
    if not digest.startswith(m.group(1)):
        raise ValueError(f"hash mismatch for {dst}: expected prefix {m.group(1)}, got {digest[:16]}")


def resolve_weight_path(weight: str) -> str:
    """The checkpoint.py:132-154 resolution chain: catalog:// -> URL or
    path; http(s):// -> cache_url; anything else returned as it is."""
    if not weight:
        return weight
    if weight.startswith("catalog://"):
        from ..data.paths_catalog import ModelCatalog

        weight = ModelCatalog.get(weight)
    if weight.startswith(("http://", "https://")):
        weight = cache_url(weight)
    return weight
