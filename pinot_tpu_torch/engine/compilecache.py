"""Persistent compile cache: warm restarts for the device lanes (port of
``pinot_tpu.engine.compilecache`` on the card).

What a restarted server pays before its first queries are fast is, on
the card, the ``nvcc`` build of the kernels' libraries (seconds to a
minute, at ``ServerInstance`` construction) and, at each plan digest's
first launch, the CUDA module's lazy load and the caching allocator's
first blocks (``compile.firstCallMs``).  This module keeps the first
across restarts and makes the second honest to account for:

- **The libraries.**  With ``PINOT_TPU_COMPILE_CACHE_DIR`` set, the
  kernels build under ``<root>/ext/<fingerprint>`` (``library_dir``)
  instead of the checkout's ``build/``.  The fingerprint digests the
  torch version, the CUDA version, the device name and capability, the
  device count and the x64 mode: a library built by another toolkit or
  for another card lands in another directory, so it can be missed,
  never loaded stale (``build/`` keys a library by its source and flags
  only).

- **A plan ledger.**  One small JSON file per (plan digest, fingerprint)
  after a digest's first successful launch, so the first launch of that
  digest in a later process is classified ``persistent`` (the ledger
  proves this topology ran it before) rather than ``cold``, and the
  ``compile.cold`` meter stays honest across restarts.  A corrupt or
  alien entry is a miss, never a crash: the ledger is accounting.

Everything is gated on ``PINOT_TPU_COMPILE_CACHE_DIR``; unset, nothing
is written or read and the kernels build in ``build/`` as before.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)


def cache_root() -> Optional[str]:
    """The persistent-cache root, or None when the feature is off."""
    root = os.environ.get("PINOT_TPU_COMPILE_CACHE_DIR", "").strip()
    return root or None


def enabled() -> bool:
    return cache_root() is not None


def topology_fingerprint(
    torch_version: Optional[str] = None,
    cuda_version: Optional[str] = None,
    device_name: Optional[str] = None,
    capability: Optional[str] = None,
    device_count: Optional[int] = None,
    x64: bool = True,
) -> str:
    """Short stable digest of everything that must separate cache keys.

    A built library and a ledger entry are only reusable under the same
    torch and CUDA versions, the same card (name and compute capability),
    the same device count and the same float-width mode; any of these
    changing gives another fingerprint, so old entries become
    unreachable, not wrong.  Every axis is overridable so tests can show
    that each one separates keys without owning a second card.  Reading
    the card's name initializes CUDA: call this where the card is in use
    (the lane's first launch, the kernels' build)."""
    if torch_version is None:
        torch_version = torch.__version__
    if cuda_version is None:
        cuda_version = torch.version.cuda or "none"
    available = torch.cuda.is_available()
    if device_count is None:
        device_count = torch.cuda.device_count() if available else 0
    if device_name is None:
        device_name = torch.cuda.get_device_name(0) if available else "cpu"
    if capability is None:
        capability = ("%d.%d" % torch.cuda.get_device_capability(0)) if available else "none"
    payload = json.dumps(
        {
            "torch": torch_version,
            "cuda": cuda_version,
            "device": device_name,
            "capability": capability,
            "devices": int(device_count),
            "x64": bool(x64),
        },
        sort_keys=True,
    )
    return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


def library_dir(root: Optional[str] = None) -> Optional[str]:
    """Where the kernels' libraries build under the cache root
    (``<root>/ext/<fingerprint>``), or None when the cache is off.  The
    libraries do not depend on the precision, so the x64 axis is fixed
    here."""
    if root is None:
        root = cache_root()
    if root is None:
        return None
    return os.path.join(root, "ext", topology_fingerprint())


# -- plan ledger ------------------------------------------------------------


def _plan_path(root: str, digest: str, fingerprint: str) -> str:
    # digest and fingerprint are short hex; sanitize anyway so a hostile
    # digest string can never escape the ledger directory
    safe = "".join(c for c in f"{digest}-{fingerprint}" if c.isalnum() or c == "-")
    return os.path.join(root, "plans", f"{safe}.json")


def record_plan(digest: str, fingerprint: Optional[str] = None, root: Optional[str] = None) -> bool:
    """Mark a plan digest as launched under this topology.  Atomic (a
    per-process temporary file, then a rename), so a crash mid-write
    leaves a valid entry or none."""
    if root is None:
        root = cache_root()
    if root is None or not digest:
        return False
    if fingerprint is None:
        fingerprint = topology_fingerprint()
    path = _plan_path(root, digest, fingerprint)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "digest": digest,
                    "fingerprint": fingerprint,
                    "torchVersion": torch.__version__,
                    "recordedAtMs": int(time.time() * 1000),
                },
                f,
            )
        os.replace(tmp, path)
        return True
    except OSError:
        logger.warning("plan ledger write failed: %s", path, exc_info=True)
        return False


def known_plan(digest: str, fingerprint: Optional[str] = None, root: Optional[str] = None) -> bool:
    """True when the ledger shows this digest launched on THIS topology.
    Every failure (missing, unreadable, corrupt or truncated file, an
    alien entry whose digest or fingerprint disagrees with its name) is a
    miss."""
    if root is None:
        root = cache_root()
    if root is None or not digest:
        return False
    if fingerprint is None:
        fingerprint = topology_fingerprint()
    path = _plan_path(root, digest, fingerprint)
    try:
        with open(path) as f:
            entry = json.load(f)
    except (OSError, ValueError):
        return False
    return isinstance(entry, dict) and entry.get("digest") == digest and entry.get("fingerprint") == fingerprint
