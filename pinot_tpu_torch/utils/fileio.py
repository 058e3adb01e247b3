"""Durable file writes (copy of ``pinot_tpu.utils.fileio``): write a
same-directory temp file, fsync it, rename it over the target and fsync
the directory, so a crash leaves the old or the new content, never a
partial file."""
from __future__ import annotations

import os
import tempfile


def atomic_write(path: str, text, binary: bool = False, fsync: bool = True) -> None:
    """Replace ``path`` with ``text`` (bytes when ``binary``) atomically;
    ``fsync=False`` keeps the atomic rename but not the durability."""
    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb" if binary else "w") as f:
            f.write(text)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            fsync_dir(dirname)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def fsync_dir(dirname: str) -> None:
    """fsync a directory so renames and creates within it are durable."""
    dfd = os.open(dirname or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
