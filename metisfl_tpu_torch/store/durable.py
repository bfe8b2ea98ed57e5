"""Shared atomic-rename-then-ack durable-write idiom (the port's copy of
the JAX package's ``store/durable.py``).

A record is written to a unique temp file in the TARGET directory and
``os.replace``d into place BEFORE the caller acks anything — a crash at
any instant leaves either the previous record or the new one, never a
torn file at the final path. Reads tolerate torn/unreadable files (a
record mid-rename on a crashed box must not abort recovery of the
records that did land).

Files keyed by externally supplied identifiers (learner ids, record
kinds) go through :func:`sanitize_id`, which maps them to filesystem-safe
names with a digest suffix so two DISTINCT hostile ids can never collide
onto one file — a collision would let the second acked record silently
overwrite the first's durability guarantee.
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile
from typing import Any, Callable, Optional

logger = logging.getLogger("metisfl_tpu_torch.store.durable")


def sanitize_id(identifier: str) -> str:
    """A filesystem-safe token for ``identifier``. Well-formed ids
    (``[alnum._-]`` only, e.g. ``L<idx>_<host>_<port>``) pass through
    unchanged; anything else is sanitized with a short sha1 suffix so
    distinct hostile ids stay distinct on disk. The EXACT id must ride
    inside the record itself — the filename alone does not round-trip."""
    safe = "".join(c if (c.isalnum() or c in "._-") else "_"
                   for c in identifier)
    if safe != identifier:
        safe += "-" + hashlib.sha1(
            identifier.encode("utf-8", "surrogatepass")).hexdigest()[:8]
    return safe


def atomic_write(path: str, payload: bytes, prefix: str = ".tmp_") -> None:
    """Durably write ``payload`` to ``path``: unique temp file in the
    target directory (concurrent writers never share a staging file),
    then atomic ``os.replace``. On any failure the temp file is removed
    and the previous content of ``path`` (if any) is untouched."""
    target_dir = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=target_dir, prefix=prefix, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_tolerant(path: str,
                  decode: Optional[Callable[[bytes], Any]] = None) -> Any:
    """Read (and optionally decode) one durable record, tolerating torn
    or unreadable files: any OSError/ValueError/KeyError/TypeError is
    logged and swallowed, returning ``None`` — recovery must salvage
    the records that did land, not abort on the ones that did not."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
        return decode(raw) if decode is not None else raw
    except (OSError, ValueError, KeyError, TypeError) as exc:
        logger.warning("durable record %s unreadable (%s); skipped",
                       path, exc)
        return None
