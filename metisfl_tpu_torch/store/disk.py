"""Disk-backed model store (the port's copy of the JAX package's
``store/disk.py``, with the same files).

Each model is one blob file under ``<root>/<learner_id>/<seq>.blob`` (a
packed model) or ``<seq>.opaque`` (raw bytes, e.g. ciphertexts, kept
verbatim), so a restarted controller finds the latest lineage: the
sequence numbers ARE the bookkeeping. A directory written by either
package is read by the other.

Values are flat ``{wire_name: array}`` dicts (written as store-local v3
blobs through the copy-free :func:`write_named_tensors`), other trees
(through :func:`pack_model`), or raw ``bytes``. Arrays may be numpy
arrays or torch tensors; they read back as read-only numpy views over an
``mmap`` of the file, the host form the controller folds.

Concurrency: inserts arrive from the ingest writer pool in parallel,
serialized per learner by the base class's per-learner locks
(store/base.py). Each write lands in a ``.tmp`` file that ``os.replace``
moves to its final name. The per-learner sequence counter AND the entry
list are mirrored in memory (seeded by one scan on first touch) so
insert, eviction and select never pay a listdir, and durability fsyncs
are BATCHED: ``flush()`` syncs every directory touched since the last
flush (the ingest pipeline calls it at drain fences), so the per-insert
hot path never pays an fsync.
"""

from __future__ import annotations

import logging
import mmap
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Set

from metisfl_tpu_torch.store.base import EvictionPolicy, ModelStore
from metisfl_tpu_torch.tensor.pytree import (
    ModelBlob,
    pack_model,
    read_named_arrays,
    write_named_tensors,
)

logger = logging.getLogger("metisfl_tpu_torch.store.disk")


def _is_flat_tensor_dict(model: Any) -> bool:
    """True for the controller's flat ``{wire_name: array}`` shape."""
    return bool(isinstance(model, dict) and model and all(
        isinstance(k, str) and not isinstance(v, (dict, list, tuple))
        for k, v in model.items()))


def pack_store_value(model: Any) -> bytes:
    """Model → blob bytes with EXACT key preservation for flat dicts.

    The controller stores flat ``{wire_name: array}`` dicts whose keys
    already contain ``/`` separators ("params/Dense_0/kernel").
    ``pack_model`` would treat each key as one path component and escape
    the slashes (``params%2FDense_0%2Fkernel``), so flat dicts serialize
    through ``ModelBlob`` verbatim; only nested trees go through
    ``pack_model``'s path flattening."""
    if _is_flat_tensor_dict(model):
        return ModelBlob(tensors=list(model.items())).to_bytes()
    return pack_model(model)


def decode_store_value(buf, allow_nocrc: bool = True) -> Any:
    """Blob bytes → the store's value: ``{name: numpy view}`` for a
    plaintext blob, the raw bytes for an encrypted (opaque-only) one.
    ``allow_nocrc`` accepts the store-local v3 files (not the wire)."""
    tensors, opaque = read_named_arrays(buf, allow_nocrc=allow_nocrc)
    if opaque and not tensors:
        return bytes(buf)
    return tensors


# packed models land as .blob; verbatim byte payloads (ciphertexts) as
# .opaque — tagged at WRITE time so a corrupt .blob stays a loud parse
# error instead of being silently misread as an opaque payload
_BLOB_RE = re.compile(r"^(\d+)\.(blob|opaque)$")
_SAFE_ID = re.compile(r"[^A-Za-z0-9_.-]")

# cache-miss sentinel for the _cache_fetch hook (None is a valid value)
_MISS = object()


class DiskModelStore(ModelStore):
    def __init__(self, root: str,
                 policy: EvictionPolicy = EvictionPolicy.LINEAGE_LENGTH,
                 lineage_length: int = 1):
        super().__init__(policy, lineage_length)
        self.root = root
        os.makedirs(root, exist_ok=True)
        # cold-read pool: select() fans per-learner reads out; built on
        # first use
        self._read_pool: Optional[ThreadPoolExecutor] = None
        # next sequence number per learner (under that learner's lock;
        # seeded from a directory scan on first touch)
        self._next_seq: Dict[str, int] = {}
        # per-learner sorted [(seq, filename)] mirror of the directory
        # (under that learner's lock; seeded by one scan on first touch)
        self._known: Dict[str, List[tuple]] = {}
        # directories with writes not yet fsynced, drained by flush();
        # guarded by the registry lock, never held across the fsync
        self._dirty_dirs: Set[str] = set()

    def _pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._read_pool is None:
                self._read_pool = ThreadPoolExecutor(
                    max_workers=min(32, 4 * (os.cpu_count() or 4)),
                    thread_name_prefix="store-read")
            return self._read_pool

    def shutdown(self) -> None:
        if self._read_pool is not None:
            self._read_pool.shutdown(wait=False)
            self._read_pool = None

    def flush(self) -> None:
        """Batched directory fsyncs: make every rename since the last
        flush durable in one pass (best-effort: a filesystem without
        directory fsync keeps the renames as they are)."""
        with self._lock:
            dirty, self._dirty_dirs = self._dirty_dirs, set()
        for path in dirty:
            try:
                fd = os.open(path, os.O_RDONLY)
            except OSError:
                continue  # erased since the write: nothing to sync
            try:
                os.fsync(fd)
            except OSError:  # pragma: no cover - fs without dir fsync
                pass
            finally:
                os.close(fd)

    def _dir(self, learner_id: str) -> str:
        return os.path.join(self.root, _SAFE_ID.sub("_", learner_id))

    def _entries(self, learner_id: str) -> List[tuple]:
        """Sorted [(seq, filename)] of one learner's stored models, from
        the in-memory mirror after the first touch (this process owns the
        directory, so insert/evict/erase keep the mirror exact). Called
        with the learner's lock held."""
        known = self._known.get(learner_id)
        if known is None:
            known = self._known[learner_id] = self._scan_entries(learner_id)
        return list(known)

    def _scan_entries(self, learner_id: str) -> List[tuple]:
        path = self._dir(learner_id)
        if not os.path.isdir(path):
            return []
        entries = []
        for name in os.listdir(path):
            match = _BLOB_RE.match(name)
            if match:
                entries.append((int(match.group(1)), name))
        return sorted(entries)

    def _append(self, learner_id: str, model: Any) -> int:
        """Store one model; returns its sequence number (subclasses key
        caches off it). Called with the learner's lock held, so inserts
        for DIFFERENT learners stream their blobs in parallel."""
        path = self._dir(learner_id)
        seq = self._next_seq.get(learner_id)
        if seq is None:
            os.makedirs(path, exist_ok=True)
            entries = self._entries(learner_id)
            seq = (entries[-1][0] + 1) if entries else 0
        tmp = os.path.join(path, f".{seq}.tmp")
        if isinstance(model, (bytes, bytearray)):
            ext = "opaque"
            with open(tmp, "wb") as f:
                f.write(model)
        elif _is_flat_tensor_dict(model):
            # copy-free: tensors stream from their own buffers, as the
            # store-local v3 blob (crc-checked at the wire decode already)
            ext = "blob"
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                write_named_tensors(fd, list(model.items()), checksum=False)
            finally:
                os.close(fd)
        else:
            ext = "blob"
            with open(tmp, "wb") as f:
                f.write(pack_model(model))
        filename = f"{seq}.{ext}"
        os.replace(tmp, os.path.join(path, filename))
        self._next_seq[learner_id] = seq + 1
        known = self._known.get(learner_id)
        if known is None:
            # the post-replace scan already includes the new file
            self._known[learner_id] = self._scan_entries(learner_id)
        else:
            known.append((seq, filename))
        with self._lock:
            self._dirty_dirs.add(path)
        return seq

    def _read_entry(self, learner_id: str, filename: str) -> Any:
        """Read and decode one stored model file.

        Plaintext blobs decode over an ``mmap`` of the file with
        ``MADV_WILLNEED`` prefetch: the tensors are read-only numpy views
        straight over the page cache (the mapping lives as long as they
        do), and the kernel reads the whole file ahead while earlier
        selects decode. POSIX keeps the mapped pages valid if eviction
        unlinks the file while views are live."""
        path = os.path.join(self._dir(learner_id), filename)
        if filename.endswith(".opaque"):
            with open(path, "rb") as f:
                return f.read()  # verbatim payload, by write-time contract
        with open(path, "rb") as f:
            try:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError:  # zero-length file: let the parser raise
                return decode_store_value(f.read())
        try:
            mm.madvise(mmap.MADV_WILLNEED)
        except (AttributeError, OSError):  # madvise is best-effort
            pass
        return decode_store_value(memoryview(mm))

    def _lineage(self, learner_id: str) -> List[Any]:
        return [self._read_entry(learner_id, name)
                for _, name in reversed(self._entries(learner_id))]

    # -- in-memory cache hooks (no-ops here; CachedDiskStore overrides) ----
    def _cache_fetch(self, learner_id: str, seq: int) -> Any:
        return _MISS

    def _cache_store(self, learner_id: str, seq: int, value: Any) -> None:
        pass

    def _select_one(self, learner_id: str, k: int) -> Optional[List[Any]]:
        """Latest ≤k models for ONE learner, cache-first, under its
        lineage lock."""
        with self._locked(learner_id):
            ents = list(reversed(self._entries(learner_id)))[:k]
            if not ents:
                return None
            vals: List[Any] = []
            for seq, name in ents:
                hit = self._cache_fetch(learner_id, seq)
                if hit is _MISS:
                    hit = self._read_entry(learner_id, name)
                    self._cache_store(learner_id, seq, hit)
                vals.append(hit)
            return vals

    def select(self, learner_ids: Sequence[str],
               k: int = 1) -> Dict[str, List[Any]]:
        """Latest ≤k models per learner, cache-first, learners read in
        parallel across the pool."""
        out: Dict[str, List[Any]] = {}
        ids = list(learner_ids)
        if len(ids) == 1:  # no pool round-trip for a single learner
            vals = self._select_one(ids[0], k)
            if vals is not None:
                out[ids[0]] = vals
            return out
        futures = [(lid, self._pool().submit(self._select_one, lid, k))
                   for lid in ids]
        for lid, fut in futures:
            vals = fut.result()
            if vals is not None:
                out[lid] = vals
        return out

    def size(self, learner_id: str) -> int:
        """Entry count without decoding any blob."""
        with self._locked(learner_id):
            return len(self._entries(learner_id))

    def _erase(self, learner_id: str) -> None:
        shutil.rmtree(self._dir(learner_id), ignore_errors=True)
        self._next_seq.pop(learner_id, None)
        self._known.pop(learner_id, None)

    def _evict(self, learner_id: str) -> None:
        entries = self._entries(learner_id)
        excess = len(entries) - self.lineage_length
        if excess <= 0:
            return
        for _, name in entries[:excess]:
            os.unlink(os.path.join(self._dir(learner_id), name))
        self._known[learner_id] = entries[excess:]

    def _learner_ids(self) -> List[str]:
        return [d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d))]

