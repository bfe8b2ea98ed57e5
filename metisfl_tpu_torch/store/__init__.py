"""Model lineage stores (the port's copy of the JAX package's ``store``):
a per-learner cache of recent models with lineage-length eviction. The
in-memory store is the default; ``disk`` persists each model as a blob
file, ``cached_disk`` adds a byte-bounded LRU over it, and ``remote``
reaches a ``python -m metisfl_tpu_torch.store.server`` process.
:class:`IngestPipeline` moves store writes off the controller's
completion path."""

from metisfl_tpu_torch.store.base import EvictionPolicy, ModelStore
from metisfl_tpu_torch.store.cached import CachedDiskStore
from metisfl_tpu_torch.store.disk import DiskModelStore
from metisfl_tpu_torch.store.ingest import IngestPipeline
from metisfl_tpu_torch.store.memory import InMemoryModelStore


def _remote(**kwargs):
    from metisfl_tpu_torch.store.remote import RemoteModelStore  # grpc

    return RemoteModelStore(**kwargs)


STORES = {
    "in_memory": InMemoryModelStore,
    "disk": DiskModelStore,
    "cached_disk": CachedDiskStore,
    "remote": _remote,
}


def make_store(name: str, **kwargs) -> ModelStore:
    try:
        return STORES[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown store {name!r}; have "
                         f"{sorted(STORES)}") from None


__all__ = ["ModelStore", "EvictionPolicy", "InMemoryModelStore",
           "DiskModelStore", "CachedDiskStore", "IngestPipeline", "STORES",
           "make_store"]
