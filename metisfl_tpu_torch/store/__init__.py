"""Model lineage stores. The port has the in-memory store; the JAX
package's disk, cached, durable, ingest and remote stores are not ported
yet (ROADMAP.md Queue 1 item 3b), and ``FederationConfig`` refuses them by
name."""

from metisfl_tpu_torch.store.base import EvictionPolicy, ModelStore
from metisfl_tpu_torch.store.memory import InMemoryModelStore

STORES = {"in_memory": InMemoryModelStore}


def make_store(name: str, **kwargs) -> ModelStore:
    try:
        return STORES[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown store {name!r}; have "
                         f"{sorted(STORES)}") from None


__all__ = ["ModelStore", "EvictionPolicy", "InMemoryModelStore", "STORES",
           "make_store"]
