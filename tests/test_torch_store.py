"""The port's model-store files against the JAX package's: the copy-free
blob writer (``tensor/pytree.py`` ``write_named_tensors``), the disk store
(``store/disk.py``) and the cached disk store (``store/cached.py``).

The writer's bytes must equal the JAX writer's for the same named tensors
(v2 with the crc, v3 without), and a store directory written by either
package must be read by the other to the same names, dtypes and bytes,
with the same file names. Inputs come from numpy seeds; comparisons are
exact (files and tensors are bytes).
"""

import os

import numpy as np
import pytest
import torch

from metisfl_tpu.store.cached import CachedDiskStore as JaxCachedDiskStore
from metisfl_tpu.store.disk import DiskModelStore as JaxDiskModelStore
from metisfl_tpu.tensor.pytree import ModelBlob as JaxModelBlob
from metisfl_tpu.tensor.pytree import \
    write_named_tensors as jax_write_named_tensors
from metisfl_tpu_torch.store import (
    CachedDiskStore,
    DiskModelStore,
    EvictionPolicy,
    make_store,
)
from metisfl_tpu_torch.tensor.pytree import (
    ModelBlob,
    read_named_arrays,
    write_named_tensors,
)
from metisfl_tpu_torch.tensor.spec import DType, TensorKind, TensorSpec


def _named(seed=3):
    """Named tensors of the shape classes both writers handle: a matrix,
    a non-contiguous view, a big-endian vector, a 0-d scalar, an int
    tensor. (The JAX writer cannot cast an empty tensor's buffer;
    ``test_empty_tensor_writes_its_staged_bytes`` covers the port's.)"""
    rng = np.random.default_rng(seed)
    return [
        ("enc/w", rng.standard_normal((17, 9)).astype(np.float32)),
        ("enc/slice", np.ascontiguousarray(
            rng.standard_normal((12, 12)).astype(np.float32))[::2, ::3]),
        ("head/b", rng.standard_normal(5).astype(">f4")),
        ("step", np.int32(7)),
        ("ids", rng.integers(-9, 9, (4, 2)).astype(np.int64)),
    ]


def _write(path, writer, named, checksum):
    fd = os.open(str(path), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        wrote = writer(fd, named, checksum=checksum)
    finally:
        os.close(fd)
    data = path.read_bytes()
    assert wrote == len(data)
    return data


@pytest.mark.parametrize("checksum", [True, False], ids=["v2", "v3"])
def test_write_named_tensors_bytes_equal_the_jax_writer(tmp_path, checksum):
    """The same named numpy tensors give the same file bytes through
    either package's writer; with the crc they are also the staged
    ``ModelBlob.to_bytes`` of both packages."""
    named = _named()
    got = _write(tmp_path / "port.bin", write_named_tensors, named, checksum)
    want = _write(tmp_path / "jax.bin", jax_write_named_tensors, named,
                  checksum)
    assert got == want
    assert got[4] == (2 if checksum else 3)  # the version byte
    if checksum:
        assert got == ModelBlob(tensors=named).to_bytes()
        assert got == JaxModelBlob(
            tensors=[(k, np.asarray(v)) for k, v in named]).to_bytes()


def test_empty_tensor_writes_its_staged_bytes(tmp_path):
    """An empty tensor (numpy or torch) writes what ``to_bytes`` stages:
    its header and no payload."""
    named = [("e", np.zeros((0, 3), np.float64)),
             ("t", torch.zeros(2, 0)), ("w", np.ones(2, np.float32))]
    got = _write(tmp_path / "e.bin", write_named_tensors, named, True)
    assert got == ModelBlob(tensors=named).to_bytes()
    arrays, _ = read_named_arrays(got)
    assert arrays["e"].shape == (0, 3) and arrays["t"].shape == (2, 0)


@pytest.mark.parametrize("checksum", [True, False], ids=["v2", "v3"])
def test_torch_tensors_write_the_bytes_of_their_numpy_twins(tmp_path,
                                                            checksum):
    """Torch tensors (a transposed view and a 0-d one included) write the
    bytes that their numpy twins write through the JAX writer."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    h = rng.standard_normal((3, 5)).astype(np.float64)
    named_torch = [("w", torch.from_numpy(w)),
                   ("h_t", torch.from_numpy(h).t()),
                   ("n", torch.tensor(3, dtype=torch.int64))]
    named_np = [("w", w), ("h_t", np.ascontiguousarray(h.T)),
                ("n", np.int64(3))]
    got = _write(tmp_path / "port.bin", write_named_tensors, named_torch,
                 checksum)
    want = _write(tmp_path / "jax.bin", jax_write_named_tensors, named_np,
                  checksum)
    assert got == want


def test_bf16_tensors_write_the_jax_blob_bytes(tmp_path):
    """bf16 (torch, or numpy through ml_dtypes) writes the JAX package's
    staged blob bytes. (The JAX streaming writer cannot take a bf16
    buffer, so its ``to_bytes`` is the reference here.)"""
    import ml_dtypes

    h = np.random.default_rng(6).standard_normal((3, 5)).astype(np.float32)
    want = JaxModelBlob(tensors=[("h", h.astype(ml_dtypes.bfloat16)),
                                 ("w", h)]).to_bytes()
    for value in (torch.from_numpy(h).to(torch.bfloat16),
                  h.astype(ml_dtypes.bfloat16)):
        got = _write(tmp_path / "bf16.bin", write_named_tensors,
                     [("h", value), ("w", h)], True)
        assert got == want


def test_nocrc_blob_roundtrip_and_length_framing(tmp_path):
    """checksum=False writes the v3 store-local variant: it decodes to the
    same tensors where the store reads it, a truncated file still rejects
    (the length frame), and the wire decode refuses v3."""
    named = [("a/w", np.arange(12, dtype=np.float32)),
             ("b", np.float32(3.5))]
    data = _write(tmp_path / "v3.bin", write_named_tensors, named, False)
    assert data[4] == 3
    back = ModelBlob.from_bytes(data, allow_nocrc=True)
    arrays, opaque = read_named_arrays(data, allow_nocrc=True)
    assert not opaque
    for (name, arr), (bname, barr) in zip(named, back.tensors):
        assert name == bname
        np.testing.assert_array_equal(np.asarray(arr), barr.numpy())
        np.testing.assert_array_equal(np.asarray(arr), arrays[name])
    with pytest.raises(ValueError, match="length mismatch"):
        ModelBlob.from_bytes(data[:-4], allow_nocrc=True)
    with pytest.raises(ValueError, match="v3"):
        ModelBlob.from_bytes(data)
    with pytest.raises(ValueError, match="v3"):
        read_named_arrays(data)


def _m(v, n=8):
    return {"w": np.full((n,), float(v), np.float32),
            "layer/b": np.full((3,), float(v) + 0.5, np.float32)}


def _lineage_values(lineage):
    return [float(m["w"][0]) for m in lineage]


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def _fill(store):
    """One lineage per learner id shape: a flat tensor dict, a nested
    tree, raw ciphertext bytes, and an id the store sanitizes."""
    rng = np.random.default_rng(11)
    for v in (1, 2, 3):
        store.insert("L0_host_7001", {
            "params/Dense_0/kernel": np.full((4, 3), float(v), np.float32),
            "params/Dense_0/bias": rng.standard_normal(3).astype(np.float32),
            "step": np.int64(v)})
    store.insert("L1", {"params": {"w": np.arange(6, dtype=np.float64)}})
    store.insert("enc", b"\x00opaque-ciphertext\xff" * 5)
    store.insert("bad/id with space", _m(4))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_directories_are_shared_between_the_packages(tmp_path, writer):
    """A lineage written by either package's DiskModelStore has the same
    file names and bytes as the other's, and each package reads the
    other's directory back to the same names, dtypes and values."""
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    _fill(JaxDiskModelStore(roots["jax"], lineage_length=2))
    _fill(DiskModelStore(roots["port"], lineage_length=2))
    assert _files(roots["jax"]) == _files(roots["port"])
    ids = ["L0_host_7001", "L1", "enc", "bad/id with space"]
    reader = (DiskModelStore if writer == "jax" else JaxDiskModelStore)(
        roots[writer], lineage_length=2)
    own = (JaxDiskModelStore if writer == "jax" else DiskModelStore)(
        roots[writer], lineage_length=2)
    got, want = reader.select(ids, k=5), own.select(ids, k=5)
    assert sorted(got) == sorted(want) == sorted(ids)
    for lid in ids:
        assert len(got[lid]) == len(want[lid])
        for g, w in zip(got[lid], want[lid]):
            if isinstance(w, bytes):
                assert g == w
                continue
            assert sorted(g) == sorted(w)
            for name in w:
                g_arr, w_arr = np.asarray(g[name]), np.asarray(w[name])
                assert g_arr.dtype == w_arr.dtype
                assert g_arr.shape == w_arr.shape
                assert g_arr.tobytes() == w_arr.tobytes()
    assert _lineage_values(got["bad/id with space"]) == [4.0]
    reader.shutdown()
    own.shutdown()


def test_disk_store_reads_numpy_views_of_torch_inserts(tmp_path):
    """Torch tensors go in, read-only numpy views come out (the host form
    the controller folds), in a v3 file."""
    store = DiskModelStore(str(tmp_path / "s"))
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    store.insert("L0", {"a/w": t, "a/b": torch.ones(3, dtype=torch.bfloat16)})
    name = os.listdir(store._dir("L0"))[0]
    assert name == "0.blob"
    with open(os.path.join(store._dir("L0"), name), "rb") as f:
        assert f.read(5)[4] == 3
    out = store.select(["L0"])["L0"][0]
    assert isinstance(out["a/w"], np.ndarray)
    assert not out["a/w"].flags.writeable
    np.testing.assert_array_equal(out["a/w"], t.numpy())
    assert out["a/b"].dtype.name == "bfloat16"
    store.shutdown()


# -- the disk store's semantics (tests/test_policies.py TestDiskStore) ----

def test_disk_roundtrip_and_eviction(tmp_path):
    store = DiskModelStore(str(tmp_path / "store"), lineage_length=2)
    for v in (1, 2, 3):
        store.insert("L0", _m(v))
    lineage = store.select(["L0"], k=5)["L0"]
    assert _lineage_values(lineage) == [3.0, 2.0]
    assert sorted(os.listdir(store._dir("L0"))) == ["1.blob", "2.blob"]


def test_disk_lineage_three_keeps_all_three(tmp_path):
    store = DiskModelStore(str(tmp_path / "store"), lineage_length=3)
    store.insert("L0", _m(1))
    store.insert("L0", _m(2))
    assert store.size("L0") == 2
    store.insert("L0", _m(3))
    assert store.size("L0") == 3
    assert _lineage_values(store.select(["L0"], k=3)["L0"]) == [3.0, 2.0,
                                                                1.0]


def test_disk_no_eviction_policy(tmp_path):
    store = DiskModelStore(str(tmp_path / "store"),
                           policy=EvictionPolicy.NO_EVICTION)
    for v in range(5):
        store.insert("L0", _m(v))
    assert store.size("L0") == 5


def test_disk_survives_reopen(tmp_path):
    root = str(tmp_path / "store")
    DiskModelStore(root, lineage_length=2).insert("L0", _m(7))
    reopened = DiskModelStore(root, lineage_length=2)
    np.testing.assert_allclose(reopened.select(["L0"])["L0"][0]["w"], 7.0)
    reopened.insert("L0", _m(8))  # the sequence resumes after the scan
    assert sorted(os.listdir(reopened._dir("L0"))) == ["0.blob", "1.blob"]


def test_disk_raw_bytes_passthrough(tmp_path):
    store = DiskModelStore(str(tmp_path / "store"))
    blob = ModelBlob(opaque={"w": (b"cipher", TensorSpec(
        (3,), DType.F64, TensorKind.CIPHERTEXT))})
    store.insert("L0", blob.to_bytes())
    out = store.select(["L0"])["L0"][0]
    assert isinstance(out, bytes)
    assert ModelBlob.from_bytes(out).opaque["w"][0] == b"cipher"
    assert os.listdir(store._dir("L0")) == ["0.opaque"]


def test_disk_parallel_select_matches_serial_lineage(tmp_path):
    store = DiskModelStore(str(tmp_path / "store"), lineage_length=3)
    for i in range(16):
        for v in (1, 2, 3):
            store.insert(f"L{i}", _m(v * (i + 1)))
    ids = [f"L{i}" for i in range(16)] + ["ghost"]
    out = store.select(ids, k=2)
    assert "ghost" not in out and len(out) == 16
    for i in range(16):
        assert _lineage_values(out[f"L{i}"]) == [3.0 * (i + 1),
                                                 2.0 * (i + 1)]
    assert store.size("L0") == 3 and store.size("ghost") == 0
    store.shutdown()


# -- the cached disk store (tests/test_policies.py TestCachedDiskStore) ---

def _cached(tmp_path, cache_bytes, cls=CachedDiskStore):
    return cls(str(tmp_path / "store"), lineage_length=2,
               cache_bytes=cache_bytes)


def test_cached_roundtrip_matches_disk_semantics(tmp_path):
    store = _cached(tmp_path, 1 << 20)
    for v in (1, 2, 3):
        store.insert("L0", _m(v))
    assert _lineage_values(store.select(["L0"], k=5)["L0"]) == [3.0, 2.0]


def test_cached_inserts_hit_cache_on_select(tmp_path):
    store = _cached(tmp_path, 1 << 20)
    store.insert("L0", _m(1))
    store.select(["L0"])
    assert store.cache_hits >= 1 and store.cache_misses == 0


@pytest.mark.parametrize("tensor_kind", ["numpy", "torch"])
def test_cached_byte_budget_and_lru_match_the_jax_store(tmp_path,
                                                        tensor_kind):
    """The same inserts and selects leave the same resident bytes, the
    same cached keys in the same LRU order, and the same hit and miss
    counts in both packages' caches; models evicted from the cache read
    back from disk. Torch tensors count their bytes as numpy arrays do."""
    one = sum(a.nbytes for a in _m(0).values())
    budget = int(one * 2.5)
    port = _cached(tmp_path / "port", budget)
    jax = _cached(tmp_path / "jax", budget, JaxCachedDiskStore)
    for i in range(8):
        model = _m(i)
        port.insert(f"L{i}", model if tensor_kind == "numpy" else {
            k: torch.from_numpy(v) for k, v in model.items()})
        jax.insert(f"L{i}", model)
    assert port._cached_total == jax._cached_total <= budget
    assert list(port._cache) == list(jax._cache)
    # one learner a select: a select of many reads them in parallel, and
    # the hits then depend on which read evicts first
    ids = [f"L{i}" for i in (7, 0, 3, 6, 7, 1)]
    for store in (port, jax):
        out = [store.select([lid], k=1)[lid][0] for lid in ids]
        assert [float(m["w"][0]) for m in out] == [7, 0, 3, 6, 7, 1]
    assert (port.cache_hits, port.cache_misses) == (jax.cache_hits,
                                                    jax.cache_misses)
    assert port.cache_hits > 0 and port.cache_misses > 0
    assert port._cached_total == jax._cached_total <= budget
    assert list(port._cache) == list(jax._cache)
    # the parallel select reads back every model, the evicted from disk
    out = port.select([f"L{i}" for i in range(8)], k=1)
    assert sorted(float(m[0]["w"][0]) for m in out.values()) == list(
        range(8))


def test_cached_oversized_model_is_never_cached(tmp_path):
    """A model larger than the whole budget is read from the mmapped file
    on every select and evicts nothing."""
    store = _cached(tmp_path, 64)
    store.insert("small", {"w": np.zeros(4, np.float32)})
    store.insert("big", {"w": np.zeros(1024, np.float32)})
    assert list(store._cache) == [("small", 0)]
    out = store.select(["big"])["big"][0]
    assert not out["w"].flags.writeable  # a view over the file's mapping
    assert store.cache_misses == 1 and list(store._cache) == [("small", 0)]


def test_cached_consistent_after_erase_and_evict(tmp_path):
    store = _cached(tmp_path, 1 << 20)
    for v in (1, 2, 3):
        store.insert("L0", _m(v))  # lineage 2: seq 0 evicted
    store.insert("L1", _m(9))
    store.erase(["L0"])
    assert store.select(["L0"]) == {}
    np.testing.assert_allclose(store.select(["L1"])["L1"][0]["w"], 9.0)
    assert store._cached_total == sum(a.nbytes for a in _m(9).values())


def test_cached_survives_reopen_cold_cache(tmp_path):
    root = str(tmp_path / "store")
    CachedDiskStore(root, lineage_length=2).insert("L0", _m(7))
    reopened = CachedDiskStore(root, lineage_length=2)
    np.testing.assert_allclose(reopened.select(["L0"])["L0"][0]["w"], 7.0)
    assert reopened.cache_misses == 1


def test_make_store_builds_every_store(tmp_path):
    assert type(make_store("in_memory")).__name__ == "InMemoryModelStore"
    assert isinstance(make_store("disk", root=str(tmp_path / "d")),
                      DiskModelStore)
    cached = make_store("cached_disk", root=str(tmp_path / "c"),
                        cache_bytes=1024)
    assert isinstance(cached, CachedDiskStore) and cached.cache_bytes == 1024
    with pytest.raises(ValueError, match="unknown store"):
        make_store("redis")


def test_load_config_reads_the_model_store_block(tmp_path):
    """``load_config`` reads examples/config/template.yaml's model_store
    block as the JAX package's loader does, and a block that picks the
    cached disk store with parallel ingest."""
    import dataclasses

    from metisfl_tpu.config import load_config as jax_load_config
    from metisfl_tpu_torch.config import load_config

    template = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "config", "template.yaml")
    got = dataclasses.asdict(load_config(template).model_store)
    want = dataclasses.asdict(jax_load_config(template).model_store)
    assert got == want
    path = tmp_path / "federation.yaml"
    path.write_text("model_store: {store: cached_disk, root: /data/m, "
                    "cache_mb: 64, ingest_workers: 4, lineage_length: 2}\n")
    store = load_config(str(path)).model_store
    assert (store.store, store.root, store.cache_mb, store.ingest_workers,
            store.lineage_length) == ("cached_disk", "/data/m", 64, 4, 2)
