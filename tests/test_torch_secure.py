"""The port's secure-aggregation plane against the JAX package's.

- Masking: the pair streams, the mask graph, the fixed point and
  ``MaskingBackend``'s masked payloads are the JAX package's uint64 words
  bit for bit (same secret, party, round, values); so are
  ``MaskedAccumulator``, ``combine_partials``, ``unmask``, ``settle``,
  ``recovery_correction`` and ``MaskedStreamingAggregator``. Recovery
  refuses what the JAX backend refuses (tests/test_secure_agg.py), with
  the same message; a decoded sum lies within 1e-9 of the float64 mean.
- CKKS: the port builds its own ``native/ckks.cc``; keys made by either
  package's library are read by the other's, and a sum encrypted by one
  package and combined and decrypted by the other lies within 1e-5 of
  the plain weighted sum (tests/test_ckks.py's tolerance).
- Paillier: each package decrypts the other's ciphertexts under one
  keypair.
- The learner: the port's masked uplink of a model is the JAX learner's,
  byte for byte (the tensor order on the wire included), and an opaque
  community decodes into the engine's dtypes as the JAX learner's does.
- Federations: the port's masked in-process federation of the MLP lies
  within 1e-5 of the JAX package's; a dropout mid-round settles through
  one survivor's residual (store path and masked stream) to within 1e-9
  of the float64 mean of the uplinks recorded through a probe; a mixed
  cohort over gRPC (port learners under a JAX controller, and JAX
  learners under a port controller) lands within 1e-9 of the plain mean.

The planes are host numpy in both packages; nothing here needs a GPU.
"""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from metisfl_tpu.aggregation.secure import SecureAgg as JaxSecureAgg
from metisfl_tpu.secure import distributed as jax_dist
from metisfl_tpu.secure import paillier as jax_paillier
from metisfl_tpu.secure import recovery as jax_recovery
from metisfl_tpu.secure.identity import IdentityBackend as JaxIdentity
from metisfl_tpu.secure.masking import MaskingBackend as JaxMasking
from metisfl_tpu_torch.aggregation.secure import SecureAgg
from metisfl_tpu_torch.comm import TrainParams
from metisfl_tpu_torch.comm.codec import dumps, loads
from metisfl_tpu_torch.config import (
    AggregationConfig,
    EvalConfig,
    FederationConfig,
    TerminationConfig,
)
from metisfl_tpu_torch.config.federation import SecureAggConfig
from metisfl_tpu_torch.driver import InProcessFederation
from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
from metisfl_tpu_torch.models.zoo import MLP
from metisfl_tpu_torch.secure import distributed as dist
from metisfl_tpu_torch.secure import make_backend, paillier, recovery
from metisfl_tpu_torch.secure.identity import IdentityBackend
from metisfl_tpu_torch.secure.masking import MaskingBackend
from metisfl_tpu_torch.tensor import ModelBlob, pack_model
from metisfl_tpu_torch.tensor.spec import DType, TensorKind, TensorSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a decoded masked mean against the float64 mean: fixed point rounds each
# value to 2^-41 (tests/test_secure_agg.py's tolerance)
MASK_ATOL = 1e-9
# CKKS against the plain weighted sum (tests/test_ckks.py)
CKKS_ATOL = 1e-5
# two packages' federations, community weights after each round: both run
# the same f32 SGD steps (tests/test_torch_federation.py)
COMMUNITY_ATOL = 1e-5


def _backends(cls, n, secret="s3cret", neighbors=0):
    return [cls(federation_secret=secret, party_index=i, num_parties=n,
                neighbors=neighbors) for i in range(n)]


def _bytes(arr):
    return np.asarray(arr).tobytes()


# -- pair streams, the mask graph, the fixed point ---------------------------

@pytest.mark.parametrize("n", [1, 37, dist.MASK_CHUNK + 5])
def test_pair_streams_are_the_jax_words(n):
    for secret, i, j, rid, t in (("s3cret", 0, 1, 0, 0),
                                 ("fed", 4, 2, 7, 3), ("", 1, 0, 123, 9)):
        got = dist.pair_stream(secret, i, j, rid, t, n)
        assert got.dtype == np.uint64 and got.shape == (n,)
        assert _bytes(got) == _bytes(jax_dist.pair_stream(secret, i, j, rid,
                                                          t, n))
        # symmetric in the pair
        assert _bytes(got) == _bytes(dist.pair_stream(secret, j, i, rid, t,
                                                      n))
    chunks = list(dist.iter_pair_stream("fed", 2, 5, 1, 0, n, chunk=16))
    want = list(jax_dist.iter_pair_stream("fed", 2, 5, 1, 0, n, chunk=16))
    assert [(o, _bytes(v)) for o, v in chunks] == [
        (o, _bytes(v)) for o, v in want]


def test_the_mask_graph_and_signs_are_the_jax_ones():
    for n in (1, 2, 3, 7, 10):
        for k in (0, 1, 2, 3, 4, 9):
            for i in range(n):
                partners = dist.mask_partners(i, n, k)
                assert partners == jax_dist.mask_partners(i, n, k)
                for j in partners:
                    assert i in dist.mask_partners(j, n, k)
                    assert dist.pair_sign(i, j) == jax_dist.pair_sign(i, j)
                    assert dist.pair_sign(i, j) == -dist.pair_sign(j, i)


def test_the_fixed_point_is_the_jax_one():
    rng = np.random.default_rng(0)
    values = np.concatenate([rng.standard_normal(1000) * 100,
                             [0.0, -0.0, 1e-13, -1e-13, 2.0 ** 21]])
    got = dist.encode_fixed(values)
    assert _bytes(got) == _bytes(jax_dist.encode_fixed(values))
    assert dist.FP_BITS == jax_dist.FP_BITS == 40
    for scale in (1.0, 1 / 3, 0.25):
        assert _bytes(dist.decode_fixed(got, scale)) == _bytes(
            jax_dist.decode_fixed(got, scale))


# -- MaskingBackend ------------------------------------------------------------

@pytest.mark.parametrize("neighbors", [0, 2])
def test_masked_payloads_are_the_jax_words(neighbors):
    n = 5
    port, ref = (_backends(MaskingBackend, n, neighbors=neighbors),
                 _backends(JaxMasking, n, neighbors=neighbors))
    rng = np.random.default_rng(1)
    for rid in (0, 3):
        vectors = [(rng.standard_normal(40), rng.standard_normal(7))
                   for _ in range(n)]
        for p, r, (a, b) in zip(port, ref, vectors):
            p.begin_round(rid)
            r.begin_round(rid)
            assert p.encrypt(a) == r.encrypt(a)
            assert p.encrypt(b) == r.encrypt(b)
            # a re-dispatched round re-ships the first payload verbatim
            p.begin_round(rid)
            r.begin_round(rid)
            assert p.encrypt(a + 1.0) == r.encrypt(a + 1.0)


def test_masks_cancel_to_the_float64_mean():
    n = 4
    backends = _backends(MaskingBackend, n)
    rng = np.random.default_rng(2)
    vectors = [rng.standard_normal(50) for _ in range(n)]
    payloads = []
    for b, v in zip(backends, vectors):
        b.begin_round(4)
        payloads.append(b.encrypt(v))
    for p, v in zip(payloads, vectors):
        assert not np.allclose(np.frombuffer(p, np.float64), v, atol=0.1)
    mean = backends[0].decrypt(
        backends[0].weighted_sum(payloads, [1 / n] * n), 50)
    assert np.abs(mean - np.mean(vectors, axis=0)).max() <= MASK_ATOL
    ref = JaxMasking(num_parties=n)
    assert ref.weighted_sum(payloads, [1 / n] * n) == (
        MaskingBackend(num_parties=n).weighted_sum(payloads, [1 / n] * n))


def _refusal(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - compared below
        return type(exc).__name__, str(exc)
    return None


def _refusal_script(cls):
    """tests/test_secure_agg.py's recovery refusals, run on ``cls``'s
    backends; returns what each step raised (None: it did not)."""
    out = []
    b3 = _backends(cls, 3)
    out.append(_refusal(lambda: b3[1].recovery_correction(0, [0], [1, 2],
                                                          [4])))
    b3[0].begin_round(0)
    payload = b3[0].encrypt(np.ones(4))
    out.append(_refusal(lambda: b3[0].weighted_sum(
        [payload], [1.0], correction=b"\0" * 32)))
    out.append(_refusal(lambda: b3[0].weighted_sum([payload], [1.0])))
    b2 = _backends(cls, 2)
    pays = []
    for b in b2:
        b.begin_round(0)
        pays.append(b.encrypt(np.ones(4)))
    out.append(_refusal(lambda: b2[0].weighted_sum(pays, [0.3, 0.7])))
    b4 = _backends(cls, 4)
    b4[1].begin_round(5)
    out.append(_refusal(lambda: b4[1].recovery_correction(5, [0, 1], [2, 3],
                                                          [4])))
    out.append(_refusal(lambda: b4[1].recovery_correction(5, [0, 1], [2, 3],
                                                          [4])))
    out.append(_refusal(lambda: b4[1].recovery_correction(5, [0, 2], [1, 3],
                                                          [4])))
    out.append(_refusal(lambda: b4[2].recovery_correction(99, [0, 2],
                                                          [1, 3], [4])))
    for rid in range(200, 230):
        out.append(_refusal(lambda: b4[1].recovery_correction(
            rid, [0, 1], [2, 3], [4])))
    out.append(_refusal(lambda: b4[1].recovery_correction(5, [0, 2], [1, 3],
                                                          [4])))
    b4[1].begin_round(6)
    out.append(_refusal(lambda: b4[1].recovery_correction(6, [0, 2], [1, 3],
                                                          [4])))
    out.append(_refusal(lambda: b4[1].recovery_correction(6, [0, 1], [1, 3],
                                                          [4])))
    keyless = cls(num_parties=3)
    out.append(_refusal(lambda: keyless.recovery_correction(0, [0, 1], [2],
                                                            [4])))
    # bounded mask graphs: a survivor whose every partner dropped
    ring = _backends(cls, 6, neighbors=2)
    ring[0].begin_round(1)
    out.append(_refusal(lambda: ring[0].recovery_correction(
        1, [0, 3], [1, 2, 4, 5], [4])))
    big = cls(num_parties=1 << 16)
    out.append(_refusal(lambda: big.encrypt(np.full(4, 1000.0))))
    return out


def test_recovery_refuses_what_the_jax_backend_refuses():
    got, want = _refusal_script(MaskingBackend), _refusal_script(JaxMasking)
    assert got == want
    # the script's refusals: threshold, surviving, all parties, uniform
    # scales, a second split, an unknown round (x31), secret, isolation,
    # the value bound; the repeated identical split and round 6 pass
    assert sum(r is not None for r in got) == 41
    assert got[4] is None and got[5] is None and got[-5] is None
    assert "threshold" in got[0][1] and "different recovery split" in got[6][1]


# -- the masked partial-fold plane --------------------------------------------

def _masked_models(cls, n, rid, vectors, specs):
    backends = _backends(cls, n)
    models = {}
    for i, b in enumerate(backends):
        b.begin_round(rid)
        models[f"L{i}"] = {name: (b.encrypt(vectors[i][name]), spec)
                           for name, spec in specs.items()}
    return backends, models


def test_the_masked_plane_is_the_jax_one_bit_for_bit():
    """Fold five masked models in two slices (port and JAX accumulators,
    different orders, one duplicate), combine the partials, settle with
    parties 1 and 3 dropped (a survivor's residual), unmask."""
    n, rid = 5, 2
    rng = np.random.default_rng(3)
    specs = {"a": TensorSpec((3, 4), DType.F32, TensorKind.CIPHERTEXT),
             "b": TensorSpec((5,), DType.BF16, TensorKind.CIPHERTEXT)}
    vectors = [{"a": rng.standard_normal(12), "b": rng.standard_normal(5)}
               for _ in range(n)]
    backends, models = _masked_models(MaskingBackend, n, rid, vectors, specs)
    present = ["L0", "L2", "L4"]
    sums = {}
    for acc_cls, order in ((dist.MaskedAccumulator, ["L4", "L0", "L2"]),
                           (jax_dist.MaskedAccumulator, present)):
        left, right = acc_cls(), acc_cls()
        for lid in order[:2]:
            assert left.fold(lid, models[lid])
        assert not left.fold(order[0], models[order[0]])
        right.fold(order[2], models[order[2]])
        sums[acc_cls.__module__.split(".")[0]] = (
            left.snapshot(), right.snapshot())
    (pl, pr), (jl, jr) = sums["metisfl_tpu_torch"], sums["metisfl_tpu"]
    combined = dist.combine_partials([pl[0], pr[0]])
    want = jax_dist.combine_partials([jl[0], jr[0]])
    assert {k: _bytes(v) for k, v in combined.items()} == {
        k: _bytes(v) for k, v in want.items()}
    idx = {lid: int(lid[1:]) for lid in present}
    lengths = [12, 5]
    residual = backends[0].recovery_correction(rid, [0, 2, 4], [1, 3],
                                               lengths)
    ref = _backends(JaxMasking, n)
    ref[2].begin_round(rid)
    assert residual == ref[2].recovery_correction(rid, [0, 2, 4], [1, 3],
                                                  lengths)
    got, report = recovery.settle(combined, idx, n, 2, rid,
                                  lambda *a: residual)
    want_payloads, want_report = jax_recovery.settle(
        want, idx, n, 2, rid, lambda *a: residual)
    assert got == want_payloads
    assert (report.contributors, report.surviving, report.dropped,
            report.recovered) == (
        want_report.contributors, want_report.surviving,
        want_report.dropped, want_report.recovered) == (
        present, [0, 2, 4], [1, 3], True)
    assert dist.unmask(combined, dict(zip(["a", "b"], residual)),
                       1 / 3) == got
    assert recovery.reconcile(idx, n) == jax_recovery.reconcile(idx, n)
    for name in ("a", "b"):
        mean = np.mean([vectors[int(lid[1:])][name] for lid in present],
                       axis=0)
        assert np.abs(np.frombuffer(got[name], np.float64) - mean).max() \
            <= MASK_ATOL
    # merge_sums: a slice's partial into another accumulator
    merged = dist.MaskedAccumulator()
    merged.merge_sums(pl[0], pl[2], pl[1])
    merged.merge_sums(pr[0], pr[2], pr[1])
    assert {k: _bytes(v) for k, v in merged.snapshot()[0].items()} == {
        k: _bytes(v) for k, v in combined.items()}


def test_a_streamed_settlement_recovers_in_wire_order():
    """A tree whose list holds 12 leaves of distinct sizes: its wire order
    (``w/0``, ``w/1``, ``w/2``, ...) is not the names' string order
    (``w/10`` before ``w/2``). Party 0 drops, the survivors' uplinks fold
    into the masked stream, and the settlement asks survivor 1 for the
    residual over the tensors in wire order; the community is within 1e-9
    of the float64 mean of the survivors' values."""
    from metisfl_tpu_torch.tensor.pytree import pytree_to_named_tensors

    n, rid = 3, 4
    rng = np.random.default_rng(12)
    tree = {"b": np.zeros(3, np.float32),
            "w": [np.zeros(i + 1, np.float32) for i in range(12)]}
    names = [name for name, _ in pytree_to_named_tensors(tree)]
    assert names != sorted(names)
    specs = {name: TensorSpec((int(t.numel()),), DType.F32,
                              TensorKind.CIPHERTEXT)
             for name, t in pytree_to_named_tensors(tree)}
    vectors = [{name: rng.standard_normal(specs[name].shape[0])
                for name in names} for _ in range(n)]
    backends, models = _masked_models(MaskingBackend, n, rid, vectors, specs)
    stream = dist.MaskedStreamingAggregator()
    stream.begin_round(rid)
    for lid in ("L2", "L1"):
        assert stream.fold(lid, models[lid], rid)
    sums, _, contributors = stream.finish(["L0", "L1", "L2"])
    asked = []

    def recover_fn(round_id, surviving, dropped, lengths):
        asked.append((surviving, dropped, lengths))
        return backends[1].recovery_correction(round_id, surviving, dropped,
                                               lengths)

    idx = {lid: int(lid[1:]) for lid in contributors}
    got, report = recovery.settle(sums, idx, n, 2, rid, recover_fn)
    assert report.recovered and report.dropped == [0]
    assert asked == [([1, 2], [0],
                      [specs[name].shape[0] for name in names])]
    for name in names:
        mean = np.mean([vectors[i][name] for i in (1, 2)], axis=0)
        assert np.abs(np.frombuffer(got[name], np.float64) - mean).max() \
            <= MASK_ATOL, name


def test_settlement_refuses_what_the_jax_settlement_refuses():
    sums = {"w": np.zeros(4, np.uint64)}
    cases = [({}, 3, 2, lambda *a: None),
             ({"A": -1}, 3, 2, lambda *a: None),
             ({"A": 0, "B": 0}, 3, 2, lambda *a: None),
             ({"A": 0}, 3, 2, lambda *a: [b"\0" * 32]),
             ({"A": 0, "B": 1}, 3, 2, lambda *a: None)]
    for present, n, t, fn in cases:
        got = _refusal(lambda: recovery.settle(sums, present, n, t, 0, fn))
        want = _refusal(lambda: jax_recovery.settle(sums, present, n, t, 0,
                                                    fn))
        assert got == want and got is not None and got[0] == "RuntimeError"


def test_the_masked_stream_is_the_jax_one():
    n, rid = 3, 4
    specs = {"w": TensorSpec((6,), DType.F32, TensorKind.CIPHERTEXT)}
    rng = np.random.default_rng(4)
    vectors = [{"w": rng.standard_normal(6)} for _ in range(n)]
    _, models = _masked_models(MaskingBackend, n, rid, vectors, specs)
    outs = []
    for cls in (dist.MaskedStreamingAggregator,
                jax_dist.MaskedStreamingAggregator):
        stream = cls()
        stream.begin_round(rid)
        log = [stream.fold(lid, models[lid], rid)
               for lid in ("L2", "L0", "L2", "L1")]
        log.append(stream.fold("L1", models["L1"], rid + 1))
        log.append(stream.stats())
        sums, _, contributors = stream.finish(["L0", "L1", "L2"])
        log += [{k: _bytes(v) for k, v in sums.items()}, contributors,
                stream.stats(), stream.finish(["L0"])]
        stream.fold("L0", models["L0"], rid)
        log.append(_refusal(lambda: stream.finish(["L1"])))
        outs.append(log)
    assert outs[0] == outs[1]
    assert outs[0][:4] == [True, True, False, True]


def test_identity_backend_and_secure_agg_are_the_jax_ones():
    rng = np.random.default_rng(5)
    vecs = [rng.standard_normal(9) for _ in range(3)]
    port, ref = IdentityBackend(), JaxIdentity()
    assert [port.encrypt(v) for v in vecs] == [ref.encrypt(v) for v in vecs]
    pays = [port.encrypt(v) for v in vecs]
    assert port.weighted_sum(pays, [0.2, 0.3, 0.5]) == ref.weighted_sum(
        pays, [0.2, 0.3, 0.5])
    spec = TensorSpec((9,), DType.F32, TensorKind.CIPHERTEXT)
    models = [([{"w": (p, spec)}], s) for p, s in zip(pays, (1.0, 2.0, 5.0))]
    got = SecureAgg(port).aggregate(models)
    want = JaxSecureAgg(ref).aggregate(models)
    assert got["w"][0] == want["w"][0]
    assert got["w"][1].kind == TensorKind.CIPHERTEXT
    np.testing.assert_allclose(port.decrypt(got["w"][0], 9),
                               (vecs[0] + 2 * vecs[1] + 5 * vecs[2]) / 8,
                               atol=1e-12)
    with pytest.raises(ValueError):
        SecureAgg(port).aggregate([])


# -- CKKS ------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckks_keys(tmp_path_factory):
    from metisfl_tpu.secure.ckks import generate_keys as jax_keygen
    from metisfl_tpu_torch.secure.ckks import generate_keys

    return (generate_keys(str(tmp_path_factory.mktemp("port_keys"))),
            jax_keygen(str(tmp_path_factory.mktemp("jax_keys"))))


def test_ckks_is_the_ports_own_build(ckks_keys):
    from metisfl_tpu.native import _DIR as jax_native_dir
    from metisfl_tpu_torch import native

    lib = native.load_ckks()
    assert lib.ckks_selftest() == 0
    path = native.library_path("ckks")
    assert os.path.exists(path) and os.path.exists(path + ".srchash")
    assert os.path.dirname(path) != jax_native_dir
    assert lib._name == path


@pytest.mark.parametrize("keys_by", ["port", "jax"])
def test_ckks_sums_cross_the_packages(ckks_keys, keys_by):
    """Keys made by one package's library, each package encrypting and the
    other combining (keyless) and decrypting: within 1e-5 of the plain
    weighted sum, both ways."""
    from metisfl_tpu.secure.ckks import CKKSBackend as JaxCKKS
    from metisfl_tpu_torch.secure.ckks import CKKSBackend

    key_dir = ckks_keys[0] if keys_by == "port" else ckks_keys[1]
    port_l, jax_l = (CKKSBackend(key_dir=key_dir, role="learner"),
                     JaxCKKS(key_dir=key_dir, role="learner"))
    port_c, jax_c = (CKKSBackend(role="controller"),
                     JaxCKKS(role="controller"))
    rng = np.random.default_rng(6)
    vs = [rng.standard_normal(3000) for _ in range(4)]
    scales = [0.1, 0.2, 0.3, 0.4]
    want = sum(s * v for s, v in zip(scales, vs))
    for enc, comb, dec in ((port_l, jax_c, jax_l), (jax_l, port_c, port_l)):
        cts = [enc.encrypt(v) for v in vs]
        out = dec.decrypt(comb.weighted_sum(cts, scales), 3000)
        assert np.abs(out - want).max() <= CKKS_ATOL
    with pytest.raises(RuntimeError, match="cannot encrypt"):
        port_c.encrypt(np.ones(4))
    with pytest.raises(RuntimeError, match=r"\|v\| <= 63"):
        port_l.encrypt(np.array([1e6]))


def test_ckks_raises_where_gpp_cannot_build_it(monkeypatch):
    from metisfl_tpu_torch import native
    from metisfl_tpu_torch.secure.ckks import CKKSBackend

    def no_compiler(src, so, key):
        raise RuntimeError("native build of ckks.cc failed: no g++")

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_build", no_compiler)
    monkeypatch.setattr(native, "library_path",
                        lambda name: "/nonexistent/libmetisfl_ckks.so")
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        CKKSBackend(role="controller")


def test_ckks_in_process_federation_decrypts_to_the_plain_fedavg(ckks_keys):
    """The port's in-process federation of the MLP under scheme: ckks and
    train_dataset_size weights: the controller combines ciphertexts it
    cannot read, and the community decrypts to within 1e-5 of the plain
    weighted mean of the uplinks (recorded through a probe on each
    learner's backend)."""
    from metisfl_tpu_torch.secure.ckks import CKKSBackend

    key_dir = ckks_keys[0]
    cfg = SecureAggConfig(enabled=True, scheme="ckks", key_dir=key_dir)
    backends = [make_backend(cfg, role="learner") for _ in range(3)]
    fed, probes, sizes, seen = _secure_federation(
        backends, make_backend(cfg, role="controller"), cfg, rounds=1,
        scaler="train_dataset_size", sizes=(30, 50, 70))
    _run_rounds(fed, 1, seen)
    blob = ModelBlob.from_bytes(fed.controller.community_model_bytes())
    assert blob.opaque and not blob.tensors
    learner = CKKSBackend(key_dir=key_dir, role="learner")
    ups = [p.uplink(0) for p in probes]
    for t, (name, (payload, spec)) in enumerate(blob.opaque.items()):
        got = learner.decrypt(payload, spec.size)
        want = sum(n * u[t] for n, u in zip(sizes, ups)) / sum(sizes)
        assert np.abs(got - want).max() <= CKKS_ATOL, name


# -- Paillier ----------------------------------------------------------------

def test_paillier_ciphertexts_cross_the_packages():
    jax_pub, jax_priv = jax_paillier.generate_keypair(bits=512)
    pub = paillier.PaillierPublicKey(jax_pub.n)
    priv = paillier.PaillierPrivateKey(pub, jax_priv.lam, jax_priv.mu)
    values = [0.5, -1.25, 3.0, 1e-6]
    by_port = paillier.encrypt_vector(pub, values)
    by_jax = jax_paillier.encrypt_vector(jax_pub, values)
    np.testing.assert_allclose(jax_paillier.decrypt_vector(jax_priv, by_port),
                               values, atol=1e-9)
    np.testing.assert_allclose(paillier.decrypt_vector(priv, by_jax), values,
                               atol=1e-9)
    summed = paillier.weighted_sum(pub, [by_port, by_jax], [0.25, 0.75])
    want = jax_paillier.weighted_sum(jax_pub, [by_port, by_jax],
                                     [0.25, 0.75])
    got_port = paillier.decrypt_vector(priv, summed, weighted=True)
    got_jax = jax_paillier.decrypt_vector(jax_priv, want, weighted=True)
    assert _bytes(got_port) == _bytes(got_jax)
    np.testing.assert_allclose(got_port, values, atol=1e-6)
    own_pub, own_priv = paillier.generate_keypair(bits=256)
    assert own_priv.decrypt_int(own_pub.encrypt_int(-7)) == -7


# -- the config --------------------------------------------------------------

def _configs(pkg):
    if pkg == "port":
        from metisfl_tpu_torch.config import (
            AggregationConfig as A,
            FederationConfig as F,
        )
        from metisfl_tpu_torch.config.federation import SecureAggConfig as S
    else:
        from metisfl_tpu.config import AggregationConfig as A
        from metisfl_tpu.config import FederationConfig as F
        from metisfl_tpu.config import SecureAggConfig as S
    return {
        "masking": lambda: F(aggregation=A(rule="secure_agg",
                                           scaler="participants"),
                             secure=S(enabled=True, scheme="masking")),
        "masking_streaming": lambda: F(
            aggregation=A(rule="secure_agg", scaler="participants",
                          streaming=True),
            secure=S(enabled=True, scheme="masking", num_parties=3)),
        "ckks": lambda: F(aggregation=A(rule="secure_agg"),
                          secure=S(enabled=True, scheme="ckks")),
        "identity": lambda: F(aggregation=A(rule="secure_agg"),
                              secure=S(enabled=True, scheme="identity")),
        "masking_weighted": lambda: F(
            aggregation=A(rule="secure_agg"),
            secure=S(enabled=True, scheme="masking")),
        "ckks_streaming": lambda: F(
            aggregation=A(rule="secure_agg", streaming=True),
            secure=S(enabled=True, scheme="ckks")),
        "enabled_fedavg": lambda: F(secure=S(enabled=True)),
        "secure_agg_disabled": lambda: F(aggregation=A(rule="secure_agg")),
        "negative_neighbors": lambda: F(
            aggregation=A(rule="secure_agg", scaler="participants"),
            secure=S(enabled=True, mask_neighbors=-1)),
    }


@pytest.mark.parametrize("name", sorted(_configs("port")))
def test_secure_config_checks_match_the_jax_package(name):
    got = _refusal(_configs("port")[name])
    want = _refusal(_configs("jax")[name])
    assert (got is None) == (want is None), (got, want)
    if got is not None:
        assert got[0] == want[0] == "ValueError"


def test_the_distributed_tier_and_dp_still_refuse():
    """Masking with streaming over the distributed tier, and DP, are
    ported; what still refuses is what the JAX package refuses: CKKS
    ciphertexts over the slices, and DP noise with no clip bound."""
    from metisfl_tpu_torch.config.federation import TreeAggregationConfig

    cfg = FederationConfig(
        aggregation=AggregationConfig(
            rule="secure_agg", scaler="participants", streaming=True,
            tree=TreeAggregationConfig(enabled=True, distributed=True)),
        secure=SecureAggConfig(enabled=True))
    assert FederationConfig.from_wire(cfg.to_wire()) == cfg
    with pytest.raises(ValueError, match="secure.scheme: masking"):
        FederationConfig(
            aggregation=AggregationConfig(
                rule="secure_agg", scaler="participants",
                tree=TreeAggregationConfig(enabled=True, distributed=True)),
            secure=SecureAggConfig(enabled=True, scheme="ckks"))
    assert FederationConfig(
        train=TrainParams(dp_clip_norm=1.0)).train.dp_clip_norm == 1.0
    with pytest.raises(ValueError, match="dp_clip_norm > 0"):
        FederationConfig(train=TrainParams(dp_noise_multiplier=1.0))
    cfg = _configs("port")["masking_streaming"]()
    assert FederationConfig.from_wire(cfg.to_wire()) == cfg


# -- the learner ---------------------------------------------------------------

def _mlp_pair(seed=0):
    """A JAX learner and a port learner over the same MLP variables."""
    from metisfl_tpu.learner.learner import Learner as JaxLearner
    from metisfl_tpu.models import FlaxModelOps
    from metisfl_tpu.models.dataset import ArrayDataset as JaxDataset
    from metisfl_tpu.models.zoo import MLP as JaxMLP
    from metisfl_tpu_torch.learner import Learner

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.integers(0, 3, 8).astype(np.int32)
    jax_ops = FlaxModelOps(JaxMLP(features=(16,), num_outputs=3), x[:2])
    variables = jax_ops.get_variables()
    port_ops = TorchModelOps(MLP(6, (16,), 3), variables=variables,
                             device="cpu")
    return (JaxLearner, jax_ops, JaxDataset(x, y)), (Learner, port_ops,
                                                     ArrayDataset(x, y))


def test_the_masked_uplink_is_the_jax_learners_byte_for_byte():
    """Same variables, secret, party and round: the port learner's masked
    blob is the JAX learner's bytes, which pins the tensor order on the
    wire (each tensor's mask derives from its position)."""
    (JaxLearner, jax_ops, jax_ds), (Learner, port_ops, ds) = _mlp_pair()
    jax_backend = JaxMasking("sec", party_index=1, num_parties=3)
    port_backend = MaskingBackend("sec", party_index=1, num_parties=3)
    ref = JaxLearner(jax_ops, jax_ds, controller=None,
                     secure_backend=jax_backend)
    port = Learner(port_ops, ds, controller=None,
                   secure_backend=port_backend)
    try:
        for rid in (0, 2):
            jax_backend.begin_round(rid)
            port_backend.begin_round(rid)
            got, want = port._dump_model(), ref._dump_model()
            assert got == want
            blob = ModelBlob.from_bytes(got)
            assert list(blob.opaque) == [
                n for n, _ in ModelBlob.from_bytes(
                    pack_model(jax_ops.get_variables())).tensors]
    finally:
        port.shutdown()


@pytest.mark.parametrize("dtype", [DType.F32, DType.BF16, DType.F16,
                                   DType.I32])
def test_an_opaque_tensor_decodes_as_numpy_rounds_it(dtype):
    from metisfl_tpu.tensor.spec import np_dtype_of
    from metisfl_tpu_torch.tensor.pytree import tensor_from_float64, to_numpy

    rng = np.random.default_rng(7)
    # ties and near-ties of every narrow type, and ordinary values
    values = np.concatenate([
        rng.standard_normal(200) * 50,
        [1 + 2 ** -8 + 2 ** -30, 1 + 2 ** -11 + 2 ** -40, -2.5, 2.5, 0.0]])
    spec = TensorSpec((len(values),), dtype, TensorKind.CIPHERTEXT)
    got = to_numpy(tensor_from_float64(spec, values))
    want = np.asarray(values, np_dtype_of(dtype))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_an_opaque_community_loads_into_the_engines_dtypes():
    (JaxLearner, jax_ops, jax_ds), (Learner, port_ops, ds) = _mlp_pair(1)
    backend = IdentityBackend()
    ref = JaxLearner(jax_ops, jax_ds, controller=None,
                     secure_backend=JaxIdentity())
    port = Learner(port_ops, ds, controller=None, secure_backend=backend)
    try:
        blob = port._dump_model()
        assert ModelBlob.from_bytes(blob).opaque
        got = port._load_model(blob)
        want = ref._load_model(blob)

        def flat(tree, prefix=""):
            out = {}
            for k in sorted(tree):
                name = f"{prefix}/{k}"
                if isinstance(tree[k], dict):
                    out.update(flat(tree[k], name))
                else:
                    out[name] = np.asarray(tree[k])
            return out

        g, w = flat(got), flat(want)
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == w[name].dtype
            assert g[name].tobytes() == w[name].tobytes()
        with pytest.raises(RuntimeError, match="secure backend"):
            Learner(port_ops, ds, controller=None)._load_model(blob)
    finally:
        port.shutdown()


def test_recover_masks_over_the_learner_service():
    from metisfl_tpu_torch.learner import Learner
    from metisfl_tpu_torch.learner.service import LearnerServer

    (_, _, _), (_, port_ops, ds) = _mlp_pair()
    backend = MaskingBackend("sec", party_index=0, num_parties=4)
    backend.begin_round(3)
    learner = Learner(port_ops, ds, controller=None, secure_backend=backend)
    server = LearnerServer(learner, host="127.0.0.1", port=0)
    try:
        reply = loads(server._recover_masks(dumps(
            {"round_id": 3, "surviving": [0, 1], "dropped": [2, 3],
             "lengths": [5, 2]})))
        ref = JaxMasking("sec", party_index=3, num_parties=4)
        ref.begin_round(3)
        assert reply["corrections"] == ref.recovery_correction(
            3, [0, 1], [2, 3], [5, 2])
        with pytest.raises(ValueError, match="different recovery split"):
            server._recover_masks(dumps(
                {"round_id": 3, "surviving": [0, 2], "dropped": [1, 3],
                 "lengths": [5, 2]}))
        plain = Learner(port_ops, ds, controller=None)
        with pytest.raises(RuntimeError, match="no masking backend"):
            plain.recover_masks(3, [0, 1], [2], [5])
    finally:
        learner.shutdown()


# -- in-process federations ----------------------------------------------------

class _UplinkProbe:
    """Records the float64 plaintext each ``encrypt`` call of a learner's
    backend receives, by round (the probe of what the learner shipped)."""

    def __init__(self, backend):
        self.backend = backend
        self.by_round = {}
        encrypt = backend.encrypt

        def recorded(values):
            rid = getattr(backend, "_round_id", 0)
            self.by_round.setdefault(rid, []).append(
                np.array(values, np.float64))
            return encrypt(values)

        backend.encrypt = recorded

    def uplink(self, round_id):
        return self.by_round[round_id]


def _shards(n, sizes=None, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    out = []
    for i in range(n):
        x = rng.standard_normal(((sizes or [48] * n)[i], 6)).astype(
            np.float32)
        out.append((x, np.argmax(x @ w, axis=-1).astype(np.int32)))
    return out


def _template():
    from metisfl_tpu.models import FlaxModelOps
    from metisfl_tpu.models.zoo import MLP as JaxMLP

    x = np.zeros((2, 6), np.float32)
    return FlaxModelOps(JaxMLP(features=(8,), num_outputs=3), x
                        ).get_variables()


def _secure_federation(backends, controller_backend, secure, rounds=2,
                       scaler="participants", streaming=False, sizes=None):
    config = FederationConfig(
        aggregation=AggregationConfig(rule="secure_agg", scaler=scaler,
                                      streaming=streaming),
        secure=secure,
        train=TrainParams(batch_size=16, local_steps=3, learning_rate=0.05),
        eval=EvalConfig(every_n_rounds=0),
        termination=TerminationConfig(federation_rounds=rounds))
    fed = InProcessFederation(config, device="cpu",
                              secure_backend=controller_backend)
    template = _template()
    probes = []
    for i, (x, y) in enumerate(_shards(len(backends), sizes)):
        ops = TorchModelOps(MLP(6, (8,), 3), variables=template,
                            device="cpu")
        probes.append(_UplinkProbe(backends[i]))
        fed.add_learner(ops, ArrayDataset(x, y, seed=i),
                        secure_backend=backends[i])
    fed.seed_model(template)
    return (fed, probes, [len(x) for x, _ in _shards(len(backends), sizes)],
            _Communities(fed))


def _run_rounds(fed, rounds, seen):
    try:
        fed.start()
        seen.gate.set()
        assert fed.wait_for_rounds(rounds, timeout_s=120)
        return fed.statistics()
    finally:
        fed.shutdown()


def _opaque(blob_bytes):
    return {name: np.frombuffer(payload, np.float64).copy()
            for name, (payload, _) in ModelBlob.from_bytes(
                blob_bytes).opaque.items()}


class _Communities:
    """The community model each round's train tasks carry; the tasks wait
    for ``gate``, set once every learner has joined, so round 0's cohort
    is the whole federation."""

    def __init__(self, fed):
        self.by_round = {}
        self.gate = threading.Event()
        for learner in fed.learners:
            run = learner.run_task

            def run_task(task, run=run):
                self.by_round.setdefault(task.round_id, task.model)
                self.gate.wait(60)
                return run(task)

            learner.run_task = run_task


def test_masked_federation_matches_the_jax_package():
    """Two rounds of 3 MLP learners under masking in both packages'
    InProcessFederation: each round's community (float64 payloads) within
    1e-5 of the JAX package's, and the port's masked stream gives the
    port's store path's community bit for bit (modular sums are
    order-free)."""
    from metisfl_tpu.comm.messages import TrainParams as JaxTrainParams
    from metisfl_tpu.config import AggregationConfig as JaxAggregationConfig
    from metisfl_tpu.config import EvalConfig as JaxEvalConfig
    from metisfl_tpu.config import FederationConfig as JaxFederationConfig
    from metisfl_tpu.config import SecureAggConfig as JaxSecureAggConfig
    from metisfl_tpu.config import TerminationConfig as JaxTermination
    from metisfl_tpu.driver import InProcessFederation as JaxFederation
    from metisfl_tpu.models import FlaxModelOps
    from metisfl_tpu.models.dataset import ArrayDataset as JaxDataset
    from metisfl_tpu.models.zoo import MLP as JaxMLP

    n, rounds = 3, 2
    secure = SecureAggConfig(enabled=True, scheme="masking")
    runs = {}
    for streaming in (False, True):
        fed, _, _, seen = _secure_federation(
            _backends(MaskingBackend, n, "fed"),
            MaskingBackend(num_parties=n), secure, streaming=streaming)
        _run_rounds(fed, rounds, seen)
        runs[streaming] = [_opaque(seen.by_round[r]) for r in range(1, rounds)]
        runs[streaming].append(_opaque(fed.controller.community_model_bytes()))
    jax_cfg = JaxFederationConfig(
        aggregation=JaxAggregationConfig(rule="secure_agg",
                                         scaler="participants"),
        secure=JaxSecureAggConfig(enabled=True, scheme="masking"),
        train=JaxTrainParams(batch_size=16, local_steps=3,
                             learning_rate=0.05),
        eval=JaxEvalConfig(every_n_rounds=0),
        termination=JaxTermination(federation_rounds=rounds))
    ref = JaxFederation(jax_cfg, secure_backend=JaxMasking(num_parties=n))
    template = _template()
    for i, (x, y) in enumerate(_shards(n)):
        engine = FlaxModelOps(JaxMLP(features=(8,), num_outputs=3), x[:2])
        engine.set_variables(template)
        ref.add_learner(engine, JaxDataset(x, y, seed=i),
                        secure_backend=JaxMasking("fed", i, n))
    ref.seed_model(template)
    seen = _Communities(ref)
    try:
        ref.start()
        seen.gate.set()
        assert ref.wait_until(lambda: rounds in seen.by_round, 120)
    finally:
        ref.shutdown()
    want = [_opaque(seen.by_round[r]) for r in range(1, rounds + 1)]
    for got_round, stream_round, want_round in zip(runs[False], runs[True],
                                                   want):
        assert sorted(got_round) == sorted(want_round)
        for name in want_round:
            assert _bytes(got_round[name]) == _bytes(stream_round[name])
            assert np.abs(got_round[name] - want_round[name]).max() <= \
                COMMUNITY_ATOL, name


@pytest.mark.parametrize("streaming", [False, True])
def test_a_mid_round_dropout_settles_to_the_survivors_mean(streaming):
    """Learner 0 leaves while round 1 waits on it: the barrier releases
    the two survivors, one of them discloses party 0's residual, and the
    community is within 1e-9 of the float64 mean of the survivors'
    uplinks (store path and masked stream)."""
    n = 3
    secure = SecureAggConfig(enabled=True, scheme="masking")
    backends = _backends(MaskingBackend, n, "fed")
    fed, probes, _, seen = _secure_federation(
        backends, MaskingBackend(num_parties=n), secure, streaming=streaming)
    leaver = fed.learners[0]
    run = leaver.run_task
    held = threading.Event()

    def run_task(task):
        if task.round_id == 1:
            held.set()  # accepted, never reported: it leaves instead
            return
        run(task)

    leaver.run_task = run_task
    recovered = []
    for learner in fed.learners[1:]:
        recover = learner.recover_masks

        def recorded(*args, recover=recover):
            out = recover(*args)
            recovered.append(args)
            return out

        learner.recover_masks = recorded
    try:
        fed.start()
        seen.gate.set()
        assert fed.wait_until(held.is_set, 60)
        assert leaver.leave_federation()
        assert fed.wait_for_rounds(2, timeout_s=60)
        stats = fed.statistics()
        community = _opaque(fed.controller.community_model_bytes())
    finally:
        fed.shutdown()
    meta = stats["round_metadata"][1]
    assert len(meta["selected_learners"]) == 2
    assert not meta["errors"]
    assert [a[1:3] for a in recovered] == [([1, 2], [0])]
    for t, name in enumerate(community):
        mean = np.mean([p.uplink(1)[t] for p in probes[1:]], axis=0)
        assert np.abs(community[name] - mean).max() <= MASK_ATOL, name


# -- over gRPC: mixed cohorts and the driver -----------------------------------

def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return env


def _spawn(args, log_path):
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, *args], stdout=log,
                                stderr=subprocess.STDOUT, env=_env(),
                                cwd=REPO)


def _wait_log(proc, log_path, pattern, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with open(log_path) as f:
            found = re.search(pattern, f.read())
        if found:
            return found
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    with open(log_path) as f:
        raise AssertionError(f"{pattern!r} never appeared:\n"
                             f"{f.read()[-3000:]}")


def _wait_until(predicate, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return False


def _recipe(kind, x, y, out_dir, seed, gate, hold):
    """A learner recipe of either package that writes the plaintext of each
    uplink (``up_r.npz``, the trained weights) and holds round 1 and later
    on ``hold``."""

    def recipe():
        import os
        import time

        import numpy as np

        if kind == "torch":
            from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
            from metisfl_tpu_torch.models.zoo import MLP
            ops = TorchModelOps(MLP(6, (8,), 3), rng_seed=0, device="cpu")
        else:
            from metisfl_tpu.models import FlaxModelOps
            from metisfl_tpu.models.dataset import ArrayDataset
            from metisfl_tpu.models.zoo import MLP
            ops = FlaxModelOps(MLP(features=(8,), num_outputs=3), x[:2],
                               rng_seed=0)

        def flat(tree, prefix=""):
            out = {}
            for key in sorted(tree):
                name = f"{prefix}/{key}" if prefix else key
                if isinstance(tree[key], dict):
                    out.update(flat(tree[key], name))
                else:
                    out[name] = np.asarray(tree[key], np.float64)
            return out

        train, calls = ops.train, []

        def recorded(dataset, params, *args, **kwargs):
            files = [gate] + ([hold] if calls else [])
            deadline = time.time() + 120
            while (not all(os.path.exists(f) for f in files)
                   and time.time() < deadline):
                time.sleep(0.05)
            r = len(calls)
            calls.append(r)
            out = train(dataset, params, *args, **kwargs)
            np.savez(os.path.join(out_dir, f"up_{r}.npz"),
                     **flat(out.variables))
            return out

        ops.train = recorded
        return ops, ArrayDataset(x, y, seed=seed)

    return recipe


@pytest.mark.parametrize("controller_kind", ["jax", "torch"])
def test_a_mixed_cohort_over_grpc_unmasks_to_the_plain_mean(
        tmp_path, controller_kind):
    """Three learner processes under ``scheme: masking`` (one federation
    secret, party indices 0-2): under a JAX controller two port learners
    and a JAX one, under a port controller two JAX learners and a port
    one. Round 0's community (float64 payloads) lies within 1e-9 of the
    plain mean of the three recorded uplinks; a mask that differs by one
    bit between the packages would leave ~1e7 there."""
    import cloudpickle

    from metisfl_tpu_torch.controller.service import ControllerClient

    n = 3
    other = "torch" if controller_kind == "jax" else "jax"
    kinds = [other, controller_kind, other]
    shards = _shards(n, sizes=[24, 24, 24])
    gate, hold = str(tmp_path / "gate"), str(tmp_path / "hold")
    if controller_kind == "torch":
        config = FederationConfig(
            controller_port=0,
            aggregation=AggregationConfig(rule="secure_agg",
                                          scaler="participants"),
            secure=SecureAggConfig(enabled=True, scheme="masking",
                                   num_parties=n),
            train=TrainParams(batch_size=8, local_steps=2, learning_rate=0.1),
            eval=EvalConfig(every_n_rounds=0),
            termination=TerminationConfig(federation_rounds=3))
        module = "metisfl_tpu_torch"
    else:
        from metisfl_tpu.comm.messages import TrainParams as JTrain
        from metisfl_tpu.config import AggregationConfig as JAgg
        from metisfl_tpu.config import EvalConfig as JEval
        from metisfl_tpu.config import FederationConfig as JFed
        from metisfl_tpu.config import SecureAggConfig as JSecure
        config = JFed(
            controller_port=0,
            aggregation=JAgg(rule="secure_agg", scaler="participants"),
            secure=JSecure(enabled=True, scheme="masking", num_parties=n),
            train=JTrain(batch_size=8, local_steps=2, learning_rate=0.1),
            eval=JEval(every_n_rounds=0))
        module = "metisfl_tpu"
    cfg_path = tmp_path / "federation_config.bin"
    cfg_path.write_bytes(config.to_wire())
    procs, client = [], None
    module_obj = sys.modules[__name__]
    try:
        log = str(tmp_path / "controller.log")
        procs.append(_spawn(["-m", f"{module}.controller", "--config",
                             str(cfg_path), "--port", "0"], log))
        port = int(_wait_log(procs[0], log,
                             r"CONTROLLER_READY port=(\d+)").group(1))
        client = ControllerClient("127.0.0.1", port)
        template = TorchModelOps(MLP(6, (8,), 3), rng_seed=0,
                                 device="cpu").get_variables()
        assert client.replace_community_model(pack_model(template))
        for i, ((x, y), kind) in enumerate(zip(shards, kinds)):
            out_dir = tmp_path / f"learner_{i}"
            out_dir.mkdir()
            recipe_path = tmp_path / f"recipe_{i}.pkl"
            cloudpickle.register_pickle_by_value(module_obj)
            try:
                recipe_path.write_bytes(cloudpickle.dumps(
                    _recipe(kind, x, y, str(out_dir), i, gate, hold)))
            finally:
                cloudpickle.unregister_pickle_by_value(module_obj)
            secure_path = tmp_path / f"learner_{i}_secure.bin"
            secure_path.write_bytes(dumps({"scheme": "masking", "kwargs": {
                "federation_secret": "mixed", "party_index": i,
                "num_parties": n}}))
            pkg = "metisfl_tpu_torch" if kind == "torch" else "metisfl_tpu"
            args = ["-m", f"{pkg}.learner", "--controller-host",
                    "127.0.0.1", "--controller-port", str(port), "--port",
                    "0", "--advertise-host", "127.0.0.1", "--recipe",
                    str(recipe_path), "--secure-config", str(secure_path)]
            if kind == "torch":
                args += ["--device", "cpu"]
            procs.append(_spawn(args, str(tmp_path / f"learner_{i}.log")))
        assert _wait_until(lambda: len(client.list_learners()) == n)
        open(gate, "w").close()
        assert _wait_until(lambda: client.get_runtime_metadata(tail=1)[
            "global_iteration"] >= 1)
        # round 1's tasks wait on ``hold``: the community is round 0's
        community = _opaque(client.get_community_model())
        ups = [np.load(tmp_path / f"learner_{i}" / "up_0.npz")
               for i in range(n)]
        assert len(community) == len(ups[0].files)
        for name in community:
            mean = np.mean([u[name].ravel() for u in ups], axis=0)
            assert np.abs(community[name] - mean).max() <= MASK_ATOL, name
        open(hold, "w").close()
    finally:
        open(hold, "w").close()
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)


def test_the_driver_writes_each_learners_secure_material(tmp_path):
    from metisfl_tpu_torch.driver import DriverSession

    template = _template()
    for scheme in ("masking", "ckks", "identity"):
        cfg = FederationConfig(
            aggregation=AggregationConfig(rule="secure_agg",
                                          scaler="participants"),
            secure=SecureAggConfig(enabled=True, scheme=scheme,
                                   mask_neighbors=2))
        session = DriverSession(cfg, template, [lambda: None] * 3,
                                workdir=str(tmp_path / scheme),
                                device="cpu")
        session._prepare_secure()
        files = [loads((tmp_path / scheme / f"learner_{i}_secure.bin"
                        ).read_bytes()) for i in range(3)]
        assert {f["scheme"] for f in files} == {scheme}
        assert all(oct(os.stat(p).st_mode)[-3:] == "600" for i in range(3)
                   for p in session._secure_files(i)[:1])
        if scheme == "masking":
            assert cfg.secure.num_parties == 3
            assert [f["kwargs"]["party_index"] for f in files] == [0, 1, 2]
            assert len({f["kwargs"]["federation_secret"] for f in files}) == 1
            assert files[0]["kwargs"]["neighbors"] == 2
            backend = make_backend(SecureAggConfig(enabled=True,
                                                   scheme="masking"),
                                   **files[1]["kwargs"])
            assert backend.party_index == 1 and backend.neighbors == 2
        if scheme == "ckks":
            key_dir = cfg.secure.key_dir
            assert session._secure_files(0)[1:] == [
                os.path.join(key_dir, "pk.bin"),
                os.path.join(key_dir, "sk.bin")]
            assert os.path.exists(os.path.join(key_dir, "sk.bin"))


def test_the_ports_secure_smoke_passes_on_the_cpu(tmp_path):
    from metisfl_tpu_torch.driver.secure_smoke import run_secure_smoke

    out = run_secure_smoke(device="cpu", workdir=str(tmp_path))
    assert out["ok"], out
    assert out["masked"]["masks_recovered"] >= 1
    assert out["max_abs_diff"] <= out["tolerance"]
