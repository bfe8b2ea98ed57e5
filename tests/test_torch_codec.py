"""The port's wire codec and messages against the JAX package's.

The same values and the same messages go through both packages' codecs:
the port's ``dumps`` must give the JAX package's bytes, byte for byte, and
each package's ``loads`` must read the other's bytes back to the value.
The values stress the format: nesting, numpy scalars of every dtype and
arrays as raw bytes, the int64 bounds, zigzag negatives, unicode, bytes,
NaN and -0.0. Malformed input must fail the same way in both.
"""

import math
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from metisfl_tpu.comm import codec as jax_codec
from metisfl_tpu.comm import messages as jax_messages
from metisfl_tpu_torch.comm import codec
from metisfl_tpu_torch.comm import messages
from metisfl_tpu_torch.config import (
    CommConfig,
    FederationConfig,
    LearnerEndpoint,
    SSLConfig,
    TerminationConfig,
    load_config,
)

NUMPY_SCALARS = [
    np.bool_(True), np.int8(-128), np.int16(-32768), np.int32(-2**31),
    np.int64(-2**63), np.uint8(255), np.uint16(65535), np.uint32(2**32 - 1),
    np.uint64(2**63 - 1), np.float16(1.5), np.float32(-0.1),
    np.float64(np.pi),
]
ARRAY_DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8",
                "uint16", "uint32", "uint64", "float16", "float32",
                "float64"]

VALUES = {
    "none": None, "true": True, "false": False, "zero": 0,
    "int64_max": 2**63 - 1, "int64_min": -(2**63),
    "zigzag_negatives": [-1, -2, -63, -64, -65, -(2**31), -(2**62)],
    "varint_edges": [127, 128, 16383, 16384, 2**56, 2**62],
    "float": 3.25, "neg_zero": -0.0, "inf": [math.inf, -math.inf],
    "tiny": 5e-324, "empty_str": "", "unicode": "héllo wörld ✓ 𝄞 中文",
    "empty_bytes": b"", "bytes": bytes(range(256)),
    "bytearray": bytearray(b"\x00\xff\x80"),
    "nested": {"a": [1, {"b": [None, True, [2.5, "x"]]}], "c": {"d": {}},
               "e": ()},
    "numpy_scalars": NUMPY_SCALARS,
    "arrays_as_bytes": {name: np.arange(-3, 5).astype(name).tobytes()
                        for name in ARRAY_DTYPES},
    "deep": [[[[[[[[[[1]]]]]]]]]],
    "wide": {f"k{i}": list(range(i)) for i in range(40)},
}


def _same(a, b):
    """Equality that holds NaN equal to NaN and tells -0.0 from 0.0."""
    if isinstance(a, float) and isinstance(b, float):
        return struct.pack("<d", a) == struct.pack("<d", b)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _plain(value):
    """What decoding gives back: tuples as lists, numpy scalars as Python
    values, bytearrays as bytes."""
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, bytearray):
        return bytes(value)
    return value


@pytest.mark.parametrize("name", sorted(VALUES))
def test_codec_bytes_equal_the_jax_codec(name):
    value = VALUES[name]
    mine = codec.dumps(value)
    assert mine == jax_codec.dumps(value)
    assert _same(codec.loads(mine), _plain(value))
    assert _same(jax_codec.loads(mine), _plain(value))


def test_codec_nan_bits_survive_both_ways():
    nan = float("nan")
    mine = codec.dumps({"x": nan})
    assert mine == jax_codec.dumps({"x": nan})
    assert math.isnan(jax_codec.loads(mine)["x"])
    assert math.isnan(codec.loads(jax_codec.dumps([nan]))[0])


@pytest.mark.parametrize("bad", [2**63, -(2**63) - 1, np.uint64(2**64 - 1)])
def test_codec_refuses_ints_beyond_int64_like_the_jax_codec(bad):
    for dumps in (codec.dumps, jax_codec.dumps):
        with pytest.raises(OverflowError):
            dumps(bad)


@pytest.mark.parametrize("bad", [{1: "x"}, object(), np.zeros(3), {1.5}])
def test_codec_refuses_what_the_jax_codec_refuses(bad):
    for dumps in (codec.dumps, jax_codec.dumps):
        with pytest.raises(TypeError):
            dumps(bad)


def test_memoryview_of_wide_items_encodes_as_bytes():
    view = memoryview(np.arange(4, dtype=np.int32))
    assert codec.dumps(view) == jax_codec.dumps(view) == codec.dumps(
        view.tobytes())


@pytest.mark.parametrize("buf", [
    b"", b"\x03", b"\x03\x80", b"\x04\x00\x00", b"\x05\x05ab",
    b"\x07\x02\x00", b"\x08\x01\x01", b"\x09", b"\x00\x00",
    b"\x03" + b"\xff" * 10 + b"\x01",
    b"\x07\x01" * 120 + b"\x00",
])
def test_malformed_input_fails_alike(buf):
    for loads in (codec.loads, jax_codec.loads):
        with pytest.raises(ValueError):
            loads(buf)


def test_random_garbage_decodes_alike():
    rng = np.random.default_rng(7)
    for _ in range(500):
        buf = rng.integers(0, 256, rng.integers(1, 24)).astype(
            np.uint8).tobytes()
        results = []
        for loads in (codec.loads, jax_codec.loads):
            try:
                results.append(("ok", loads(buf)))
            except (ValueError, UnicodeDecodeError) as exc:
                results.append(("error", type(exc)))
        assert _same(results[0], results[1]), buf


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2**63), max_value=2**63 - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_values = st.recursive(
    _scalars,
    lambda children: st.lists(children, max_size=5)
    | st.dictionaries(st.text(max_size=8), children, max_size=5),
    max_leaves=30)


@settings(max_examples=150, deadline=None)
@given(_values)
def test_codec_property_bytes_equal_and_cross_decode(value):
    mine = codec.dumps(value)
    theirs = jax_codec.dumps(value)
    assert mine == theirs
    assert _same(codec.loads(theirs), value)
    assert _same(jax_codec.loads(mine), value)


def _message_kwargs():
    model = b"".join(np.linspace(-1, 1, 7).astype(name).tobytes()
                     for name in ARRAY_DTYPES)
    params = dict(batch_size=8, local_steps=3, local_epochs=0.5,
                  optimizer="adam", learning_rate=1e-3,
                  optimizer_kwargs={"b1": 0.9, "eps": 1e-8},
                  proximal_mu=0.01, ship_dtype="bf16", scan_chunk=2)
    return {
        "TrainParams": params,
        "JoinRequest": dict(hostname="héte", port=50123,
                            num_train_examples=600, num_val_examples=0,
                            num_test_examples=-1, previous_id="L0_x_1",
                            auth_token="tok", capabilities={
                                "device": "cuda", "kernels": ["k1", "k2"]}),
        "JoinReply": dict(learner_id="L0_host_1", auth_token="abc",
                          rejoined=True, controller_epoch="e" * 32),
        "TrainTask": dict(task_id="t1", learner_id="L1", round_id=2,
                          global_iteration=2, model=model,
                          params=("TrainParams", params), scaffold=False,
                          control=b"", controller_epoch="epoch"),
        "TaskResult": dict(task_id="t1", learner_id="L1", auth_token="tok",
                           controller_epoch="epoch", round_id=2,
                           model=model, num_train_examples=600,
                           completed_steps=3, completed_epochs=0.5,
                           completed_batches=3,
                           processing_ms_per_step=12.5,
                           train_metrics={"loss": 0.25,
                                          "accuracy": float("nan")},
                           epoch_metrics=[{"loss": 1.0}, {"loss": -0.0}],
                           control_delta=b"\x01",
                           device_stats={"step_ms_ewma": 3.0}),
        "EvalTask": dict(task_id="e1", learner_id="L2", round_id=4,
                         model=model, batch_size=64,
                         datasets=["test", "valid"],
                         metrics=["loss", "accuracy"],
                         controller_epoch="epoch"),
        "EvalResult": dict(task_id="e1", learner_id="L2", round_id=4,
                           evaluations={"test": {"loss": 0.5,
                                                 "accuracy": 0.875}},
                           duration_ms=17.25),
    }


def _build(module, name, kwargs):
    kwargs = {k: (getattr(module, v[0])(**v[1]) if isinstance(v, tuple)
                  else v) for k, v in kwargs.items()}
    return getattr(module, name)(**kwargs)


@pytest.mark.parametrize("name", sorted(_message_kwargs()))
def test_message_wire_equals_the_jax_message(name):
    kwargs = _message_kwargs()[name]
    mine = _build(messages, name, kwargs)
    theirs = _build(jax_messages, name, kwargs)
    assert mine.to_wire() == theirs.to_wire()
    back = getattr(jax_messages, name).from_wire(mine.to_wire())
    assert back.to_wire() == theirs.to_wire()
    again = getattr(messages, name).from_wire(theirs.to_wire())
    assert again.to_wire() == mine.to_wire()
    assert type(again) is type(mine)


@pytest.mark.parametrize("name", sorted(_message_kwargs()))
def test_default_messages_equal_the_jax_defaults(name):
    assert (getattr(messages, name)().to_wire()
            == getattr(jax_messages, name)().to_wire())


def test_nested_params_come_back_as_a_message():
    task = messages.TrainTask.from_wire(jax_messages.TrainTask(
        params=jax_messages.TrainParams(batch_size=3)).to_wire())
    assert isinstance(task.params, messages.TrainParams)
    assert task.params.batch_size == 3


def test_unknown_fields_are_ignored():
    wire = codec.dumps({"task_id": "t", "from_a_later_version": [1, 2]})
    assert messages.EvalTask.from_wire(wire).task_id == "t"


def test_federation_config_round_trips(tmp_path):
    cfg = FederationConfig(
        controller_port=0, comm=CommConfig(default_deadline_s=30.0),
        ssl=SSLConfig(enabled=True, cert_path="c.pem", key_path="k.pem"),
        termination=TerminationConfig(federation_rounds=4,
                                      execution_cutoff_mins=1.5,
                                      metric_cutoff_score=0.9),
        learners=[LearnerEndpoint(port=7), LearnerEndpoint()])
    back = FederationConfig.from_wire(cfg.to_wire())
    assert back == cfg
    assert isinstance(back.learners[0], LearnerEndpoint)
    path = tmp_path / "federation.yaml"
    path.write_text("controller_port: 0\n"
                    "termination: {federation_rounds: 2, "
                    "metric_cutoff_score: 0.5}\n"
                    "learners: [{port: 5}, {}]\n"
                    "comm: {retries: 2}\n"
                    "a_field_of_the_jax_package: 1\n")
    loaded = load_config(str(path))
    assert loaded.termination.federation_rounds == 2
    assert loaded.termination.metric_cutoff_score == 0.5
    assert [ep.port for ep in loaded.learners] == [5, 0]
    assert loaded.comm.retries == 2


def test_config_still_refuses_multi_host_learners():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FederationConfig(learners=[LearnerEndpoint(world_size=2)])
