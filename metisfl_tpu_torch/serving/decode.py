"""Continuous-batching autoregressive decode for the serving gateway.

Orca-style (Yu et al., OSDI 2022) iteration-level scheduling over the
KV-cache decode of :mod:`metisfl_tpu_torch.models.generate`: the gateway's
``generate`` feeds a slot-based in-flight batch where finished sequences
retire and queued prompts join **at step granularity**: a late prompt
prefills between two decode steps of the running batch instead of waiting
for the whole batch to finish. Each step is one batched forward at fixed
slot shapes (:class:`~metisfl_tpu_torch.models.generate.SlotDecoder`).

Hot-swap follows the gateway's zero-drop contract: ``swap()`` marks a
pending (version, model) pair; the in-flight batch FINISHES on the pair it
captured, admission pauses, and the queue drains onto the new pair. No
request is dropped, and every reply reports the version that decoded it.

Greedy only by contract; output equals a solo
:func:`metisfl_tpu_torch.models.generate.generate` call at the same
``max_len``.

Telemetry, the JAX package's: queue depth, active slots, emitted tokens
and the tokens/s EWMA per channel, and a ``decode.slot`` span per request
(enqueue to retire) parented on the submitter's ``serving.generate``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent import futures
from typing import Any, Dict, List, Optional

import numpy as np

from metisfl_tpu_torch import telemetry as _tel
from metisfl_tpu_torch.models.generate import SlotDecoder
from metisfl_tpu_torch.telemetry import metrics as _tmetrics
from metisfl_tpu_torch.telemetry import trace as _ttrace

logger = logging.getLogger("metisfl_tpu_torch.serving")

_REG = _tmetrics.registry()
_M_DECODE_QUEUE = _REG.gauge(
    _tel.M_SERVING_DECODE_QUEUE_DEPTH,
    "Generation requests queued for a free decode slot, per channel "
    "(series removed when the channel's decode engine closes)",
    ("channel",))
_M_DECODE_SLOTS = _REG.gauge(
    _tel.M_SERVING_DECODE_ACTIVE_SLOTS,
    "Decode slots currently occupied by in-flight sequences, per channel",
    ("channel",))
_M_DECODE_TOKENS = _REG.counter(
    _tel.M_SERVING_DECODE_TOKENS_TOTAL,
    "Tokens emitted by the continuous-batching decode loop", ("channel",))
_M_DECODE_TPS = _REG.gauge(
    _tel.M_SERVING_DECODE_TOKENS_PER_SEC,
    "EWMA decode throughput (tokens/s across all active slots), per "
    "channel", ("channel",))

PAD_ID = 0


class _GenPending:
    """One queued generation request + the future its caller blocks on."""

    __slots__ = ("prompt", "max_new", "eos_id", "future", "enqueued_at",
                 "admitted_step", "trace_ctx")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 eos_id: Optional[int]):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.future: "futures.Future" = futures.Future()
        self.enqueued_at = time.perf_counter()
        self.admitted_step = -1
        # the submitter's span context: slots retire on the loop's thread
        self.trace_ctx = _ttrace.current_context()


class _Slot:
    """One occupied decode slot's host-side state."""

    __slots__ = ("req", "tokens", "position", "last_tok", "version")

    def __init__(self, req: _GenPending, first_tok: int, position: int,
                 version: int):
        self.req = req
        self.tokens: List[int] = [first_tok]
        self.position = position         # next cache write position
        self.last_tok = first_tok
        self.version = version


class ContinuousBatcher:
    """Slot-based continuous-batching decode over one serving channel.

    ``model_ops`` supplies the architecture (its module); ``(version,
    model)`` is the channel's installed pair at construction (``model`` a
    module from ``TorchModelOps.bind``). One worker thread owns the decode
    loop: each iteration admits queued prompts into free slots (prefill),
    then advances every active slot one token in one batched step.
    Per-request ``max_new_tokens`` retire sequences independently.
    """

    def __init__(self, model_ops, version: int, model: Any,
                 slots: int = 4, max_len: int = 512,
                 channel: str = "stable"):
        self.channel = channel
        self.slots = max(1, int(slots))
        self.max_len = int(max_len)
        module = model_ops.module
        if not all(hasattr(module, a)
                   for a in ("heads", "dim", "depth", "kv_heads")):
            raise TypeError(
                "serving decode needs a KV-cache causal-LM module "
                "(the models.zoo LlamaLite family); "
                f"{type(module).__name__} has no cache geometry")
        self._decoder = SlotDecoder(module, self.slots, self.max_len,
                                    device=model_ops.device)
        self._pair = (int(version), model)
        self._pending_pair: Optional[tuple] = None
        self._queue: deque = deque()
        self._cv = threading.Condition(threading.Lock())
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self._closed = False
        self.steps = 0                   # decode-step counter
        self.tokens_emitted = 0
        self._tps_ewma = 0.0
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=f"decode-{channel}")
        self._worker.start()

    # -- request side --------------------------------------------------- #

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> "futures.Future":
        """Queue one prompt; resolves to ``(tokens, version)`` where
        ``tokens`` is the (max_new_tokens,) int32 continuation (``PAD_ID``
        after an emitted ``eos_id``) and ``version`` the registry version
        that decoded it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({int(max_new_tokens)}) exceeds the decode cache "
                f"(serving.decode.max_len={self.max_len})")
        req = _GenPending(prompt, max_new_tokens, eos_id)
        with self._cv:
            if self._closed:
                req.future.set_exception(RuntimeError("decode engine "
                                                      "closed"))
                return req.future
            self._queue.append(req)
            _M_DECODE_QUEUE.set(len(self._queue), channel=self.channel)
            self._cv.notify()
        return req.future

    def swap(self, version: int, model: Any) -> None:
        """Zero-drop hot-swap: the in-flight batch finishes on the pair
        it captured; queued prompts decode on the new one."""
        with self._cv:
            self._pending_pair = (int(version), model)
            self._cv.notify()

    # -- decode loop ---------------------------------------------------- #

    def _admit_locked(self) -> List[_GenPending]:
        """Pop admittable requests (called under the lock); prefill runs
        OUTSIDE the lock so submit() never blocks behind device work."""
        admitted = []
        if self._pending_pair is not None:
            return admitted              # draining toward the swap
        free = sum(1 for s in self._slots if s is None)
        while free and self._queue:
            admitted.append(self._queue.popleft())
            free -= 1
        _M_DECODE_QUEUE.set(len(self._queue), channel=self.channel)
        return admitted

    def _retire(self, idx: int, slot: _Slot) -> None:
        self._slots[idx] = None
        req = slot.req
        out = np.full((req.max_new,), PAD_ID, np.int32)
        out[: len(slot.tokens)] = slot.tokens
        if req.trace_ctx is not None:
            # enqueue to retire, parented on the submitter's
            # serving.generate span: the queue wait and the slot's occupancy
            _ttrace.event(
                "decode.slot", time.perf_counter() - req.enqueued_at,
                parent=req.trace_ctx,
                attrs={"channel": self.channel,
                       "admitted_step": req.admitted_step,
                       "retired_step": self.steps,
                       "tokens": len(slot.tokens)})
        if not req.future.done():
            req.future.set_result((out, slot.version))

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._queue
                       and all(s is None for s in self._slots)
                       and self._pending_pair is None
                       and not self._closed):
                    self._cv.wait(0.1)
                if (self._closed and not self._queue
                        and all(s is None for s in self._slots)):
                    return
                if (self._pending_pair is not None
                        and all(s is None for s in self._slots)):
                    # drained: install the new pair, resume admission
                    self._pair = self._pending_pair
                    self._pending_pair = None
                admitted = self._admit_locked()
            try:
                self._tick(admitted)
            except Exception as exc:  # noqa: BLE001 - worker must survive
                # one poisoned tick fails ITS requests only: a dead worker
                # would hang every later Generate on this channel
                logger.exception("decode tick failed")
                with self._cv:
                    for req in admitted:
                        if not req.future.done():
                            req.future.set_exception(exc)
                    for idx, slot in enumerate(self._slots):
                        if slot is not None:
                            if not slot.req.future.done():
                                slot.req.future.set_exception(exc)
                            self._slots[idx] = None

    def _tick(self, admitted: List[_GenPending]) -> None:
        version, model = self._pair
        # 1. prefill admissions between decode steps
        for req in admitted:
            idx = next(i for i, s in enumerate(self._slots) if s is None)
            first = self._decoder.prefill(model, idx, req.prompt)
            req.admitted_step = self.steps
            slot = _Slot(req, first, int(req.prompt.size), version)
            self.tokens_emitted += 1
            _M_DECODE_TOKENS.inc(channel=self.channel)
            if ((req.eos_id is not None and first == req.eos_id)
                    or req.max_new == 1):
                self._retire(idx, slot)
            else:
                self._slots[idx] = slot
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None]
        _M_DECODE_SLOTS.set(len(active), channel=self.channel)
        if not active:
            return
        # 2. one decode step for the whole in-flight batch (free rows carry
        #    zeros and are never read)
        t0 = time.perf_counter()
        toks = np.zeros((self.slots,), np.int32)
        poss = np.zeros((self.slots,), np.int32)
        for i, s in active:
            toks[i], poss[i] = s.last_tok, s.position
        nxt = self._decoder.step(model, toks, poss)
        self.steps += 1
        step_s = max(time.perf_counter() - t0, 1e-9)
        self._tps_ewma = (0.8 * self._tps_ewma
                          + 0.2 * (len(active) / step_s))
        _M_DECODE_TPS.set(round(self._tps_ewma, 3), channel=self.channel)
        for i, s in active:
            tok = int(nxt[i])
            s.tokens.append(tok)
            s.last_tok = tok
            s.position += 1
            self.tokens_emitted += 1
            _M_DECODE_TOKENS.inc(channel=self.channel)
            done = (len(s.tokens) >= s.req.max_new
                    or (s.req.eos_id is not None and tok == s.req.eos_id))
            if done:
                self._retire(i, s)

    # -- status --------------------------------------------------------- #

    def depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def active(self) -> int:
        with self._cv:
            return sum(1 for s in self._slots if s is not None)

    def describe(self) -> Dict[str, Any]:
        with self._cv:
            return {"slots": self.slots, "max_len": self.max_len,
                    "queued": len(self._queue),
                    "active": sum(1 for s in self._slots if s is not None),
                    "steps": self.steps,
                    "tokens_emitted": self.tokens_emitted,
                    "tokens_per_sec": round(self._tps_ewma, 3),
                    "version": self._pair[0],
                    "swap_pending": self._pending_pair is not None}

    def close(self) -> None:
        """Drain: queued + in-flight generations still finish, then the
        worker exits."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=60.0)
        _M_DECODE_QUEUE.remove(channel=self.channel)
        _M_DECODE_SLOTS.remove(channel=self.channel)
        _M_DECODE_TPS.remove(channel=self.channel)
