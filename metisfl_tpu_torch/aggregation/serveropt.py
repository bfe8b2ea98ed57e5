"""Server-side adaptive optimization: FedAvgM / FedAdam / FedYogi.

The port's copy of the JAX package's ``aggregation/serveropt.py`` (Reddi
et al., "Adaptive Federated Optimization"). With the previous community
model ``w`` and the round's weighted average ``avg``, the pseudo-gradient
is ``g = w - avg`` and the server steps on it:

- ``fedavgm``: momentum ``m = β1·m + g``;              ``w ← w - lr·m``
- ``fedadam``: Adam moments on ``g`` (bias-corrected); ``w ← w - lr·m̂/(√v̂+τ)``
- ``fedyogi``: Adam with Yogi's sign-damped second moment.

The average is the port's :class:`FedAvg` fold (one stride block resident
at a time); the step runs once a round on the host in fp32 numpy, the JAX
package's code line for line, so the same average gives the same bits.

- integer leaves take the plain average;
- a cold start adopts the average and seeds ``w``; a seeded community
  model (:meth:`seed_community`, from the controller) is stepped from;
- :meth:`result` stages the new state, and :meth:`commit` installs it
  once the controller has installed the community model, so a retried
  round does not step twice;
- :meth:`export_state` and :meth:`restore_state` carry the committed
  moments, the step counter and the model it steps from through a
  controller checkpoint, as ModelBlobs named like the JAX package's, so
  a resumed run takes the steps of an uninterrupted one.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from metisfl_tpu_torch.aggregation.base import Pytree, host_array
from metisfl_tpu_torch.aggregation.fedavg import FedAvg
from metisfl_tpu_torch.tensor.pytree import (
    ModelBlob,
    pack_model,
    to_numpy,
    tree_leaves,
    tree_map,
    tree_paths,
    tree_unflatten,
)

_OPTS = ("fedavgm", "fedadam", "fedyogi")


def to_f32(x) -> np.ndarray:
    """A leaf as fp32 host numpy; integer leaves keep their dtype."""
    x = host_array(x)
    return x if np.issubdtype(x.dtype, np.integer) \
        else np.asarray(x, np.float32)


def unpack_f32(blob: bytes) -> Dict[str, np.ndarray]:
    """A checkpointed state blob as the flat ``{name: fp32 array}`` tree
    the rules keep (integer tensors keep their dtype)."""
    return {name: to_f32(to_numpy(t))
            for name, t in ModelBlob.from_bytes(blob).tensors}


def check_structure(state: Pytree, avg: Pytree, what: str) -> None:
    """A state tree must match the round's tree leaf for leaf (a replaced
    community model with other keys fails loudly, never misaligns)."""
    if tree_paths(state) != tree_paths(avg):
        raise ValueError(f"{what} state tree does not match the aggregated "
                         "model tree")


class ServerOpt:
    """Wraps the FedAvg fold with a server optimizer step on the result."""

    required_lineage = 1

    def __init__(self, opt: str = "fedadam", learning_rate: float = 1.0,
                 beta1: float = 0.9, beta2: float = 0.99, tau: float = 1e-3):
        if opt not in _OPTS:
            raise ValueError(f"unknown server optimizer {opt!r}; have {_OPTS}")
        self.name = opt
        self.opt = opt
        self.learning_rate = float(learning_rate)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.tau = float(tau)
        self._fold = FedAvg()
        # seed_community arrives on RPC threads while result() runs on the
        # controller's scheduling worker: one lock orders the state
        self._state_lock = threading.Lock()
        self._prev: Optional[Pytree] = None      # fp32 numpy community
        self._m: Optional[Pytree] = None
        self._v: Optional[Pytree] = None
        self._step = 0
        # (prev, m, v, step) computed by result(), installed by commit()
        self._staged: Optional[Tuple[Pytree, Pytree, Pytree, int]] = None

    # -- fold interface (the controller streams stride blocks) -------------

    def reset(self) -> None:
        """Per-round fold reset; the optimizer state survives it."""
        self._fold.reset()

    def accumulate(
        self, models: Sequence[Tuple[Sequence[Pytree], float]]
    ) -> None:
        self._fold.accumulate(models)

    def result(self) -> Pytree:
        avg = tree_map(host_array, self._fold.result())
        with self._state_lock:
            return self._apply_server_step(avg)

    def aggregate(self, models, state=None) -> Pytree:
        self.reset()
        self.accumulate(models)
        out = self.result()
        self.commit()
        self.reset()
        return out

    def commit(self) -> None:
        """Install the state the last :meth:`result` staged."""
        with self._state_lock:
            if self._staged is not None:
                self._prev, self._m, self._v, self._step = self._staged
                self._staged = None

    # -- persistence (controller checkpoint) --------------------------------

    def export_state(self) -> Dict[str, Any]:
        """The committed optimizer state: the rule, the step counter, and
        the model it steps from and the moments as ModelBlobs."""
        with self._state_lock:
            out: Dict[str, Any] = {"opt": self.opt, "step": self._step}
            if self._prev is not None:
                out["prev"] = pack_model(self._prev)
            if self._m is not None:
                out["m"] = pack_model(self._m)
                out["v"] = pack_model(self._v)
            return out

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Install an :meth:`export_state` (of this package or the JAX
        package's rule); a state of another optimizer raises."""
        if state.get("opt") not in (None, self.opt):
            raise ValueError(
                f"checkpoint server-opt state is for {state.get('opt')!r}, "
                f"this rule is {self.opt!r}")
        with self._state_lock:
            self._step = int(state.get("step", 0))
            if state.get("prev"):
                self._prev = unpack_f32(state["prev"])
            if state.get("m"):
                self._m = unpack_f32(state["m"])
                self._v = unpack_f32(state["v"])
            self._staged = None

    # -- server step -------------------------------------------------------

    def seed_community(self, community: Pytree) -> None:
        """Adopt a seeded model as the point the next step starts from."""
        with self._state_lock:
            self._prev = tree_map(to_f32, community)

    def _apply_server_step(self, avg: Pytree) -> Pytree:
        if self._prev is None:
            self._staged = (tree_map(to_f32, avg), self._m, self._v,
                            self._step)
            return avg
        check_structure(self._prev, avg, "server-optimizer")
        cur_m, cur_v = self._m, self._v
        if cur_m is None:
            cur_m = tree_map(np.zeros_like, tree_map(to_f32, avg))
            cur_v = tree_map(np.zeros_like, cur_m)
        step = self._step + 1
        lr, b1, b2, tau = (self.learning_rate, self.beta1, self.beta2,
                           self.tau)
        opt = self.opt

        def leaf(prev, a, m, v):
            if np.issubdtype(a.dtype, np.integer):
                return a, m, v  # discrete state: adopt the average
            g = prev - np.asarray(a, np.float32)
            if opt == "fedavgm":
                m = b1 * m + g
                new = prev - lr * m
            else:
                m = b1 * m + (1.0 - b1) * g
                g2 = g * g
                if opt == "fedadam":
                    v = b2 * v + (1.0 - b2) * g2
                else:  # fedyogi
                    v = v - (1.0 - b2) * g2 * np.sign(v - g2)
                m_hat = m / (1.0 - b1 ** step)
                v_hat = v / (1.0 - b2 ** step)
                new = prev - lr * m_hat / (np.sqrt(v_hat) + tau)
            return new.astype(np.float32), m, v

        out = [leaf(p, a, m, v) for p, a, m, v in zip(
            tree_leaves(self._prev), tree_leaves(avg), tree_leaves(cur_m),
            tree_leaves(cur_v))]
        new_prev = tree_unflatten(avg, [o[0] for o in out])
        self._staged = (new_prev, tree_unflatten(avg, [o[1] for o in out]),
                        tree_unflatten(avg, [o[2] for o in out]), step)
        # the community keeps each tensor's storage dtype (wire contract)
        return tree_map(lambda n, a: n.astype(a.dtype), new_prev, avg)
