"""Optimizers with optax's update rules, written out on tensors, and FedProx.

The JAX package builds its optimizers with optax
(metisfl_tpu/models/optimizers.py). ``torch.optim`` differs from optax in
places that change the trajectory (RMSprop's eps outside the sqrt,
Adagrad's zero initial accumulator, dampened momentum), so the port writes
optax's rules out itself:

- ``sgd``: momentum trace ``t ← g + μ·t`` (no dampening), Nesterov
  ``g + μ·t``; update ``−lr·t``;
- ``adam``: bias-corrected moments, ``m̂ / (sqrt(v̂ + eps_root) + eps)``
  with eps outside the sqrt and ``eps_root = 0``;
- ``adamw``: ``−lr·(adam + wd·p)``, weight decay 1e-4 by default;
- ``rmsprop``: ``ν ← 0.9·ν + 0.1·g²`` from ν = 0, ``g·rsqrt(ν + 1e-8)``
  with eps inside the sqrt, then ``−lr`` and the momentum trace;
- ``adagrad``: accumulator from 0.1, ``where(t > 0, rsqrt(t + 1e-7), 0)·g``.

A transformation works on lists of tensors in a fixed order (the trainable
parameters): ``init(params) → state`` and ``update(grads, state, params)
→ (updates, state)``; :func:`apply_updates` adds the updates in place. The
state's moment buffers are updated in place, which saves a params-sized
copy per moment on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch


class GradientTransformation(NamedTuple):
    """optax's pair of pure functions, over lists of tensors."""

    init: Callable[[Sequence[torch.Tensor]], Any]
    update: Callable[..., Any]


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: None,
                                  lambda g, state, params=None: (g, state))


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """Apply ``txs`` in order, each to the previous one's updates."""

    def init(params):
        return [tx.init(params) for tx in txs]

    def update(grads, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params)
            new_state.append(s)
        return grads, new_state

    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax.trace: ``t ← g + decay·t``; Nesterov returns ``g + decay·t``.
    A zero decay is the identity (``g + 0·t == g``) and keeps no buffer."""
    if decay == 0.0:
        return identity()

    def update(grads, state, params=None):
        out = []
        for g, t in zip(grads, state):
            t.copy_(g + decay * t)
            out.append(g + decay * t if nesterov else t.clone())
        return out, state

    return GradientTransformation(_zeros, update)


def scale_by_learning_rate(lr: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: None,
        lambda grads, state, params=None: ([-lr * g for g in grads], state))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adam with its default ``eps_root = 0``."""

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params=None):
        state["count"] += 1
        c1 = 1.0 - b1 ** state["count"]
        c2 = 1.0 - b2 ** state["count"]
        out = []
        for g, m, v in zip(grads, state["mu"], state["nu"]):
            m.copy_((1.0 - b1) * g + b1 * m)
            v.copy_((1.0 - b2) * (g * g) + b2 * v)
            out.append((m / c1) / (torch.sqrt(v / c2) + eps))
        return out, state

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(grads, state, params=None):
        return [g + weight_decay * p for g, p in zip(grads, params)], state

    return GradientTransformation(lambda params: None, update)


def scale_by_rms(decay: float = 0.9) -> GradientTransformation:
    """optax.scale_by_rms as optax.rmsprop uses it: ν from 0, eps 1e-8
    inside the sqrt."""

    def update(grads, state, params=None):
        out = []
        for g, nu in zip(grads, state):
            nu.copy_((1.0 - decay) * (g * g) + decay * nu)
            out.append(torch.rsqrt(nu + 1e-8) * g)
        return out, state

    return GradientTransformation(_zeros, update)


def scale_by_rss() -> GradientTransformation:
    """optax.scale_by_rss as optax.adagrad uses it: the accumulator starts
    at 0.1, eps 1e-7."""

    def init(params):
        return [torch.full_like(p, 0.1) for p in params]

    def update(grads, state, params=None):
        out = []
        for g, t in zip(grads, state):
            t.copy_(g * g + t)
            inv = torch.where(t > 0, torch.rsqrt(t + 1e-7),
                              torch.zeros_like(t))
            out.append(inv * g)
        return out, state

    return GradientTransformation(init, update)


def fedprox(mu: float, global_params: Sequence[torch.Tensor]
            ) -> GradientTransformation:
    """Proximal-term gradient transform ``g ← g + μ·(w − w_global)``: pulls
    weights toward the community model shipped at round start."""

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("fedprox requires params to be passed to update")
        return [g + mu * (p - p0) for g, p, p0 in
                zip(grads, params, global_params)], state

    return GradientTransformation(lambda params: None, update)


_OPTIMIZERS: Dict[str, Callable[[float, Dict[str, Any]],
                                GradientTransformation]] = {
    "sgd": lambda lr, kw: chain(
        trace(kw.get("momentum", 0.0), kw.get("nesterov", False)),
        scale_by_learning_rate(lr)),
    "adam": lambda lr, kw: chain(
        scale_by_adam(kw.get("b1", 0.9), kw.get("b2", 0.999),
                      kw.get("eps", 1e-8)),
        scale_by_learning_rate(lr)),
    "adamw": lambda lr, kw: chain(
        scale_by_adam(kw.get("b1", 0.9), kw.get("b2", 0.999)),
        add_decayed_weights(kw.get("weight_decay", 1e-4)),
        scale_by_learning_rate(lr)),
    "rmsprop": lambda lr, kw: chain(
        scale_by_rms(kw.get("decay", 0.9)), scale_by_learning_rate(lr),
        trace(kw.get("momentum", 0.0))),
    "adagrad": lambda lr, kw: chain(scale_by_rss(),
                                    scale_by_learning_rate(lr)),
}


def make_optimizer(name: str, learning_rate: float,
                   optimizer_kwargs: Optional[Dict[str, Any]] = None,
                   proximal_mu: float = 0.0,
                   global_params: Optional[Sequence[torch.Tensor]] = None
                   ) -> GradientTransformation:
    """The JAX package's ``make_optimizer``: a named optimizer with its
    keyword arguments, chained after FedProx when ``proximal_mu > 0``."""
    kw = optimizer_kwargs or {}
    try:
        base = _OPTIMIZERS[name.lower()](learning_rate, kw)
    except KeyError:
        raise ValueError(
            f"unknown optimizer {name!r}; have {sorted(_OPTIMIZERS)}"
        ) from None
    if proximal_mu > 0.0:
        if global_params is None:
            raise ValueError("fedprox (proximal_mu > 0) needs global_params")
        return chain(fedprox(proximal_mu, global_params), base)
    return base


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> None:
    """``p ← p + u`` in place, in each parameter's dtype."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
