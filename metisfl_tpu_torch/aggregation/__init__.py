"""Aggregation rules. The port has FedAvg; the JAX package's other rules
(FedStride, FedRec, SCAFFOLD, FedNova, the server optimizers, the robust
rules, secure aggregation) are not ported yet (ROADMAP.md Queue 1 item
3c), and ``FederationConfig`` refuses them by name."""

from metisfl_tpu_torch.aggregation.fedavg import FedAvg

AGGREGATION_RULES = {"fedavg": FedAvg}


def make_aggregation_rule(name: str, **kwargs) -> FedAvg:
    try:
        return AGGREGATION_RULES[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown aggregation rule {name!r}; have "
                         f"{sorted(AGGREGATION_RULES)}") from None


__all__ = ["FedAvg", "AGGREGATION_RULES", "make_aggregation_rule"]
