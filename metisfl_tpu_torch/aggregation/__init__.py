"""Aggregation rules: the JAX package's registry.

- :class:`FedAvg`: the weighted average, folded block by block;
- :class:`Scaffold`: FedAvg's fold, with the control variates around it
  (the learner and the controller);
- :class:`FedStride`, :class:`FedRec`: the reference's rolling averages;
- :class:`FedNova`: normalized averaging for uneven local step counts;
- :class:`ServerOpt`: FedAvgM / FedAdam / FedYogi server optimizers;
- :class:`CoordinateMedian`, :class:`TrimmedMean`, :class:`Krum`: the
  byzantine-robust rules, which run on a device (``DEVICE_RULES``);
- :class:`SecureAgg`: the weighted average over encrypted or masked
  payloads (``secure_agg``; the controller builds it over the secure
  backend when ``secure.enabled``).
"""

import functools

from metisfl_tpu_torch.aggregation.fedavg import FedAvg, Scaffold
from metisfl_tpu_torch.aggregation.fednova import FedNova
from metisfl_tpu_torch.aggregation.robust import (
    CoordinateMedian,
    Krum,
    TrimmedMean,
)
from metisfl_tpu_torch.aggregation.rolling import FedRec, FedStride
from metisfl_tpu_torch.aggregation.secure import SecureAgg
from metisfl_tpu_torch.aggregation.serveropt import ServerOpt

AGGREGATION_RULES = {
    "fedavg": FedAvg,
    "scaffold": Scaffold,
    "fedstride": FedStride,
    "fedrec": FedRec,
    "fednova": FedNova,
    "fedavgm": functools.partial(ServerOpt, "fedavgm"),
    "fedadam": functools.partial(ServerOpt, "fedadam"),
    "fedyogi": functools.partial(ServerOpt, "fedyogi"),
    "median": CoordinateMedian,
    "trimmed_mean": TrimmedMean,
    "krum": Krum,
    "multikrum": functools.partial(Krum, name="multikrum"),
    "secure_agg": SecureAgg,
}

# the rules that combine on a device (their ``device`` argument)
DEVICE_RULES = ("median", "trimmed_mean", "krum", "multikrum")


def make_aggregation_rule(name: str, **kwargs):
    try:
        cls = AGGREGATION_RULES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown aggregation rule {name!r}; have "
                         f"{sorted(AGGREGATION_RULES)}") from None
    return cls(**kwargs)


__all__ = [
    "AGGREGATION_RULES",
    "DEVICE_RULES",
    "CoordinateMedian",
    "FedAvg",
    "FedNova",
    "FedRec",
    "FedStride",
    "Krum",
    "Scaffold",
    "SecureAgg",
    "ServerOpt",
    "TrimmedMean",
    "make_aggregation_rule",
]
