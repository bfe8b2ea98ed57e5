"""Byzantine-robust federation on metisfl_tpu_torch, the PyTorch port.

The port's counterpart of the host path of ``examples/robust_federation.py``:
the same 6-learner federation, where learner 0 trains on exploded features
and shuffled labels and so ships garbage at a huge magnitude, runs under
fedavg, median and krum through the port's ``InProcessFederation``, and
each rule prints its community model's final test accuracy. A mean follows
the poisoned learner; the median and Krum do not. The learners train on
``--device`` (cuda by default) and the robust rules combine there too;
``--device cpu`` runs without a GPU.

    python examples/torch_robust_federation.py --rounds 3

``--pod`` (the device-resident rules over a mesh) is not ported yet.
The last line of the output is one JSON object: the accuracy by rule.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("torch byzantine-robust federation")
    parser.add_argument("--learners", type=int, default=6)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--rules", default="fedavg,median,krum")
    parser.add_argument("--device", default="cuda",
                        help="where the learners train and the robust "
                             "rules combine (cuda or cpu)")
    parser.add_argument("--pod", action="store_true",
                        help="not ported (ROADMAP.md Queue 1 item 9)")
    args = parser.parse_args(argv)

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        TerminationConfig,
    )
    from metisfl_tpu_torch.config.federation import not_ported
    from metisfl_tpu_torch.driver import InProcessFederation
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import MLP

    if args.pod:
        raise not_ported("the device-resident robust rules (--pod)", "9")

    rng = np.random.default_rng(0)
    d, classes = 12, 4
    w_true = rng.standard_normal((d, classes)).astype(np.float32)

    def make_xy(n, seed):
        r = np.random.default_rng(seed)
        x = r.standard_normal((n, d)).astype(np.float32)
        return x, np.argmax(x @ w_true, axis=-1).astype(np.int32)

    test_ds = ArrayDataset(*make_xy(512, 999))
    accuracy = {}
    for rule in (r.strip() for r in args.rules.split(",")):
        config = FederationConfig(
            aggregation=AggregationConfig(rule=rule, scaler="participants"),
            train=TrainParams(batch_size=16, local_steps=6,
                              learning_rate=0.2),
            eval=EvalConfig(every_n_rounds=0),
            termination=TerminationConfig(federation_rounds=args.rounds))
        fed = InProcessFederation(config, device=args.device)
        template = None
        for i in range(args.learners):
            x, y = make_xy(96, seed=i)
            if i == 0:
                # the poisoned shard: features x50, labels shuffled
                x = x * 50.0
                y = np.random.default_rng(i).permutation(y)
            ops = TorchModelOps(MLP(d, (16,), classes), rng_seed=0,
                                variables=template, device=args.device)
            template = template or ops.get_variables()
            fed.add_learner(ops, ArrayDataset(x, y, seed=i),
                            test_dataset=test_ds)
        fed.seed_model(template)
        try:
            fed.start()
            ok = fed.wait_for_rounds(args.rounds, timeout_s=300)
            honest = fed.learners[1]
            merged = honest._load_model(
                fed.controller.community_model_bytes())
            acc = honest.model_ops.evaluate(
                test_ds, 128, ["accuracy"], variables=merged)["accuracy"]
        finally:
            fed.shutdown()
        accuracy[rule] = float(acc)
        print(f"[host] rule={rule:<12} rounds_ok={ok} "
              f"community test accuracy: {acc:.3f}", flush=True)
    print(json.dumps({"rounds": args.rounds, "accuracy": accuracy}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
