"""FashionMNIST federation on metisfl_tpu_torch, the PyTorch port.

The port's counterpart of ``examples/fashionmnist.py``: partition the data
across N learners, boot a controller and N learner processes on localhost
through ``DriverSession``, run R synchronous FedAvg rounds of a
FashionMNIST CNN, print the community model's test accuracy by round and
write ``experiment.json``. It uses the port alone (no JAX).

It runs offline: the images are a structured synthetic stand-in with
Fashion-MNIST's shapes (class templates plus Gaussian noise, as the JAX
examples make theirs). Every learner trains on ``--device`` (cuda by
default; ``--device cpu`` runs without a GPU).

    python examples/torch_fashionmnist.py --learners 3 --rounds 3

The last line of its output is one JSON object: the rounds completed, the
mean community test accuracy by round, and every process's exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def synthetic_fashion_mnist(n: int, noise: float, seed: int = 7):
    """``n`` 28x28x1 float32 images of 10 class templates plus Gaussian
    noise, and their int32 labels."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((10, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = templates[y] + noise * rng.standard_normal(
        (n, 28, 28, 1)).astype(np.float32)
    return x.astype(np.float32), y


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("torch fashionmnist federation")
    parser.add_argument("--learners", type=int, default=3)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--device", default="cuda",
                        help="where every learner trains (cuda or cpu)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--examples-per-learner", type=int, default=600)
    parser.add_argument("--test-examples", type=int, default=600)
    parser.add_argument("--noise", type=float, default=0.35,
                        help="pixel noise over the class templates")
    parser.add_argument("--workdir", default="")
    args = parser.parse_args(argv)

    from metisfl_tpu_torch.comm import TrainParams
    from metisfl_tpu_torch.config import (
        AggregationConfig,
        EvalConfig,
        FederationConfig,
        LearnerEndpoint,
        TerminationConfig,
    )
    from metisfl_tpu_torch.driver import DriverSession
    from metisfl_tpu_torch.models import ArrayDataset, TorchModelOps
    from metisfl_tpu_torch.models.zoo import FashionMnistCNN

    n_train = args.examples_per_learner * args.learners
    x, y = synthetic_fashion_mnist(n_train + args.test_examples, args.noise)
    x_test, y_test = x[n_train:], y[n_train:]
    order = np.random.default_rng(0).permutation(n_train)
    shards = np.array_split(order, args.learners)
    print(f"partitioned {n_train} examples into "
          f"{[len(s) for s in shards]} (IID)", flush=True)

    def make_recipe(idx: np.ndarray, seed: int, device: str):
        sx, sy = x[idx], y[idx]

        def recipe():
            ops = TorchModelOps(FashionMnistCNN(), rng_seed=0, device=device)
            return (ops, ArrayDataset(sx, sy, seed=seed), None,
                    ArrayDataset(x_test, y_test))

        return recipe

    config = FederationConfig(
        controller_port=0,
        aggregation=AggregationConfig(scaler="train_dataset_size"),
        train=TrainParams(batch_size=args.batch_size, local_epochs=1.0,
                          learning_rate=0.05),
        eval=EvalConfig(batch_size=256, datasets=["test"]),
        termination=TerminationConfig(federation_rounds=args.rounds),
        learners=[LearnerEndpoint() for _ in range(args.learners)])
    template = TorchModelOps(FashionMnistCNN(), rng_seed=0,
                             device=args.device).get_variables()
    session = DriverSession(
        config, template,
        [make_recipe(s, i, args.device) for i, s in enumerate(shards)],
        workdir=args.workdir or None, device=args.device)
    stats = session.run()

    accuracy = []
    for entry in sorted(stats["community_evaluations"],
                        key=lambda e: e["global_iteration"]):
        values = [m["test"]["accuracy"]
                  for m in entry["evaluations"].values() if "test" in m]
        if values:
            accuracy.append(float(np.mean(values)))
    print(f"completed {stats['global_iteration']} rounds "
          f"({args.learners} learners on {args.device})")
    print(f"community test accuracy by round: "
          f"{[round(a, 4) for a in accuracy]}")
    print("experiment.json:",
          os.path.join(session.workdir, "experiment.json"))
    print(json.dumps({"rounds": stats["global_iteration"],
                      "accuracy": accuracy,
                      "exit_codes": session.process_exit_codes()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
