"""Standalone model-store service: ``python -m metisfl_tpu_torch.store.server``
(the port's copy of the JAX package's ``store/server.py``).

Hosts a disk-persistent, memory-cached store over gRPC for one or many
controllers; a controller reaches it with ``model_store.store: remote``
and the printed port.

    python -m metisfl_tpu_torch.store.server --port 50099 --root /data/models

It prints ``METISFL_TPU_STORE_READY port=N`` once it serves, and exits 0
on SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import tempfile

from metisfl_tpu_torch.store import make_store
from metisfl_tpu_torch.store.remote import ModelStoreServer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("metisfl_tpu_torch model-store service")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=0,
                        help="0 picks an ephemeral port (printed on start)")
    parser.add_argument("--store", default="cached_disk",
                        choices=["in_memory", "disk", "cached_disk"])
    parser.add_argument("--root",
                        default=os.path.join(tempfile.gettempdir(),
                                             "metisfl_tpu_store"),
                        help="blob directory (disk-backed stores)")
    parser.add_argument("--lineage-length", type=int, default=2,
                        help="models retained per learner (2 serves every "
                             "aggregation rule incl. FedRec)")
    parser.add_argument("--cache-mb", type=int, default=256)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    kwargs = {"lineage_length": args.lineage_length}
    if args.store in ("disk", "cached_disk"):
        kwargs["root"] = args.root
    if args.store == "cached_disk":
        kwargs["cache_bytes"] = args.cache_mb << 20
    server = ModelStoreServer(make_store(args.store, **kwargs),
                              host=args.host, port=args.port)
    port = server.start()
    print(f"METISFL_TPU_STORE_READY port={port}", flush=True)

    def _stop(signum, frame):
        server.stop()
        sys.exit(0)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    server.wait()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
