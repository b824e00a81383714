"""Run the JAX reference (`repro.core.dpfl.run_dpfl`) on the configuration
that ``chip_smoke.py`` drives through the port, on the CPU, and print its
accuracies and comm counters as one JSON line.

``chip_smoke.py``'s learning check takes its threshold from this run:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_reference_smoke.py

The configuration (PaperCNN at its published width, 32 clients, 3
rounds) is the one in ``chip_smoke.py``'s ``SMOKE_*`` constants; keep the
two in step.
"""
from __future__ import annotations

import json
import resource
import time

# jax 0.9's PrimitiveBatchersProxy has no __contains__, which
# repro.sharding.compat needs at import; the test suite carries the same
# patch (tests/test_torch_common.py)
from jax.interpreters import batching

if not hasattr(type(batching.primitive_batchers), "__contains__"):
    type(batching.primitive_batchers).__contains__ = \
        lambda self, p: p in batching.fancy_primitive_batchers

import numpy as np  # noqa: E402

from repro.configs.paper_cnn import CNNConfig  # noqa: E402
from repro.core import DPFLConfig, run_dpfl  # noqa: E402
from repro.data import make_federated_classification  # noqa: E402
from repro.fl.engine import FLEngine  # noqa: E402
from repro.models.classifier import PaperCNN  # noqa: E402

DATA = dict(seed=0, n_clients=32, n_clusters=4, partition="pathological",
            classes_per_client=3, image_shape=(32, 32, 3), n_train=128,
            n_val=32, n_test=64, noise=2.0, assign_level="cluster")
RUN = dict(rounds=3, tau_init=2, tau_train=1, budget=4, seed=0)


def main():
    t0 = time.perf_counter()
    data = make_federated_classification(**DATA)
    engine = FLEngine(PaperCNN(CNNConfig()), data, lr=0.01, batch_size=16)
    res = run_dpfl(engine, DPFLConfig(**RUN))
    print(json.dumps({
        "mean_test_acc": float(np.mean(res.test_acc)),
        "mean_val_acc_per_round": [float(np.mean(v))
                                   for v in res.val_acc_history],
        "comm_downloads": res.comm_downloads,
        "comm_preprocess": res.comm_preprocess,
        "n_params": engine.n_params,
        "seconds": time.perf_counter() - t0,
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 1024,
    }))


if __name__ == "__main__":
    main()
