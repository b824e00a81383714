"""LM clients on the client mesh: `examples/lm_dpfl_torch.py`'s setting
(reduced qwen3 clients, 6 of them, `DPFLConfig(rounds=4, tau_init=2,
tau_train=2, budget=3)`) with the engine sharded over client meshes
(1, 2) and (1, 3), gloo ranks on the CPU (`torch_mesh_workers.
lm_client_runs`, one launch a mesh).

Each sharded run is bit for bit the single-device run whose forward
and backward take the shard's client count (`FLEngine._client_chunk`),
and selects the plain single-device run's Omega, graphs and downloads.
Against `repro`'s `examples/lm_dpfl.py`: tests/test_torch_lm_dpfl.py's
tolerances (Omega and every graph equal, test and validation
accuracies equal, the best models' validation losses within 1e-5).
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import contextlib  # noqa: E402
import io  # noqa: E402
import runpy  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402
from repro_torch.core import DPFLConfig, run_dpfl  # noqa: E402
from repro_torch.launch.mesh import run_on_client_mesh  # noqa: E402

ex = workers.lm_example()
MESHES = {"1x2": 2, "1x3": 3}


class _Runs:
    def __init__(self, tmp):
        self.tmp, self.meshes, self.single, self.repro = tmp, {}, {}, None

    def mesh(self, name):
        if name not in self.meshes:
            store = self.tmp.mktemp(f"store-{name}") / "store"
            self.meshes[name] = run_on_client_mesh(
                workers.lm_client_runs, MESHES[name], device="cpu",
                init_file=str(store), timeout=600)
        return self.meshes[name]

    def single_device(self, chunk=None):
        """The port's single-device run (``chunk``: `_client_chunk`) and
        its engine."""
        if chunk not in self.single:
            engine, _ = ex.lm_engine(ex.example_config(), ex.CLIENTS,
                                     common.CPU)
            engine._client_chunk = chunk
            self.single[chunk] = (workers.result_dict(run_dpfl(
                engine, DPFLConfig(**ex.RUN))), engine)
        return self.single[chunk]

    def repro_run(self):
        """(`repro`'s engine, its result) of examples/lm_dpfl.py."""
        if self.repro is None:
            import repro.core

            kept, inner = {}, repro.core.run_dpfl

            def keeping(engine, cfg):
                kept["engine"], kept["res"] = engine, inner(engine, cfg)
                return kept["res"]

            repro.core.run_dpfl = keeping
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    runpy.run_path(str(common.ROOT / "examples" /
                                       "lm_dpfl.py"), run_name="__main__")
            finally:
                repro.core.run_dpfl = inner
            self.repro = kept["engine"], kept["res"]
        return self.repro


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _Runs(tmp_path_factory)


KEYS = ("best_flat", "test_acc", "omega", "graph_history",
        "val_acc_history")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_lm_clients_on_a_mesh_equal_the_chunked_twin(runs, mesh):
    got = runs.mesh(mesh)
    n_loc = ex.CLIENTS // MESHES[mesh]
    assert got["rows"] == [[r * n_loc, (r + 1) * n_loc]
                           for r in range(MESHES[mesh])]
    want, _ = runs.single_device(chunk=n_loc)
    for k in KEYS:
        np.testing.assert_array_equal(got["res"][k], want[k], err_msg=k)
    for k in ("comm_downloads", "comm_preprocess", "comm_bytes"):
        assert got["res"][k] == want[k], k
    # the greedy's peers and the results crossed ranks by all-gathers
    assert got["counts"]["all_gather"][0] > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_lm_clients_on_a_mesh_select_the_single_device_graphs(runs, mesh):
    got = runs.mesh(mesh)["res"]
    want, _ = runs.single_device()
    for k in ("omega", "graph_history", "test_acc", "val_acc_history"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("comm_downloads", "comm_preprocess", "comm_bytes"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_lm_clients_on_a_mesh_match_repro(runs, mesh):
    got = runs.mesh(mesh)["res"]
    je, jres = runs.repro_run()
    np.testing.assert_array_equal(np.asarray(jres.omega), got["omega"])
    np.testing.assert_array_equal(np.asarray(jres.graph_history),
                                  got["graph_history"])
    assert got["comm_downloads"] == jres.comm_downloads
    assert got["comm_bytes"] == jres.comm_bytes
    np.testing.assert_array_equal(np.asarray(jres.test_acc),
                                  got["test_acc"])
    np.testing.assert_array_equal(np.asarray(jres.val_acc_history),
                                  got["val_acc_history"])
    # the best models' validation losses, each package evaluating its own
    _, te = runs.single_device()
    _, jl = je.eval_val(je.unflatten(jnp.asarray(jres.best_flat)))
    _, tl = te.eval_val(te.unflatten(torch.from_numpy(got["best_flat"])))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0,
                               atol=1e-5)
