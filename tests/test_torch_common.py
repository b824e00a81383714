"""Shared setup of the PyTorch-port tests, and the port's own checks.

Every other ``tests/test_torch_*.py`` imports this module before `repro`:

* jax 0.9's ``PrimitiveBatchersProxy`` has no ``__contains__``, and
  `repro.sharding.compat` evaluates ``prim in primitive_batchers`` at
  import, which raises ``TypeError`` and blocks every module that reaches
  `repro.models` or `repro.sharding`. The patch below gives the proxy
  class that method at runtime (membership in
  ``fancy_primitive_batchers``); it changes no file of `repro`.
* torch is held to 2 threads, since the suite runs several workers.

Its own tests hold the port to its import rules: nothing under
``src/repro_torch/``, not ``chip_smoke.py`` and not the port's drivers
(``examples/*_torch.py``) imports ``jax`` or `repro`; importing the port
leaves ``jax`` out of ``sys.modules``; the port's copies of `repro`'s
numpy modules (the synthetic data generator, the availability schedules,
the adversary's host code, the LM token corpus) equal the originals;
every DPFL setting of `repro` is ported; no file of the port names
ROADMAP item 14d (split into 14d-1 to 14d-5, all ported).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

from jax.interpreters import batching

if not hasattr(type(batching.primitive_batchers), "__contains__"):
    type(batching.primitive_batchers).__contains__ = \
        lambda self, p: p in batching.fancy_primitive_batchers

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"

# the small MLP setting of tests/test_round_engine.py (6 clients)
SMALL_DATA = dict(seed=5, n_clients=6, n_clusters=2,
                  partition="pathological", classes_per_client=3,
                  feature_dim=8, n_train=16, n_val=16, n_test=16, noise=2.0,
                  assign_level="cluster")
SMALL_MLP = (8, 16, 10)
SMALL_ENGINE = dict(lr=0.05, batch_size=8)
# a narrow PaperCNN on 16x16x3 images (4 clients)
NARROW_CNN = dict(image_size=16, c1=4, c2=8, fc1=16, fc2=16)
CNN_DATA = dict(seed=1, n_clients=4, n_clusters=2, partition="pathological",
                classes_per_client=3, image_shape=(16, 16, 3), n_train=16,
                n_val=8, n_test=8, noise=2.0, assign_level="cluster")
CNN_ENGINE = dict(lr=0.05, batch_size=8)


def np_tree(tree):
    """A JAX pytree of arrays -> dict of numpy arrays."""
    return {k: np.asarray(v) for k, v in tree.items()}


def key_to_torch(jkey):
    """A raw JAX key (uint32 pair, any batch shape) -> the port's int64."""
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def make_engines(kind: str):
    """(repro FLEngine, port FLEngine on the CPU) on the same data:
    ``kind`` is "mlp" (the small setting) or "cnn" (the narrow PaperCNN)."""
    from repro.configs.paper_cnn import CNNConfig as JCNNConfig
    from repro.data import make_federated_classification as jmake
    from repro.fl.engine import FLEngine as JEngine
    from repro.models.classifier import MLP as JMLP
    from repro.models.classifier import PaperCNN as JCNN

    from repro_torch.configs.paper_cnn import CNNConfig
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine
    from repro_torch.models.classifier import MLP, PaperCNN

    if kind == "mlp":
        jm, tm, data_kw, eng_kw = (JMLP(*SMALL_MLP), MLP(*SMALL_MLP),
                                   SMALL_DATA, SMALL_ENGINE)
    else:
        jm = JCNN(JCNNConfig(**NARROW_CNN))
        tm = PaperCNN(CNNConfig(**NARROW_CNN))
        data_kw, eng_kw = CNN_DATA, CNN_ENGINE
    je = JEngine(jm, jmake(**data_kw), **eng_kw)
    te = FLEngine(tm, make_federated_classification(**data_kw), **eng_kw,
                  device=CPU)
    return je, te


def carry_init(je, te):
    """Make the port engine start from `repro`'s init: its
    ``init_clients(key)`` returns the JAX engine's init for the same key,
    carried across with `repro_torch.interop` (the port's own normal
    sampler may differ from jax's by a few ulps)."""
    from repro_torch.interop import params_from_jax

    def init_clients(key):
        jkey = np.asarray(key.cpu().numpy(), np.uint32)
        return params_from_jax(np_tree(je.init_clients(jkey)),
                               device=te.device)

    te.init_clients = init_clients


# ------------------------------------------------------ the port's checks

_PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in _PORT_FILES])
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys\n"
            "import repro_torch.core.dpfl\n"
            "import repro_torch.kernels.ops\n"
            "import repro_torch.interop\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not any(m == 'repro' or m.startswith('repro.')\n"
            "               for m in sys.modules), 'repro was imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("image_shape", [None, (8, 8, 3)])
def test_port_data_equals_repro_data(seed, image_shape):
    from repro.data import make_federated_classification as jmake

    from repro_torch.data import make_federated_classification

    kw = dict(seed=seed, n_clients=5, n_clusters=2, n_train=12, n_val=6,
              n_test=6, image_shape=image_shape, feature_dim=7)
    for extra in ({}, dict(partition="pathological", classes_per_client=3,
                           assign_level="cluster", p_mode="size")):
        a = jmake(**kw, **extra)
        b = make_federated_classification(**kw, **extra)
        for name in ("train_x", "train_y", "val_x", "val_y", "test_x",
                     "test_y", "p", "cluster"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        assert a.n_classes == b.n_classes


@pytest.mark.parametrize("seed,n_clients,vocab,seq_len,n_seqs,n_clusters", [
    (0, 1, 64, 16, 8, 2), (3, 3, 97, 9, 5, 2), (1, 4, 40, 12, 6, 3)])
def test_port_lm_token_data_equals_repro(seed, n_clients, vocab, seq_len,
                                         n_seqs, n_clusters):
    """`make_lm_token_data` is `repro`'s code, docstring aside, and draws
    the same corpora and clusters."""
    from repro.data import synthetic as jsynthetic

    from repro_torch.data import make_lm_token_data

    rel = Path("data") / "synthetic.py"
    assert _defs(ROOT / "src" / "repro_torch" / rel)["make_lm_token_data"] \
        == _defs(ROOT / "src" / "repro" / rel)["make_lm_token_data"]
    kw = dict(seed=seed, n_clients=n_clients, vocab=vocab, seq_len=seq_len,
              n_seqs=n_seqs, n_clusters=n_clusters)
    (a, ca), (b, cb) = jsynthetic.make_lm_token_data(**kw), \
        make_lm_token_data(**kw)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)


def test_no_raise_names_the_split_item_14d():
    """ROADMAP Queue 1 item 14d was split into 14d-1 to 14d-5 (14d-2 the
    SSM and hybrid training, 14d-3 bf16 training, 14d-4 the families
    not ported, 14d-5 the dry run, with the gradient of the model mesh's
    paths), and every one of them is ported: no file of the port names
    item 14d or any of its parts, in a raise or anywhere else."""
    import re

    pattern = re.compile(r"\b14d\b")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert not pattern.search(text), f"{path} names item 14d"


def test_port_availability_is_a_copy_of_repro():
    """`repro_torch.data.availability` is `repro.data.availability`
    verbatim (numpy only; tests/test_torch_participation.py holds the
    schedules equal too)."""
    rel = Path("data") / "availability.py"
    assert (ROOT / "src" / "repro_torch" / rel).read_text() == \
        (ROOT / "src" / "repro" / rel).read_text()


def test_port_shapes_is_a_copy_of_repro():
    """`repro_torch.configs.shapes` (the dry run's four input shapes) is
    `repro.configs.shapes` verbatim."""
    rel = Path("configs") / "shapes.py"
    assert (ROOT / "src" / "repro_torch" / rel).read_text() == \
        (ROOT / "src" / "repro" / rel).read_text()


def _code(node):
    """The AST of a def or class without its docstrings."""
    node = ast.parse(ast.unparse(node)).body[0]
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            sub.body = body[1:] or [ast.Pass()]
    return ast.dump(node)


def _defs(path: Path):
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = _code(node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node.value)
    return out


def test_port_adversary_host_code_is_a_copy_of_repro():
    """The numpy host half of `repro_torch.fl.adversary` (the config,
    the malicious set, the schedules, the derangement, the segregation
    metrics) is `repro.fl.adversary`'s code, docstrings aside."""
    rel = Path("fl") / "adversary.py"
    ours = _defs(ROOT / "src" / "repro_torch" / rel)
    theirs = _defs(ROOT / "src" / "repro" / rel)
    for name in ("ATTACKS", "AdversaryConfig", "n_malicious",
                 "malicious_mask", "attack_schedule", "label_permutation",
                 "edge_rates", "segregation_history"):
        assert ours[name] == theirs[name], name


def test_every_dpfl_setting_is_ported():
    """`_NOT_PORTED` is empty, and no raise under ``src/repro_torch/``
    names ROADMAP Queue 1 items 8 or 10 (participation, adversaries and
    robust mixing), which are ported."""
    import re

    from repro_torch.core import dpfl

    assert dpfl._NOT_PORTED == ()
    pattern = re.compile(r"item (8|10)\b")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Raise):
                assert not pattern.search(ast.unparse(node)), \
                    f"{path}:{node.lineno} names a ported item"


def test_jax_patch_lets_repro_import():
    """The proxy patch above is what lets the graph_mix reference load."""
    import repro.core.dpfl  # noqa: F401
    import repro.kernels.graph_mix  # noqa: F401
    assert jax.__version__
