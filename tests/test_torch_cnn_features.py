"""PaperCNN's convolution stack, K7 (`repro_torch.kernels.cnn_features`)
and its route in `PaperCNN.features`, on the CPU.

* `ops.cnn_features` on CPU tensors is the grouped-convolution stack
  `PaperCNN.features` ran before K7 existed, bit for bit, and so is
  `PaperCNN.features` itself on either route.
* The route follows whether a gradient will be taken: under
  ``enable_grad`` with leaves that need one the model runs the grouped
  convolutions (gradients bit for bit the earlier code's); with grad mode
  off, or no leaf that needs a gradient, it calls `ops.cnn_features`.
* On "meta" tensors the wrapper runs its checks, allocates its output,
  records its ``work`` and launches nothing; the dry run of a PaperCNN
  round records K7's calls; the wrapper refuses what the kernel does not
  take.
* The kernel's plan (`launch_plan`) and its carve-up of shared memory,
  emulated in float64 block by block as the CUDA source indexes it
  (staging, the padded rows and planes, the tiles, the pooled maps),
  against the plain version; its padding keeps conv1's 8-byte loads free
  of bank conflicts.

The CUDA kernel itself is held to its plain version on the card by
tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""
import test_torch_common as common  # noqa: F401  (jax patch, threads)

import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import prng  # noqa: E402
from repro_torch.configs.paper_cnn import CNNConfig  # noqa: E402
from repro_torch.kernels import cnn_features as k7  # noqa: E402
from repro_torch.kernels import meta as kmeta  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import classifier  # noqa: E402
from repro_torch.models.classifier import PaperCNN  # noqa: E402

# the PaperCNN configurations the repo runs: the cell's, image 16, the
# tests' narrow one, one input channel of each width
CONFIGS = {
    "paper": dict(),
    "image16": dict(image_size=16),
    "narrow": common.NARROW_CNN,
    "paper-1ch": dict(in_channels=1),
    "narrow-1ch": dict(common.NARROW_CNN, in_channels=1),
}


def _models(cfg, G, seed=0):
    """G PaperCNNs of ``cfg`` with seeded weights (biases non-zero)."""
    model = PaperCNN(CNNConfig(**cfg))
    keys = prng.split(prng.PRNGKey(seed), G)
    params = {k: torch.stack([model.init(keys[i])[k] for i in range(G)])
              for k in model.init(keys[0])}
    gen = torch.Generator().manual_seed(seed)
    for k in ("conv1_b", "conv2_b", "fc1_b", "fc2_b"):
        params[k] = 0.1 * torch.randn(params[k].shape, generator=gen)
    return model, params


def _images(cfg, G, B, seed=0):
    c = CNNConfig(**cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    return torch.randn((G, B, c.image_size, c.image_size, c.in_channels),
                       generator=gen)


def _conv_args(x, params):
    return (x, params["conv1_w"], params["conv1_b"], params["conv2_w"],
            params["conv2_b"])


def _earlier_features(params, x):
    """`PaperCNN.features` as it was before K7: grouped convolutions."""
    def conv(h, w, b):
        G, kh, kw, cin, cout = w.shape
        wt = w.permute(0, 4, 3, 1, 2).reshape(G * cout, cin, kh, kw)
        return F.conv2d(h, wt, groups=G) + b.reshape(1, G * cout, 1, 1)

    G, B = x.shape[:2]
    h = x.permute(1, 0, 4, 2, 3).reshape(B, G * x.shape[4], x.shape[2],
                                          x.shape[3])
    h = F.relu(conv(h, params["conv1_w"], params["conv1_b"]))
    h = F.max_pool2d(h, 2)
    h = F.relu(conv(h, params["conv2_w"], params["conv2_b"]))
    h = F.max_pool2d(h, 2)
    c2 = params["conv2_w"].shape[-1]
    h = h.reshape(B, G, c2, h.shape[2], h.shape[3])
    h = h.permute(1, 0, 3, 4, 2).reshape(G, B, -1)
    h = F.relu(torch.bmm(h, params["fc1_w"]) + params["fc1_b"][:, None])
    return F.relu(torch.bmm(h, params["fc2_w"]) + params["fc2_b"][:, None])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cpu_op_and_features_are_the_earlier_code_bit_for_bit(name):
    model, params = _models(CONFIGS[name], G=3)
    x = _images(CONFIGS[name], G=3, B=5)
    want = _earlier_features(params, x)
    before = k7.cnn_features.launches
    with torch.no_grad():
        assert torch.equal(model.features(params, x), want)
        conv = ops.cnn_features(*_conv_args(x, params))
    assert torch.equal(conv, ref.cnn_features_ref(*_conv_args(x, params)))
    assert torch.equal(model.features(params, x), want)   # no leaf needs grad
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    assert torch.equal(model.features(leaves, x).detach(), want)
    assert k7.cnn_features.launches == before, "a CPU call launched K7"


def _spy_op(monkeypatch):
    calls = []
    real = ops.cnn_features

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(ops, "cnn_features", spy)
    return calls


@pytest.mark.parametrize("name", ["paper", "narrow"])
def test_gradients_take_the_grouped_convolutions(name, monkeypatch):
    """Under ``enable_grad`` with leaves that need a gradient (the local
    train's `_loss_and_grads_once`), the forward never reaches the op and
    the gradients are the earlier code's, bit for bit; with grad mode off
    the op runs once a forward."""
    model, params = _models(CONFIGS[name], G=2, seed=3)
    x = _images(CONFIGS[name], G=2, B=4, seed=3)
    y = torch.randint(0, 10, (2, 4), generator=torch.Generator()
                      .manual_seed(4))
    calls = _spy_op(monkeypatch)
    grads = []
    for fn in (lambda p: model.features(p, x), lambda p:
               _earlier_features(p, x)):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            h = fn(leaves)
            logits = torch.bmm(h, leaves["out_w"]) + leaves["out_b"][:, None]
            loss = F.cross_entropy(logits.reshape(-1, 10), y.reshape(-1))
            grads.append(torch.autograd.grad(loss, list(leaves.values())))
    assert calls == []
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        classifier.xent_loss(model, params, {"x": x, "y": y})
    assert len(calls) == 1


def test_engine_routes_rewards_and_evaluation_to_the_op(monkeypatch):
    """`FLEngine`'s reward probes and evaluation reach `ops.cnn_features`
    (one call each: a reward call's K x Q models in one launch on the
    card); its local train does not."""
    from repro_torch.data import make_federated_classification
    from repro_torch.fl.engine import FLEngine

    engine = FLEngine(PaperCNN(CNNConfig(**common.NARROW_CNN)),
                      make_federated_classification(**common.CNN_DATA),
                      **common.CNN_ENGINE, device="cpu")
    stacked = engine.init_clients(prng.PRNGKey(0))
    calls = _spy_op(monkeypatch)
    engine.local_train(stacked, prng.PRNGKey(1), epochs=1)
    assert calls == []
    N = engine.n_local
    probes = engine.flatten(stacked)[:, None].expand(N, 4, -1)
    engine.make_reward_fn()(probes, torch.arange(N))
    assert [c[0].shape[0] for c in calls] == [4 * N]
    engine.eval_val(stacked)
    assert len(calls) == 3          # the accuracy's and the loss's forwards


def _meta_args(G, B, H, W, cin, c1, c2):
    def m(*shape):
        return torch.empty(shape, device="meta")
    return (m(G, B, H, W, cin), m(G, 5, 5, cin, c1), m(G, c1),
            m(G, 5, 5, c1, c2), m(G, c2))


def test_meta_path_allocates_records_its_work_and_launches_nothing():
    before = k7.cnn_features.launches
    with kmeta.recording() as calls:
        out = k7.cnn_features(*_meta_args(400, 50, 32, 32, 3, 6, 16))
    assert out.device.type == "meta" and tuple(out.shape) == (400, 50, 400)
    assert [(c.name, c.nbytes, c.flops, c.dtype) for c in calls] == [
        ("cnn_features", *k7.work(400, 50, 32, 32, 3, 6, 16), "float32")]
    # the reward call of the dense cell: 23.7 GFLOP, 282 MB
    assert calls[0].flops == 2 * 20_000 * (352_800 + 240_000)
    assert calls[0].nbytes == 4 * (20_000 * 3072 + 400 * 2872 + 20_000 * 400)
    assert k7.cnn_features.launches == before


def test_meta_forward_of_the_model_records_k7_under_no_grad():
    model = PaperCNN(CNNConfig())
    params = {k: torch.empty((6,) + tuple(v.shape), device="meta")
              for k, v in model.init(prng.PRNGKey(0)).items()}
    x = torch.empty((6, 7, 32, 32, 3), device="meta")
    with kmeta.recording() as calls, torch.no_grad():
        out = model.logits(params, x)
    assert tuple(out.shape) == (6, 7, 10)
    assert [c.name for c in calls] == ["cnn_features"]
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    with kmeta.recording() as calls:
        model.logits(leaves, x)
    assert calls == []              # training's route: the grouped convs


def test_dry_run_round_records_k7():
    """One dense round of `launch.fl_dryrun` (16 clients on 8 devices, on
    "meta"): the reward probes and the evaluation are K7's shape-only
    calls, the greedy's at K x 4 models a call."""
    from repro_torch.launch import fl_dryrun
    from repro_torch.roofline import count_step

    step, state, mesh, engine, cfg = fl_dryrun.build_engine_step(
        16, 32, 16, 1, 4, 1, 8)
    count = count_step(lambda: step(state))
    k7_calls = [c for c in count.kernels if c.name == "cnn_features"]
    n_loc = engine.n_local
    want = k7.work(4 * n_loc, 16, 32, 32, 3, 6, 16)
    assert sum(1 for c in k7_calls if (c.nbytes, c.flops) == want) == 16
    assert len(k7_calls) >= 16 + 2


REFUSED = {
    "bf16": lambda a: (a[0].bfloat16(),) + a[1:],
    "images not contiguous": lambda a: (a[0].transpose(2, 3),) + a[1:],
    "weights not contiguous": lambda a: (a[0], a[1].transpose(1, 2)) + a[2:],
    "cin 2": lambda a: _meta_args(2, 3, 32, 32, 2, 6, 16),
    "c2 12": lambda a: _meta_args(2, 3, 32, 32, 3, 6, 12),
    "image 13": lambda a: _meta_args(2, 3, 13, 13, 3, 6, 16),
    "3x3 kernels": lambda a: (a[0], a[1][:, :3, :3]) + a[2:],
    "bias shape": lambda a: a[:2] + (a[2][:, :4],) + a[3:],
    "mixed devices": lambda a: (torch.empty(a[0].shape),) + a[1:],
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    args = REFUSED[what](_meta_args(2, 3, 32, 32, 3, 6, 16))
    error = TypeError if what == "bf16" else ValueError
    with pytest.raises(error):
        k7.cnn_features(*args)


def test_wrapper_never_falls_back_on_cpu_tensors():
    model, params = _models(CONFIGS["narrow"], G=2)
    with pytest.raises(ValueError):
        k7.cnn_features(*_conv_args(_images(CONFIGS["narrow"], 2, 3),
                                    params))


def test_plan_of_the_cell():
    """The dense cell's reward call (50 images of 32 x 32 x 3 a model): 13
    tiles of at most 4 images, two blocks an SM."""
    plan = k7.launch_plan(50, 32, 32, 3, 6, 16)
    assert (plan.tiles, plan.tile_images) == (13, 4)
    assert plan.smem_bytes <= k7.PAIR_SMEM
    assert plan.smem_bytes == 4 * (k7.weight_floats(3, 6, 16)
                                   + 4 * (plan.is_ + plan.is2))
    assert k7.launch_plan(1, 32, 32, 3, 6, 16).tiles == 1
    # images too large for two blocks an SM take one, then none
    assert k7.launch_plan(8, 100, 100, 3, 6, 16).tile_images == 1
    with pytest.raises(ValueError):
        k7.launch_plan(8, 200, 200, 3, 6, 16)


@pytest.mark.parametrize("shape", [(32, 32, 3), (16, 16, 3), (32, 32, 1),
                                   (16, 16, 1)])
def test_conv1_loads_hit_distinct_banks(shape):
    """Each half-warp's 8-byte loads of conv1 (16 consecutive (image,
    pixel) items a block, from any item on, across rows and images) hit
    32 distinct banks: the plan's padding makes item k's words start at
    word 2 cin k (mod 32)."""
    H, W, cin = shape
    plan = k7.launch_plan(50, H, W, cin, 6, 16)
    (p1h, p1w), _ = k7.pooled(H, W)
    items = torch.arange(plan.tile_images * p1h * p1w)
    j, r = items // (p1h * p1w), items % (p1h * p1w)
    base = j * plan.is_ + 2 * (r // p1w) * plan.rs + 2 * (r % p1w) * cin
    for start in range(len(items) - 15):
        words = base[start:start + 16]
        banks = torch.cat([words % 32, (words + 1) % 32])
        assert len(set(banks.tolist())) == 32, (shape, start)


@pytest.mark.parametrize("shape", [(32, 32), (16, 16), (20, 24)])
def test_conv2_loads_hit_distinct_banks(shape):
    """conv2's scalar loads: the 16 pixels of a warp (two threads each),
    from any pixel on, across rows and images, read 16 distinct banks."""
    H, W = shape
    plan = k7.launch_plan(50, H, W, 3, 6, 16)
    _, (p2h, p2w) = k7.pooled(H, W)
    pixels = torch.arange(plan.tile_images * p2h * p2w)
    j, r = pixels // (p2h * p2w), pixels % (p2h * p2w)
    base = j * plan.is2 + 2 * (r // p2w) * plan.rs2 + 2 * (r % p2w)
    for start in range(len(pixels) - 15):
        assert len(set((base[start:start + 16] % 32).tolist())) == 16


def _emulate(x, w1, b1, w2, b2):
    """The kernel, block by block, as the CUDA source indexes its shared
    memory (float64; NaN where nothing was written)."""
    G, B, H, W, cin = x.shape
    c1, c2 = w1.shape[-1], w2.shape[-1]
    plan = k7.launch_plan(B, H, W, cin, c1, c2)
    (p1h, p1w), (p2h, p2w) = k7.pooled(H, W)
    c1p = -(-c1 // 4) * 4
    nw1, nw2 = 25 * cin * c1p, 25 * c1 * c2
    out = torch.full((G, B, p2h * p2w * c2), float("nan"),
                     dtype=torch.float64)
    taps = [(ky, kx) for ky in range(5) for kx in range(5)]
    for g in range(G):
        for t in range(plan.tiles):
            b0 = t * B // plan.tiles
            n = (t + 1) * B // plan.tiles - b0
            assert 1 <= n <= plan.tile_images
            smem = torch.full((plan.smem_bytes // 4,), float("nan"),
                              dtype=torch.float64)
            w1s = torch.zeros(nw1, dtype=torch.float64)
            w1s.view(-1, c1p)[:, :c1] = w1[g].reshape(-1, c1)
            smem[:nw1] = w1s
            smem[nw1:nw1 + c1] = b1[g]
            o2 = nw1 + c1p
            smem[o2:o2 + nw2] = w2[g].reshape(-1)
            smem[o2 + nw2:o2 + nw2 + c2] = b2[g]
            xs = o2 + nw2 + c2
            for jj in range(n):
                for yy in range(H):
                    at = xs + jj * plan.is_ + yy * plan.rs
                    smem[at:at + W * cin] = x[g, b0 + jj, yy].reshape(-1)
            p1s = xs + n * plan.is_
            # conv1: every item at once, gathered by its flat addresses
            k = torch.arange(n * p1h * p1w)
            jj, r = k // (p1h * p1w), k % (p1h * p1w)
            py, px = r // p1w, r % p1w
            base = xs + jj * plan.is_ + 2 * py * plan.rs + 2 * px * cin
            acc = torch.zeros((len(k), 4, c1), dtype=torch.float64)
            for ky, kx in taps:
                for ci in range(cin):
                    w = smem[((ky * 5 + kx) * cin + ci) * c1p +
                             torch.arange(c1)]
                    for p, (dy, dx) in enumerate([(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]):
                        v = smem[base + (ky + dy) * plan.rs +
                                 (kx + dx) * cin + ci]
                        acc[:, p] += v[:, None] * w
            h = (acc.max(dim=1).values + smem[nw1:nw1 + c1]).clamp_min(0)
            for c in range(c1):
                smem[p1s + jj * plan.is2 + c * plan.cs2 + py * plan.rs2 +
                     px] = h[:, c]
            # conv2: two threads a pixel, half of its channels each
            k = torch.arange(n * p2h * p2w)
            jj, r = k // (p2h * p2w), k % (p2h * p2w)
            py, px = r // p2w, r % p2w
            base = p1s + jj * plan.is2 + 2 * py * plan.rs2 + 2 * px
            ch = torch.arange(c2 // 2)
            for half in (0, c2 // 2):
                acc = torch.zeros((len(k), 4, c2 // 2), dtype=torch.float64)
                for ky in range(5):
                    for ci in range(c1):
                        for kx in range(5):
                            w = smem[o2 + ((ky * 5 + kx) * c1 + ci) * c2 +
                                     half + ch]
                            for p, (dy, dx) in enumerate(
                                    [(0, 0), (0, 1), (1, 0), (1, 1)]):
                                v = smem[base + ci * plan.cs2 +
                                         (ky + dy) * plan.rs2 + kx + dx]
                                acc[:, p] += v[:, None] * w
                h = (acc.max(dim=1).values +
                     smem[o2 + nw2 + half + ch]).clamp_min(0)
                out[g, b0 + jj, r * c2 + half + ch[:, None]] = h.T
    return out


@pytest.mark.parametrize("name, G, B", [
    ("paper", 2, 9), ("image16", 3, 5), ("narrow", 2, 1),
    ("paper-1ch", 1, 6), ("narrow-1ch", 3, 4)])
def test_kernel_plan_emulated_equals_the_plain_version(name, G, B):
    """The emulated kernel in float64 against the plain version in float64
    (each output a sum of the same products in another order): within
    1e-12 of the largest feature; no NaN, so nothing unwritten was
    read."""
    _, params = _models(CONFIGS[name], G=G, seed=5)
    x = _images(CONFIGS[name], G=G, B=B, seed=5)
    args = [t.double() for t in _conv_args(x, params)]
    got = _emulate(*args)
    want = ref.cnn_features_ref(*args)
    assert not torch.isnan(got).any()
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
