"""The host side of the port's kernel designs, as pure Python.

K1 (`graph_mix`) and K2 (`sparse_graph_mix`) load their tables in vectors
of 2 or 1 columns, whichever every row is aligned to, and K2's grid puts
clients on x and walks the P tiles on y with a stride; K3
(`compressed_graph_mix`) groups each payload row by 256-column tile
before its mix (`ref.bucket_payload_ref` is that pass's plain version);
K4 (`flash_attention`) copies rows in 16-byte pieces and refuses an input
it cannot copy so, and its backward launches by `backward_plan` (tiles,
head splits, slabs of keys and the scratch between its passes); K5
(`ssd`) splits the scan into three launches over (b, head, chunk) and
64-row tiles (`ssd.launch_plan`), and copies in 16-byte pieces only
where every row is aligned (`ssd.aligned16`); its backward launches by
`ssd.backward_plan` (six launches, head groups, workspaces), run here in
float64 through its block lists against the plain gradient; K6's
backward takes `rglru_scan.backward_blocks` blocks. These
are tested here without a card; the kernels
themselves are held to their plain versions by tests/test_torch_cuda.py
and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import compressed_graph_mix as k3
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import graph_mix as k1
from repro_torch.kernels import ref
from repro_torch.kernels import sparse_graph_mix as k2
from repro_torch.kernels import ssd as k5

BASE = 0x7F0000000000  # a 256-byte aligned device address


# (P, element size, byte offset of W, expected columns per thread)
K1_WIDTHS = [
    (62004, 4, 0, 2),   # P = 0 mod 4, fp32: float2 (the widest)
    (62006, 4, 0, 2),   # PaperCNN: P = 2 mod 4, rows 8-byte aligned
    (62005, 4, 0, 1),   # P = 1 mod 4
    (62007, 4, 0, 1),   # P = 3 mod 4
    (3, 4, 0, 1),       # P under one vector
    (1, 4, 0, 1),
    (62004, 4, 4, 1),   # a row-offset view: only 4-byte aligned
    (62004, 4, 8, 2),   # 8-byte aligned view
    (62004, 2, 0, 2),   # bf16: 2 columns, 4 bytes
    (62006, 2, 0, 2),   # bf16, P = 2 mod 4
    (62005, 2, 0, 1),   # bf16, P odd
    (62004, 2, 2, 1),   # bf16 view one element in
    (62004, 2, 4, 2),   # bf16 view two elements in
]


@pytest.mark.parametrize("P, elt, offset, want", K1_WIDTHS)
def test_graph_mix_vector_width(P, elt, offset, want):
    out = BASE + (1 << 20)
    cols = k1.vector_width(P, elt, BASE + offset, out)
    assert cols == want
    # every row n of W and out starts on a cols * elt boundary
    for n in (0, 1, 7, 31):
        for addr in (BASE + offset, out):
            assert (addr + n * P * elt) % (cols * elt) == 0


def test_graph_mix_vector_width_follows_out_too():
    assert k1.vector_width(64, 4, BASE, BASE + 8) == 2
    assert k1.vector_width(64, 4, BASE + 4, BASE) == 1


def test_graph_mix_vector_width_refuses_a_misaligned_element():
    with pytest.raises(ValueError, match="aligned"):
        k1.vector_width(64, 4, BASE + 2)


# K2: (P, element size, byte offsets of W_self, W_peers and out, columns)
K2_WIDTHS = [
    (62006, 4, (0, 0, 0), 2),     # the main path: P even, all aligned
    (62006, 4, (0, 8, 0), 2),     # W_peers a separate, aligned table
    (62006, 4, (4, 0, 0), 1),     # W_self one element in: off 8 bytes
    (62006, 4, (0, 4, 0), 1),     # W_peers off 8 bytes
    (62006, 4, (0, 0, 4), 1),     # out off 8 bytes
    (1001, 4, (0, 0, 0), 1),      # odd P
    (62006, 2, (0, 0, 0), 2),     # bf16 pairs in one word
    (62006, 2, (2, 0, 0), 1),     # bf16 one element in
    (1001, 2, (0, 0, 0), 1),      # bf16, odd P
]


@pytest.mark.parametrize("P, elt, offsets, want", K2_WIDTHS)
def test_sparse_graph_mix_vector_width(P, elt, offsets, want):
    addresses = [BASE + (i << 24) + o for i, o in enumerate(offsets)]
    cols = k1.vector_width(P, elt, *addresses)
    assert cols == want
    for n in (0, 1, 5, 31):   # every row of every table stays aligned
        for addr in addresses:
            assert (addr + n * P * elt) % (cols * elt) == 0


# (N, P, cols): the main path, one tile, a P that needs the y stride
K2_GRIDS = [(32, 62006, 2), (32, 62005, 1), (1, 1, 1), (5, 1, 2),
            (3, 512 * 65535, 1), (3, 512 * 65535 + 1, 1),
            (2, 1024 * 70000, 2), (7, 10 ** 9, 1)]


@pytest.mark.parametrize("N, P, cols", K2_GRIDS)
def test_sparse_graph_mix_grid_covers_every_tile_once(N, P, cols):
    """One block column per client; the y blocks, each taking tiles
    y0, y0 + y, ..., cover every P tile exactly once within CUDA's grid
    limits."""
    y = k2.launch_grid(N, P, cols)
    assert N <= k2.MAX_GRID_X and 1 <= y <= k2.MAX_GRID_Y
    span = k2.BLOCK_VECTORS * cols   # columns of one tile
    tiles = -(-P // span)
    assert tiles * span >= P > (tiles - 1) * span
    taken = np.zeros(tiles, dtype=np.int64)
    for y0 in range(y):
        taken[y0::y] += 1
    assert (taken == 1).all()


def test_sparse_graph_mix_grid_refuses_more_clients_than_x_takes():
    assert k2.launch_grid(k2.MAX_GRID_X, 10, 1) == 1
    with pytest.raises(ValueError, match="grid"):
        k2.launch_grid(k2.MAX_GRID_X + 1, 10, 1)


# K3 payloads: (N, K, P, fraction of -1 pads, distinct columns or 0 for
# all of P); few distinct columns make duplicates, K > P too
K3_PAYLOADS = [(4, 300, 900, 0.3, 40), (3, 70, 600, 0.0, 20),
               (5, 300, 100, 0.1, 0), (2, 1000, 70_000, 0.05, 0),
               (6, 33, 1000, 0.5, 8), (1, 1, 1, 0.0, 0),
               (3, 200, 200_000, 0.2, 300)]


def _payload(N, K, P, pads, distinct, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, P, distinct) if distinct else None
    idx = (rng.choice(cols, (N, K)) if distinct
           else rng.integers(0, P, (N, K)))
    idx = np.where(rng.random((N, K)) < pads, -1, idx)
    vals = rng.standard_normal((N, K)).astype(np.float32)
    return torch.from_numpy(vals), torch.from_numpy(idx.astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("N, K, P, pads, distinct", K3_PAYLOADS)
def test_bucket_payload_ref_groups_the_sorted_rows(N, K, P, pads, distinct,
                                                    seed):
    """Each tile's bucket holds the row's entries of that tile in payload
    order, and the same entries as the row sorted by index (a stable
    `torch.sort`) between the tile's bounds; pads are dropped, the tail
    is (0, -1) and the offsets have T + 1 entries."""
    vals, idx = _payload(N, K, P, pads, distinct, seed)
    bv, bi, off = ref.bucket_payload_ref(vals, idx, P, k3.TILE)
    T = -(-P // k3.TILE)
    assert off.shape == (N, T + 1) and off.dtype == torch.int32
    assert bv.shape == vals.shape and bi.shape == idx.shape
    s_idx, perm = torch.sort(idx, dim=1, stable=True)
    s_vals = vals.gather(1, perm)
    for n in range(N):
        kept = int((idx[n] >= 0).sum())
        assert int(off[n, 0]) == 0 and int(off[n, T]) == kept
        assert (bi[n, kept:] == -1).all() and (bv[n, kept:] == 0).all()
        for t in range(T):
            lo, hi = int(off[n, t]), int(off[n, t + 1])
            mine = ((idx[n] >= t * k3.TILE) &
                    (idx[n] < (t + 1) * k3.TILE)).nonzero().flatten()
            # payload order within the bucket
            assert torch.equal(bi[n, lo:hi], idx[n, mine])
            assert torch.equal(bv[n, lo:hi], vals[n, mine])
            # the sorted row's group, as a multiset
            a, b = (int(torch.searchsorted(s_idx[n], v, right=False))
                    for v in (torch.tensor(t * k3.TILE, dtype=torch.int32),
                              torch.tensor((t + 1) * k3.TILE,
                                           dtype=torch.int32)))
            got = sorted(zip(bi[n, lo:hi].tolist(), bv[n, lo:hi].tolist()))
            want = sorted(zip(s_idx[n, a:b].tolist(),
                              s_vals[n, a:b].tolist()))
            assert got == want


def test_bucket_payload_ref_drops_indices_past_p():
    vals = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    idx = torch.tensor([[300, 5, 299, 1000]], dtype=torch.int32)
    bv, bi, off = ref.bucket_payload_ref(vals, idx, 300, k3.TILE)
    assert off.tolist() == [[0, 1, 2]]
    assert bi.tolist() == [[5, 299, -1, -1]]
    assert bv.tolist() == [[2.0, 3.0, 0.0, 0.0]]
    # the mix's plain version drops them as well
    dense = ref.densify_topk(vals, idx, 300)
    assert dense.sum().item() == 5.0 and dense[0, 5] == 2.0


def _contiguous(shape):
    B, S, H, hd = shape
    return (S * H * hd, H * hd, hd, 1)


# (shape, strides, element size, byte offset, refused axis or None)
K4_LAYOUTS = [
    ((4, 512, 16, 128), None, 4, 0, None),          # serve, fp32
    ((4, 512, 16, 128), None, 2, 0, None),          # serve, bf16
    ((1, 33, 2, 16), None, 2, 0, None),             # hd 16 bf16: 32 bytes
    ((2, 100, 8, 64), (51200, 64, 6400, 1), 4, 0, None),   # (B, H, S, hd)
    ((2, 64, 2, 32), (5120, 80, 40, 1), 2, 0, None),       # padded heads
    ((2, 64, 4, 32), None, 4, 4, "address"),        # one element in
    ((2, 64, 4, 32), None, 2, 8, "address"),        # bf16, four in
    ((2, 64, 2, 32), (4608, 72, 33, 1), 4, 0, "h"),  # head stride 33
    ((2, 64, 2, 32), (4608, 72, 33, 1), 2, 0, "h"),
    ((2, 64, 1, 32), (2112, 33, 33, 1), 4, 0, "s"),  # one head: s refused
    ((1, 64, 1, 32), (7, 32, 5, 1), 4, 0, None),    # length-1 axes unread
    ((3, 1, 1, 32), (34, 32, 5, 1), 4, 0, "b"),
]


@pytest.mark.parametrize("shape, strides, elt, offset, refused",
                         K4_LAYOUTS)
def test_flash_attention_alignment_rule(shape, strides, elt, offset,
                                        refused):
    strides = strides or _contiguous(shape)
    err = k4.alignment_error("q", BASE + offset, shape, strides, elt)
    if refused is None:
        assert err is None
    elif refused == "address":
        assert "data_ptr" in err and "aligned" in err
    else:
        assert f"{refused} stride" in err


# K4 backward plans (B, Sq, Sk, Hq, Hkv, hd, causal, window, SMs,
# scratch budget in keys or None): qwen3-0.6b's training shape (one split,
# one slab), recurrentgemma-9b's (hd 256, one KV head: 8 splits), S 4096
# (4 slabs at the default budget), a window over several slabs (query
# tiles that see no key of the first), ragged S with Sq < Sk, non-causal
# with a window, hd 160 and 176 (two Q/dO stages and one), one SM (one
# split)
K4_BWD_PLANS = [(8, 512, 512, 16, 8, 128, True, None, 132, None),
                (4, 512, 512, 16, 1, 256, True, 2048, 132, None),
                (1, 4096, 4096, 16, 4, 64, True, None, 132, None),
                (1, 200, 200, 4, 1, 32, True, 48, 132, 64),
                (2, 77, 130, 4, 2, 16, True, None, 132, 64),
                (1, 130, 190, 2, 2, 16, False, 30, 132, 128),
                (1, 96, 64, 4, 2, 160, False, None, 8, None),
                (1, 100, 100, 4, 2, 176, True, 40, 8, 32),
                (2, 100, 100, 4, 2, 80, True, None, 1, None),
                # whisper's non-causal shapes cut in batch and heads: 50
                # queries against 1,500 keys (the cross-attention's), in
                # slabs of 320 keys (the encoder's at its train shape):
                # 5 slabs, the last of 220 keys ending in a ragged tile
                (1, 50, 1500, 2, 1, 64, False, None, 132, 320)]


def _k4_bwd_plan(monkeypatch, B, Sq, Sk, Hq, Hkv, hd, sms, keys):
    """The plan, with a scratch budget of ``keys`` keys a slab where
    given."""
    if keys is not None:
        monkeypatch.setattr(k4, "BWD_SCRATCH_BYTES", B * Hq * -(
            -Sq // k4.QUERY_TILE) * k4.QUERY_TILE * 4 * keys)
    return k4.backward_plan(B, Sq, Sk, Hq, Hkv, hd, sms)


def _visible(Sq, Sk, causal, window):
    i = np.arange(Sq)[:, None]
    j = np.arange(Sk)[None]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    return mask


def _dkdv_tiles(k0, bk, Sq, Sk, causal, window):
    """The query tiles a (b) block of keys [k0, k0 + bk) walks, as
    csrc/flash_attention_bwd.cu computes them."""
    T = k4.QUERY_TILE
    k_end = min(k0 + bk, Sk)
    q_lo = k0 if causal else 0
    q_hi = min(Sq, k_end - 1 + min(window, Sq)) if window else Sq
    q_first = q_lo // T * T
    n_q = -(-(q_hi - q_first) // T) if q_hi > q_first else 0
    return range(q_first // T, q_first // T + n_q)


def _dq_tiles(qt, n_qt, bk, Sq, Sk, causal, window):
    """The key tiles of query tile ``qt``'s band, as flash_attention.cuh's
    block_span computes them for (c): (first key, tiles)."""
    q0 = qt * k4.QUERY_TILE
    q_end = min(q0 + k4.QUERY_TILE, Sq)
    lo = max(0, q0 - window + 1) if window else 0
    hi = min(Sk, q_end) if causal else Sk
    k_first = lo // bk * bk
    return k_first, -(-(hi - k_first) // bk)


def _k4_bwd_blocks(plan, B, Sq, Sk, Hq, Hkv, causal, window):
    """What each pass's blocks do: per slab, the (b) blocks' (b, key
    tile, KV head, split, query heads, written (h, query tile) pairs) and
    the (c) blocks' (b, h, query tile, key tiles read, add)."""
    bk, rep, slab = plan.block_keys, Hq // Hkv, plan.slab_keys
    heads = rep // plan.splits
    passes = []
    for s in range(plan.n_slabs):
        lo = s * slab
        gx, gy, gz = plan.grids["dkdv"][s]
        dkdv = []
        for z in range(gz):
            k0 = lo + z * bk
            tiles = _dkdv_tiles(k0, bk, Sq, Sk, causal, window)
            for b in range(gy):
                for x in range(gx):
                    hk, split = divmod(x, plan.splits)
                    hs = range(hk * rep + split * heads,
                               hk * rep + (split + 1) * heads)
                    dkdv.append((b, k0, hk, split, hs,
                                 [(h, qt) for h in hs for qt in tiles]))
        dq = []
        gx, gy, gz = plan.grids["dq"][s]
        for z in range(gz):
            qt = gz - 1 - z if causal else z
            k_first, n = _dq_tiles(qt, gz, bk, Sq, Sk, causal, window)
            a, c = max(k_first, lo), min(k_first + n * bk, lo + slab)
            for b in range(gy):
                for h in range(gx):
                    if a < c:
                        dq.append((b, h, qt, list(range(a, c, bk)),
                                   k_first < lo))
        passes.append((lo, dkdv, dq))
    return passes


@pytest.mark.parametrize("B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, "
                         "keys", K4_BWD_PLANS)
def test_flash_attention_backward_plan_covers_every_tile_once(
        monkeypatch, B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, keys):
    """(b) covers every (key tile, KV head, batch) once per split and
    every query head of a group in exactly one split; it writes the
    scratch tile of every visible (query tile, key tile) pair once, inside
    its slab, and (c) reads exactly the tiles its slab's (b) wrote; every
    (query tile, head, batch) of (c) meets its whole band over the slabs,
    writing dQ in the first slab it sees and adding in the later ones."""
    plan = _k4_bwd_plan(monkeypatch, B, Sq, Sk, Hq, Hkv, hd, sms, keys)
    bk, T, rep = plan.block_keys, k4.QUERY_TILE, Hq // Hkv
    assert rep % plan.splits == 0 and plan.slab_keys % bk == 0
    assert plan.n_slabs == -(-Sk // plan.slab_keys)
    vis = _visible(Sq, Sk, causal, window)
    want = {(qt, k0) for qt in range(plan.query_tiles)
            for k0 in range(0, Sk, bk)
            if vis[qt * T:(qt + 1) * T, k0:k0 + bk].any()}
    kv_blocks, written = {}, {}
    bands = {}
    for lo, dkdv, dq in _k4_bwd_blocks(plan, B, Sq, Sk, Hq, Hkv, causal,
                                       window):
        in_slab = set()
        for z, k0, hk, split, hs, pairs in dkdv:
            assert lo <= k0 < min(lo + plan.slab_keys, Sk)
            for h in hs:
                key = (z, k0, h)
                kv_blocks[key] = kv_blocks.get(key, 0) + 1
            for h, qt in pairs:
                w = (z, h, qt, k0)
                written[w] = written.get(w, 0) + 1
                in_slab.add(w)
                assert k0 - lo + bk <= plan.slab_keys
        read = set()
        for z, h, qt, tiles, add in dq:
            read |= {(z, h, qt, k0) for k0 in tiles}
            band = bands.setdefault((z, h, qt), [])
            assert add == bool(band)
            band += tiles
        assert read == in_slab
    assert set(kv_blocks) == {(z, k0, h) for z in range(B)
                              for k0 in range(0, Sk, bk) for h in range(Hq)}
    assert set(kv_blocks.values()) == {1}
    assert set(written.values()) == {1}
    for z in range(B):
        for h in range(Hq):
            assert {(qt, k0) for (zz, hh, qt, k0) in written
                    if (zz, hh) == (z, h)} == want
    assert set(bands) == {(z, h, qt) for z in range(B) for h in range(Hq)
                          for qt in range(plan.query_tiles)}
    for (z, h, qt), tiles in bands.items():
        assert tiles == sorted({k0 for q, k0 in want if q == qt})


@pytest.mark.parametrize("hd", range(16, 257, 16))
def test_flash_attention_backward_shared_memory_fits_every_head_size(hd):
    """(b) and (c) fit a block's shared memory at every head size the
    kernel takes, two (c) blocks an SM; (b) streams Q and dO through two
    stages up to hd 112 and at hd 144 and 160, one at hd 128 and from hd
    176, with 64 keys a block up to hd 128 and 32 above."""
    dkdv, stages, dq = k4.backward_smem(hd)
    assert dkdv <= k4.MAX_SMEM and 2 * dq <= k4.MAX_SMEM
    assert stages == (2 if hd <= 112 or hd in (144, 160) else 1)
    assert k4.backward_block_keys(hd) == (64 if hd <= 128 else 32)
    plan = k4.backward_plan(1, 100, 100, 2, 1, hd, 132)
    assert plan.smem == {"dkdv": dkdv, "dq": dq}
    assert plan.launch[4:6] == (dkdv, dq)


@pytest.mark.parametrize("B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, "
                         "keys", K4_BWD_PLANS)
def test_flash_attention_backward_scratch_bytes(monkeypatch, B, Sq, Sk, Hq,
                                                Hkv, hd, causal, window, sms,
                                                keys):
    """The scratch is (B, Hq, query tiles, slab keys, 64) fp32 of scale
    dS^T, within the budget unless one key tile exceeds it, plus (2,
    splits, B, Sk, Hkv, hd) fp32 of partial dK and dV where a group is
    split; the splits are the fewest that give two blocks an SM."""
    plan = _k4_bwd_plan(monkeypatch, B, Sq, Sk, Hq, Hkv, hd, sms, keys)
    T = k4.QUERY_TILE
    n_qt = -(-Sq // T)
    ds = B * Hq * n_qt * T * plan.slab_keys * 4
    part = 2 * plan.splits * B * Sk * Hkv * hd * 4 if plan.splits > 1 else 0
    assert plan.scratch_bytes() == ds + part
    budget = (k4.BWD_SCRATCH_BYTES if keys is None
              else B * Hq * n_qt * T * 4 * keys)
    assert ds <= budget or plan.slab_keys == plan.block_keys
    blocks = plan.grids["dkdv"][0][2] * Hkv * B
    assert blocks * plan.splits >= 2 * sms or plan.splits == Hq // Hkv
    assert all(blocks * d < 2 * sms for d in range(1, plan.splits)
               if (Hq // Hkv) % d == 0)


def test_flash_attention_backward_plan_at_the_two_training_shapes():
    """qwen3-0.6b's training shape runs one split and one slab, 134 MB of
    scratch; recurrentgemma-9b's (hd 256, one KV head) 8 splits (512 (b)
    blocks for 132 SMs, against 64 for one split) and 101 MB."""
    p = k4.backward_plan(8, 512, 512, 16, 8, 128, 132)
    assert (p.block_keys, p.splits, p.n_slabs, p.stages) == (64, 1, 1, 1)
    assert p.grids["dkdv"] == ((8, 8, 8),) and p.grids["reduce"] == ()
    assert p.grids["dq"] == ((16, 8, 8),)
    assert p.scratch_bytes() == 8 * 16 * 512 * 512 * 4
    p = k4.backward_plan(4, 512, 512, 16, 1, 256, 132)
    assert (p.block_keys, p.splits, p.n_slabs, p.stages) == (32, 8, 1, 1)
    assert p.grids["dkdv"] == ((8, 4, 16),)
    assert p.scratch_bytes() == 4 * (4 * 16 * 512 * 512 +
                                     2 * 8 * 4 * 512 * 256)


def test_flash_attention_backward_plans_of_whisper_training():
    """whisper-medium's train step (B 8, 448 tokens, 1,500 frames, 16
    heads of 64, MHA): the encoder's non-causal self-attention walks 5
    slabs of 320 keys (the last 220) with 240 MiB of scratch, the
    cross-attention slabs of 1,152 and 348 keys with 252 MiB, the
    decoder's causal self-attention one slab; one split each."""
    p = k4.backward_plan(8, 1500, 1500, 16, 16, 64, 132)
    assert (p.block_keys, p.splits, p.slab_keys, p.n_slabs) == (64, 1, 320, 5)
    assert p.grids["dkdv"] == ((16, 8, 5),) * 4 + ((16, 8, 4),)
    assert p.grids["dq"] == ((16, 8, 24),) * 5
    assert 1500 - 4 * 320 == 220 and p.scratch_bytes() == 240 << 20
    p = k4.backward_plan(8, 448, 1500, 16, 16, 64, 132)
    assert (p.splits, p.slab_keys, p.n_slabs) == (1, 1152, 2)
    assert p.grids["dkdv"] == ((16, 8, 18), (16, 8, 6))
    assert 1500 - 1152 == 348 and p.scratch_bytes() == 252 << 20
    p = k4.backward_plan(8, 448, 448, 16, 16, 64, 132)
    assert (p.splits, p.slab_keys, p.n_slabs) == (1, 448, 1)
    assert p.grids["dkdv"] == ((16, 8, 7),)
    assert p.scratch["ds"] == (8, 16, 7, 448, 64)


def _emulate_bwd(q, k, v, dout, causal, window, plan):
    """dq, dk, dv by the plan's passes, tile by tile in float64, as the
    kernels compute them: (b) writes scale dS^T into a scratch filled with
    NaN and sums dK and dV (or a split's partials), (c) reads the
    scratch's tiles, writing dQ or adding to it, and the splits are
    summed in order."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep, bk, T = Hq // Hkv, plan.block_keys, k4.QUERY_TILE
    scale = 1.0 / np.sqrt(hd)
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    vis = torch.from_numpy(_visible(Sq, Sk, causal, window))
    kk, vv = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    lse = torch.logsumexp(torch.where(vis, s, -1e30), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd",
                       torch.where(vis, torch.exp(s - lse[..., None]), 0.0),
                       vv)
    delta = (dout * out).sum(-1).transpose(1, 2)
    nq, nk = plan.query_tiles * T, -(-Sk // bk) * bk

    def pad(t, n):
        return torch.cat([t, t.new_zeros((t.shape[0], n - t.shape[1]) +
                                         t.shape[2:])], dim=1)
    qp, gp, kp, vp = pad(q, nq), pad(dout, nq), pad(k, nk), pad(v, nk)
    lp = torch.cat([lse, lse.new_zeros(B, Hq, nq - Sq)], dim=2)
    dp_ = torch.cat([delta, delta.new_zeros(B, Hq, nq - Sq)], dim=2)
    visp = torch.zeros((nq, nk), dtype=torch.bool)
    visp[:Sq, :Sk] = vis
    dq = torch.full((B, Sq, Hq, hd), float("nan"), dtype=torch.float64)
    part = torch.zeros((2, plan.splits, B, Sk, Hkv, hd), dtype=torch.float64)
    for lo, dkdv, dqb in _k4_bwd_blocks(plan, B, Sq, Sk, Hq, Hkv, causal,
                                        window):
        scratch = torch.full(plan.scratch["ds"], float("nan"),
                             dtype=torch.float64)
        for z, k0, hk, split, _, pairs in dkdv:
            acc = torch.zeros((2, bk, hd), dtype=torch.float64)
            kt, vt = kp[z, k0:k0 + bk, hk], vp[z, k0:k0 + bk, hk]
            for h, qt in pairs:
                rows = slice(qt * T, (qt + 1) * T)
                qt_, gt = qp[z, rows, h], gp[z, rows, h]
                p = torch.where(visp[rows, k0:k0 + bk],
                                torch.exp(qt_ @ kt.T * scale -
                                          lp[z, h, rows, None]), 0.0)
                ds = p * (gt @ vt.T - dp_[z, h, rows, None])
                scratch[z, h, qt, k0 - lo:k0 - lo + bk] = scale * ds.T
                acc[0] += ds.T @ qt_
                acc[1] += p.T @ gt
            n = min(bk, Sk - k0)
            part[0, split, z, k0:k0 + n, hk] = scale * acc[0, :n]
            part[1, split, z, k0:k0 + n, hk] = acc[1, :n]
        for z, h, qt, tiles, add in dqb:
            acc = sum(scratch[z, h, qt, k0 - lo:k0 - lo + bk].T @
                      kp[z, k0:k0 + bk, h // rep] for k0 in tiles)
            n = min(T, Sq - qt * T)
            rows = slice(qt * T, qt * T + n)
            dq[z, rows, h] = dq[z, rows, h] + acc[:n] if add else acc[:n]
    dk, dv = part[0, 0], part[1, 0]
    for g in range(1, plan.splits):
        dk, dv = dk + part[0, g], dv + part[1, g]
    return dq, dk, dv


@pytest.mark.parametrize("B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, "
                         "keys", [c for c in K4_BWD_PLANS
                                  if c[1] * c[2] * c[3] <= 200 * 200 * 4])
def test_flash_attention_backward_plan_computes_the_gradients(
        monkeypatch, B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, keys):
    """The plan's passes, run in float64 through the scratch as the
    kernels run them (slabs, splits, the dQ writes and adds), give the
    plain version's gradients, and every dQ row is written."""
    plan = _k4_bwd_plan(monkeypatch, B, Sq, Sk, Hq, Hkv, hd, sms, keys)
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                               (B, Sk, Hkv, hd), (B, Sq, Hq, hd)))
    got = _emulate_bwd(q, k, v, dout, causal, window, plan)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       window=window)
    for name, g, w in zip("qkv", got, want):
        assert not torch.isnan(g).any(), f"d{name}"
        scale = w.abs().max()
        torch.testing.assert_close(g.float() / scale, w / scale, rtol=0,
                                   atol=2e-5, msg=f"d{name}")


# K4's bf16 backward (csrc/flash_attention_bwd_bf16.cu): the plan at
# element size 2, and its passes at the kernels' cast points
BF16 = 2
#: CUDA's grid extents (x, y, z)
GRID_MAX = (2 ** 31 - 1, 65535, 65535)
#: each bf16 gradient against the plain version's as a share of its
#: largest element: chip_smoke.py's K4_BWD_BF16_TOL, the card's tolerance
K4_BWD_BF16_TOL = 2e-2


@pytest.mark.parametrize("B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, "
                         "keys", K4_BWD_PLANS)
def test_flash_attention_bf16_backward_plan_covers_every_pair_once(
        B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, keys):
    """The bf16 plan is one pass over every key: (b) visits every visible
    (key tile, query tile, head) once, each query head of a group in
    exactly one split, and (c) every visible (query tile, key tile) of
    every head once, in ascending key order; the grids lie within CUDA's
    extents and the shared memory within a block's. (The fp32 scratch
    budget, ``keys``, does not bind a plan that has no scratch.)"""
    plan = k4.backward_plan(B, Sq, Sk, Hq, Hkv, hd, sms, BF16)
    bk, T, rep = plan.block_keys, k4.QUERY_TILE, Hq // Hkv
    assert plan.n_slabs == 1 and Sk <= plan.slab_keys < Sk + bk
    assert rep % plan.splits == 0
    assert max(plan.smem.values()) <= k4.MAX_SMEM
    for grids in plan.grids.values():
        for grid in grids:
            assert all(0 < g <= m for g, m in zip(grid, GRID_MAX))
    vis = _visible(Sq, Sk, causal, window)
    want = {(qt, k0) for qt in range(plan.query_tiles)
            for k0 in range(0, Sk, bk)
            if vis[qt * T:(qt + 1) * T, k0:k0 + bk].any()}
    (lo, dkdv, dq), = _k4_bwd_blocks(plan, B, Sq, Sk, Hq, Hkv, causal,
                                     window)
    visits, heads = {}, {}
    for z, k0, hk, split, hs, pairs in dkdv:
        for h in hs:
            heads[(z, k0, h)] = heads.get((z, k0, h), 0) + 1
        for h, qt in pairs:
            visits[(z, h, qt, k0)] = visits.get((z, h, qt, k0), 0) + 1
    assert set(heads) == {(z, k0, h) for z in range(B)
                          for k0 in range(0, Sk, bk) for h in range(Hq)}
    assert set(heads.values()) == {1} and set(visits.values()) == {1}
    for z in range(B):
        for h in range(Hq):
            assert {(qt, k0) for (zz, hh, qt, k0) in visits
                    if (zz, hh) == (z, h)} == want
    seen = {}
    for z, h, qt, tiles, add in dq:
        assert not add and (z, h, qt) not in seen
        seen[(z, h, qt)] = tiles
    assert set(seen) == {(z, h, qt) for z in range(B) for h in range(Hq)
                         for qt in range(plan.query_tiles)}
    for (z, h, qt), tiles in seen.items():
        assert tiles == sorted({k0 for q, k0 in want if q == qt})


@pytest.mark.parametrize("hd", range(16, 257, 16))
def test_flash_attention_bf16_backward_shared_memory_fits_every_head_size(
        hd):
    """(b) holds bf16 K and V tiles, two stages of Q and dO tiles with
    their L and D, and the P^T, dS^T hi and dS^T lo exchange tiles (keys x
    64 queries); (c) Q and dO tiles, two stages of K and V tiles and the dS
    hi and lo exchange tiles (64 rows x keys); rows padded by 16 bytes:
    both fit a block's shared memory at every head size; the key tiles
    are the fp32 backward's (64 keys, 32 above hd 128)."""
    dkdv, stages, dq = k4.backward_smem(hd, BF16)
    bk, row = k4.backward_block_keys(hd), 2 * (hd + 8)
    assert stages == 2
    assert dkdv == 2 * bk * row + 2 * (2 * 64 * row + 2 * 64 * 4) + \
        3 * bk * 2 * 72
    assert dq == (2 * 64 + 4 * bk) * row + 2 * 64 * 2 * (bk + 8)
    assert max(dkdv, dq) <= k4.MAX_SMEM
    plan = k4.backward_plan(1, 100, 100, 2, 1, hd, 132, BF16)
    assert (plan.block_keys, plan.stages) == (bk, 2)
    assert plan.smem == {"dkdv": dkdv, "dq": dq}
    assert plan.launch[4:6] == (dkdv, dq)
    # the fp32 plan keeps its own
    assert k4.backward_plan(1, 100, 100, 2, 1, hd, 132).smem == {
        "dkdv": k4.backward_smem(hd)[0], "dq": k4.backward_smem(hd)[2]}


def test_flash_attention_bf16_backward_plans_at_the_training_shapes():
    """The three shapes of bf16 training's main path: qwen3-0.6b's and
    whisper-medium's encoder run one split and no scratch at all (the
    request is delta and the bf16 gradients: 33,816,576 bytes at qwen3's
    shape, against 235,143,168 for the first bf16 design, which wrote scale
    dS to a scratch between its passes); recurrentgemma-9b's
    (hd 256, one KV head) 8 splits, 32-key tiles and the fp32 partials."""
    p = k4.backward_plan(8, 512, 512, 16, 8, 128, 132, BF16)
    assert (p.block_keys, p.splits, p.n_slabs, p.stages) == (64, 1, 1, 2)
    assert p.grids == {"delta": ((8 * 512 * 16 // 4, 1, 1),),
                       "dkdv": ((8, 8, 8),), "dq": ((16, 8, 8),),
                       "reduce": ()}
    assert p.scratch == {} and p.scratch_bytes() == 0
    assert p.smem == {"dkdv": 133120, "dq": 122880}
    grads = 2 * (8 * 512 * 16 * 128 + 2 * 8 * 512 * 8 * 128)
    assert grads + 4 * 8 * 16 * 512 == 33816576
    p = k4.backward_plan(8, 1500, 1500, 16, 16, 64, 132, BF16)
    assert (p.block_keys, p.splits, p.slab_keys, p.n_slabs) == \
        (64, 1, 1536, 1)
    assert p.grids["dkdv"] == ((16, 8, 24),)
    assert p.grids["dq"] == ((16, 8, 24),) and p.scratch == {}
    p = k4.backward_plan(4, 512, 512, 16, 1, 256, 132, BF16)
    assert (p.block_keys, p.splits, p.n_slabs) == (32, 8, 1)
    assert p.grids["dkdv"] == ((8, 4, 16),) and p.grids["dq"] == (
        (16, 4, 8),)
    assert p.grids["reduce"] == ((512, 2, 1),)
    assert p.scratch == {"part": (2, 8, 4, 512, 1, 256)}
    assert p.scratch_bytes() == 33554432
    assert p.smem == {"dkdv": 183808, "dq": 145408}


def _round_bf16(x):
    return x.bfloat16().float()


def _split_bf16(x):
    """(hi, lo): hi = bf16(x), lo = bf16(x - hi), as fp32."""
    hi = _round_bf16(x)
    return hi, _round_bf16(x - hi)


def test_bf16_split_carries_sixteen_bits():
    """hi + lo = x within 2^-17 |x| (normal fp32 values), so hi^T Q + lo^T
    Q is the fp32 dS's product within 2^-16 of each term."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100000) *
                          np.exp(rng.uniform(-20, 20, 100000)))
                         .astype(np.float32))
    hi, lo = _split_bf16(x)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert (rest <= x.double().abs() * 2.0 ** -17).all()
    assert ((x.double() - hi.double()).abs() > x.double().abs() *
            2.0 ** -10).any()    # a bf16 dS alone would not do


def _emulate_bwd_bf16(q, k, v, dout, causal, window, plan):
    """dq, dk, dv (bf16) by the bf16 plan's passes, tile by tile, at the
    kernels' cast points: the forward's bf16 out and fp32 L; D = rowsum
    (dO o O) of the bf16 O; (b) per block, for each query head of its
    split and each query tile of its band, in order: P = exp(scale S - L)
    (fp32 sums of the bf16 products), dV += bf16(P)^T dO, dP = bf16(dO
    V^T), dS = scale P (dP - D), dK += hi^T Q + lo^T Q (dS = hi + lo in
    bf16), each block's sums in fp32, rounded to bf16 once or written as
    a split's fp32 partial and summed in split order; (c) per (head, query
    tile), its key tiles in ascending order: S, P, dP, dS again, dQ += hi
    K + lo K, rounded once."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep, bk, T = Hq // Hkv, plan.block_keys, k4.QUERY_TILE
    scale = 1.0 / np.sqrt(hd)
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    vis = torch.from_numpy(_visible(Sq, Sk, causal, window))
    s_all = torch.einsum("bqhd,bkhd->bhqk", qf,
                         kf.repeat_interleave(rep, dim=2)) * scale
    lse = torch.logsumexp(torch.where(vis, s_all, -1e30), dim=-1)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)
    nq, nk = plan.query_tiles * T, -(-Sk // bk) * bk

    def pad(t, n):
        return torch.cat([t, t.new_zeros((t.shape[0], n - t.shape[1]) +
                                         t.shape[2:])], dim=1)
    qp, gp, kp, vp = pad(qf, nq), pad(gf, nq), pad(kf, nk), pad(vf, nk)
    lp = torch.cat([lse, lse.new_zeros(B, Hq, nq - Sq)], dim=2)
    dp_ = torch.cat([delta, delta.new_zeros(B, Hq, nq - Sq)], dim=2)
    visp = torch.zeros((nq, nk), dtype=torch.bool)
    visp[:Sq, :Sk] = vis

    def tile(z, h, qt, k0):
        """P and the hi, lo of dS of one (query tile, key tile) pair."""
        rows, keys = slice(qt * T, (qt + 1) * T), slice(k0, k0 + bk)
        qt_, gt = qp[z, rows, h], gp[z, rows, h]
        kt, vt = kp[z, keys, h // rep], vp[z, keys, h // rep]
        p = torch.where(visp[rows, keys],
                        torch.exp(qt_ @ kt.T * scale - lp[z, h, rows, None]),
                        0.0)
        ds = scale * p * (_round_bf16(gt @ vt.T) - dp_[z, h, rows, None])
        return p, _split_bf16(ds)

    (_, dkdv, dqb), = _k4_bwd_blocks(plan, B, Sq, Sk, Hq, Hkv, causal,
                                     window)
    part = torch.zeros((2, plan.splits, B, Sk, Hkv, hd))
    for z, k0, hk, split, _, pairs in dkdv:
        acc = torch.zeros((2, bk, hd))
        for h, qt in pairs:
            p, (hi, lo) = tile(z, h, qt, k0)
            rows = slice(qt * T, (qt + 1) * T)
            acc[0] += hi.T @ qp[z, rows, h] + lo.T @ qp[z, rows, h]
            acc[1] += _round_bf16(p).T @ gp[z, rows, h]
        n = min(bk, Sk - k0)
        part[:, split, z, k0:k0 + n, hk] = acc[:, :n]
    dk, dv = part[0, 0], part[1, 0]
    for g in range(1, plan.splits):
        dk, dv = dk + part[0, g], dv + part[1, g]
    dq = torch.full((B, Sq, Hq, hd), float("nan"))
    for z, h, qt, tiles, add in dqb:
        acc = torch.zeros((T, hd))
        for k0 in tiles:
            _, (hi, lo) = tile(z, h, qt, k0)
            kt = kp[z, k0:k0 + bk, h // rep]
            acc += hi @ kt + lo @ kt
        n = min(T, Sq - qt * T)
        dq[z, qt * T:qt * T + n, h] = acc[:n]
    return tuple(t.bfloat16() for t in (dq, dk, dv))


@pytest.mark.parametrize("B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, "
                         "keys", [c for c in K4_BWD_PLANS
                                  if c[1] * c[2] * c[3] <= 200 * 200 * 4])
def test_flash_attention_bf16_backward_passes_compute_the_gradients(
        B, Sq, Sk, Hq, Hkv, hd, causal, window, sms, keys):
    """The bf16 plan's passes at the kernels' cast points (the hi + lo
    split of the fp32 dS included) give the plain version's bf16
    gradients (`repro`'s autograd of its plain attention at bf16) within
    the card's tolerance, and every dQ row is written."""
    plan = k4.backward_plan(B, Sq, Sk, Hq, Hkv, hd, sms, BF16)
    rng = np.random.default_rng(4)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32) * c).bfloat16() for s, c in (
        ((B, Sq, Hq, hd), 0.5), ((B, Sk, Hkv, hd), 0.5),
        ((B, Sk, Hkv, hd), 1.0), ((B, Sq, Hq, hd), 1.0)))
    got = _emulate_bwd_bf16(q, k, v, dout, causal, window, plan)
    want = ref.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       window=window)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        assert not torch.isnan(g.float()).any(), f"d{name}"
        scale = w.float().abs().max()
        err = float(((g.float() - w.float()) / scale).abs().max())
        assert err <= K4_BWD_BF16_TOL, f"d{name}: {err}"


# K5 shapes (b, l, H, p, n, L, h0): the serve shape, eight chunks, one
# ragged chunk (L 100), one tile (L 32), p 24 and n 4, p 128 with h0, a
# chunk of 65 rows (a one-row second tile)
K5_PLANS = [(4, 512, 32, 64, 128, 256, False),
            (1, 2048, 2, 64, 128, 256, False),
            (2, 100, 3, 64, 128, 100, False),
            (1, 128, 2, 16, 8, 32, False),
            (2, 128, 3, 24, 4, 64, True),
            (1, 256, 2, 128, 64, 128, True),
            (1, 130, 2, 10, 12, 65, True)]


def _chunk_blocks(plan, b, H):
    """What each block of ``ssd_chunk_kernel`` takes, in block order, as
    the kernel decodes ``blockIdx.x`` (``csrc/ssd.cu``): ``("state", b,
    head, chunk)`` for the first b H nc blocks, then ``("scores", b,
    chunk, qt, kt)``."""
    out = []
    for blk in range(plan.grids["chunk"][0]):
        if blk < b * H * plan.nc:
            i = blk % (b * H)
            out.append(("state", i // H, i % H, blk // (b * H)))
            continue
        j = blk - b * H * plan.nc
        tile, bc = j % plan.ntri, j // plan.ntri
        qt = 0
        while (qt + 1) * (qt + 2) // 2 <= tile:
            qt += 1
        out.append(("scores", bc // plan.nc, bc % plan.nc, qt,
                    tile - qt * (qt + 1) // 2))
    return out


def _output_blocks(plan, b, H):
    """(b, head, chunk, query tile) of each block of ``ssd_output_kernel``,
    in block order, as the kernel decodes ``blockIdx.x``: the last query
    tile (the most key tiles) first."""
    per_tile = b * H * plan.nc
    out = []
    for blk in range(plan.grids["output"][0]):
        rest = blk % per_tile
        bh = rest % (b * H)
        out.append((bh // H, bh % H, rest // (b * H),
                    plan.nt - 1 - blk // per_tile))
    return out


@pytest.mark.parametrize("b, l, H, p, n, L, h0", K5_PLANS)
def test_ssd_plan_covers_every_block_once(b, l, H, p, n, L, h0):
    """Pass 1 takes every (b, head, chunk) once and every causal pair of
    64-row tiles of every (b, chunk) once; pass 3 every (b, head, chunk,
    query tile) once, the tiles with the most key tiles first."""
    plan = k5.launch_plan(b, l, H, p, n, L)
    nc, nt = l // L, -(-L // k5.TILE)
    assert (plan.nc, plan.nt, plan.ntri) == (nc, nt, nt * (nt + 1) // 2)
    # the values the kernels launch with (ssd_f32's grid)
    assert plan.launch == (plan.grids["chunk"][0], plan.smem["chunk"],
                           *plan.grids["pass"], plan.grids["output"][0],
                           plan.smem["output"])
    blocks = _chunk_blocks(plan, b, H)
    assert len(blocks) == plan.grids["chunk"][0]
    states = [blk[1:] for blk in blocks if blk[0] == "state"]
    scores = [blk[1:] for blk in blocks if blk[0] == "scores"]
    assert sorted(states) == [(bi, hh, c) for bi in range(b)
                              for hh in range(H) for c in range(nc)]
    assert sorted(scores) == [(bi, c, qt, kt) for bi in range(b)
                              for c in range(nc) for qt in range(nt)
                              for kt in range(qt + 1)]
    out = _output_blocks(plan, b, H)
    assert len(out) == plan.grids["output"][0]
    assert sorted(out) == [(bi, hh, c, qt) for bi in range(b)
                           for hh in range(H) for c in range(nc)
                           for qt in range(nt)]
    assert [qt for *_, qt in out] == sorted((qt for *_, qt in out),
                                            reverse=True)
    gx, gy = plan.grids["pass"]
    assert gx == b * H and \
        gy * k5.PASS_THREADS * k5.PASS_VALUES >= n * plan.pw


def _parent_smem(p, n, L):
    """Shared memory of the parent design's one block per (b, head): the
    state, C and B tiles padded to n + 4 floats, an x tile, a score tile
    and the chunk's prefix sums; it refused a chunk that overflowed."""
    pw = 16 * next(c for c in (1, 2, 4, 8) if 16 * c >= p)
    ns = n + 4
    return 4 * (pw * ns + 2 * 64 * ns + 64 * pw + 64 * 68 + L)


@pytest.mark.parametrize("p", [1, 10, 16, 24, 63, 64, 65, 100, 127, 128])
def test_ssd_plan_shared_memory_fits_every_accepted_shape(p):
    """Each kernel's shared memory depends on p alone and fits a block at
    every p; at p <= 64 two blocks of pass 1 and three of pass 3 fit an
    SM (228 KB, 1 KB reserved a block), as the kernels' launch bounds
    assume. Every
    (p, n, chunk) the parent design took is still taken, and longer
    chunks too: no workspace lives in shared memory."""
    smem = k5.smem_bytes(p)
    assert max(smem.values()) <= k5.MAX_SMEM
    if p <= 64:
        assert 2 * (smem["chunk"] + 1024) <= 233472
        assert 3 * (smem["output"] + 1024) <= 233472
    for n in (4, 8, 64, 124, 128):
        for L in (1, 64, 100, 256, 4096, 20224, 51583):
            if _parent_smem(p, n, L) <= k5.MAX_SMEM:
                plan = k5.launch_plan(1, L, 2, p, n, L)
                assert plan.smem == smem
    assert k5.launch_plan(1, 16384, 1, 128, 128, 16384).nt == 256


def test_ssd_plan_refuses_a_grid_past_cuda_extent():
    with pytest.raises(ValueError, match="grid"):
        k5.launch_plan(2 ** 16, 2 ** 16, 2 ** 10, 64, 128, 64)


def _emulate_ssd(x, dA, B, C, L, h0):
    """The three passes as the kernels split them, in float64 through the
    plan's block lists and workspace layouts: pass 1 writes the prefix
    sums, the transposed chunk states and the score tiles; pass 2 turns
    each state slot, in place, into the state entering its chunk; pass 3
    reads only the workspaces and x. Workspace entries no block writes
    stay NaN, so a gap in the plan shows in the result. The decays are
    applied as pass 3 applies them: e^{cum_i0} on the carried-in sums,
    off the diagonal a factor per key row and, once, one per query
    row."""
    b, l, H, p = x.shape
    n = B.shape[-1]
    T = k5.TILE
    plan = k5.launch_plan(b, l, H, p, n, L)
    nan = float("nan")
    cum = torch.full(plan.workspace["cum"], nan, dtype=torch.float64)
    scores = torch.full(plan.workspace["scores"], nan, dtype=torch.float64)
    states = torch.full(plan.workspace["states"], nan, dtype=torch.float64)
    ct = torch.full(plan.workspace["ct"], nan, dtype=torch.float64)
    for blk in _chunk_blocks(plan, b, H):
        if blk[0] == "state":
            _, bi, hh, c = blk
            t = slice(c * L, c * L + L)
            cs = torch.cumsum(dA[bi, t, hh], 0)
            cum[bi, hh, t] = cs
            xd = x[bi, t, hh] * torch.exp(cs[-1] - cs)[:, None]
            states[bi, c, hh] = 0.0
            states[bi, c, hh, :, :p] = B[bi, t].T @ xd
        else:
            _, bi, c, qt, kt = blk
            q0, k0 = c * L + qt * T, c * L + kt * T
            rq, rk = min(T, L - qt * T), min(T, L - kt * T)
            g = torch.zeros((T, T), dtype=torch.float64)
            g[:rq, :rk] = C[bi, q0:q0 + rq] @ B[bi, k0:k0 + rk].T
            scores[bi, c, qt * (qt + 1) // 2 + kt] = g.T   # keys by queries
            if qt == kt:
                ct[bi, c, qt] = 0.0
                ct[bi, c, qt, :, :rq] = C[bi, q0:q0 + rq].T
    h_last = torch.full((b, H, p, n), nan, dtype=torch.float64)
    for bi in range(b):
        for hh in range(H):
            h = torch.zeros((n, plan.pw), dtype=torch.float64)
            if h0 is not None:
                h[:, :p] = h0[bi, hh].T
            for c in range(plan.nc):
                s = states[bi, c, hh].clone()
                states[bi, c, hh] = h
                h = torch.exp(cum[bi, hh, c * L + L - 1]) * h + s
            h_last[bi, hh] = h[:, :p].T
    y = torch.full(x.shape, nan, dtype=torch.float64)
    for bi, hh, c, qt in _output_blocks(plan, b, H):
        i0 = c * L + qt * T
        rq = min(T, L - qt * T)
        cq = cum[bi, hh, i0:i0 + rq]
        acc = torch.zeros((rq, p), dtype=torch.float64)
        if c > 0 or h0 is not None:   # carried in, times e^{cum_i0}
            acc += ct[bi, c, qt, :, :rq].T @ states[bi, c, hh, :, :p]
            acc *= torch.exp(cq[0])
        tri = qt * (qt + 1) // 2
        for kt in range(qt + 1):
            j0 = c * L + kt * T
            rk = min(T, L - kt * T)
            ck = cum[bi, hh, j0:j0 + rk]
            G = scores[bi, c, tri + kt, :rk, :rq].T
            xk = x[bi, j0:j0 + rk, hh]
            if kt < qt:   # off the diagonal: the decay as column factors
                acc += G @ (torch.exp(cq[0] - ck)[:, None] * xk)
                continue
            # and row factors, once; the diagonal decayed pair by pair
            acc *= torch.exp(cq - cq[0])[:, None]
            acc += torch.tril(G * torch.exp(cq[:, None] - ck[None, :])) @ xk
        y[bi, i0:i0 + rq, hh] = acc
    return y, h_last


@pytest.mark.parametrize("b, l, H, p, n, L, h0", K5_PLANS[1:])
def test_ssd_plan_computes_the_scan(b, l, H, p, n, L, h0):
    """The plan's split of the work, run in float64, is the plain
    version's scan: nothing is missed or taken twice (serve-shape blocks
    are covered by the test above; its scan would take minutes here)."""
    rng = np.random.default_rng(7)
    dt = np.logaddexp(rng.standard_normal((b, l, H)), 0.0)
    x = torch.from_numpy(rng.standard_normal((b, l, H, p)) * 0.3 * dt[
        ..., None])
    dA = torch.from_numpy(-dt)
    Bm = torch.from_numpy(rng.standard_normal((b, l, n)) * 0.3)
    Cm = torch.from_numpy(rng.standard_normal((b, l, n)) * 0.3)
    h = torch.from_numpy(rng.standard_normal((b, H, p, n)) * 0.5) \
        if h0 else None
    y, hl = _emulate_ssd(x, dA, Bm, Cm, L, h)
    wy, wh = ref.ssd_ref(x, dA, Bm, Cm, L, h)
    torch.testing.assert_close(y, wy, atol=1e-10, rtol=1e-10)
    torch.testing.assert_close(hl, wh, atol=1e-10, rtol=1e-10)


def test_ssd_copies_in_16_byte_pieces_only_where_every_row_is_aligned():
    """`aligned16`: the base address and every stride of an axis longer
    than 1, in 16-byte units; the model's B and C, column slices of its
    (b, l, d_in + 2n) projection at mamba2-370m's widths, are aligned."""
    xBC = torch.empty((2, 8, 2048 + 2 * 128))
    B, C = xBC[..., 2048:2176], xBC[..., 2176:]
    assert k5.aligned16(B, (0, 1)) and k5.aligned16(C, (0, 1))
    x = torch.empty((2, 8, 3, 10))               # p 10: rows 40 bytes
    assert x.data_ptr() % 16 == 0 and not k5.aligned16(x, (0, 1, 2))
    padded = torch.empty((2, 8, 3, 12))[..., :10]  # rows 48 bytes apart
    assert k5.aligned16(padded, (0, 1, 2))
    odd = torch.empty(2 * 8 * 12 + 1)[1:].view(2, 8, 12)   # one float in
    assert not k5.aligned16(odd, (0, 1))
    # a stride of an axis of extent 1 is never stepped
    assert k5.aligned16(torch.empty((1, 8, 1, 10)), (0, 1, 2)) is False
    assert k5.aligned16(torch.empty((1, 1, 1, 10)), (0, 1, 2))


def test_ssd_kernel_flops_at_the_serve_shape():
    """The kernels' work at mamba2-370m's serve shape: at most 3.1 GFLOP
    (the parent design did 6.17), against the least work's 2.76."""
    f = k5.kernel_flops(4, 512, 32, 64, 128, 256, False)
    assert f["total"] == f["scores"] + f["states"] + f["intra"] + \
        f["carried"]
    assert 2.76e9 < f["total"] <= 3.1e9
    # scores once per (b, chunk): 4 x 2 x 10 tile pairs of 64 x 64 x 128
    assert f["scores"] == 4 * 2 * 10 * 64 * 64 * 128 * 2
    # no carried-in product in the first chunk without h0
    assert f["carried"] == 4 * 32 * 1 * 256 * 128 * 64 * 2


@pytest.mark.parametrize("b, l, H, p, n, L, h0", K5_PLANS)
def test_ssd_kernel_flops_count_the_launched_blocks(b, l, H, p, n, L, h0):
    """`ssd.kernel_flops`' closed form is the sum, over the blocks the
    plan launches, of what each block's loops run: a state block every
    key tile at n padded to 128, a score block one 64 x 64 tile at n,
    an output block C hᵀ where a state enters its chunk, its whole key
    tiles off the diagonal, and on it each warp's 16 rows up to the
    warp's last row."""
    plan = k5.launch_plan(b, l, H, p, n, L)
    T, pw = k5.TILE, plan.pw
    want = dict(scores=0, states=0, intra=0, carried=0)
    for blk in _chunk_blocks(plan, b, H):
        if blk[0] == "state":
            want["states"] += 2 * plan.nt * T * pw * k5.MAX_STATE
        else:
            want["scores"] += 2 * T * T * n
    for _, _, c, qt in _output_blocks(plan, b, H):
        if c > 0 or h0:
            want["carried"] += 2 * T * n * pw
        want["intra"] += 2 * qt * T * T * pw
        want["intra"] += 2 * sum(16 * min(T, 16 * (w + 1)) * pw
                                 for w in range(k5.THREADS // 32))
    want["total"] = sum(want.values())
    assert k5.kernel_flops(b, l, H, p, n, L, h0) == want


# ------------------------------------------------- K5's backward (ssd_bwd)

# shapes for the backward's plan beside K5_PLANS: one head (a dx block
# with an empty second half), 3 heads (one pair and a single), 17 heads
# (a second W group of one head), n 100 (a ragged second column block)
K5_BWD_PLANS = [(1, 128, 1, 32, 16, 64, True),
                (2, 128, 3, 16, 12, 128, False),
                (1, 192, 17, 8, 8, 64, True),
                (1, 160, 2, 24, 100, 80, True)]


def _bwd_blocks(plan, b, H):
    """What each block of the backward's six launches takes, in block
    order, as ``csrc/ssd_bwd.cu`` decodes ``blockIdx``: ``chunk``:
    ("dstate", b, head, chunk), then ("scores", b, chunk, it, jt);
    ``pass``: (b, head, y); ``state``: (kind, b, chunk, tile, head group,
    column block); ``dx``: (b, chunk, jt, (heads of the pair)), key tile 0
    first; ``w``: (b, chunk, it, jt, group); ``final``: ("dC" or "dB", b,
    chunk, tile, column block), then ("dlogA", b, head, chunk)."""
    bh = b * H
    nc, nt, nh, hp, sg = plan.nc, plan.nt, plan.nh, plan.hp, plan.sg

    def pair(tile):
        it = 0
        while (it + 1) * (it + 2) // 2 <= tile:
            it += 1
        return it, tile - it * (it + 1) // 2
    out = {"chunk": [], "pass": [], "state": [], "dx": [], "w": [],
           "final": []}
    for blk in range(plan.grids["chunk"][0]):
        if blk < bh * nc:
            i = blk % bh
            out["chunk"].append(("dstate", i // H, i % H, blk // bh))
        else:
            j = blk - bh * nc
            bc = j // plan.ntri
            out["chunk"].append(("scores", bc // nc, bc % nc,
                                 *pair(j % plan.ntri)))
    for x in range(plan.grids["pass"][0]):
        for y in range(plan.grids["pass"][1]):
            out["pass"].append((x // H, x % H, y))
    for blk in range(plan.grids["state"][0]):
        q, rest = blk % nh, blk // nh
        t, rest = rest % nt, rest // nt
        g, rest = rest % sg, rest // sg
        kind, bc = rest % 2, rest // 2
        out["state"].append((kind, bc // nc, bc % nc, t, g, q))
    for j in range(plan.grids["dx"][0]):
        jt, rest = j // (b * nc * hp), j % (b * nc * hp)
        c, rest = rest // (b * hp), rest % (b * hp)
        h0 = (rest % hp) * 2
        out["dx"].append((rest // hp, c, jt, tuple(range(h0, min(h0 + 2, H)))))
    for j in range(plan.grids["w"][0]):
        rest = j // plan.ntri
        bc = rest // plan.groups
        out["w"].append((bc // nc, bc % nc, *pair(j % plan.ntri),
                         rest % plan.groups))
    n_bc = 2 * nh * b * nc * nt
    for blk in range(plan.grids["final"][0]):
        if blk < n_bc:
            rest = blk >> 1
            q, rest = rest % nh, rest // nh
            t, bc = rest % nt, rest // nt
            out["final"].append(("dC" if blk % 2 == 0 else "dB",
                                 bc // nc, bc % nc, t, q))
        else:
            j = blk - n_bc
            out["final"].append(("dlogA", (j % bh) // H, (j % bh) % H,
                                 j // bh))
    return out


@pytest.mark.parametrize("b, l, H, p, n, L, h0", K5_PLANS + K5_BWD_PLANS)
def test_ssd_backward_plan_covers_every_block_once(b, l, H, p, n, L, h0):
    """Each kind of block of the backward takes its unit of work once:
    every (b, head, chunk) for the dh_in terms and d dlogA; every (b,
    chunk, tile, column block) for dC and dB, and with every group of 8
    heads for each kind of state block; every (b, head, chunk, key tile)
    for dx, two heads a block (the last alone where H is odd), key tile
    0 (the most query tiles) first; every causal tile pair of every (b,
    chunk) for the scores, and with every group of 8 heads for W."""
    plan = k5.backward_plan(b, l, H, p, n, L)
    blocks = _bwd_blocks(plan, b, H)
    heads = [(bi, hh, c) for bi in range(b) for hh in range(H)
             for c in range(plan.nc)]
    pairs = [(bi, c, it, jt) for bi in range(b) for c in range(plan.nc)
             for it in range(plan.nt) for jt in range(it + 1)]
    tiles = [(bi, c, t, q) for bi in range(b) for c in range(plan.nc)
             for t in range(plan.nt) for q in range(plan.nh)]
    chunk, final = blocks["chunk"], blocks["final"]
    assert sorted(k[1:] for k in chunk if k[0] == "dstate") == sorted(heads)
    assert sorted(k[1:] for k in chunk if k[0] == "scores") == sorted(pairs)
    assert sorted(blocks["pass"]) == sorted(
        (bi, hh, y) for bi in range(b) for hh in range(H)
        for y in range(plan.ny))
    for kind in (0, 1):
        assert sorted(k[1:] for k in blocks["state"] if k[0] == kind) == \
            sorted(t[:3] + (g, t[3]) for t in tiles for g in range(plan.sg))
    dx = blocks["dx"]
    assert all(len(hs) == (2 if hs[0] + 1 < H else 1) for *_, hs in dx)
    assert sorted((bi, hh, c, jt) for bi, c, jt, hs in dx for hh in hs) == \
        sorted(h + (t,) for h in heads for t in range(plan.nt))
    assert [k[2] for k in dx] == sorted(k[2] for k in dx)
    assert sorted(blocks["w"]) == sorted(
        p_ + (g,) for p_ in pairs for g in range(plan.groups))
    for kind in ("dC", "dB"):
        assert sorted(k[1:] for k in final if k[0] == kind) == sorted(tiles)
    assert sorted(k[1:] for k in final if k[0] == "dlogA") == sorted(heads)
    assert plan.groups * k5.BWD_GROUP_HEADS >= H > \
        (plan.groups - 1) * k5.BWD_GROUP_HEADS
    assert plan.hp == -(-H // 2) and plan.nh * k5.BWD_COLS >= n > \
        (plan.nh - 1) * k5.BWD_COLS
    assert plan.sg * k5.BWD_STATE_HEADS >= H > \
        (plan.sg - 1) * k5.BWD_STATE_HEADS
    # the pass blocks cover the (n, pw) transposed state
    assert plan.ny * k5.PASS_THREADS * k5.PASS_VALUES >= n * plan.pw


@pytest.mark.parametrize("p", [1, 64, 65, 128])
def test_ssd_backward_shared_memory_fits_and_matches_the_carve_up(p):
    """The shared memory each backward kernel launches with: what
    ``csrc/ssd_bwd.cu`` carves out (the chunk kernel's C and dy tiles two
    deep or its C and B score tiles; the main kernel's state block (dy or
    x and h_in^T or g^T tiles with their rows' cum, two stages), dx block
    (the shared A tiles and each half's X tiles and cum, two stages; the
    halves' key cum) or W block (the pair's score tile, the warps' column
    sums, the tile its halves exchange, two stages of dy and x tiles with
    both rows' cum); the final
    kernel's W tile
    and 64 columns of B or C), within what a block may opt in to on
    Hopper; at p <= 64 two main blocks (16 warps) fit an SM's 228 KB."""
    plan = k5.backward_plan(1, 64, 1, p, 128, 64)
    pw = plan.pw
    fp = pw + 4
    state = 2 * (2 * 64 * fp + 64)
    dx = 2 * 64 * 68 + 4 * 64 * pw + 4 * 64 + 2 * 64
    w = 64 * 72 + 8 * 64 + 64 * 72 + 2 * (2 * 64 * fp + 2 * 64)
    assert plan.smem == {
        "chunk": 4 * max(2 * 64 * 128 + 2 * 64 * pw, 2 * 64 * 132),
        "state": 4 * state, "dx": 4 * dx, "w": 4 * w,
        "final": 4 * (64 * 68 + 64 * 64)}
    assert max(plan.smem.values()) <= k5.MAX_SMEM
    if pw == 64:   # 1 KB of each block's is the system's
        for kind in ("state", "dx", "w"):
            assert 2 * (plan.smem[kind] + 1024) <= 228 * 1024
    src = _build_src("ssd_bwd.cu")
    for carve in ("float* y_s = c_s + 2 * kT * kN;  // [2][kT][PW]",
                  "constexpr int kStage = 2 * kT * FP + kT;",
                  "float* x_s = g_s + 2 * kT * kGP;  // [2][2][kT][PW]",
                  "float* ck_s = x_s + 4 * kT * PW;  // [2][2][kT]",
                  "float* cq_s = ck_s + 4 * kT;      // [2][kT]",
                  "constexpr int kStage = 2 * kT * FP + 2 * kT;",
                  "float* red_s = s_s + kT * kSP;",
                  "float* x_s = red_s + kMainWarps * kT;",
                  "float* ring = x_s + kT * kXP;",
                  "kSP = kT + 8;", "kXP = kT + 8;",
                  "float* m_s = w_s + kT * kGP;  // [kT][kNH]",
                  "constexpr int kGroupHeads = 8;",
                  "constexpr int kStateHeads = 8;",
                  "constexpr int kMainThreads = 256;",
                  "constexpr int kNH = 64;",
                  "__launch_bounds__(kMainThreads, PW <= 64 ? 2 : 1)"):
        assert carve in src, carve
    assert k5.BWD_MAIN_THREADS == 256 and k5.BWD_COLS == 64


def _build_src(name):
    from repro_torch.kernels import _build
    return (_build.CSRC / name).read_text()


def test_ssd_backward_plan_at_the_train_shape():
    """mamba2-370m at B 8, S 512: 672 / (256, 4) / 1,024 state (half of
    them with no state to sum) / 1,024 dx / 640 W / 768 blocks, 4 head
    groups of 8 for W and for the state terms, 16 head pairs, and
    53 MB of workspaces, the largest `dst` and `sd` (16.8 MB each): no
    (b, l, H, n) head-sum workspace (134 MB of them at this shape);
    9.01 GFLOP of least work without h0 or dh_last."""
    plan = k5.backward_plan(8, 512, 32, 64, 128, 256)
    assert plan.grids == {"chunk": (672, 1), "pass": (256, 4),
                          "state": (1024, 1), "dx": (1024, 1), "w": (640, 1),
                          "final": (768, 1)}
    assert (plan.groups, plan.ny, plan.nh, plan.hp, plan.sg) == \
        (4, 4, 2, 16, 4)
    assert plan.launch == (672, plan.smem["chunk"], 256, 4,
                           1024, plan.smem["state"], 1024, plan.smem["dx"],
                           640, plan.smem["w"], 768, plan.smem["final"])
    assert plan.scratch_bytes() == 4 * sum(
        -(-int(np.prod(s)) // 4) * 4 for s in plan.workspace.values())
    assert 53e6 < plan.scratch_bytes() < 54e6
    assert np.prod(plan.workspace["dst"]) == np.prod(plan.workspace["sd"])
    assert max(np.prod(s) for s in plan.workspace.values()) == \
        np.prod(plan.workspace["dst"])
    assert (8, 512, 32, 128) not in plan.workspace.values()
    assert plan.workspace["sd"] == (2, 4, 8, 512, 128)
    assert plan.workspace["sv"] == (8, 32, 512, 2, 2)
    f = k5.backward_flops(8, 512, 32, 64, 128, 256, False, False)
    assert f["total"] == sum(v for k, v in f.items() if k != "total")
    assert 9.0e9 < f["total"] < 9.02e9
    # h0 and dh_last add v, dh_in, dx's state term and w in one chunk each
    g = k5.backward_flops(8, 512, 32, 64, 128, 256, True, True)
    assert g["total"] - f["total"] == 4 * 8 * 32 * 256 * 2 * 128 * 64


@pytest.mark.parametrize("b, l, H, p, n, L, h0", K5_PLANS + K5_BWD_PLANS)
def test_ssd_backward_plan_has_no_per_head_state_workspace(b, l, H, p, n, L,
                                                          h0):
    """The head sums of dC's and dB's state terms never go through a
    (b, l, H, n) workspace: ``sd`` holds them summed over groups of 8
    heads, (2, sg, b, l, n), and per head only dcum's state terms (b, H,
    l, 2, nh) are kept."""
    plan = k5.backward_plan(b, l, H, p, n, L)
    assert set(plan.workspace) == set(k5.BWD_WORKSPACES)
    assert "vs" not in plan.workspace and "ws" not in plan.workspace
    assert plan.workspace["sd"] == (2, plan.sg, b, l, n)
    assert plan.workspace["sv"] == (b, H, l, 2, plan.nh)
    per_head = [s for s in plan.workspace.values()
                if len(s) == 4 and s[:3] == (b, l, H)]
    assert per_head == []
    assert np.prod(plan.workspace["sd"]) <= 2 * -(-H // 8) * b * l * n


def test_ssd_backward_plan_refuses_a_grid_past_cuda_extent():
    with pytest.raises(ValueError, match="grid"):
        k5.backward_plan(2 ** 16, 2 ** 16, 2 ** 10, 64, 128, 64)


def _emulate_ssd_bwd(x, dA, B, C, L, h0, dy, dhl):
    """The backward's six launches as ``csrc/ssd_bwd.cu`` splits them,
    in float64 through the plan's block lists and workspace layouts
    (workspace entries no block writes stay NaN, so a gap shows in the
    result), from the forward's workspaces (`_emulate_ssd`'s cum and the
    states entering each chunk). The decays are applied as the kernels
    apply them: in dx, the state sums times e^{Lam - cum_jl}, the query
    tiles' dy rows times e^{cum_i - cum_jl}, then the row factors
    e^{cum_jl - cum_j} before the diagonal tile; in W off the diagonal,
    the row and column factors around the key tile's last row."""
    b, l, H, p = x.shape
    n = B.shape[-1]
    T, NH = k5.TILE, k5.BWD_COLS
    f64 = dict(dtype=torch.float64)
    plan = k5.backward_plan(b, l, H, p, n, L)
    nc, nt, pw = plan.nc, plan.nt, plan.pw
    # the forward's workspaces
    cum = torch.cumsum(dA.reshape(b, nc, L, H), 2).permute(0, 3, 1, 2) \
        .reshape(b, H, l)
    st = torch.zeros((b, nc, H, n, pw), **f64)
    for bi in range(b):
        for hh in range(H):
            h = torch.zeros((n, pw), **f64)
            if h0 is not None:
                h[:, :p] = h0[bi, hh].T
            for c in range(nc):
                st[bi, c, hh] = h
                t = slice(c * L, c * L + L)
                cs = cum[bi, hh, t]
                xd = x[bi, t, hh] * torch.exp(cs[-1] - cs)[:, None]
                h = torch.exp(cs[-1]) * h
                h[:, :p] += B[bi, t].T @ xd
    w = {k: torch.full(s, float("nan"), **f64)
         for k, s in plan.workspace.items()}
    blocks = _bwd_blocks(plan, b, H)

    def rows(t):
        return min(T, L - t * T)

    def has_h(c):
        return c > 0 or h0 is not None

    def has_g(c):
        return c < nc - 1 or dhl is not None
    for blk in blocks["chunk"]:
        if blk[0] == "dstate":
            _, bi, hh, c = blk
            if c == 0 and h0 is None:
                continue
            t = slice(c * L, c * L + L)
            yd = dy[bi, t, hh] * torch.exp(cum[bi, hh, t])[:, None]
            w["dst"][bi, c, hh] = 0.0
            w["dst"][bi, c, hh, :, :p] = C[bi, t].T @ yd
        else:
            _, bi, c, it, jt = blk
            i0, j0 = c * L + it * T, c * L + jt * T
            g = torch.zeros((T, T), **f64)
            g[:rows(it), :rows(jt)] = C[bi, i0:i0 + rows(it)] @ \
                B[bi, j0:j0 + rows(jt)].T
            w["sc"][bi, c, it * (it + 1) // 2 + jt] = g
            if it == jt:
                w["bt"][bi, c, jt] = 0.0
                w["bt"][bi, c, jt, :, :rows(jt)] = B[bi, j0:j0 + rows(jt)].T
    dh0 = None if h0 is None else torch.full(h0.shape, float("nan"), **f64)
    for bi, hh, y in blocks["pass"]:
        if y:
            continue   # one emulated block carries a (b, head) whole
        g = torch.zeros((n, pw), **f64)
        if dhl is not None:
            g[:, :p] = dhl[bi, hh].T
        for c in reversed(range(nc)):
            term = w["dst"][bi, c, hh].clone() if c > 0 or h0 is not None \
                else torch.zeros((n, pw), **f64)
            dec = torch.exp(cum[bi, hh, c * L + L - 1])
            w["lam"][bi, hh, c] = 0.0
            w["lam"][bi, hh, c, 0] = dec * (g * st[bi, c, hh]).sum()
            w["dst"][bi, c, hh] = g
            g = dec * g + term
        if dh0 is not None:
            dh0[bi, hh] = g[:, :p].T
    dx = torch.full(x.shape, float("nan"), **f64)
    main = [("state",) + k for k in blocks["state"]] + \
        [("dx",) + k for k in blocks["dx"]] + [("W",) + k for k in blocks["w"]]
    for blk in main:
        if blk[0] == "state":
            _, kind, bi, c, t, sgi, q = blk
            if not (has_h(c) if kind == 0 else has_g(c)):
                continue
            t0, rt = c * L + t * T, rows(t)
            cols = slice(q * NH, min(n, q * NH + NH))
            acc = 0.0
            for hh in range(sgi * k5.BWD_STATE_HEADS,
                            min(H, (sgi + 1) * k5.BWD_STATE_HEADS)):
                cs = cum[bi, hh, t0:t0 + rt]
                if kind == 0:
                    f = dy[bi, t0:t0 + rt, hh] @ \
                        st[bi, c, hh, cols, :p].T
                    u = torch.exp(cs)[:, None] * f
                    m = C[bi, t0:t0 + rt, cols]
                else:
                    f = x[bi, t0:t0 + rt, hh] @ \
                        w["dst"][bi, c, hh, cols, :p].T
                    lam = cum[bi, hh, c * L + L - 1]
                    u = torch.exp(lam - cs)[:, None] * f
                    m = B[bi, t0:t0 + rt, cols]
                w["sv"][bi, hh, t0:t0 + rt, kind, q] = (u * m).sum(1)
                acc = acc + u
            w["sd"][kind, sgi, bi, t0:t0 + rt, cols] = acc
        elif blk[0] == "dx":
            _, bi, c, jt, hs = blk
            for hh in hs:
                j0, rj = c * L + jt * T, rows(jt)
                cq = cum[bi, hh, j0:j0 + rj]
                lam, cl = cum[bi, hh, c * L + L - 1], cq[-1]
                acc = torch.zeros((rj, p), **f64)
                if has_g(c):
                    acc += w["bt"][bi, c, jt, :, :rj].T @ \
                        w["dst"][bi, c, hh, :, :p]
                    acc *= torch.exp(lam - cl)
                for it in range(nt - 1, jt - 1, -1):
                    i0, ri = c * L + it * T, rows(it)
                    ci = cum[bi, hh, i0:i0 + ri]
                    S = w["sc"][bi, c, it * (it + 1) // 2 + jt, :ri, :rj]
                    yi = dy[bi, i0:i0 + ri, hh]
                    if it > jt:
                        acc += S.T @ (torch.exp(ci - cl)[:, None] * yi)
                        continue
                    acc *= torch.exp(cl - cq)[:, None]
                    D = torch.tril(S * torch.exp(ci[:, None] - cq[None, :]))
                    acc += D.T @ yi
                dx[bi, j0:j0 + rj, hh] = acc
        else:
            _, bi, c, it, jt, grp = blk
            i0, j0 = c * L + it * T, c * L + jt * T
            ri, rj = rows(it), rows(jt)
            tile = it * (it + 1) // 2 + jt
            S = w["sc"][bi, c, tile, :ri, :rj]
            acc = torch.zeros((T, T), **f64)
            group = range(grp * k5.BWD_GROUP_HEADS,
                          min(H, (grp + 1) * k5.BWD_GROUP_HEADS))
            for hh in group:
                ci = cum[bi, hh, i0:i0 + ri]
                cj = cum[bi, hh, j0:j0 + rj]
                P = dy[bi, i0:i0 + ri, hh] @ x[bi, j0:j0 + rj, hh].T
                if it == jt:
                    W = torch.where(torch.ones((ri, rj), dtype=torch.bool)
                                    .tril(), P * torch.exp(
                                        ci[:, None] - cj[None, :]), 0.0)
                    M = torch.tril(S * W, -1)
                else:
                    W = P * torch.exp(ci - cj[-1])[:, None] * \
                        torch.exp(cj[-1] - cj)[None, :]
                    M = S * W
                acc[:ri, :rj] += W
                w["mp"][bi, c, tile, hh] = 0.0
                w["mp"][bi, c, tile, hh, 0, :ri] = M.sum(1)
                w["mp"][bi, c, tile, hh, 1, :rj] = M.sum(0)
            w["wp"][bi, c, grp, tile] = acc
    dB = torch.full(B.shape, float("nan"), **f64)
    dC = torch.full(C.shape, float("nan"), **f64)
    ddA = torch.full(dA.shape, float("nan"), **f64)
    for blk in blocks["final"]:
        if blk[0] in ("dC", "dB"):
            kind, bi, c, t, q = blk
            t0, rt = c * L + t * T, rows(t)
            cols = slice(q * NH, min(n, q * NH + NH))
            acc = torch.zeros((rt, cols.stop - cols.start), **f64)
            us = range(t + 1) if kind == "dC" else range(t, nt)
            for u in us:
                u0, ru = c * L + u * T, rows(u)
                tile = t * (t + 1) // 2 + u if kind == "dC" \
                    else u * (u + 1) // 2 + t
                W = w["wp"][bi, c, :, tile].sum(0)
                if kind == "dC":
                    acc += W[:rt, :ru] @ B[bi, u0:u0 + ru, cols]
                else:
                    acc += W[:ru, :rt].T @ C[bi, u0:u0 + ru, cols]
            if kind == "dC" and has_h(c):
                acc += w["sd"][0, :, bi, t0:t0 + rt, cols].sum(0)
            if kind == "dB" and has_g(c):
                acc += w["sd"][1, :, bi, t0:t0 + rt, cols].sum(0)
            (dC if kind == "dC" else dB)[bi, t0:t0 + rt, cols] = acc
        else:
            _, bi, hh, c = blk
            sv = w["sv"][bi, hh, c * L:c * L + L]
            dc = torch.zeros(L, **f64)
            wsum = 0.0
            if has_h(c):
                dc += sv[:, 0].sum(1)
            if has_g(c):
                dc -= sv[:, 1].sum(1)
                wsum = sv[:, 1].sum()
            for i in range(L):
                t, r = divmod(i, T)
                for jt in range(t + 1):
                    dc[i] += w["mp"][bi, c, t * (t + 1) // 2 + jt, hh, 0, r]
                for it in range(t, nt):
                    dc[i] -= w["mp"][bi, c, it * (it + 1) // 2 + t, hh, 1, r]
            dc[L - 1] += w["lam"][bi, hh, c].sum() + wsum
            ddA[bi, c * L:c * L + L, hh] = torch.flip(
                torch.cumsum(torch.flip(dc, [0]), 0), [0])
    return dx, ddA, dB, dC, dh0


@pytest.mark.parametrize("b, l, H, p, n, L, h0", K5_PLANS[1:] + [
    (2, 192, 9, 16, 8, 64, False)] + K5_BWD_PLANS)
@pytest.mark.parametrize("dh_last", [False, True])
def test_ssd_backward_plan_computes_the_gradients(b, l, H, p, n, L, h0,
                                                  dh_last):
    """The backward's split of the work, run in float64 through its block
    lists, is the plain version's gradient (`ref.ssd_bwd_ref`): dx, d
    dlogA, dB, dC and dh0, with and without dh_last; nothing is missed
    or taken twice (9 heads: a dx block of one head, a second W group
    and state group of one head; 17 heads: three groups, a pair of one
    head; 1 and 3 heads; n 100: a ragged column block)."""
    rng = np.random.default_rng(11)
    dt = np.logaddexp(rng.standard_normal((b, l, H)), 0.0)
    x = torch.from_numpy(rng.standard_normal((b, l, H, p)) * 0.3 * dt[
        ..., None])
    dA = torch.from_numpy(-dt)
    Bm = torch.from_numpy(rng.standard_normal((b, l, n)) * 0.3)
    Cm = torch.from_numpy(rng.standard_normal((b, l, n)) * 0.3)
    h = torch.from_numpy(rng.standard_normal((b, H, p, n)) * 0.5) \
        if h0 else None
    dy = torch.from_numpy(rng.standard_normal((b, l, H, p)))
    dhl = torch.from_numpy(rng.standard_normal((b, H, p, n))) \
        if dh_last else None
    got = _emulate_ssd_bwd(x, dA, Bm, Cm, L, h, dy, dhl)
    want = ref.ssd_bwd_ref(x, dA, Bm, Cm, L, h, dy, dhl)
    for name, g, wt in zip(("dx", "d dlogA", "dB", "dC", "dh0"), got, want):
        if wt is None:
            assert g is None
            continue
        torch.testing.assert_close(g, wt, atol=1e-9, rtol=1e-9, msg=name)


def test_rglru_scan_backward_blocks():
    """K6's backward: one thread a channel, 128 a block (the C entry
    refuses any other count): 128 blocks at recurrentgemma-9b's train
    shape (B 4, W 4096), a ragged last block otherwise."""
    from repro_torch.kernels import rglru_scan as k6

    assert k6.backward_blocks(4, 4096) == 128
    assert k6.backward_blocks(1, 40) == 1
    assert k6.backward_blocks(2, 100) == 2
    assert k6.backward_blocks(3, 128) == 3
    assert k6.THREADS == 128
    src = _build_src("rglru_scan_bwd.cu")
    assert "constexpr int kThreads = 128;" in src
    assert "blocks != (BW + kThreads - 1) / kThreads" in src
