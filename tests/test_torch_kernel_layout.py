"""The host side of the port's kernel designs, as pure Python.

K1 (`graph_mix`) and K2 (`sparse_graph_mix`) load their tables in vectors
of 2 or 1 columns, whichever every row is aligned to, and K2's grid puts
clients on x and walks the P tiles on y with a stride; K3
(`compressed_graph_mix`) groups each payload row by 256-column tile
before its mix (`ref.bucket_payload_ref` is that pass's plain version);
K4 (`flash_attention`) copies rows in 16-byte pieces and refuses an input
it cannot copy so. These are tested here without a card; the kernels
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
