"""The layout rules of the port's K1 and K4 wrappers, as pure arithmetic.

K1 (`graph_mix`) loads W in vectors of 2 or 1 columns, whichever every
row of W and of out is aligned to; K4 (`flash_attention`) copies rows in
16-byte pieces and refuses an input it cannot copy so. Both choices are
plain Python on integers, so they are tested here without a card; the
kernels themselves are held to their plain versions by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import pytest

from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import graph_mix as k1

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
