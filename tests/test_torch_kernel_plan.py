"""Host-side tiling of the port's attention kernels, checked on the CPU:
the split plan that K1 and K5 share, their launch geometry, and K4's
shared-memory reckoning against the 227 KB a block may use on the H100.
The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``)."""
import math

import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa

SMS = (1, 8, 132)
SMAX = (1, 7, 63, 64, 65, 100, 1000, 1020, 1024, 4096, 4100, 32768, 131072)


@pytest.mark.parametrize("sm_count", SMS)
@pytest.mark.parametrize("B,KV", [(1, 1), (1, 8), (3, 2), (8, 2), (8, 32),
                                  (64, 8)])
def test_split_plan_covers_smax_in_whole_tiles(B, KV, sm_count):
    for Smax in SMAX:
        split_len, n = dec.split_plan(B, KV, Smax, sm_count)
        assert split_len % dec.DEC_TILE == 0 and split_len > 0
        assert n * split_len >= Smax              # every key in a split
        assert (n - 1) * split_len < Smax         # no split wholly past Smax
        assert n <= math.ceil(Smax / dec.DEC_TILE)
        assert split_len <= max(dec.MAX_SPLIT_LEN, dec.DEC_TILE)
        # about BLOCKS_PER_SM blocks per SM where Smax has the tiles for
        # it (whole tiles per split can cost up to half of the target)
        blocks = B * KV * n
        assert (2 * blocks >= dec.BLOCKS_PER_SM * sm_count
                or n == math.ceil(Smax / dec.DEC_TILE))


def test_split_plan_at_the_served_shapes():
    """qwen2.5-3b's 8 slots x 2 KV heads over Smax 1024 take 16 splits of one
    tile; zamba2-2.7b's 8 x 32 already fill the card with two."""
    assert dec.split_plan(8, 2, 1024, 132) == (64, 16)
    assert dec.split_plan(8, 32, 1024, 132) == (512, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV", [(16, 2), (32, 32), (32, 8), (40, 8),
                                  (28, 4), (64, 4), (4, 2)])
@pytest.mark.parametrize("hd", [8, 10, 16, 64, 80, 128])
def test_decode_geometry(dtype, H, KV, hd):
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    geo = dec.geometry(8, H, KV, hd, 1024, dtype, 132)
    lanes = geo.lanes_per_row
    assert lanes & (lanes - 1) == 0 and lanes <= 32
    assert lanes * per16 >= hd and (lanes // 2) * per16 < hd or lanes == 1
    G = H // KV
    assert geo.gmax in (1, 2, 4, 8) and geo.gmax * geo.gchunks >= G
    assert (geo.gchunks - 1) * geo.gmax < G
    # one plan for K1 and K5: the split plan over KV * gchunks block rows
    assert (geo.split_len, geo.n_splits) == dec.split_plan(
        8, KV * geo.gchunks, 1024, 132)
    assert geo == dec.geometry(8, H, KV, hd, 1024, dtype, 132)


@pytest.mark.parametrize("dtype,widest", [(torch.float32, 128),
                                          (torch.bfloat16, 256)])
def test_decode_geometry_refuses_rows_wider_than_a_warp(dtype, widest):
    dec.geometry(1, 2, 1, widest, 64, dtype, 132)
    with pytest.raises(ValueError, match="hd"):
        dec.geometry(1, 2, 1, widest + 1, 64, dtype, 132)


def test_flash_tensor_cores_take_bf16_up_to_hd_128():
    assert all(fa.uses_tensor_cores(torch.bfloat16, hd) for hd in range(1, 129))
    assert not fa.uses_tensor_cores(torch.bfloat16, 129)
    assert not any(fa.uses_tensor_cores(torch.float32, hd)
                   for hd in range(1, 257))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_smem_fits_a_block(dtype):
    """Every hd the configs use, and up to 256, fits the 232,448 bytes of
    dynamic shared memory a block may use."""
    for hd in range(1, 257):
        assert 0 < fa.smem_bytes(dtype, hd) <= fa.SMEM_LIMIT, hd


def test_flash_smem_at_the_served_shapes():
    """bf16: a 32-row query tile and a three-stage ring of 64-row K and V
    tiles at row pitch round16(hd) + 8; hd 8 and 16 share the padded 16."""
    assert fa.smem_bytes(torch.bfloat16, 128) == (32 + 6 * 64) * 136 * 2
    assert fa.smem_bytes(torch.bfloat16, 80) == (32 + 6 * 64) * 88 * 2
    assert (fa.smem_bytes(torch.bfloat16, 8)
            == fa.smem_bytes(torch.bfloat16, 16) == (32 + 6 * 64) * 24 * 2)
    assert fa.smem_bytes(torch.float32, 128) == (
        32 * 129 + 64 * 129 + 32 * 65 + 32 * 128 + 96) * 4


def test_flash_refuses_an_hd_past_shared_memory():
    """The wrapper's reckoning says where the float32 body stops fitting."""
    hd = next(h for h in range(256, 1024)
              if fa.smem_bytes(torch.float32, h) > fa.SMEM_LIMIT)
    assert fa.smem_bytes(torch.float32, hd - 1) <= fa.SMEM_LIMIT
    assert hd > 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_16b_picks_the_vector_loads(dtype):
    """The wrappers pass the kernels 16-byte loads only for rows that start
    on 16-byte boundaries and span whole vectors; views that break either
    take the element loads."""
    from repro_torch.kernels._lib import rows_16b
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    x = torch.zeros(2, 10, 4, 64, dtype=dtype)
    assert rows_16b(64, x) and rows_16b(64, x, x[:, :1])
    wide = torch.zeros(2, 10, 4, 65, dtype=dtype)[..., :64]     # pitch 65
    assert not rows_16b(64, wide) and not rows_16b(64, x, wide)
    shifted = torch.zeros(2 * 10 * 4 * 64 + 1, dtype=dtype)[1:].view(2, 10, 4, 64)
    assert not rows_16b(64, shifted)
    odd = torch.zeros(2, 10, 4, per16 + 2, dtype=dtype)           # hd 6 / 10
    assert not rows_16b(per16 + 2, odd)
