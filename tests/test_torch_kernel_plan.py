"""Host-side tiling of the port's kernels, checked on the CPU: the split
plan that K1 and K5 share, their launch geometry, K4's shared-memory
reckoning against the 227 KB a block may use on the H100, the sampler's
(K3) split of each row, and the SSD scan's (K7) chunk and tile plan and
shared memory; and that every wrapper hands the library its tensors'
device and that device's stream.  The kernels themselves run only on the
card (``tests/test_torch_cuda_kernels.py``)."""
import math
import types
import warnings

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import _lib, ops
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import sample as smp
from repro_torch.kernels import ssm_scan as ssp

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


# K3: the sampler's split of each logits row across the SMs

VOCABS = (1, 3, 4, 5, 1000, 1023, 1024, 1025, 4097, 32000, 151936, 151937,
          262144)


@pytest.mark.parametrize("sm_count", SMS)
@pytest.mark.parametrize("B", [1, 3, 8, 64])
def test_sample_split_plan_covers_v_in_whole_vectors(B, sm_count):
    for V in VOCABS:
        split_len, n = smp.split_plan(B, V, sm_count)
        assert split_len > 0 and split_len % smp.SAMPLE_VEC == 0
        assert n * split_len >= V                  # every column in a split
        assert (n - 1) * split_len < V             # no split empty
        assert n <= math.ceil(V / smp.MIN_SPLIT)
        # about BLOCKS_PER_SM blocks per SM where V has the columns for it
        assert (2 * B * n >= smp.BLOCKS_PER_SM * sm_count
                or n == math.ceil(V / smp.MIN_SPLIT))


def test_sample_split_plan_at_the_served_shapes():
    """qwen2.5-3b's 8 slots over 151,936 logits: 33 ranges of 4608 columns
    (264 blocks); zamba2-2.7b's 32,000: 32 of 1000."""
    assert smp.split_plan(8, 151936, 132) == (4608, 33)
    assert smp.split_plan(8, 32000, 132) == (1000, 32)
    assert smp.split_plan(1, 151936, 132) == (1020, 149)
    assert smp.split_plan(8, 1000, 132) == (1000, 1)


# K7: the SSD scan's chunk and tile plan

@pytest.mark.parametrize("chunk", [1, 10, 32, 64, 128, 256])
@pytest.mark.parametrize("hd,N", [(8, 8), (8, 4), (16, 8), (40, 16),
                                  (64, 64), (80, 128), (128, 128)])
def test_ssm_plan_covers_l_and_hd(hd, N, chunk):
    for L in (1, 2, 31, 32, 33, 63, 64, 65, 100, 129, 200, 1000, 2048):
        p = ssp.plan(2, L, 3, hd, N, chunk)
        assert p.T == min(chunk, ssp.SSD_TILE)
        assert p.n_chunks * p.T >= L > (p.n_chunks - 1) * p.T
        assert p.DW % ssp.SSD_DG == 0 and p.DW >= hd > p.DW - ssp.SSD_DG
        assert p.NK % 8 == 0 and p.NK >= N > p.NK - 8
        # the state blocks take every chunk's every SSD_DG state rows, the
        # output blocks' two query tiles every token of every chunk
        assert p.state_grid == p.n_chunks * p.DW // ssp.SSD_DG
        assert p.output_grid == 2 * p.n_chunks
        assert 2 * ssp.SSD_QT >= p.T
        if p.n_chunks == 1:
            assert p.pass_grid == 0 and p.workspace == 0
        else:
            # the pass takes every float4 of every (row, head) state
            assert p.pass_grid * ssp.PASS_THREADS * 4 >= p.DW * p.NK
            assert (p.pass_grid - 1) * ssp.PASS_THREADS * 4 < p.DW * p.NK
            assert p.workspace == 2 * 3 * p.n_chunks * (p.DW * p.NK + 1)
        assert ssp.plan(2, L, 3, hd, N, chunk, return_state=False)\
            .state_grid == (0 if p.n_chunks == 1 else p.state_grid)


def test_ssm_plan_fills_the_card_at_one_chunk():
    """zamba2-2.7b's chunked prefill calls the scan at (1, 64, 80, 64, 64):
    one chunk, so 160 state blocks and 160 output blocks (grids of
    (x, 80 heads, 1 row)) for 132 SMs."""
    p = ssp.plan(1, 64, 80, 64, 64, 128)
    assert p.state_grid * 80 >= 132 and p.output_grid * 80 >= 132


def test_ssm_plan_at_the_served_shapes():
    assert ssp.plan(1, 64, 80, 64, 64, 128) == ssp.Plan(
        T=64, n_chunks=1, DW=64, NK=64, state_grid=2, pass_grid=0,
        output_grid=2, workspace=0)
    assert ssp.plan(1, 200, 80, 64, 64, 128) == ssp.Plan(
        T=64, n_chunks=4, DW=64, NK=64, state_grid=8, pass_grid=8,
        output_grid=8, workspace=80 * 4 * (64 * 64 + 1))
    assert ssp.plan(1, 2048, 80, 64, 64, 128).output_grid == 32 * 2


def test_ssm_width_covers_hd_and_n():
    """The kernel instance's padded width: the least of 32, 64 and 128
    that holds both hd and N (zamba2-2.7b's 64 and 64 take 64)."""
    for hd in range(1, ssp.MAX_WIDTH + 1):
        for N in range(1, ssp.MAX_WIDTH + 1):
            W = ssp.width(hd, N)
            assert W in (32, 64, 128) and W >= max(hd, N)
            assert W == 32 or W // 2 < max(hd, N)
            assert ssp.plan(1, 64, 1, hd, N, 64).DW <= W
    assert ssp.width(64, 64) == 64 and ssp.width(8, 8) == 32
    assert ssp.width(40, 8) == 64 and ssp.width(10, 100) == 128


@pytest.mark.parametrize("hd", [1, 8, 40, 64, 80, 127, 128])
def test_ssm_smem_fits_a_block(hd):
    for N in range(1, ssp.MAX_WIDTH + 1):
        state, out = ssp.smem_bytes(hd, N)
        assert 0 < state <= ssp.SMEM_LIMIT and 0 < out <= ssp.SMEM_LIMIT


def test_ssm_smem_at_the_served_shapes():
    """zamba2-2.7b (hd 64, N 64): 64 rows of x and B at pitch 40 and 72;
    32 rows of C, 64 of B, 64 of the state and 32 of M at pitch 68, 64 of x
    at 72 — three output blocks an SM."""
    assert ssp.smem_bytes(64, 64) == (
        4 * (64 * 40 + 64 * 72 + 3 * 64),
        4 * ((32 + 64 + 64) * 68 + 32 * 68 + 64 * 72 + 2 * 64))
    assert 3 * ssp.smem_bytes(64, 64)[1] <= 228 * 1024


def test_ssm_plan_refuses_widths_past_the_tiles():
    with pytest.raises(ValueError, match="hd"):
        ssp.plan(1, 64, 2, 129, 64, 128)
    with pytest.raises(ValueError, match="N"):
        ssp.plan(1, 64, 2, 64, 129, 128)


def _drive_every_wrapper(dev):
    """One call of each kernel wrapper on (fake) tensors on ``dev``."""
    B, H, KV, hd, Smax, bk = 2, 4, 2, 16, 64, 8
    z = lambda *shape, dt=torch.float32: torch.zeros(*shape, dtype=dt,
                                                     device=dev)
    q, kc, vc = z(B, 1, H, hd), z(B, Smax, KV, hd), z(B, Smax, KV, hd)
    kp, vp = z(17, bk, KV, hd), z(17, bk, KV, hd)
    kn, vn = z(B, KV, hd), z(B, KV, hd)
    idx, tbl = z(B, dt=torch.int32), z(B, Smax // bk, dt=torch.int32)
    ops.decode_attention(q, kc, vc, idx)
    ops.decode_attention_write(q, kn, vn, kc, vc, idx)
    ops.decode_attention_paged(q, kp, vp, tbl, idx)
    ops.decode_attention_paged_write(q, kn, vn, kp, vp, tbl, idx)
    ops.cache_ring_update(kc, kn, idx)
    ops.cache_paged_update(kp, kn, idx, idx)
    ops.flash_attention(z(1, 8, H, hd), z(1, 8, KV, hd), z(1, 8, KV, hd))
    ops.fused_sample(z(B, 100), idx, idx, idx, z(B))
    smp.sample_noise(idx, idx, idx, 100)
    ops.ssm_scan(z(1, 8, 2, 16), z(1, 8, 2), z(2), z(1, 8, 2, 4),
                 z(1, 8, 2, 4))


@pytest.mark.parametrize("device_index", [0, 1, 3])
def test_wrappers_launch_on_their_tensors_device(monkeypatch, device_index):
    """The library launches on any CUDA device: every entry point gets the
    tensors' device index first and PyTorch's current stream on that device
    last, with as many arguments as its ctypes signature declares.  Fake
    CUDA tensors and a recording library stand in for the card."""
    calls = []

    class Recorder:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_lib, "load", Recorder)
    monkeypatch.setattr(_lib, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: (
        types.SimpleNamespace(cuda_stream=1000 + device.index)))
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore")     # fake tensors' data_ptr
        _drive_every_wrapper(torch.device("cuda", device_index))
    assert sorted({name for name, _ in calls}) == sorted(_lib._SIGNATURES)
    assert len(calls) == 10
    for name, args in calls:
        assert args[0] == device_index, name
        assert args[-1] == 1000 + device_index, name
        assert len(args) == 1 + len(_lib._SIGNATURES[name]), name
