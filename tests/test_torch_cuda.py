"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA Hopper GPU and ``nvcc``; without a card they
skip. They cover what ``chip_smoke.py`` does not: ragged M, N and K, widths
other than B/16's, and the launch counts of a small forward, float and
int8. The file
imports no JAX, so on a machine without it run it alone:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_cuda.py

Bars as in ``chip_smoke.py``: fp32 max|diff| <= 1e-4 (sum order only);
bf16 elementwise |diff| <= 2e-2 * (1 + |ref|).
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _counts(**named):
    """Expected launch counts: ``named``, 0 for every other kernel."""
    from vit_tpu_torch.ops.cuda import KERNELS
    return {k: named.get(k, 0) for k in KERNELS}


def _rnd(gen, dtype, *shape, std=1.0, mean=0.0):
    t = torch.randn(shape, generator=gen, device="cuda") * std + mean
    return t.to(dtype)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    diff = (g - w).abs()
    if got.dtype == torch.float32:
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert (diff <= 2e-2 * (1 + w.abs())).all(), diff.max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(37, 588, 100), (1, 768, 1000),
                                   (130, 24, 9)])
def test_torch_cuda_matmul_ragged(gen, dtype, m, k, n):
    from vit_tpu_torch import ops

    x = _rnd(gen, dtype, m, k)
    w = _rnd(gen, dtype, k, n, std=0.05)
    b = _rnd(gen, dtype, n, std=0.1)
    r = _rnd(gen, dtype, m, n)
    for args in ((None, None, None), (b, None, None), (b, "gelu", None),
                 (b, None, r), (None, "gelu", r)):
        bias, act, res = args
        _close(ops.matmul(x, w, bias, act, residual=res, impl="cuda"),
               ops.matmul(x, w, bias, act, residual=res, impl="torch"))


def _k2_path(x, w):
    from vit_tpu_torch.ops.cuda import matmul as cuda_matmul

    return cuda_matmul.k2_operands(x, w, *x.shape)[-1]


def _k2_operand(gen, dtype, rows, cols, trans, std=1.0):
    """A (rows, cols) operand: contiguous, or the .t() view of a
    contiguous (cols, rows) matrix."""
    if trans:
        return _rnd(gen, dtype, cols, rows, std=std).t()
    return _rnd(gen, dtype, rows, cols, std=std)


@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("m,k,n,paths", [
    # ragged against 128 x 128 tiles and K steps of 64
    (200, 72, 136, ("wgmma", "wgmma")),
    # 36 tiles: fewer than the 132 SMs
    (768, 6656, 768, ("wgmma", "wgmma")),
    # x.t() has rows of 130 elements: TMA needs multiples of 8
    (130, 24, 16, ("wgmma", "wmma")),
    # rows of 588 (x, w.t()), 100 (w) or 37 (x.t()): the wrapper copies
    (37, 588, 100, ("wmma", "wmma"))])
def test_torch_cuda_matmul_bf16_tiles(gen, trans_a, trans_b, m, k, n, paths):
    """K2 in bf16 on the tile gemm_path picks (``paths``: without and with
    trans_a), with operands given as .t() views, every epilogue of
    test_torch_cuda_matmul_ragged, at the kernel bar (mean <= 3e-3 too);
    two calls equal bit for bit."""
    from vit_tpu_torch import ops

    dt = torch.bfloat16
    x = _k2_operand(gen, dt, m, k, trans_a)
    w = _k2_operand(gen, dt, k, n, trans_b, std=0.05)
    assert _k2_path(x, w) == paths[trans_a]
    b = _rnd(gen, dt, n, std=0.1)
    r = _rnd(gen, dt, m, n)
    for bias, act, res in ((None, None, None), (b, None, None),
                           (b, "gelu", None), (b, None, r),
                           (None, "gelu", r)):
        got = ops.matmul(x, w, bias, act, residual=res, impl="cuda")
        want = ops.matmul(x, w, bias, act, residual=res, impl="torch")
        _close(got, want)
        assert (got.float() - want.float()).abs().mean() <= 3e-3
        again = ops.matmul(x, w, bias, act, residual=res, impl="cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, again)


@pytest.mark.parametrize("shape,n", [((2, 256, 588), 1280),
                                     ((2, 196, 768), 768)])
def test_torch_cuda_matmul_bf16_batched_input(gen, shape, n):
    """A (B, N, K) x, as the patch projection gives it: H/14's rows of 588
    take wmma, B/16's of 768 the wgmma tile."""
    from vit_tpu_torch import ops

    x = _rnd(gen, torch.bfloat16, *shape)
    w = _rnd(gen, torch.bfloat16, shape[-1], n, std=0.05)
    b = _rnd(gen, torch.bfloat16, n, std=0.1)
    got = ops.matmul(x, w, b, impl="cuda")
    want = ops.matmul(x, w, b, impl="torch")
    _close(got, want)
    assert (got.float() - want.float()).abs().mean() <= 3e-3


def test_torch_cuda_matmul_fp32_transposed_views(gen):
    """fp32 .t() views of contiguous matrices whose rows TMA reads (16-byte
    aligned, strides a multiple of 4 floats) go to the tf32 wgmma tile as
    they lie; a view whose storage rows are not go to the FFMA tile, which
    the wrapper copies it for."""
    from vit_tpu_torch import ops

    for m, k, n in ((96, 200, 72), (4, 768, 96), (37, 64, 40), (96, 200, 9)):
        for ta, tb in ((True, True), (True, False), (False, True)):
            x = _k2_operand(gen, torch.float32, m, k, ta)
            w = _k2_operand(gen, torch.float32, k, n, tb, std=0.05)
            lda, ldb = m if ta else k, k if tb else n
            want = "wgmma" if lda % 4 == 0 and ldb % 4 == 0 else "ffma"
            assert _k2_path(x, w) == want, (m, k, n, ta, tb)
            _close(ops.matmul(x, w, impl="cuda"),
                   ops.matmul(x, w, impl="torch"))


@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("m,k,n", [(200, 72, 136), (1, 24, 1000),
                                   (768, 6656, 768), (332, 100, 260),
                                   (64, 4, 8)])
def test_torch_cuda_matmul_fp32_tiles(gen, trans_a, trans_b, m, k, n):
    """K2 in fp32 on the tf32 wgmma tile (three-pass split, a fresh
    accumulator each 32-deep K step): M, N and K ragged against 128 x 128
    tiles and K steps of 32, every operand layout read where it lies,
    every epilogue, at the fp32 bar; two calls bit for bit; the first rows
    of an M = 33 call equal those of the whole call."""
    from vit_tpu_torch import ops

    dt = torch.float32
    x = _k2_operand(gen, dt, m, k, trans_a)
    w = _k2_operand(gen, dt, k, n, trans_b, std=0.05)
    assert _k2_path(x, w) == "wgmma"
    b = _rnd(gen, dt, n, std=0.1)
    r = _rnd(gen, dt, m, n)
    for bias, act, res in ((None, None, None), (b, None, None),
                           (b, "gelu", None), (b, None, r),
                           (None, "gelu", r)):
        got = ops.matmul(x, w, bias, act, residual=res, impl="cuda")
        _close(got, ops.matmul(x, w, bias, act, residual=res, impl="torch"))
        again = ops.matmul(x, w, bias, act, residual=res, impl="cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, again)
    if m > 33 and not trans_a:
        part = ops.matmul(x[:33], w, b, impl="cuda")
        torch.cuda.synchronize()
        assert torch.equal(part, ops.matmul(x, w, b, impl="cuda")[:33])


def test_torch_cuda_matmul_fp32_k6656_refuses_faults(gen):
    """The training backward's ``x.t() @ g`` at B/16 bs=32 (K = 6656, g at
    std 0.01 as ``chip_smoke.py:kernel_cases`` sets it) on the tf32 tile
    within 1e-4 of plain fp32, and ``g @ w.t()`` (K = 2304); the bar
    refuses the output scaled by 0.85 and one 32-deep K step left out."""
    from vit_tpu_torch import ops

    dt = torch.float32
    x = _rnd(gen, dt, 6656, 768)
    gf = _rnd(gen, dt, 6656, 2304, std=0.01)
    assert _k2_path(x.t(), gf) == "wgmma"
    got = ops.matmul(x.t(), gf, impl="cuda")
    want = ops.matmul(x.t(), gf, impl="torch")
    _close(got, want)
    cut = x.clone()
    cut[1024:1056] = 0
    for fault in (got * 0.85, ops.matmul(cut.t(), gf, impl="cuda")):
        torch.cuda.synchronize()
        assert (fault - want).abs().max() > 1e-4
    gu = _rnd(gen, dt, 6656, 2304)
    w = _rnd(gen, dt, 768, 2304, std=0.04)
    _close(ops.matmul(gu, w.t(), impl="cuda"),
           ops.matmul(gu, w.t(), impl="torch"))


def test_torch_cuda_tf32_split_probe(gen):
    """The split's numerics probe (``tools/tf32_probe.py``): on both paths
    the three passes hold 1e-4 against plain fp32 at small K and one pass
    does not; on the wgmma path at K = 2304 the split with a fresh
    accumulator each 32-deep step holds it."""
    from vit_tpu_torch.tools import tf32_probe

    a = _rnd(gen, torch.float32, 64, 128)
    b = _rnd(gen, torch.float32, 128, 136)
    plain = a @ b
    for path in ("wgmma", "mma"):
        got = tf32_probe.probe(a, b, path, "split")
        assert (got - plain).abs().max() <= 1e-4
        one = tf32_probe.probe(a, b, path, "tf32")
        assert (one - plain).abs().max() > 1e-3
    a = _rnd(gen, torch.float32, 128, 2304)
    b = _rnd(gen, torch.float32, 2304, 128, std=0.04)
    got = tf32_probe.probe(a, b, "wgmma", "split_promoted")
    assert (got - a @ b).abs().max() <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(5, 100), (9, 768), (1, 1280)])
def test_torch_cuda_layernorm(gen, dtype, rows, d):
    from vit_tpu_torch import ops

    x = _rnd(gen, dtype, rows, d, std=2.0, mean=0.5)
    g = _rnd(gen, dtype, d, std=0.1, mean=1.0)
    b = _rnd(gen, dtype, d, std=0.05)
    _close(ops.layernorm(x, g, b, impl="cuda"),
           ops.layernorm(x, g, b, impl="torch"))


@pytest.mark.parametrize("dtype,m,d,mlp", [
    (torch.bfloat16, 33, 128, 256), (torch.bfloat16, 70, 1024, 512),
    (torch.float32, 33, 100, 200), (torch.float32, 17, 768, 3072)])
def test_torch_cuda_mlp_block(gen, dtype, m, d, mlp):
    from vit_tpu_torch import ops

    args = (_rnd(gen, dtype, m, d), _rnd(gen, dtype, d, std=0.1, mean=1.0),
            _rnd(gen, dtype, d, std=0.05), _rnd(gen, dtype, d, mlp, std=0.05),
            _rnd(gen, dtype, mlp, std=0.02), _rnd(gen, dtype, mlp, d, std=0.05),
            _rnd(gen, dtype, d, std=0.02))
    _close(ops.mlp_block(*args, impl="cuda"),
           ops.mlp_block(*args, impl="torch"))


@pytest.mark.parametrize("m,d,mlp,partial", [
    (200, 768, 3072, False), (70, 1024, 4096, False), (70, 768, 1536, True)])
def test_torch_cuda_mlp_block_bf16_tiles(gen, m, d, mlp, partial):
    """K3's bf16 ``wgmma`` tile (``csrc/mlp_wgmma.cuh``) at real widths:
    B/16's (three ragged 64-row clusters), L/16's (four boxes a
    warpgroup) and B/16's shard form over model=2, at the kernel bar with
    mean <= 3e-3; two calls bit for bit; rows 0-32 the same bits in an
    M = 33 call as in the M-row call (no sum runs over rows)."""
    from vit_tpu_torch import ops

    args = (_rnd(gen, torch.bfloat16, m, d, std=1.5, mean=0.2),
            _rnd(gen, torch.bfloat16, d, std=0.1, mean=1.0),
            _rnd(gen, torch.bfloat16, d, std=0.05),
            _rnd(gen, torch.bfloat16, d, mlp, std=0.03),
            _rnd(gen, torch.bfloat16, mlp, std=0.02),
            _rnd(gen, torch.bfloat16, mlp, d, std=0.03),
            _rnd(gen, torch.bfloat16, d, std=0.02))
    got = ops.mlp_block(*args, partial_out=partial, impl="cuda")
    _close_bf16_bars(got, ops.mlp_block(*args, partial_out=partial,
                                        impl="torch"))
    again = ops.mlp_block(*args, partial_out=partial, impl="cuda")
    head = ops.mlp_block(args[0][:33], *args[1:], partial_out=partial,
                         impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(head, got[:33])


@pytest.mark.parametrize("m,d,mlp,partial", [
    (200, 768, 3072, False), (70, 1024, 4096, False),
    (70, 1280, 5120, False), (40, 1536, 512, False),
    (70, 768, 1536, True), (33, 200, 300, False), (65, 128, 256, True)])
def test_torch_cuda_mlp_block_tf32_tiles(gen, m, d, mlp, partial):
    """K3's fp32 tile on the tensor cores (``csrc/mlp_tf32.cuh``, three
    TF32 passes) at every ``VARIANTS`` width, 1536 (``mlp_plan``'s fp32
    limit, 16-row form), the B/16 shard over model=2 and narrow ragged
    widths: the form ``mlp_f32_form`` gives, within 1e-4 of the plain
    version, two calls bit for bit, rows 0-32 of an M = 33 call the same
    bits as in the M-row call."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import block

    args = (_rnd(gen, torch.float32, m, d, std=1.5, mean=0.2),
            _rnd(gen, torch.float32, d, std=0.1, mean=1.0),
            _rnd(gen, torch.float32, d, std=0.05),
            _rnd(gen, torch.float32, d, mlp, std=0.03),
            _rnd(gen, torch.float32, mlp, std=0.02),
            _rnd(gen, torch.float32, mlp, d, std=0.03),
            _rnd(gen, torch.float32, d, std=0.02))
    assert block.mlp_f32_form(d, mlp, (args[0].data_ptr(),
                                       args[3].data_ptr(),
                                       args[5].data_ptr())) == "tf32"
    got = ops.mlp_block(*args, partial_out=partial, impl="cuda")
    _close(got, ops.mlp_block(*args, partial_out=partial, impl="torch"))
    again = ops.mlp_block(*args, partial_out=partial, impl="cuda")
    head = ops.mlp_block(args[0][:33], *args[1:], partial_out=partial,
                         impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(head, got[:33])


def test_torch_cuda_mlp_block_fp32_ffma_form(gen):
    """Where TMA cannot read x (a base 4 bytes past 16-byte alignment) K3
    keeps ``mlp_tile.cuh``'s FFMA form, within 1e-4 of the plain
    version."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import block

    m, d, mlp = 40, 256, 512
    x = torch.empty(m * d + 1, device="cuda")[1:].view(m, d)
    x.copy_(_rnd(gen, torch.float32, m, d))
    args = (x, _rnd(gen, torch.float32, d, std=0.1, mean=1.0),
            _rnd(gen, torch.float32, d, std=0.05),
            _rnd(gen, torch.float32, d, mlp, std=0.03),
            _rnd(gen, torch.float32, mlp, std=0.02),
            _rnd(gen, torch.float32, mlp, d, std=0.03),
            _rnd(gen, torch.float32, d, std=0.02))
    assert block.mlp_f32_form(d, mlp, (x.data_ptr(), args[3].data_ptr(),
                                       args[5].data_ptr())) == "ffma"
    _close(ops.mlp_block(*args, impl="cuda"),
           ops.mlp_block(*args, impl="torch"))


@pytest.mark.parametrize("b,m,k,n", [
    (3, 37, 16, 37),     # odd M and N: rows and batches unaligned
    (5, 37, 37, 16),     # odd K: x rows 148 bytes
    (2, 197, 197, 64),   # the context
    (2, 197, 64, 197),   # the scores
    (2, 200, 64, 200),   # every row 16-byte aligned
    (3, 129, 5, 67),     # K < 8
    (2, 197, 2304, 131)])  # 36 runs of 64, ragged M and N
@pytest.mark.parametrize("scale", [None, 1.0, 0.125])
def test_torch_cuda_matmul3_tf32_tiles(gen, b, m, k, n, scale):
    """K16's fp32 form on ``mma.sync`` tf32 (three passes, each operand
    split once as it is staged, 64-deep runs summed apart) within 1e-4 of
    the plain version; ``scale=1`` equals no scale bit for bit; two calls
    equal bit for bit."""
    from vit_tpu_torch import ops

    # At K = 2304 y at std 0.02 keeps the sums near 1, where fp32 sum
    # orders differ by far less than the absolute bar.
    x = _rnd(gen, torch.float32, b, m, k)
    y = _rnd(gen, torch.float32, b, k, n, std=0.3 if k < 1000 else 0.02)
    got = ops.matmul3(x, y, scale=scale, impl="cuda")
    _close(got, ops.matmul3(x, y, scale=scale, impl="torch"))
    again = ops.matmul3(x, y, scale=scale, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if scale == 1.0:
        assert torch.equal(got, ops.matmul3(x, y, impl="cuda"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,heads,hd,seq_len", [
    (2, 32, 2, 64, 17), (3, 80, 4, 16, 80), (2, 48, 3, 80, 40),
    (1, 272, 4, 64, 257)])
def test_torch_cuda_attention_core(gen, dtype, b, s, heads, hd, seq_len):
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block

    qkv = _rnd(gen, dtype, b * s, 3 * heads * hd)
    kw = dict(batch=b, num_heads=heads, scale=hd ** -0.5, seq_len=seq_len)
    _close(block.attention_core(qkv, **kw),
           reference.attention_core(qkv, **kw))


@pytest.mark.parametrize("b,s,heads,hd,seq_len", [
    (2, 197, 3, 64, 197), (3, 16, 2, 64, 16), (1, 434, 2, 64, 430),
    (2, 80, 2, 20, 71), (1, 96, 2, 40, 90), (1, 64, 1, 272, 50)])
def test_torch_cuda_attention_core_bf16_geometries(gen, b, s, heads, hd,
                                                   seq_len):
    """The bf16 core on the tensor cores at geometries the FFMA tile did
    not meet in the cases above: S = 197 unpadded, S = 16, S = 434 (the
    longest ``ops.attn_plan`` admits in bf16 at d=64), head widths that
    are not multiples of 16 (20 is not one of 8: element copies), and one
    wider than 128 (q and the context in blocks of 128 columns); two calls
    agree bit for bit."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block

    assert ops.attn_plan(b, s, heads * hd, heads, torch.bfloat16)
    qkv = _rnd(gen, torch.bfloat16, b * s, 3 * heads * hd)
    kw = dict(batch=b, num_heads=heads, scale=hd ** -0.5, seq_len=seq_len)
    got = block.attention_core(qkv, **kw)
    _close(got, reference.attention_core(qkv, **kw))
    assert torch.equal(got, block.attention_core(qkv, **kw))


def test_torch_cuda_attention_core_bf16_vs_ffma_core(gen):
    """K4's bf16 core (mma.sync) against K23's ``full`` core, the FFMA tile
    that K4 ran before, at B/16 widths (208 tokens, 197 real, 12 heads of
    64): the kernel bar, since the two sum in different orders."""
    from vit_tpu_torch.ops.cuda import block
    from vit_tpu_torch.tools import attn_core_probe as acp

    b, sp, s, d, heads = 2, 208, 197, 768, 12
    qkv = _rnd(gen, torch.bfloat16, b * sp, 3 * d)
    out = torch.empty((b * sp, d), dtype=torch.bfloat16, device="cuda")
    kw = dict(batch=b, num_heads=heads, scale=(d // heads) ** -0.5,
              seq_len=s)
    ffma = acp.core_launch("full", qkv, None, out, b=b, sp=sp, d=d,
                           heads=heads, seq_len=s, scale=kw["scale"])
    _close(block.attention_core(qkv, **kw), ffma)


@pytest.mark.parametrize("b,s,heads,hd,seq_len", [
    (1, 279, 2, 64, 270), (2, 16, 3, 64, 16), (2, 80, 2, 20, 71),
    (1, 64, 1, 272, 50), (1, 16, 1, 592, 13), (3, 208, 2, 64, 197)])
def test_torch_cuda_attention_core_fp32_tiles(gen, b, s, heads, hd, seq_len):
    """K4's fp32 core on mma.sync tf32 (three passes) at the geometries
    ``ops.attn_plan`` admits in fp32 that its tile must meet: S = 279 (the
    longest at d = 64), S = 16, a head width that is not a multiple of 8
    (20: element copies), heads wider than 64 columns (272 at S = 64 and
    592 at S = 16: q and the context in blocks of 64 columns) and B/16's
    208 tokens with 197 real; within 1e-4 of the plain version, two calls
    bit for bit, its shared memory at most the FFMA tile's."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block

    assert ops.attn_plan(b, s, heads * hd, heads, torch.float32)
    assert block.attention_tf32_smem_bytes(s, hd) <= \
        block.attention_smem_bytes(s, hd, 4)
    qkv = _rnd(gen, torch.float32, b * s, 3 * heads * hd)
    kw = dict(batch=b, num_heads=heads, scale=hd ** -0.5, seq_len=seq_len)
    got = block.attention_core(qkv, **kw)
    _close(got, reference.attention_core(qkv, **kw))
    assert torch.equal(got, block.attention_core(qkv, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(37, 200), (9, 1024), (1, 1280)])
def test_torch_cuda_layernorm_stats(gen, dtype, rows, d):
    from vit_tpu_torch import ops

    x = _rnd(gen, dtype, rows, d, std=2.0, mean=0.5)
    x[0] = _rnd(gen, dtype, d, std=0.5, mean=100.0)  # large mean
    got, want = ops.layernorm_stats(x, impl="cuda"), ops.layernorm_stats(
        x, impl="torch")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (rows, 1) and g.dtype == torch.float32
        assert ((g - w).abs() <= 1e-5 * (1 + w.abs())).all()


#: The bf16 tile K6 runs each case of test_torch_cuda_fused_linear_ragged
#: on (``gemm_path``'s rule: N = 100 and 9 are not multiples of 8).
K6_TILES = {(37, 200, 100): "wmma", (130, 1024, 3072): "wgmma",
            (5, 24, 9): "wmma", (300, 520, 264): "wgmma"}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(37, 200, 100), (130, 1024, 3072),
                                   (5, 24, 9), (300, 520, 264)])
def test_torch_cuda_fused_linear_ragged(gen, dtype, m, k, n):
    """Every flag combination; K=200 and 520 with LN are the zero-fill
    trap (K ends inside a step). Both dtypes run on both tiles: each case
    asserts the one ``vit_fused_linear`` picks, which is ``gemm_path``'s
    for K2 on the same operands (fp32: the tf32 tile where K and N are
    multiples of 4, else the FFMA tile); with LN two calls agree bit for
    bit."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import matmul as cuda_matmul

    x = _rnd(gen, dtype, m, k, std=1.5, mean=0.3)
    w = _rnd(gen, dtype, k, n, std=0.05)
    b = _rnd(gen, dtype, n, std=0.1)
    g = _rnd(gen, dtype, k, std=0.1, mean=1.0)
    beta = _rnd(gen, dtype, k, std=0.2)
    r = _rnd(gen, dtype, m, n)
    tile = K6_TILES[m, k, n] if dtype == torch.bfloat16 else \
        "wgmma" if k % 4 == 0 and n % 4 == 0 else "ffma"
    assert cuda_matmul.fused_linear_tile(x, w) == tile
    k2_path = cuda_matmul.gemm_path(m, n, k, dtype, False, False,
                                    (x.data_ptr(), w.data_ptr()),
                                    ((k, 1), (n, 1)))
    assert k2_path == tile
    for bias, act, ln, res in ((None, None, False, None),
                               (b, None, True, None), (b, "gelu", True, None),
                               (b, None, False, r), (b, "gelu", True, r),
                               (None, None, True, r)):
        kw = dict(ln_scale=g if ln else None, ln_bias=beta if ln else None,
                  residual=res)
        got = ops.fused_linear(x, w, bias, act, impl="cuda", **kw)
        _close(got, ops.fused_linear(x, w, bias, act, impl="torch", **kw))
        if ln:
            again = ops.fused_linear(x, w, bias, act, impl="cuda", **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("b,heads,s,seq_len", [
    (2, 3, 197, 197), (1, 2, 592, 577), (1, 2, 1000, 1000), (3, 1, 40, 33)])
def test_torch_cuda_flash_attention(gen, dtype, hd, b, heads, s, seq_len):
    """Contiguous operands and strided views of a packed QKV buffer."""
    from vit_tpu_torch import ops

    kw = dict(scale=hd ** -0.5, seq_len=seq_len)
    q, k, v = (_rnd(gen, dtype, b, heads, s, hd) for _ in range(3))
    _close(ops.flash_attention(q, k, v, impl="cuda", **kw),
           ops.flash_attention(q, k, v, impl="torch", **kw))
    qkv = _rnd(gen, dtype, b * s, 3 * heads * hd)
    q, k, v = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    got = ops.flash_attention(q, k, v, impl="cuda", **kw)
    assert got.transpose(1, 2).is_contiguous()  # a (B, S, H, d) buffer
    _close(got, ops.flash_attention(q, k, v, impl="torch", **kw))


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("hd", [16, 80, 128])
@pytest.mark.parametrize("b,heads,s,seq_len", [
    (2, 3, 150, 141),   # S not a multiple of 64; seq_len inside a fragment
    (1, 2, 208, 197),   # B/16: the last tile holds one 16-key group
    (3, 1, 70, 70)])
def test_torch_cuda_flash_attention_bf16_tiles(gen, out_f32, hd, b, heads,
                                               s, seq_len):
    """K7's bf16 tile on mma.sync: packed QKV views (cp.async staging) and
    the same views one element off 16-byte alignment (element staging),
    bf16 or fp32 out, at the kernel bars (mean <= 3e-3 too); two calls
    equal bit for bit."""
    from vit_tpu_torch import ops

    dt = torch.bfloat16
    kw = dict(scale=hd ** -0.5, seq_len=seq_len,
              out_dtype=torch.float32 if out_f32 else None)
    flat = _rnd(gen, dt, b * s * 3 * heads * hd + 1)
    for off in (0, 1):  # off 1: every row 2 bytes past a 16-byte boundary
        qkv = flat[off:off + b * s * 3 * heads * hd]
        q, k, v = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
        got = ops.flash_attention(q, k, v, impl="cuda", **kw)
        _close_bf16_bars(got, ops.flash_attention(q, k, v, impl="torch",
                                                  **kw))
        again = ops.flash_attention(q, k, v, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("b,heads,s,seq_len", [
    (2, 3, 150, 141),   # S not a multiple of 64; seq_len inside a C tile
    (1, 2, 208, 197),   # B/16: the last tile holds one 8-key C tile
    (1, 2, 592, 577),   # L/16-384
    (3, 1, 70, 70)])
def test_torch_cuda_flash_attention_fp32_tiles(gen, hd, b, heads, s,
                                               seq_len):
    """K7's fp32 form on the tensor cores (three TF32 passes; ``wgmma`` at
    d = 32 and 64, ``mma.sync`` at the others): packed QKV views (cp.async
    or 16-byte loads) and the same views one element off 16-byte alignment
    (element copies), within 1e-4 of the plain version; two calls bit for
    bit."""
    from vit_tpu_torch import ops

    kw = dict(scale=hd ** -0.5, seq_len=seq_len)
    flat = _rnd(gen, torch.float32, b * s * 3 * heads * hd + 1)
    for off in (0, 1):  # off 1: every row 4 bytes past a 16-byte boundary
        qkv = flat[off:off + b * s * 3 * heads * hd]
        q, k, v = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
        got = ops.flash_attention(q, k, v, impl="cuda", **kw)
        _close(got, ops.flash_attention(q, k, v, impl="torch", **kw))
        assert torch.equal(got, ops.flash_attention(q, k, v, impl="cuda",
                                                    **kw))


@pytest.mark.parametrize("b,m,k,n", [
    (3, 37, 16, 37),     # odd M and N: batch bases 2 mod 16 bytes apart
    (5, 37, 37, 16),     # odd K: x rows 74 bytes
    (2, 197, 197, 64),   # the context
    (2, 197, 64, 197),   # the scores
    (3, 129, 5, 67),     # K < 16
    (2, 65, 200, 131)])  # four K steps, the last ragged
@pytest.mark.parametrize("scale", [None, 1.0, 0.125])
def test_torch_cuda_matmul3_bf16_tiles(gen, b, m, k, n, scale):
    """K16's bf16 tile on mma.sync at ragged sizes whose rows and batches
    are only 2-byte aligned (realigned staging and output words), at the
    kernel bars (mean <= 3e-3 too); ``scale=1`` equals no scale bit for
    bit; two calls equal bit for bit."""
    from vit_tpu_torch import ops

    dt = torch.bfloat16
    x, y = _rnd(gen, dt, b, m, k), _rnd(gen, dt, b, k, n, std=0.3)
    got = ops.matmul3(x, y, scale=scale, impl="cuda")
    _close_bf16_bars(got, ops.matmul3(x, y, scale=scale, impl="torch"))
    again = ops.matmul3(x, y, scale=scale, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if scale == 1.0:
        assert torch.equal(got, ops.matmul3(x, y, impl="cuda"))


def test_torch_cuda_wrappers_check_inputs(gen):
    from vit_tpu_torch import ops

    x = _rnd(gen, torch.float32, 4, 64)
    v = _rnd(gen, torch.float32, 64)
    with pytest.raises(ValueError, match="dtype"):
        ops.layernorm(x, v.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):  # not a .t() view
        ops.matmul(x, _rnd(gen, torch.float32, 64, 16)[:, ::2])
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.mlp_block(x.to(torch.bfloat16), *(t.to(torch.bfloat16) for t in (
            v, v, _rnd(gen, torch.float32, 64, 128), _rnd(gen, torch.float32, 128),
            _rnd(gen, torch.float32, 128, 64), v)))


def test_torch_cuda_forward_counts_and_matches_plain(gen):
    from vit_tpu_torch.config import ViTConfig
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = ViTConfig(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
                    num_layers=2, mlp_dim=256, num_classes=10,
                    dtype=torch.bfloat16)
    params = vit.init_params(cfg, generator=gen, device="cuda")
    px = torch.randn((3, 3, 32, 32), generator=gen, device="cuda")
    reset_launch_counts()
    got = vit.forward(params, px, cfg)
    torch.cuda.synchronize()
    # bs=3 embeds through embed_fused; the head is the fifth matmul.
    assert launch_counts() == _counts(layernorm=3, matmul=5, attention=2,
                                      mlp_block=2, embed_fused=1)
    want = vit.forward(params, px, cfg, impl="torch")
    assert launch_counts()["matmul"] == 5  # the plain path launches nothing
    _close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_cuda_composed_forward_counts_and_matches_plain(gen, dtype):
    """A narrow L/16-384 geometry (592 padded tokens): the attention half
    is composed in both dtypes, the MLP half too in bf16 (D % 128)."""
    from vit_tpu_torch.config import ViTConfig
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = ViTConfig(image_size=384, patch_size=16, hidden_dim=64,
                    num_heads=2, num_layers=2, mlp_dim=128, dtype=dtype)
    params = vit.init_params(cfg, generator=gen, device="cuda")
    px = torch.randn((2, 3, 384, 384), generator=gen, device="cuda")
    reset_launch_counts()
    got = vit.forward(params, px, cfg)
    torch.cuda.synchronize()
    mlp_mega = dtype == torch.float32
    assert launch_counts() == _counts(
        layernorm=1, matmul=1, mlp_block=2 if mlp_mega else 0,
        layernorm_stats=2 if mlp_mega else 4,
        fused_linear=4 if mlp_mega else 8, flash_attention=2)
    _close(got, vit.forward(params, px, cfg, impl="torch"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,d", [(588, 1280), (3072, 768)])
@pytest.mark.parametrize("b", [1, 3, 4])
def test_torch_cuda_embed_fused_ragged(gen, dtype, k, d, b):
    """K8 at H/14's (K=588) and B/32's (K=3072) patch lengths, 49 patches
    padded to 64 rows."""
    from vit_tpu_torch import ops

    n, sp = 49, 64
    args = (_rnd(gen, dtype, b, n, k), _rnd(gen, dtype, k, d, std=0.03),
            _rnd(gen, dtype, d, std=0.1), _rnd(gen, dtype, d),
            _rnd(gen, dtype, n, d))
    got = ops.embed_fused(*args, sp, impl="cuda")
    _close(got, ops.embed_fused(*args, sp, impl="torch"))
    assert not got[:, n + 1:].any()


def _stack_inputs(gen, dtype, b, *, d=128, heads=2, mlp=256, layers=2,
                  n=16, k=192, sp=32, wstd=1.0):
    """Random stacked encoder weights and the inputs of both K9 forms; the
    projections' spreads are scaled by ``wstd``."""
    enc = {
        "ln1": {"scale": _rnd(gen, dtype, layers, d, std=0.1, mean=1.0),
                "bias": _rnd(gen, dtype, layers, d, std=0.05)},
        "qkv": {"kernel": _rnd(gen, dtype, layers, d, 3 * d,
                               std=0.06 * wstd),
                "bias": _rnd(gen, dtype, layers, 3 * d, std=0.02)},
        "out": {"kernel": _rnd(gen, dtype, layers, d, d, std=0.06 * wstd),
                "bias": _rnd(gen, dtype, layers, d, std=0.02)},
        "ln2": {"scale": _rnd(gen, dtype, layers, d, std=0.1, mean=1.0),
                "bias": _rnd(gen, dtype, layers, d, std=0.05)},
        "fc1": {"kernel": _rnd(gen, dtype, layers, d, mlp, std=0.06 * wstd),
                "bias": _rnd(gen, dtype, layers, mlp, std=0.02)},
        "fc2": {"kernel": _rnd(gen, dtype, layers, mlp, d, std=0.04 * wstd),
                "bias": _rnd(gen, dtype, layers, d, std=0.02)},
    }
    x = _rnd(gen, dtype, b, sp, d)
    x[:, n + 1:] = 0
    patches = _rnd(gen, dtype, b, n, k)
    wemb = _rnd(gen, dtype, k, d, std=0.05)
    base = _rnd(gen, dtype, sp, d)
    base[n + 1:] = 0
    lnf = {"scale": _rnd(gen, dtype, d, std=0.1, mean=1.0),
           "bias": _rnd(gen, dtype, d, std=0.05)}
    return enc, x, patches, wemb, base, lnf


def _close_model(got, want):
    """A whole encoder: fp32 to 1e-4; bf16 to the model bar of
    chip_smoke.py, 5e-2 * (1 + |ref|), since a sum-order difference that
    flips a bf16 rounding carries into the next layer."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    bar = 1e-4 if got.dtype == torch.float32 else 5e-2 * (1 + w.abs())
    assert ((g - w).abs() <= bar).all(), (g - w).abs().max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 2, 3])
def test_torch_cuda_encoder_stack(gen, dtype, b):
    """Both forms of K9 against their plain versions at a narrow width,
    17 real tokens of 32; two calls agree bit for bit."""
    from vit_tpu_torch import ops

    enc, x, patches, wemb, base, lnf = _stack_inputs(gen, dtype, b)
    kw = dict(num_heads=2, scale=64 ** -0.5, seq_len=17)
    x0 = x.clone()
    got = ops.encoder_stack(x, enc, impl="cuda", **kw)
    _close_model(got, ops.encoder_stack(x, enc, impl="torch", **kw))
    assert torch.equal(got, ops.encoder_stack(x, enc, impl="cuda", **kw))
    assert torch.equal(x, x0)  # the kernel does not write its input
    fkw = dict(kw, sp=32)
    got = ops.encoder_stack_fused(patches, enc, wemb, base, lnf, impl="cuda",
                                  **fkw)
    _close_model(got, ops.encoder_stack_fused(patches, enc, wemb, base, lnf,
                                              impl="torch", **fkw))
    assert torch.equal(got, ops.encoder_stack_fused(
        patches, enc, wemb, base, lnf, impl="cuda", **fkw))


@pytest.mark.parametrize("heads,sp,seq_len", [
    (12, 416, 401),  # 156 32-row tiles: 84 of 64 rows, 13 key steps a part
    (24, 208, 197),  # head width 32: the core's two-step form
    (8, 208, 197),   # 96: the eight-step form, two steps skipped
    (6, 208, 197)])  # 128: the eight-step form
def test_torch_cuda_encoder_stack_attention_geometries(gen, heads, sp,
                                                       seq_len):
    """K9's bf16 attention phase (``attention_phase`` on the tensor-core
    core, 32-row tiles with the keys in four parts where they fit the
    grid in one round, else 64-row tiles in two) at D = 768 beyond B/16's
    geometry, two layers, b = 1: twice B/16's tokens (two parts), and the
    2-, 4- and 8-step forms of the core; against the plain version at the
    model bar, two calls bit for bit."""
    from vit_tpu_torch import ops

    enc, x = _stack_inputs(gen, torch.bfloat16, 1, d=768, heads=heads,
                           mlp=3072, layers=2, n=sp - 1, k=768, sp=sp,
                           wstd=(128 / 768) ** 0.5)[:2]
    kw = dict(num_heads=heads, seq_len=seq_len)
    got = ops.encoder_stack(x, enc, impl="cuda", **kw)
    _close_model(got, ops.encoder_stack(x, enc, impl="torch", **kw))
    assert torch.equal(got, ops.encoder_stack(x, enc, impl="cuda", **kw))


def _f32_tree(t):
    if isinstance(t, dict):
        return {k: _f32_tree(v) for k, v in t.items()}
    return t if t.dtype in (torch.int8, torch.float32) else t.float()


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("b", [1, 2])
def test_torch_cuda_encoder_stack_unscaled_weights_vs_fp32(gen, b):
    """K9's three forms at B/16's width and 208 tokens, two layers, with
    the 128-wide cases' weight spreads unscaled (``wstd=1``: std 0.06 at a
    fan-in of 768, where test_torch_cuda_encoder_stack_bf16_wgmma scales
    them): each form, and its plain version in bf16, held to an fp32 plain
    run of the same weights and inputs. The kernel may be no further from
    fp32 than its plain version (1.25x its relative distance + 1e-4, as
    ``chip_smoke.py`` holds K9 on int8 weights); the distances print with
    ``-s``."""
    from vit_tpu_torch import ops

    enc, x, patches, wemb, base, lnf = _stack_inputs(
        gen, torch.bfloat16, b, d=768, heads=12, mlp=3072, layers=2, n=196,
        k=768, sp=208)
    kw = dict(num_heads=12, seq_len=197)
    fkw = dict(kw, sp=208)
    qenc = _quantized(enc)
    forms = {
        "encoder_stack": lambda e, impl, f32=False: ops.encoder_stack(
            x.float() if f32 else x, e, impl=impl, **kw),
        "encoder_stack_fused": lambda e, impl, f32=False:
            ops.encoder_stack_fused(
                *((patches.float(), e, wemb.float(), base.float(),
                   _f32_tree(lnf)) if f32 else
                  (patches, e, wemb, base, lnf)), impl=impl, **fkw),
        "encoder_stack_q": lambda e, impl, f32=False: ops.encoder_stack_q(
            x.float() if f32 else x, e, impl=impl, **kw)}
    for name, run in forms.items():
        weights = qenc if name == "encoder_stack_q" else enc
        truth = run(_f32_tree(weights), "torch", True)
        got = run(weights, "cuda")
        plain = run(weights, "torch")
        torch.cuda.synchronize()
        kd, pd = _rel(got, truth), _rel(plain, truth)
        km = float((got.float() - truth).abs().max())
        pm = float((plain.float() - truth).abs().max())
        print(f"C2 b={b} {name}: kernel vs fp32 rel {kd:.6g} max {km:.6g}; "
              f"plain vs fp32 rel {pd:.6g} max {pm:.6g}; "
              f"kernel vs plain max "
              f"{float((got.float() - plain.float()).abs().max()):.6g}")
        assert torch.isfinite(got.float()).all()
        assert kd <= 1.25 * pd + 1e-4, (name, kd, pd)


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_cuda_stack_forward_counts_and_matches_plain(gen, dtype,
                                                           monkeypatch):
    """The tiny config with the stack plans patched on: one
    encoder_stack_fused launch and the head's matmul."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.config import ViTConfig
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    monkeypatch.setattr(ops, "stack_plan", lambda *a: True)
    monkeypatch.setattr(ops, "stack_fused_plan", lambda *a: True)
    cfg = ViTConfig(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
                    num_layers=2, mlp_dim=256, num_classes=10, dtype=dtype)
    params = vit.init_params(cfg, generator=gen, device="cuda")
    px = torch.randn((2, 3, 32, 32), generator=gen, device="cuda")
    reset_launch_counts()
    got = vit.forward(params, px, cfg)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(encoder_stack_fused=1, matmul=1)
    _close_model(got, vit.forward(params, px, cfg, impl="torch"))


def test_torch_cuda_stack_wrappers_check_inputs(gen):
    from vit_tpu_torch import ops

    enc, x, patches, wemb, base, lnf = _stack_inputs(gen, torch.float32, 1)
    kw = dict(num_heads=2, seq_len=17)
    with pytest.raises(ValueError, match="dtype"):
        ops.encoder_stack(x.to(torch.bfloat16), enc, impl="cuda", **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.encoder_stack(x.transpose(1, 2).contiguous().transpose(1, 2),
                          enc, impl="cuda", **kw)
    with pytest.raises(ValueError, match="head_dim"):
        # 256-wide heads at 208 tokens overflow the attention routine.
        wide, xw = _stack_inputs(gen, torch.float32, 1, d=512, mlp=128,
                                 layers=1, sp=208)[:2]
        ops.encoder_stack(xw, wide, num_heads=2, impl="cuda")
    with pytest.raises(ValueError, match="cpu"):
        ops.encoder_stack_fused(patches, enc, wemb.cpu(), base, lnf, sp=32,
                                impl="cuda", **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.embed_fused(patches, wemb.t().contiguous().t(), lnf["bias"],
                        lnf["bias"], base[1:17], 32, impl="cuda")


# ------------------------------------------------------------------ int8 --
#
# K11 and K10 without LN agree with their plain versions bit for bit (exact
# int32 sums, the same epilogue order); K10 with LN flips at most 0.1% of
# codes, by one, where the two LN sum orders differ; K12 and K9 on int8
# weights meet the bf16 bars in both dtypes (a flipped code moves a value by
# one quantization step, more than the fp32 bar).


def _quant_weight(gen, *shape, std=0.05):
    from vit_tpu_torch.quant import quantize_weight
    return quantize_weight(_rnd(gen, torch.float32, *shape, std=std))


def _close_bf16_bars(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    diff = (g - w).abs()
    assert (diff <= 2e-2 * (1 + w.abs())).all(), diff.max()
    assert diff.mean() <= 3e-3, diff.mean()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(5, 100), (37, 768), (3, 1280)])
@pytest.mark.parametrize("ln", [False, True])
def test_torch_cuda_quantize_rows(gen, dtype, rows, d, ln):
    from vit_tpu_torch import ops

    x = _rnd(gen, dtype, rows, d, std=2.0, mean=0.5)
    x[0] = 0  # a zero row: scale 1e-12 / 127, codes 0
    kw = {}
    if ln:
        kw = dict(ln_scale=_rnd(gen, dtype, d, std=0.1, mean=1.0),
                  ln_bias=_rnd(gen, dtype, d, std=0.05))
    (q, a), (qw, aw) = (ops.quantize_rows(x, impl=impl, **kw)
                        for impl in ("cuda", "torch"))
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and a.shape == (rows, 1)
    if not ln:
        assert torch.equal(q, qw) and torch.equal(a, aw)
        return
    assert ((a - aw).abs() <= 1e-5 * aw).all()
    flips = (q.int() - qw.int()).abs()
    assert flips.max() <= 1 and flips.float().mean() <= 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(37, 588, 100), (1, 768, 2304),
                                   (130, 24, 9), (64, 5120, 1280)])
def test_torch_cuda_matmul_i8_bit_exact(gen, dtype, m, k, n):
    """Ragged M, N and K; fc2's K=5120 sums exceed fp32's 2^24."""
    from vit_tpu_torch import ops

    xq, ax = ops.quantize_rows(_rnd(gen, dtype, m, k), impl="torch")
    w = _quant_weight(gen, k, n)
    b = _rnd(gen, dtype, n, std=0.1)
    r = _rnd(gen, dtype, m, n)
    for bias, act, res in ((None, None, None), (b, None, None),
                           (b, None, r), (b, "gelu", None)):
        args = (xq, ax, w["q"], w["scale"], bias, act)
        kw = dict(residual=res, out_dtype=dtype)
        got = ops.matmul_i8(*args, impl="cuda", **kw)
        want = ops.matmul_i8(*args, impl="torch", **kw)
        if act is None:
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        else:
            _close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n,path", [
    (6656, 768, 2304, "wgmma"),  # B/16 bs=32's QKV: the panel kept
    (200, 272, 144, "wgmma"),    # ragged M, K and N against the tile
    (70, 5120, 1280, "wgmma"),   # H/14's fc2: the panel streamed
    (33, 384, 48, "wgmma"),      # the model=2 shard's out-projection
    (37, 600, 100, "wmma"),      # N not a multiple of 16
    (130, 24, 200, "wmma"),      # K under 32, not a multiple of 16
])
def test_torch_cuda_matmul_i8_tiles(gen, dtype, m, k, n, path):
    """K11 on the tile :func:`i8_path` picks by shape: bit for bit with its
    plain version without GELU (every epilogue), two calls bit for bit,
    rows independent of M."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda.quant import i8_path

    xq, ax = ops.quantize_rows(_rnd(gen, dtype, m, k), impl="torch")
    w = _quant_weight(gen, k, n)
    assert i8_path(m, n, k, (xq.data_ptr(), w["q"].data_ptr())) == path
    b = _rnd(gen, dtype, n, std=0.1)
    r = _rnd(gen, dtype, m, n)
    for bias, res in ((None, None), (b, None), (b, r)):
        args = (xq, ax, w["q"], w["scale"], bias)
        kw = dict(residual=res, out_dtype=dtype)
        got = ops.matmul_i8(*args, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ops.matmul_i8(*args, impl="torch", **kw))
        assert torch.equal(ops.matmul_i8(*args, impl="cuda", **kw), got)
    part = ops.matmul_i8(xq[:m // 2 + 1], ax[:m // 2 + 1], w["q"],
                         w["scale"], b, out_dtype=dtype, impl="cuda")
    full = ops.matmul_i8(xq, ax, w["q"], w["scale"], b, out_dtype=dtype,
                         impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(part, full[:m // 2 + 1])
    _close(ops.matmul_i8(xq, ax, w["q"], w["scale"], b, "gelu",
                         out_dtype=dtype, impl="cuda"),
           ops.matmul_i8(xq, ax, w["q"], w["scale"], b, "gelu",
                         out_dtype=dtype, impl="torch"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,mlp,partial", [
    (6656, 768, 3072, False),   # B/16 bs=32
    (544, 1280, 5120, False),   # H/14 bs=2: two passes, one W1 slot
    (6656, 768, 1536, True),    # the model=2 shard
    (97, 384, 1024, False),     # ragged M, an odd box count
])
def test_torch_cuda_mlp_block_i8dot_tiles(gen, dtype, m, d, mlp, partial):
    """K12's s8 wgmma tile at the main paths' widths: the bf16 bars
    against its plain version, two calls bit for bit, rows 0-32 of an
    M = 33 call equal to those of the full call."""
    from vit_tpu_torch import ops

    w1, w2 = _quant_weight(gen, d, mlp, std=0.03), _quant_weight(
        gen, mlp, d, std=0.03)
    args = [_rnd(gen, dtype, m, d, std=1.5, mean=0.2),
            _rnd(gen, dtype, d, std=0.1, mean=1.0),
            _rnd(gen, dtype, d, std=0.05), w1["q"], w1["scale"],
            _rnd(gen, dtype, mlp, std=0.02), w2["q"], w2["scale"],
            _rnd(gen, dtype, d, std=0.02)]
    got = ops.mlp_block_i8dot(*args, partial_out=partial, impl="cuda")
    _close_bf16_bars(got, ops.mlp_block_i8dot(*args, partial_out=partial,
                                              impl="torch"))
    assert torch.equal(ops.mlp_block_i8dot(*args, partial_out=partial,
                                           impl="cuda"), got)
    args[0] = args[0][:33]
    part = ops.mlp_block_i8dot(*args, partial_out=partial, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(part, got[:33])


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("b,heads,s,seq_len", [(2, 3, 208, 197),
                                               (1, 2, 592, 577)])
def test_torch_cuda_flash_attention_fp32_output(gen, hd, b, heads, s,
                                                seq_len):
    """bf16 q, k, v from a packed buffer, an fp32 context."""
    from vit_tpu_torch import ops

    qkv = _rnd(gen, torch.bfloat16, b * s, 3 * heads * hd)
    q, k, v = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    kw = dict(scale=hd ** -0.5, seq_len=seq_len, out_dtype=torch.float32)
    got = ops.flash_attention(q, k, v, impl="cuda", **kw)
    assert got.dtype == torch.float32 and got.transpose(1, 2).is_contiguous()
    _close_bf16_bars(got, ops.flash_attention(q, k, v, impl="torch", **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,mlp", [(33, 128, 512), (70, 768, 1024),
                                     (17, 1280, 512), (5, 1024, 1536)])
def test_torch_cuda_mlp_block_i8dot(gen, dtype, m, d, mlp):
    from vit_tpu_torch import ops

    w1, w2 = _quant_weight(gen, d, mlp), _quant_weight(gen, mlp, d)
    args = (_rnd(gen, dtype, m, d), _rnd(gen, dtype, d, std=0.1, mean=1.0),
            _rnd(gen, dtype, d, std=0.05), w1["q"], w1["scale"],
            _rnd(gen, dtype, mlp, std=0.02), w2["q"], w2["scale"],
            _rnd(gen, dtype, d, std=0.02))
    _close_bf16_bars(ops.mlp_block_i8dot(*args, impl="cuda"),
                     ops.mlp_block_i8dot(*args, impl="torch"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_cuda_attn_block_q(gen, dtype):
    """The five launches against the plain version, 17 of 32 tokens."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    b, s, d, heads = 3, 32, 128, 2
    wqkv, wout = _quant_weight(gen, d, 3 * d), _quant_weight(gen, d, d)
    args = (_rnd(gen, dtype, b, s, d), _rnd(gen, dtype, d, std=0.1, mean=1.0),
            _rnd(gen, dtype, d, std=0.05), wqkv["q"], wqkv["scale"],
            _rnd(gen, dtype, 3 * d, std=0.02), wout["q"], wout["scale"],
            _rnd(gen, dtype, d, std=0.02))
    reset_launch_counts()
    got = ops.attn_block_q(*args, num_heads=heads, seq_len=17)
    assert launch_counts() == _counts(quantize_rows=2, matmul_i8=2,
                                      flash_attention=1)
    want = ops.attn_block_q(*args, num_heads=heads, seq_len=17, impl="torch")
    _close_bf16_bars(got[:, :17], want[:, :17])


def _quantized(enc):
    from vit_tpu_torch.quant import quantize_params
    return quantize_params({"encoder": enc})["encoder"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 2, 3])
def test_torch_cuda_encoder_stack_q(gen, dtype, b):
    """K9 on int8 weights against its plain version: fp32 to 1e-4 (weight
    only, so only the sum order differs), bf16 to the model bar; two calls
    agree bit for bit and the input is not written."""
    from vit_tpu_torch import ops

    enc, x = _stack_inputs(gen, dtype, b)[:2]
    qenc = _quantized(enc)
    kw = dict(num_heads=2, scale=64 ** -0.5, seq_len=17)
    x0 = x.clone()
    got = ops.encoder_stack_q(x, qenc, impl="cuda", **kw)
    _close_model(got, ops.encoder_stack_q(x, qenc, impl="torch", **kw))
    assert torch.equal(got, ops.encoder_stack_q(x, qenc, impl="cuda", **kw))
    assert torch.equal(x, x0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["stack", "layers"])
def test_torch_cuda_forward_quant_counts_and_matches_plain(gen, dtype, route,
                                                           monkeypatch):
    from vit_tpu_torch import ops, quant
    from vit_tpu_torch.config import ViTConfig
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    monkeypatch.setattr(ops, "stack_q_plan", lambda *a: route == "stack")
    cfg = ViTConfig(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
                    num_layers=2, mlp_dim=512, num_classes=10, dtype=dtype)
    qp = quant.quantize_params(vit.init_params(cfg, generator=gen))
    px = torch.randn((3, 3, 32, 32), generator=gen, device="cuda")
    reset_launch_counts()
    got = quant.forward_quant(qp, px, cfg)
    torch.cuda.synchronize()
    assert launch_counts() == (
        _counts(embed_fused=1, encoder_stack_q=1, layernorm=1, matmul=1)
        if route == "stack" else
        _counts(embed_fused=1, quantize_rows=4, matmul_i8=4,
                flash_attention=2, mlp_block_i8dot=2, layernorm=1, matmul=1))
    _close_bf16_bars(got, quant.forward_quant(qp, px, cfg, impl="torch"))


def test_torch_cuda_int8_wrappers_check_inputs(gen):
    from vit_tpu_torch import ops

    x = _rnd(gen, torch.float32, 4, 128)
    xq, ax = ops.quantize_rows(x)
    w = _quant_weight(gen, 128, 512)
    with pytest.raises(ValueError, match="dtype"):
        ops.matmul_i8(xq, ax, w["q"].float(), w["scale"], out_dtype=x.dtype)
    with pytest.raises(ValueError, match="shape"):
        ops.matmul_i8(xq, ax[:2], w["q"], w["scale"], out_dtype=x.dtype)
    v = _rnd(gen, torch.float32, 128)
    with pytest.raises(ValueError, match="quant group"):
        w2 = _quant_weight(gen, 256, 128)
        ops.mlp_block_i8dot(x, v, v, _quant_weight(gen, 128, 256)["q"],
                            _rnd(gen, torch.float32, 256), _rnd(
                                gen, torch.float32, 256), w2["q"],
                            w2["scale"], v)


# ------------------------------------------------ training (K13, Functions)

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,heads,s,seq_len,hd", [
    (1, 2, 1, 1, 16), (2, 3, 17, 17, 64), (1, 2, 65, 60, 80),
    (2, 4, 208, 197, 64), (1, 2, 592, 577, 64), (1, 2, 208, 197, 128),
    (3, 1, 65, 65, 128), (1, 3, 40, 33, 16), (1, 2, 816, 800, 64),
    (2, 2, 100, 71, 32)])
def test_torch_cuda_flash_attention_bwd(gen, dtype, b, heads, s, seq_len, hd):
    """K13 against its plain version, contiguous operands and strided views
    of a packed QKV buffer with g a (B, S, H, d) buffer's view; two calls
    agree bit for bit. 816 tokens is past the 768 where JAX leaves its
    kernel: K13 takes every S."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference

    kw = dict(scale=hd ** -0.5, seq_len=seq_len)
    q, k, v, g = (_rnd(gen, dtype, b, heads, s, hd) for _ in range(4))
    got = ops.flash_attention_bwd(q, k, v, g, impl="cuda", **kw)
    assert got.shape == (b, s, 3, heads, hd) and got.is_contiguous()
    _close(got, ops.flash_attention_bwd(q, k, v, g, impl="torch", **kw))
    qkv = _rnd(gen, dtype, b * s, 3 * heads * hd)
    q, k, v = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    g = _rnd(gen, dtype, b, s, heads, hd).transpose(1, 2)
    got = ops.flash_attention_bwd(q, k, v, g, impl="cuda", **kw)
    _close(got, ops.flash_attention_bwd(q, k, v, g, impl="torch", **kw))
    again = ops.flash_attention_bwd(q, k, v, g, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _, dk, dv = reference.split_qkv(got)
    assert not dk[:, :, seq_len:].any() and not dv[:, :, seq_len:].any()


@pytest.mark.parametrize("b,heads,s,seq_len,hd", [
    (2, 3, 100, 71, 16), (2, 4, 208, 197, 64), (1, 4, 272, 257, 80),
    (1, 2, 208, 197, 128), (1, 2, 130, 64, 64), (2, 16, 272, 257, 80)])
def test_torch_cuda_flash_attention_bwd_fp32_tiles(gen, b, heads, s, seq_len,
                                                   hd):
    """K13's fp32 form on mma.sync tf32 in three passes at head widths 16,
    64, 80 and 128, ragged seq_len, a key tile past seq_len (130 tokens, 64
    real) and H/14's 257 of 272 tokens, on packed QKV views: within 1e-4
    of its plain version, two calls bit for bit, zero dk and dv on the
    masked keys, query rows past S unwritten."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference

    dt = torch.float32
    kw = dict(scale=hd ** -0.5, seq_len=seq_len)
    qkv = _rnd(gen, dt, b * s, 3 * heads * hd)
    q, k, v = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    g = _rnd(gen, dt, b, s, heads, hd).transpose(1, 2)
    got = ops.flash_attention_bwd(q, k, v, g, impl="cuda", **kw)
    _close(got, ops.flash_attention_bwd(q, k, v, g, impl="torch", **kw))
    again = ops.flash_attention_bwd(q, k, v, g, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _, dk, dv = reference.split_qkv(got)
    assert not dk[:, :, seq_len:].any() and not dv[:, :, seq_len:].any()


def _grads(fn, args, g):
    leaves = [a.detach().requires_grad_() for a in args]
    torch.autograd.backward(fn(*leaves), g)
    return [t.grad for t in leaves]


def _close_grads(got, want, dtype):
    """Per tensor: fp32 max|diff| <= 1e-3 max|ref| (the backward's sum
    orders, through a remat chain); bf16 relative norm <= 2e-2 (the
    kernel route rounds where JAX's VJPs round, PyTorch's autograd of the
    plain ops where the forward casts)."""
    torch.cuda.synchronize()
    for gt, w in zip(got, want):
        assert gt is not None and torch.isfinite(gt).all()
        gt, w = gt.float(), w.float()
        if dtype == torch.float32:
            assert (gt - w).abs().max() <= 1e-3 * w.abs().max()
        else:
            assert (gt - w).norm() <= 2e-2 * w.norm()


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_cuda_block_backwards_match_plain(gen, dtype):
    """``AttnBlock`` (208 tokens, 197 real) and ``MlpBlock`` backward
    through the kernels against PyTorch's autograd of the plain ops, with
    the launches of one backward: the remat forward (K5 + K6, K7, K2;
    K5 + K6, K2) and its products on K2, K13 once."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    b, s, d, mlp, heads = 2, 208, 256, 512, 4
    x = _rnd(gen, dtype, b, s, d)
    ln = (_rnd(gen, dtype, d, std=0.1, mean=1.0),
          _rnd(gen, dtype, d, std=0.05))
    attn = (*ln, _rnd(gen, dtype, d, 3 * d, std=0.05),
            _rnd(gen, dtype, 3 * d, std=0.02),
            _rnd(gen, dtype, d, d, std=0.05),
            _rnd(gen, dtype, d, std=0.02))
    mlpw = (*ln, _rnd(gen, dtype, d, mlp, std=0.05), _rnd(gen, dtype, mlp),
            _rnd(gen, dtype, mlp, d, std=0.05), _rnd(gen, dtype, d))
    g = _rnd(gen, dtype, b, s, d)

    def attn_fn(impl):
        return lambda *a: ops.attn_block(*a, num_heads=heads, seq_len=197,
                                         impl=impl)

    def mlp_fn(impl):
        return lambda *a: ops.mlp_block(*a, impl=impl)
    for fn, args, expect in (
            (attn_fn, (x, *attn), dict(
                layernorm=1, matmul=6, attention=1, layernorm_stats=1,
                fused_linear=2, flash_attention=1, flash_attention_bwd=1)),
            (mlp_fn, (x, *mlpw), dict(mlp_block=1, layernorm_stats=1,
                                      fused_linear=2, matmul=5))):
        reset_launch_counts()
        got = _grads(fn(None), args, g)
        torch.cuda.synchronize()
        assert launch_counts() == _counts(**expect)
        _close_grads(got, _grads(fn("torch"), args, g), dtype)


# ------------------------------------ the reference op chain (K14-K17) --

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 7, 4099, 6304 * 768 + 3])
def test_torch_cuda_add_bit_exact(gen, dtype, n):
    """K14 at counts that are no multiple of 8 (the scalar tail), and on
    views whose offset breaks 16-byte alignment (the scalar path)."""
    from vit_tpu_torch import ops

    x, y = _rnd(gen, dtype, n + 1), _rnd(gen, dtype, n + 1)
    for a, b in ((x[:n], y[:n]), (x[1:], y[1:]), (x[1:], y[:n])):
        got = ops.add(a, b, impl="cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, ops.add(a, b, impl="torch"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 197, 1000, 4097])
def test_torch_cuda_softmax(gen, dtype, d):
    """One warp a row up to 1024 wide, one block a row above; a row with a
    large offset."""
    from vit_tpu_torch import ops

    x = _rnd(gen, dtype, 3, 37, d, std=4.0)
    x[0, 0] += 80
    got = ops.softmax(x, impl="cuda")
    _close(got, ops.softmax(x, impl="torch"))
    assert ((got.float().sum(-1) - 1).abs() <= 1e-2).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,m,k,n", [(24, 197, 64, 197), (24, 197, 197, 64),
                                     (3, 70, 33, 129), (1, 1, 5, 1),
                                     (2, 300, 200, 260)])
@pytest.mark.parametrize("scale", [None, 0.125])
def test_torch_cuda_matmul3_ragged(gen, dtype, b, m, k, n, scale):
    """K16 at the unfused attention's shapes (K = 64 and 197) and ragged
    ones; two calls agree bit for bit."""
    from vit_tpu_torch import ops

    x, y = _rnd(gen, dtype, b, m, k), _rnd(gen, dtype, b, k, n, std=0.3)
    got = ops.matmul3(x, y, scale=scale, impl="cuda")
    _close(got, ops.matmul3(x, y, scale=scale, impl="torch"))
    again = ops.matmul3(x, y, scale=scale, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [768, 1024, 1280])
@pytest.mark.parametrize("m", [1, 17, 6656])
def test_torch_cuda_mlp_block_q(gen, dtype, d, m):
    """K17 at every VARIANTS width (mlp 1024: two chunks; 4*D at 17 rows);
    nothing is quantized but the weights, so the kernel bars hold."""
    from vit_tpu_torch import ops

    for mlp in ((1024, 4 * d) if m == 17 else (1024,)):
        w1, w2 = _quant_weight(gen, d, mlp), _quant_weight(gen, mlp, d)
        args = (_rnd(gen, dtype, m, d), _rnd(gen, dtype, d, std=0.1, mean=1.0),
                _rnd(gen, dtype, d, std=0.05), w1["q"], w1["scale"],
                _rnd(gen, dtype, mlp, std=0.02), w2["q"], w2["scale"],
                _rnd(gen, dtype, d, std=0.02))
        _close(ops.mlp_block_q(*args, impl="cuda"),
               ops.mlp_block_q(*args, impl="torch"))


@pytest.mark.parametrize("m,d,mlp,partial", [
    (200, 768, 3072, False), (70, 1024, 4096, False), (33, 1280, 1024, False),
    (70, 768, 1536, True)])
def test_torch_cuda_mlp_block_q_bf16_tiles(gen, m, d, mlp, partial):
    """K17's bf16 ``wgmma`` tile (``csrc/mlp_q_wgmma.cuh``) at real widths:
    B/16's (two passes, ragged 64-row clusters), L/16's (two passes, four
    boxes a block each), H/14's (three passes, one W2 slot) and B/16's
    shard form over model=2, at the kernel bar with mean <= 3e-3; two calls
    bit for bit; rows 0-32 the same bits in an M = 33 call as in the M-row
    call (no sum runs over rows)."""
    from vit_tpu_torch import ops

    w1, w2 = _quant_weight(gen, d, mlp, std=0.03), _quant_weight(
        gen, mlp, d, std=0.03)
    args = (_rnd(gen, torch.bfloat16, m, d, std=1.5, mean=0.2),
            _rnd(gen, torch.bfloat16, d, std=0.1, mean=1.0),
            _rnd(gen, torch.bfloat16, d, std=0.05), w1["q"], w1["scale"],
            _rnd(gen, torch.bfloat16, mlp, std=0.02), w2["q"], w2["scale"],
            _rnd(gen, torch.bfloat16, d, std=0.02))
    got = ops.mlp_block_q(*args, partial_out=partial, impl="cuda")
    _close_bf16_bars(got, ops.mlp_block_q(*args, partial_out=partial,
                                          impl="torch"))
    again = ops.mlp_block_q(*args, partial_out=partial, impl="cuda")
    head = ops.mlp_block_q(args[0][:33], *args[1:], partial_out=partial,
                           impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(head, got[:33])


def _q_mlp_args(gen, m, d, mlp, x=None):
    w1, w2 = _quant_weight(gen, d, mlp, std=0.03), _quant_weight(
        gen, mlp, d, std=0.03)
    x = _rnd(gen, torch.float32, m, d, std=1.5, mean=0.2) if x is None else x
    return (x, _rnd(gen, torch.float32, d, std=0.1, mean=1.0),
            _rnd(gen, torch.float32, d, std=0.05), w1["q"], w1["scale"],
            _rnd(gen, torch.float32, mlp, std=0.02), w2["q"], w2["scale"],
            _rnd(gen, torch.float32, d, std=0.02))


@pytest.mark.parametrize("m,d,mlp,partial", [
    (37, 128, 512, False), (65, 128, 1024, True), (200, 768, 3072, False),
    (70, 768, 1536, True), (70, 1024, 4096, False), (33, 1024, 512, True),
    (70, 1280, 5120, False), (33, 1280, 1024, True)])
def test_torch_cuda_mlp_block_q_tf32_tiles(gen, m, d, mlp, partial):
    """K17's fp32 form on the tensor cores (``csrc/mlp_tf32.cuh``'s Q
    flag: the int8 codes exact as TF32 A operands, two passes a product)
    at ragged M, D 128 (the 32-row form of two groups), 768 (B/16's; its
    shard over model=2), 1024 (the 16-row form) and 1280 (H/14's, fc1 in
    K = 128 parts), whole and partial: the form ``mlp_q_f32_form`` gives,
    within 1e-4 of the plain version, two calls bit for bit, rows 0-32 of
    an M = 33 call the same bits as in the M-row call, one launch."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.ops.cuda import quant

    args = _q_mlp_args(gen, m, d, mlp)
    assert quant.mlp_q_f32_form(d, mlp, (args[0].data_ptr(),
                                         args[3].data_ptr(),
                                         args[6].data_ptr())) == "tf32"
    reset_launch_counts()
    got = ops.mlp_block_q(*args, partial_out=partial, impl="cuda")
    torch.cuda.synchronize()
    name = "mlp_block_q_partial" if partial else "mlp_block_q"
    assert launch_counts() == _counts(**{name: 1})
    _close(got, ops.mlp_block_q(*args, partial_out=partial, impl="torch"))
    again = ops.mlp_block_q(*args, partial_out=partial, impl="cuda")
    head = ops.mlp_block_q(args[0][:33], *args[1:], partial_out=partial,
                           impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(head, got[:33])


def test_torch_cuda_mlp_block_q_fp32_ffma_form(gen):
    """Where TMA cannot read x (a base 4 bytes past 16-byte alignment) K17
    keeps its FFMA form, within 1e-4 of the plain version; the library
    refuses the tensor-core form there (no stand-in)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import _build, quant

    m, d, mlp = 40, 256, 512
    x = torch.empty(m * d + 1, device="cuda")[1:].view(m, d)
    x.copy_(_rnd(gen, torch.float32, m, d))
    args = _q_mlp_args(gen, m, d, mlp, x=x)
    assert quant.mlp_q_f32_form(d, mlp, (x.data_ptr(), args[3].data_ptr(),
                                         args[6].data_ptr())) == "ffma"
    _close(ops.mlp_block_q(*args, impl="cuda"),
           ops.mlp_block_q(*args, impl="torch"))
    out = torch.empty_like(x)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("vit_mlp_block_q", *args, out, m, d, mlp, 1e-12, 0, 1,
                      like=x)


@pytest.mark.parametrize("b", [1, 2])
def test_torch_cuda_encoder_stack_bf16_wgmma(gen, b):
    """K9's three forms on the bf16 ``wgmma`` phases (``csrc/
    stack_wgmma.cuh``) at B/16's width and token count, two layers: 197
    real tokens of 208 (the out-projection and fc2 split over K five and
    three ways at b = 1, 2), against their plain versions at the model bar;
    two calls bit for bit. The projections' spreads are those of the
    128-wide cases scaled by sqrt(128 / 768), so that the activations are
    as large as there (at the 128-wide spreads the parent's K9 missed the
    model bar too)."""
    from vit_tpu_torch import ops

    enc, x, patches, wemb, base, lnf = _stack_inputs(
        gen, torch.bfloat16, b, d=768, heads=12, mlp=3072, layers=2,
        n=196, k=768, sp=208, wstd=(128 / 768) ** 0.5)
    kw = dict(num_heads=12, seq_len=197)
    got = ops.encoder_stack(x, enc, impl="cuda", **kw)
    _close_model(got, ops.encoder_stack(x, enc, impl="torch", **kw))
    assert torch.equal(got, ops.encoder_stack(x, enc, impl="cuda", **kw))
    fkw = dict(kw, sp=208)
    got = ops.encoder_stack_fused(patches, enc, wemb, base, lnf, impl="cuda",
                                  **fkw)
    _close_model(got, ops.encoder_stack_fused(patches, enc, wemb, base, lnf,
                                              impl="torch", **fkw))
    assert torch.equal(got, ops.encoder_stack_fused(
        patches, enc, wemb, base, lnf, impl="cuda", **fkw))
    qenc = _quantized(enc)
    got = ops.encoder_stack_q(x, qenc, impl="cuda", **kw)
    _close_model(got, ops.encoder_stack_q(x, qenc, impl="torch", **kw))
    assert torch.equal(got, ops.encoder_stack_q(x, qenc, impl="cuda", **kw))


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_cuda_matmul3_backward_counts(gen, dtype):
    """``Matmul3``'s backward is two K16 launches; ``Softmax``'s and
    ``Add``'s launch nothing."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    x, y = _rnd(gen, dtype, 6, 197, 64), _rnd(gen, dtype, 6, 64, 197)
    g = _rnd(gen, dtype, 6, 197, 197)

    def chain(impl):
        return lambda x, y: ops.add(ops.softmax(ops.matmul3(
            x, y, scale=0.125, impl=impl), impl=impl), g, impl=impl)
    reset_launch_counts()
    got = _grads(chain(None), (x, y), g)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(matmul3=3, softmax=1, add=1)
    _close_grads(got, _grads(chain("torch"), (x, y), g), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attention,fused", [("unfused", True),
                                             ("unfused", False),
                                             ("flash", False)])
@pytest.mark.parametrize("b", [1, 3])
def test_torch_cuda_route_counts_and_matches_plain(gen, dtype, attention,
                                                   fused, b):
    """The tiny config on the unfused and ``fused=False`` routes: exact
    launch counts (17 tokens, bs=1 and 3: the flash chain embeds through
    K8, the unfused routes through the patch projection) and the model
    bars."""
    from vit_tpu_torch.config import ViTConfig
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = ViTConfig(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
                    num_layers=2, mlp_dim=256, num_classes=10, dtype=dtype)
    params = vit.init_params(cfg, generator=gen, device="cuda")
    px = torch.randn((b, 3, 32, 32), generator=gen, device="cuda")
    reset_launch_counts()
    got = vit.forward(params, px, cfg, attention=attention, fused=fused)
    torch.cuda.synchronize()
    attn = (dict(matmul3=4, softmax=2) if attention == "unfused"
            else dict(flash_attention=2, embed_fused=1))
    embed = int(attention == "unfused")
    chain = (dict(layernorm=5, matmul=8 + embed + 1, add=4) if not fused
             else dict(layernorm=1, layernorm_stats=4, fused_linear=8,
                       matmul=embed + 1))
    assert launch_counts() == _counts(**attn, **chain)
    _close_model(got, vit.forward(params, px, cfg, attention=attention,
                                  fused=fused, impl="torch"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_cuda_forward_quant_weight_only_counts(gen, dtype, monkeypatch):
    """``forward_quant(int8_dot=False)`` on the per-layer route: K17 in
    place of K12, the bf16 bars against the plain version."""
    from vit_tpu_torch import ops, quant
    from vit_tpu_torch.config import ViTConfig
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    monkeypatch.setattr(ops, "stack_q_plan", lambda *a: False)
    cfg = ViTConfig(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
                    num_layers=2, mlp_dim=512, num_classes=10, dtype=dtype)
    qp = quant.quantize_params(vit.init_params(cfg, generator=gen))
    px = torch.randn((3, 3, 32, 32), generator=gen, device="cuda")
    reset_launch_counts()
    got = quant.forward_quant(qp, px, cfg, int8_dot=False)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(
        embed_fused=1, quantize_rows=4, matmul_i8=4, flash_attention=2,
        mlp_block_q=2, layernorm=1, matmul=1)
    _close_bf16_bars(got, quant.forward_quant(qp, px, cfg, int8_dot=False,
                                              impl="torch"))


# --------------------------------------------- tensor-parallel partials --

@pytest.mark.parametrize("dtype,m,d,mlp", [
    (torch.bfloat16, 33, 128, 256), (torch.bfloat16, 70, 768, 768),
    (torch.float32, 33, 100, 200), (torch.float32, 17, 768, 1536)])
def test_torch_cuda_mlp_block_partial(gen, dtype, m, d, mlp):
    """K3 with ``partial_out=True``: no residual, ``b2`` not read; counted
    as ``mlp_block_partial``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    args = [_rnd(gen, dtype, m, d), _rnd(gen, dtype, d, std=0.1, mean=1.0),
            _rnd(gen, dtype, d, std=0.05), _rnd(gen, dtype, d, mlp, std=0.05),
            _rnd(gen, dtype, mlp, std=0.02), _rnd(gen, dtype, mlp, d, std=0.05),
            _rnd(gen, dtype, d, std=0.02)]
    reset_launch_counts()
    got = ops.mlp_block(*args, partial_out=True, impl="cuda")
    assert launch_counts() == _counts(mlp_block_partial=1)
    _close(got, ops.mlp_block(*args, partial_out=True, impl="torch"))
    args[-1] = torch.full_like(args[-1], float("nan"))
    assert torch.equal(ops.mlp_block(*args, partial_out=True, impl="cuda"),
                       got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["mlp_block_i8dot", "mlp_block_q"])
@pytest.mark.parametrize("m,d,mlp", [(33, 128, 512), (17, 1280, 1024)])
def test_torch_cuda_int8_mlp_partial(gen, dtype, kernel, m, d, mlp):
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    w1, w2 = _quant_weight(gen, d, mlp), _quant_weight(gen, mlp, d)
    args = (_rnd(gen, dtype, m, d), _rnd(gen, dtype, d, std=0.1, mean=1.0),
            _rnd(gen, dtype, d, std=0.05), w1["q"], w1["scale"],
            _rnd(gen, dtype, mlp, std=0.02), w2["q"], w2["scale"],
            torch.full((d,), float("nan"), dtype=dtype, device="cuda"))
    reset_launch_counts()
    got = getattr(ops, kernel)(*args, partial_out=True, impl="cuda")
    assert launch_counts() == _counts(**{f"{kernel}_partial": 1})
    want = getattr(ops, kernel)(*args, partial_out=True, impl="torch")
    (_close_bf16_bars if kernel == "mlp_block_i8dot" else _close)(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,seq_len,d,heads,hd", [
    (3, 32, 17, 256, 2, 64), (1, 272, 257, 640, 4, 80),
    (1, 592, 577, 256, 2, 64)])
def test_torch_cuda_attn_block_partial(gen, dtype, b, s, seq_len, d, heads,
                                       hd):
    """B16 on one shard (``heads`` local heads of ``hd``): K1, K2, the
    attention core, K2, with no count of its own; where the core's shared
    memory refuses the length (592 tokens; 272 at hd=80 in fp32) K7 takes
    its place."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    dl = heads * hd
    args = (_rnd(gen, dtype, b, s, d), _rnd(gen, dtype, d, std=0.1, mean=1.0),
            _rnd(gen, dtype, d, std=0.05), _rnd(gen, dtype, d, 3 * dl,
                                                std=0.05),
            _rnd(gen, dtype, 3 * dl, std=0.02), _rnd(gen, dtype, dl, d,
                                                     std=0.05))
    reset_launch_counts()
    got = ops.attn_block_partial(*args, num_heads=heads, seq_len=seq_len)
    core = ({"attention": 1} if ops.attn_plan(b, s, dl, heads, dtype)
            else {"flash_attention": 1})
    assert ("attention" in core) == (s < 592 and (dtype == torch.bfloat16
                                                  or hd == 64))
    assert launch_counts() == _counts(layernorm=1, matmul=2, **core)
    want = ops.attn_block_partial(*args, num_heads=heads, seq_len=seq_len,
                                  impl="torch")
    _close(got[:, :seq_len], want[:, :seq_len])


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_cuda_attn_block_q_partial(gen, dtype):
    """B17 on one shard of 2 heads (dl=128) at D=256, 17 of 32 tokens."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    b, s, d, heads, dl = 3, 32, 256, 2, 128
    wqkv, wout = _quant_weight(gen, d, 3 * dl), _quant_weight(gen, dl, d)
    args = (_rnd(gen, dtype, b, s, d), _rnd(gen, dtype, d, std=0.1, mean=1.0),
            _rnd(gen, dtype, d, std=0.05), wqkv["q"], wqkv["scale"],
            _rnd(gen, dtype, 3 * dl, std=0.02), wout["q"], wout["scale"])
    reset_launch_counts()
    got = ops.attn_block_q_partial(*args, num_heads=heads, seq_len=17)
    assert launch_counts() == _counts(quantize_rows=2, matmul_i8=2,
                                      flash_attention=1)
    want = ops.attn_block_q_partial(*args, num_heads=heads, seq_len=17,
                                    impl="torch")
    _close_bf16_bars(got[:, :17], want[:, :17])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tier", ["float", "int8", "int8_composed"])
def test_torch_cuda_tp_forward_one_rank(gen, dtype, tier):
    """``make_tp_forward`` on a mesh of one rank (no process group): the
    partial kernels with the bias and residual added after them, launch
    counts exact, held to its plain version at the model bar. At D=64 the
    int8 MLP half is composed (K10, K11, K10, K11), as JAX composes it."""
    from vit_tpu_torch import parallel, quant as q
    from vit_tpu_torch.config import ViTConfig
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    quant = tier != "float"
    d = 64 if tier == "int8_composed" else 256
    cfg = ViTConfig(image_size=32, patch_size=8, hidden_dim=d, num_heads=4,
                    num_layers=2, mlp_dim=2 * d, num_classes=10, dtype=dtype)
    params = vit.init_params(cfg, generator=gen)
    if quant:
        params = q.quantize_params(params)
    mesh = parallel.make_mesh(1, 1)
    tp = parallel.prepare_tp_params(params, cfg, mesh)
    px = torch.randn((3, 3, 32, 32), generator=gen, device="cuda")
    fn = parallel.make_tp_forward(cfg, mesh, quant=quant)
    reset_launch_counts()
    got = fn(tp, px)
    torch.cuda.synchronize()
    want = {"float": dict(layernorm=3, matmul=6, attention=2,
                          mlp_block_partial=2),
            "int8": dict(quantize_rows=4, matmul_i8=4, flash_attention=2,
                         mlp_block_i8dot_partial=2, layernorm=1, matmul=2),
            "int8_composed": dict(quantize_rows=8, matmul_i8=8,
                                  flash_attention=2, layernorm=1, matmul=2)}
    assert launch_counts() == _counts(**want[tier])
    want = parallel.make_tp_forward(cfg, mesh, quant=quant, impl="torch")(
        tp, px)
    (_close_bf16_bars if quant else _close_model)(got, want)


# ------------------------------- the full layer and the standalone kernels --

def _layer_args(gen, dtype, b, s, d, mlp, seq_len):
    """x (B, S, D) with the rows from seq_len on zeroed, then the twelve
    weights of a layer."""
    x = _rnd(gen, dtype, b, s, d)
    x[:, seq_len:] = 0
    ln = lambda: (_rnd(gen, dtype, d, std=0.1, mean=1.0),  # noqa: E731
                  _rnd(gen, dtype, d, std=0.05))
    return (x, *ln(), _rnd(gen, dtype, d, 3 * d, std=0.05),
            _rnd(gen, dtype, 3 * d, std=0.02), _rnd(gen, dtype, d, d, std=0.05),
            _rnd(gen, dtype, d, std=0.02), *ln(),
            _rnd(gen, dtype, d, mlp, std=0.05), _rnd(gen, dtype, mlp, std=0.02),
            _rnd(gen, dtype, mlp, d, std=0.05), _rnd(gen, dtype, d, std=0.02))


@pytest.mark.parametrize("dtype,b,s,seq_len,d,heads,mlp", [
    (torch.bfloat16, 3, 48, 37, 768, 12, 512),
    (torch.bfloat16, 1, 208, 197, 1024, 16, 1024),
    (torch.bfloat16, 1, 592, 577, 256, 4, 256),
    (torch.float32, 1, 40, 33, 1280, 16, 520),
    (torch.float32, 3, 48, 37, 768, 12, 3072)])
def test_torch_cuda_layer_block(gen, dtype, b, s, seq_len, d, heads, mlp):
    """K18 after the attention launches, against the plain version, at
    rows that are not whole blocks (M = 144, 208, 592, 40), masked keys, and
    D = 768 and 1024 in bf16 and 1280 in fp32 (mlp not a multiple of 128).
    Counts: K1, K2, the attention core (K7 where its shared memory refuses
    592 tokens), K18 as ``layer_block``."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    args = _layer_args(gen, dtype, b, s, d, mlp, seq_len)
    kw = dict(num_heads=heads, seq_len=seq_len)
    reset_launch_counts()
    got = ops.layer_block(*args, **kw, impl="cuda")
    torch.cuda.synchronize()
    core = "flash_attention" if s == 592 else "attention"
    assert launch_counts() == _counts(layernorm=1, matmul=1, layer_block=1,
                                      **{core: 1})
    (_close if dtype == torch.float32 else _close_bf16_bars)(
        got, ops.layer_block(*args, **kw, impl="torch"))


def test_torch_cuda_layer_block_keeps_y_in_fp32(gen):
    """K18's rounding point, at the CPU pin's inputs
    (``tests/test_torch_layer.py:test_torch_layer_block_keeps_y_in_fp32``:
    ``tests/test_block.py:_layer_inputs`` at seed 5, seq_len 27, bf16).
    Over the real rows the kernel route sits within the mean bar of the
    plain ``layer_block``, and the plain pair ``attn_block`` ->
    ``mlp_block``, which rounds y to bf16 between the halves, sits outside
    it. A K18 that rounded y before LN2 or the accumulator seed would land
    with the pair."""
    import numpy as np

    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference

    rng = np.random.default_rng(5)
    b, s, d, mlp, seq_len = 2, 32, 256, 512, 27
    arr = lambda *sh, sc=0.1: (  # noqa: E731
        rng.standard_normal(sh) * sc).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    x[:, seq_len:] = 0
    args = [torch.from_numpy(a).to("cuda", torch.bfloat16) for a in (
        x, arr(d, sc=0.5) + 1, arr(d), arr(d, 3 * d), arr(3 * d),
        arr(d, d), arr(d), arr(d, sc=0.5) + 1, arr(d), arr(d, mlp),
        arr(mlp), arr(mlp, d), arr(d))]
    kw = dict(num_heads=4, seq_len=seq_len)
    want = reference.layer_block(*args, **kw)[:, :seq_len].float()
    got = ops.layer_block(*args, **kw, impl="cuda")[:, :seq_len].float()
    pair = reference.mlp_block(reference.attn_block(*args[:7], **kw),
                               *args[7:])[:, :seq_len].float()
    d_got = (got - want).abs().mean().item()
    d_pair = (pair - want).abs().mean().item()
    assert d_got <= 3e-3 < d_pair, (d_got, d_pair)


def _tail_args(gen, m, d, mlp):
    """K18's operands alone (``layer_tail``): ctx, x, then the ten
    weights of the out-projection and the MLP half, in bf16."""
    b = torch.bfloat16
    return (_rnd(gen, b, m, d), _rnd(gen, b, m, d, std=1.5),
            _rnd(gen, b, d, d, std=0.03), _rnd(gen, b, d, std=0.02),
            _rnd(gen, b, d, std=0.1, mean=1.0), _rnd(gen, b, d, std=0.05),
            _rnd(gen, b, d, mlp, std=0.03), _rnd(gen, b, mlp, std=0.02),
            _rnd(gen, b, mlp, d, std=0.03), _rnd(gen, b, d, std=0.02))


@pytest.mark.parametrize("m,d,mlp", [
    (1, 128, 128), (65, 128, 3072), (65, 384, 128), (1, 384, 3072),
    (6656, 768, 3072), (1, 768, 128), (65, 1024, 128), (1, 1024, 3072),
    (130, 896, 256), (1664, 1024, 4096)])
def test_torch_cuda_layer_tail_bf16_tiles(gen, m, d, mlp):
    """K18's bf16 ``wgmma`` cluster tile (``csrc/mlp_wgmma.cuh`` with its
    K18 flag) at ragged M (1, 65, 130 and B/16 bs=32's 6656, L/16 bs=8's
    1664), D from 128 (the second warpgroup owns no columns) to 1024 (two
    passes, the second pass's y kept in the output's bytes) and mlp 128 to
    4096: the kernel bar against ``reference.layer_tail`` with mean <=
    3e-3; two calls bit for bit; rows 0-32 (or the one row) the same bits
    in a shorter call; and three planted faults refused: one 64-deep K
    step of Wout skipped (its rows zeroed), one 64-column hidden chunk
    skipped (rows mlp/2 .. + 63 of w2 zeroed) and the output scaled by
    0.85."""
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block

    args = _tail_args(gen, m, d, mlp)
    got = block.layer_tail(*args)
    want = reference.layer_tail(*args)
    _close_bf16_bars(got, want)
    again = block.layer_tail(*args)
    head = min(m, 33)
    part = block.layer_tail(args[0][:head], args[1][:head], *args[2:])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(part, got[:head])
    k0, h0 = d // 2, mlp // 2
    wout, w2 = args[2].clone(), args[8].clone()
    wout[k0:k0 + 64] = 0
    w2[h0:h0 + 64] = 0
    faults = {"Wout K step": block.layer_tail(*args[:2], wout, *args[3:]),
              "hidden chunk": block.layer_tail(*args[:8], w2, args[9]),
              "output * 0.85": (got.float() * 0.85).to(got.dtype)}
    for what, bad in faults.items():
        with pytest.raises(AssertionError):
            _close_bf16_bars(bad, want)


@pytest.mark.parametrize("m", [1, 65])
@pytest.mark.parametrize("d,mlp", [(128, 256), (384, 3072), (768, 3072),
                                   (1024, 4096), (1280, 5120)])
def test_torch_cuda_layer_tail_fp32_tiles(gen, m, d, mlp):
    """K18 in fp32 on both forms (``mlp_f32_form``): the tensor-core form
    (``csrc/mlp_tf32.cuh`` with its LAYER flag) at ragged M (1, 65) and D
    from 128 to H/14's 1280 (16 rows a block, the sums split past D =
    1024), within 1e-4 of ``reference.layer_tail``, two calls bit for bit,
    the first row the same bits in a one-row call, and three planted faults
    refused (one 64-deep K step of Wout and one 64-row hidden chunk of w2
    zeroed, the output scaled by 0.85); then the FFMA form on a ctx whose
    base is 4 bytes past 16-byte alignment, within 1e-4 too."""
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import block

    f = torch.float32
    args = (_rnd(gen, f, m, d), _rnd(gen, f, m, d, std=1.5),
            _rnd(gen, f, d, d, std=0.03), _rnd(gen, f, d, std=0.02),
            _rnd(gen, f, d, std=0.1, mean=1.0), _rnd(gen, f, d, std=0.05),
            _rnd(gen, f, d, mlp, std=0.03), _rnd(gen, f, mlp, std=0.02),
            _rnd(gen, f, mlp, d, std=0.03), _rnd(gen, f, d, std=0.02))
    ptrs = tuple(args[i].data_ptr() for i in (0, 1, 2, 6, 8)) + (0,)
    assert block.mlp_f32_form(d, mlp, ptrs) == "tf32"
    got = block.layer_tail(*args)
    want = reference.layer_tail(*args)
    _close(got, want)
    again = block.layer_tail(*args)
    one = block.layer_tail(args[0][:1], args[1][:1], *args[2:])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(one, got[:1])
    k0, h0 = d // 2, mlp // 2
    wout, w2 = args[2].clone(), args[8].clone()
    wout[k0:k0 + 64] = 0
    w2[h0:h0 + 64] = 0
    faults = {"Wout K step": block.layer_tail(*args[:2], wout, *args[3:]),
              "hidden chunk": block.layer_tail(*args[:8], w2, args[9]),
              "output * 0.85": got * 0.85}
    for what, bad in faults.items():
        with pytest.raises(AssertionError):
            _close(bad, want)
    ctx = torch.empty(m * d + 1, device="cuda")[1:].view(m, d)
    ctx.copy_(args[0])
    assert block.mlp_f32_form(d, mlp, (ctx.data_ptr(),) + ptrs[1:]) == "ffma"
    _close(block.layer_tail(ctx, *args[1:]), want)


@pytest.mark.parametrize("m,k,n", [(1, 768, 2304), (65, 200, 136),
                                   (6656, 768, 3072), (130, 1280, 520)])
def test_torch_cuda_fused_linear_fp32_tiles(gen, m, k, n):
    """K6 in fp32 on the tf32 tile (``csrc/gemm_tf32.cuh``'s LN prologue)
    at ragged M, N and K (K = 200 ends inside a 32-deep step) and the B/16
    fc1 shape, with GELU and a residual: within 1e-4 of the plain version,
    two calls bit for bit, a row's bits independent of M, one 64-deep K
    step of w (rows k/2 .. + 63 zeroed) and the output x 0.85 refused;
    then the FFMA tile on an x 4 bytes past alignment, within 1e-4."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import matmul as cuda_matmul

    f = torch.float32
    x = _rnd(gen, f, m, k, std=1.5, mean=0.3)
    w = _rnd(gen, f, k, n, std=0.05)
    b = _rnd(gen, f, n, std=0.1)
    g = _rnd(gen, f, k, std=0.1, mean=1.0)
    beta = _rnd(gen, f, k, std=0.2)
    r = _rnd(gen, f, m, n)
    assert cuda_matmul.fused_linear_tile(x, w) == "wgmma"

    def run(xx, ww):
        return ops.fused_linear(xx, ww, b, "gelu", ln_scale=g, ln_bias=beta,
                                residual=r[:xx.shape[0]], impl="cuda")
    got = run(x, w)
    want = ops.fused_linear(x, w, b, "gelu", ln_scale=g, ln_bias=beta,
                            residual=r, impl="torch")
    _close(got, want)
    again = run(x, w)
    head = run(x[:1], w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(head, got[:1])
    cut = w.clone()
    cut[k // 2:k // 2 + 64] = 0
    for bad in (run(x, cut), got * 0.85):
        with pytest.raises(AssertionError):
            _close(bad, want)
    xs = torch.empty(m * k + 1, device="cuda")[1:].view(m, k)
    xs.copy_(x)
    assert cuda_matmul.fused_linear_tile(xs, w) == "ffma"
    _close(run(xs, w), want)


@pytest.mark.parametrize("b,n,k,d,sp", [
    (1, 196, 768, 768, 208), (4, 196, 768, 768, 208),
    (4, 576, 768, 1024, 592), (3, 49, 3072, 768, 64),
    (2, 256, 588, 1280, 272)])
def test_torch_cuda_embed_fused_bf16_tiles(gen, b, n, k, d, sp):
    """K8 in bf16 on the tile ``embed_tile`` names (``gemm_path``'s for K2
    on the same operands, which the kernel library's rule, read through
    ``vit_fused_linear_tile``, matches): the ``wgmma`` form at B/16 bs=1
    and 4, L/16-384 bs=4 and B/32 bs=3, ``gemm_tile.cuh`` at H/14's K =
    588. Every row bit for bit with K2 on the same operands, cast, then
    ``+ pos`` in bf16, with row 0 ``cls_row`` and the pad rows zero; two
    calls bit for bit; the kernel bar against the plain version; one
    launch."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import _build, launch_counts
    from vit_tpu_torch.ops.cuda import reset_launch_counts
    from vit_tpu_torch.ops.cuda.embed import embed_tile

    bf = torch.bfloat16
    args = (_rnd(gen, bf, b, n, k), _rnd(gen, bf, k, d, std=0.03),
            _rnd(gen, bf, d, std=0.1), _rnd(gen, bf, d),
            _rnd(gen, bf, n, d))
    tile = embed_tile(args[0], args[1])
    assert tile == ("wmma" if k % 8 else "wgmma")
    assert bool(_build.library().vit_fused_linear_tile(
        args[0].data_ptr(), args[1].data_ptr(), d, k,
        _build.DTYPE_CODES[bf])) == (tile == "wgmma")
    reset_launch_counts()
    got = ops.embed_fused(*args, sp, impl="cuda")
    torch.cuda.synchronize()
    assert launch_counts() == _counts(embed_fused=1)
    again = ops.embed_fused(*args, sp, impl="cuda")
    chain = torch.zeros_like(got)
    chain[:, 0] = args[3]
    chain[:, 1:n + 1] = ops.matmul(args[0].reshape(b * n, k), args[1],
                                   args[2]).reshape(b, n, d) + args[4]
    torch.cuda.synchronize()
    assert torch.equal(got, chain)
    assert torch.equal(got, again)
    _close_bf16_bars(got, ops.embed_fused(*args, sp, impl="torch"))


@pytest.mark.parametrize("b,n,k,d,sp,off", [
    (1, 196, 768, 768, 208, 0), (4, 196, 768, 768, 208, 0),
    (4, 576, 768, 1024, 592, 0), (1, 256, 588, 1280, 272, 0),
    (3, 50, 72, 256, 64, 0), (1, 196, 768, 768, 208, 1),
    (2, 20, 36, 128, 32, 1)])
def test_torch_cuda_embed_fused_fp32_tiles(gen, b, n, k, d, sp, off):
    """K8 in fp32 on the tile ``embed_tile`` names, held to the library's
    rule (``tf32_takes``, read through ``vit_fused_linear_tile``): the
    tf32 tile at B/16 bs=1 and 4, L/16-384 bs=4, H/14 bs=1 (K = 588, its
    last 32-deep step ragged) and a ragged (M, K, D); ``gemm_tile.cuh``'s
    FFMA form where the patches lie ``off`` floats past an aligned base.
    Every row bit for bit with K2 on the same operands + ``pos`` (row 0
    ``cls_row``, the pad rows zero), two calls bit for bit, 1e-4 against
    the plain version, one launch."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import _build, launch_counts
    from vit_tpu_torch.ops.cuda import reset_launch_counts
    from vit_tpu_torch.ops.cuda.embed import embed_tile

    f32 = torch.float32
    pt = _rnd(gen, f32, b, n, k)
    if off:
        buf = torch.empty(pt.numel() + off, device="cuda")
        pt = buf[off:].view(b, n, k).copy_(pt)
    args = (pt, _rnd(gen, f32, k, d, std=0.03), _rnd(gen, f32, d, std=0.1),
            _rnd(gen, f32, d), _rnd(gen, f32, n, d))
    tile = embed_tile(args[0], args[1])
    assert tile == ("ffma" if off else "wgmma")
    assert bool(_build.library().vit_fused_linear_tile(
        args[0].data_ptr(), args[1].data_ptr(), d, k,
        _build.DTYPE_CODES[f32])) == (tile == "wgmma")
    reset_launch_counts()
    got = ops.embed_fused(*args, sp, impl="cuda")
    torch.cuda.synchronize()
    assert launch_counts() == _counts(embed_fused=1)
    again = ops.embed_fused(*args, sp, impl="cuda")
    chain = torch.zeros_like(got)
    chain[:, 0] = args[3]
    chain[:, 1:n + 1] = ops.matmul(args[0].reshape(b * n, k), args[1],
                                   args[2]).reshape(b, n, d) + args[4]
    torch.cuda.synchronize()
    assert torch.equal(got, chain)
    assert torch.equal(got, again)
    _close(got, ops.embed_fused(*args, sp, impl="torch"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,form", [
    (5000, 768, "row"), (2000, 1024, "row"), (3000, 1280, "row"),
    (4097, 384, "row"), (33, 128, "row"), (3000, 192, "scalar"),
    (37, 776, "scalar"), (5, 1408, "scalar")])
@pytest.mark.parametrize("ln", [False, True])
def test_torch_cuda_quantize_rows_forms(gen, dtype, rows, d, form, ln):
    """K10's two forms: ``quantize_rows_form`` as the library takes it
    (the row form refused where the rule does not give it), and what the
    wrapper runs bit for bit with the scalar form (``common.cuh:
    quantize_row``, K12's prologue, launched at any D) with and without
    LN, at more rows than the card holds warps (grid-strided); two calls
    bit for bit; the plain version's bits without LN, its flip bar with
    it."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import _build
    from vit_tpu_torch.ops.cuda import quant as cuda_quant

    assert cuda_quant.quantize_rows_form(d) == form
    x = _rnd(gen, dtype, rows, d, std=2.0, mean=0.5)
    x[1] = 0
    kw = {}
    if ln:
        kw = dict(ln_scale=_rnd(gen, dtype, d, std=0.1, mean=1.0),
                  ln_bias=_rnd(gen, dtype, d, std=0.05))
    got = cuda_quant.quantize_rows(x, **kw)
    again = cuda_quant.quantize_rows(x, **kw)

    def launch(form):
        q = torch.empty((rows, d), dtype=torch.int8, device="cuda")
        a = torch.empty((rows, 1), device="cuda")
        _build.launch("vit_quantize_rows", x, kw.get("ln_scale"),
                      kw.get("ln_bias"), q, a, rows, d, 1e-12,
                      cuda_quant.QUANTIZE_ROWS_FORMS[form], like=x)
        return q, a
    scalar = launch("scalar")
    (qw, aw) = ops.quantize_rows(x, impl="torch", **kw)
    torch.cuda.synchronize()
    for a, b_, c in zip(got, scalar, again):
        assert torch.equal(a, b_) and torch.equal(a, c)
    q, a = got
    if not ln:
        assert torch.equal(q, qw) and torch.equal(a, aw)
    else:
        assert ((a - aw).abs() <= 1e-5 * aw).all()
        flips = (q.int() - qw.int()).abs()
        assert flips.max() <= 1 and flips.float().mean() <= 1e-3
    if form == "scalar":
        # The library refuses the row form where the rule does.
        with pytest.raises(RuntimeError, match="vit_quantize_rows"):
            launch("row")


def test_torch_cuda_layer_block_checks_inputs(gen):
    """Shapes K18 does not take raise before any launch."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    wide = _layer_args(gen, torch.bfloat16, 1, 32, 1152, 256, 32)
    with pytest.raises(ValueError, match="D <= 1024"):
        ops.layer_block(*wide, num_heads=8)
    ragged = _layer_args(gen, torch.bfloat16, 1, 32, 128, 200, 32)
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.layer_block(*ragged, num_heads=2)
    mixed = list(_layer_args(gen, torch.float32, 1, 32, 128, 256, 32))
    mixed[5] = mixed[5].to(torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        ops.layer_block(*mixed, num_heads=2)
    assert launch_counts() == _counts()


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_cuda_layer_route_forward_and_step(gen, dtype):
    """``forward(layer_block=True)`` at a narrow B/16 geometry (bs=3, 208
    tokens): per layer K1, K2, the core and K18 in place of the
    out-projection's K2 and K3; one train step's gradients against the
    plain tier's, with the backward of the per-layer route."""
    from vit_tpu_torch.config import ViTConfig
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.train import cross_entropy_loss
    from vit_tpu_torch.weights.convert import tree_leaves

    cfg = ViTConfig(image_size=224, patch_size=16, hidden_dim=256,
                    num_heads=4, num_layers=2, mlp_dim=512, num_classes=10,
                    dtype=dtype)
    params = vit.init_params(cfg, generator=gen)
    px = torch.randn((5, 3, 224, 224), generator=gen, device="cuda")
    with torch.inference_mode():
        reset_launch_counts()
        got = vit.forward(params, px, cfg, layer_block=True)
        torch.cuda.synchronize()
        assert launch_counts() == _counts(layernorm=3, matmul=4, attention=2,
                                          layer_block=2)
        _close_model(got, vit.forward(params, px, cfg, layer_block=True,
                                      impl="torch"))
    labels = torch.randint(0, 10, (5,), generator=gen, device="cuda")
    grads = {}
    for impl in (None, "torch"):
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        loss = cross_entropy_loss(params, px, labels, cfg, impl=impl,
                                  layer_block=True)
        grads[impl] = torch.autograd.grad(loss, leaves)
    _close_grads(grads[None], grads["torch"], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,p", [((2, 3, 80, 80), 16),
                                     ((1, 3, 224, 224), 14),
                                     ((2, 1, 48, 80), 16),
                                     ((32, 3, 224, 224), 16)])
def test_torch_cuda_patchify_bit_exact(gen, dtype, shape, p):
    """K19, bit for bit with the layout copy, at a ragged W/P (5 patches a
    row), H/14's 16x16 patches of 14, one channel with H != W, and B/16
    bs=32."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    x = _rnd(gen, dtype, *shape)
    reset_launch_counts()
    got = ops.patchify(x, p)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(patchify=1)
    assert torch.equal(got, reference.patchify(x, p))
    with pytest.raises(ValueError, match="not divisible"):
        ops.patchify(x, p + 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.patchify(x.transpose(2, 3), p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid,conds", [((2,), "=0"), ((3, 4), "=1,>1"),
                                        ((3, 4), "!=1,,<=0"), ((2,), "")])
def test_torch_cuda_print_if_prints_the_matching_blocks(gen, capfd, dtype,
                                                        grid, conds):
    """K20: the copy is bit for bit, and exactly the blocks whose index
    satisfies ``conds`` print their tile's sum (device printf reaches the
    process's stdout at the synchronisation; block order is the device's,
    so the lines are compared sorted). Integer values keep the fp32 sums
    exact in any order."""
    import ctypes

    from vit_tpu_torch.ops import debug
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    x = torch.randint(-3, 4, (24, 512), generator=gen, device="cuda").to(
        dtype)
    capfd.readouterr()
    reset_launch_counts()
    out = debug.print_if_smoke(x, conds, grid=grid)
    torch.cuda.synchronize()
    ctypes.CDLL(None).fflush(None)
    printed = [ln for ln in capfd.readouterr().out.splitlines()
               if ln.startswith("block (")]
    assert launch_counts() == _counts(print_if=1)
    assert torch.equal(out, x)
    assert sorted(printed) == sorted(debug.print_if_lines(x.cpu(), conds,
                                                          grid=grid))
    with pytest.raises(ValueError, match="tile"):
        debug.print_if_smoke(x, grid=(5,))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(256, 384, 512), (128, 1024, 384)])
def test_torch_cuda_minimal_matmul(gen, dtype, m, k, n):
    from vit_tpu_torch.examples import minimal_matmul
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    x, w = _rnd(gen, dtype, m, k, std=0.1), _rnd(gen, dtype, k, n, std=0.1)
    reset_launch_counts()
    got = minimal_matmul.matmul(x, w)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(minimal_matmul=1)
    _close(got, minimal_matmul.matmul_plain(x, w))
    with pytest.raises(ValueError, match="multiple of 128"):
        minimal_matmul.matmul(x[:, :100].contiguous(), w[:100])
    assert minimal_matmul.main([]) == 0


# ---------------------------------------------------------------- probes --

@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (37, 200, 72),
                                   (1664, 768, 3072), (33, 100, 70)])
def test_torch_cuda_dot_probe(gen, dtype, m, k, n):
    """K22: int8 sums exact (bit for bit); bf16 and fp32 in fp32. int8 on
    K11's s8 wgmma tile at the TMA-readable shapes, on gemm_tile.cuh's
    loop at (37, 200, 72) and (33, 100, 70); bf16 on K2's wgmma tile and
    fp32 on K2's tf32 tile but at (33, 100, 70), where both take
    gemm_tile.cuh's loop; the library picks the tile ``dot_tile`` names;
    in fp32 two calls give the same bits."""
    from vit_tpu_torch.ops.cuda import _build
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.tools import int8_probe

    if dtype == torch.int8:
        x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
    else:
        x, w = _rnd(gen, dtype, m, k), _rnd(gen, dtype, k, n, std=0.05)
    tile = int8_probe.dot_tile(m, n, k, dtype, (x.data_ptr(), w.data_ptr()))
    codes = {torch.int8: 2, torch.bfloat16: 1, torch.float32: 0}
    f32 = dtype == torch.float32
    assert tile == {1: "tf32" if f32 else "wgmma",
                    0: "ffma" if f32 else "wmma"}[
        _build.library().vit_dot_probe_tile(x.data_ptr(), w.data_ptr(), n,
                                            k, codes[dtype])]
    assert (tile in ("wgmma", "tf32")) == (
        (m, k, n) != (33, 100, 70) and (dtype != torch.int8 or k % 16 == 0))
    reset_launch_counts()
    got = int8_probe.dot(x, w)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(dot_probe=1)
    want = int8_probe.dot_plain(x, w)
    if dtype == torch.int8:
        assert got.dtype == torch.int32 and torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    if f32:
        _close(got, want)
        assert torch.equal(got, int8_probe.dot(x, w))


def test_torch_cuda_int8_probe_main(gen):
    from vit_tpu_torch.tools import int8_probe
    assert int8_probe.main(["--warmup", "1", "--reps", "3"]) == 0


def _probe_bar(got, want, dtype, step=0.0):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    diff = (g - w).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-4 + step, diff.max()
    else:
        assert (diff <= 2e-2 * (1 + w.abs()) + step).all(), diff.max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", [
    "full", "maskonly", "nosm", "mxu", "divonly", "recip", "sumonly",
    "bf16div", "alldiv", "mxudiv", "addmask", "vsum", "qcore", "wide", "kt",
    "projonly", "tcore", "xcore"])
def test_torch_cuda_attn_core_probe(gen, dtype, mode):
    """K23 in every mode at a ragged geometry (B=3, 40 tokens of which 33
    real, D=128, 4 heads of 32; wide pairs them to 64) against the plain
    version, with the mode's exact launches. qcore: within one int8 step
    of its codes (``attn_core_probe.qcore_step``)."""
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.tools import attn_core_probe as acp

    b, sp, seq, d, heads = 3, 40, 33, 128, 4
    x, *w = acp.make_inputs(b, sp, d, seq, dtype, "cuda", seed=3)
    if mode == "xcore":
        x = x.reshape(b * sp, d).t().contiguous()
    kw = dict(num_heads=heads, seq_len=seq, group=3, shape=(b, sp, d))
    reset_launch_counts()
    got = acp.probe(mode, x, *w, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(**acp.launches(mode))
    step = 0.0
    if mode == "qcore":
        step = acp.qcore_step(x, *w[:5], num_heads=heads)
    _probe_bar(got, acp.probe_plain(mode, x, *w, **kw), dtype, step)


@pytest.mark.parametrize("mode", [
    "full", "maskonly", "nosm", "mxu", "divonly", "recip", "sumonly",
    "bf16div", "alldiv", "mxudiv", "addmask", "vsum", "qcore", "wide", "kt",
    "projonly", "tcore", "xcore"])
def test_torch_cuda_attn_core_probe_b16_width(gen, mode):
    """K23 in every mode at B/16's width (bs=2, 208 tokens of which 197
    real, 12 heads of 64; wide's pairs 128) in bf16 against the plain
    version, with the mode's exact launches: the core's NK forms 4 and 8
    and the GEMMs on K2's wgmma tile (``gemm_tile``)."""
    from vit_tpu_torch.ops.cuda import _build
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.tools import attn_core_probe as acp

    b, sp, seq, d, heads = 2, 208, 197, 768, 12
    x, *w = acp.make_inputs(b, sp, d, seq, torch.bfloat16, "cuda", seed=7)
    if mode == "xcore":
        x = x.reshape(b * sp, d).t().contiguous()
    kw = dict(num_heads=heads, seq_len=seq, group=2, shape=(b, sp, d))
    wt = w[2].t().contiguous()
    for n, k, ptrs in ((3 * d, d, (x.data_ptr(), w[2].data_ptr())),
                       (b * sp, d, (wt.data_ptr(), x.data_ptr()))):
        assert acp.gemm_tile(1, n, k, torch.bfloat16, ptrs) == "wgmma"
        assert _build.library().vit_attn_probe_gemm_tile(*ptrs, n, k, 1) == 1
    reset_launch_counts()
    got = acp.probe(mode, x, *w, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(**acp.launches(mode))
    step = 0.0
    if mode == "qcore":
        step = acp.qcore_step(x, *w[:5], num_heads=heads)
    want = acp.probe_plain(mode, x, *w, **kw)
    if mode in acp.UNNORMALIZED:  # chip_smoke.py's compare_norm
        g, wt = got.float(), want.float()
        assert torch.isfinite(g).all()
        assert (g - wt).norm() / wt.norm() <= 2e-2
    else:
        _probe_bar(got, want, torch.bfloat16, step)


@pytest.mark.parametrize("b,sp,seq,d,heads", [
    (2, 208, 197, 768, 12), (3, 40, 33, 128, 4), (2, 50, 50, 48, 3),
    (1, 80, 71, 240, 3), (1, 96, 90, 256, 1)])
def test_torch_cuda_attn_core_probe_full_is_k4(gen, b, sp, seq, d, heads):
    """K23's bf16 ``full`` core is K4's instantiation: bit for bit with K4's
    core on the same packed QKV, at head widths 64, 32, 16, 80 and 256
    (two blocks of 128 columns)."""
    from vit_tpu_torch.ops.cuda import block as cuda_block
    from vit_tpu_torch.tools import attn_core_probe as acp

    qkv = _rnd(gen, torch.bfloat16, b * sp, 3 * d)
    hd = d // heads
    want = cuda_block.attention_core(qkv, batch=b, num_heads=heads,
                                     scale=hd ** -0.5, seq_len=seq)
    got = acp.core_launch("full", qkv, None, torch.empty_like(want), b=b,
                          sp=sp, d=d, heads=heads, seq_len=seq,
                          scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_torch_cuda_attn_core_probe_refuses_wide_heads(gen):
    """The bf16 qcore and head-major cores hold q's columns whole: heads
    past 128 columns are refused; the other modes walk them in blocks."""
    from vit_tpu_torch.tools import attn_core_probe as acp

    b, sp, d, heads = 1, 48, 256, 1
    qkv = _rnd(gen, torch.bfloat16, b * sp, 3 * d)
    core = dict(b=b, sp=sp, d=d, heads=heads, seq_len=40, scale=0.0625)
    for mode in ("qcore", "tcore"):
        tbuf = qkv.t().contiguous()
        with pytest.raises(ValueError, match="128"):
            acp.core_launch(mode, None if mode == "tcore" else qkv,
                            tbuf if mode == "tcore" else None,
                            torch.empty((b * sp, d), dtype=qkv.dtype,
                                        device="cuda"), **core)
    out = acp.core_launch("nosm", qkv, None, torch.empty(
        (b * sp, d), dtype=qkv.dtype, device="cuda"), **core)
    assert torch.isfinite(out.float()).all()


def test_torch_cuda_attn_core_probe_refuses_fp32_wide_at_208(gen):
    from vit_tpu_torch.tools import attn_core_probe as acp

    x, *w = acp.make_inputs(1, 208, 768, 197, torch.float32, "cuda")
    with pytest.raises(ValueError, match="shared"):
        acp.probe("wide", x, *w, num_heads=12, seq_len=197)


@pytest.mark.parametrize("mode", ["full", "kt", "tcore", "xcore",
                                  "projonly"])
def test_torch_cuda_attn_core_probe_core_only(gen, mode):
    """``core_only`` replays the block's core launch alone: one K23 launch
    a call, whose output is the context the block's core made."""
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.tools import attn_core_probe as acp

    b, sp, seq, d, heads = 2, 40, 33, 128, 4
    x, *w = acp.make_inputs(b, sp, d, seq, torch.bfloat16, "cuda", seed=5)
    if mode == "xcore":
        x = x.reshape(b * sp, d).t().contiguous()
    kw = dict(num_heads=heads, seq_len=seq, group=1, shape=(b, sp, d))
    seen = []

    def record(*args, **kwargs):
        seen.append(acp.core_launch(*args, **kwargs).clone())
        return seen[-1]
    acp.probe(mode, x, *w, launch_core=record, **kw)
    call = acp.core_only(mode, x, *w, **kw)
    if mode == "projonly":
        assert call is None and not seen
        return
    reset_launch_counts()
    got = call()
    torch.cuda.synchronize()
    assert launch_counts() == _counts(attn_core_probe=1)
    assert torch.equal(got, seen[0])


def test_torch_cuda_kernel_times(gen):
    """``kernel_times`` on a call of two launches of one kernel and one of
    another: their launches a call and a positive time a launch;
    ``launch_ms`` and ``pipelined_ms`` on the same call."""
    from vit_tpu_torch.utils.profiling import kernel_times

    a = _rnd(gen, torch.float32, 1024, 1024)

    def fn():
        return torch.exp(a), torch.exp(a), torch.sin(a)
    got = kernel_times(fn, 5)
    assert sorted(n for _, n in got.values()) == [1, 2], got
    assert all(ms > 0 for ms, _ in got.values())
    from vit_tpu_torch.utils.profiling import launch_ms
    from vit_tpu_torch.utils.timing import pipelined_ms
    assert launch_ms(fn, "exp") > 0 and pipelined_ms(fn) > 0


def test_torch_cuda_attn_core_probe_main(gen):
    from vit_tpu_torch.tools import attn_core_probe as acp
    assert acp.main(["--batch", "4", "--group", "2", "--modes", "full",
                     "xcore", "projonly", "--warmup", "1", "--reps", "2"]) == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["dma", "scratch", "rows", "nodots",
                                     "lnqkv", "nosm", "core"])
def test_torch_cuda_encstack_probe(gen, dtype, variant):
    """K24 in every variant at b=3, 24 tokens, D=128, MLP 256, 2 layers,
    against the plain version: ``dma`` returns x bit for bit and the
    weight sums it streamed (``check_weight_sums``); the others within
    the whole-encoder bars (fp32 relative 1e-5, bf16 relative 2e-2:
    lnqkv's QKV rounds the LN output to bf16 where JAX's does not)."""
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.tools import encstack_minrepro as em

    b, sp, d, mlp, L = 3, 24, 128, 256, 2
    x = _rnd(gen, dtype, b * sp, d, std=0.05)
    ws = [_rnd(gen, dtype, *s, std=0.05) for s in
          ((L, d, 3 * d), (L, d, d), (L, d, mlp), (L, mlp, d))]
    fn = em.make_variant(variant + "@flat", b=b, sp=sp, d=d, mlp=mlp, L=L,
                         cq=128, mt=128, dtype=dtype, heads=4)
    reset_launch_counts()
    got = fn(x, *ws)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(encstack_probe=1)
    if variant == "dma":
        assert torch.equal(got, x)
        em.check_weight_sums(fn.weight_sums(), *ws)
        with pytest.raises(AssertionError, match="weight sums"):
            em.check_weight_sums(fn.weight_sums(), ws[0], ws[1], ws[2],
                                 ws[3] * 0.99)
        return
    want = em.variant_plain(variant, x, *ws, b=b, sp=sp, heads=4)
    assert torch.isfinite(got.float()).all()
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= (1e-5 if dtype == torch.float32 else 2e-2), rel


def test_torch_cuda_encstack_probe_full_is_k9(gen):
    from vit_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from vit_tpu_torch.tools import encstack_minrepro as em

    b, sp, d, mlp, L = 2, 32, 128, 256, 2
    x = _rnd(gen, torch.bfloat16, b * sp, d, std=0.05)
    ws = [_rnd(gen, torch.bfloat16, *s, std=0.05) for s in
          ((L, d, 3 * d), (L, d, d), (L, d, mlp), (L, mlp, d))]
    fn = em.make_variant("full", b=b, sp=sp, d=d, mlp=mlp, L=L, cq=128,
                         mt=128, dtype=torch.bfloat16, heads=4)
    reset_launch_counts()
    got = fn(x, *ws)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(encoder_stack=1)
    want = em.full_encoder(x, *ws, b=b, sp=sp, heads=4, impl="torch")
    _close(got, want)


def test_torch_cuda_encstack_minrepro_main(gen):
    from vit_tpu_torch.tools import encstack_minrepro as em
    assert em.main(["--cases", "1,768,512", "--variants", "dma", "core@flat",
                    "full", "-L", "2", "--reps", "2"]) == 0
