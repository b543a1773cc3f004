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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(37, 200, 100), (130, 1024, 3072),
                                   (5, 24, 9)])
def test_torch_cuda_fused_linear_ragged(gen, dtype, m, k, n):
    """Every flag combination; K=200 with LN is the zero-fill trap."""
    from vit_tpu_torch import ops

    x = _rnd(gen, dtype, m, k, std=1.5, mean=0.3)
    w = _rnd(gen, dtype, k, n, std=0.05)
    b = _rnd(gen, dtype, n, std=0.1)
    g = _rnd(gen, dtype, k, std=0.1, mean=1.0)
    beta = _rnd(gen, dtype, k, std=0.2)
    r = _rnd(gen, dtype, m, n)
    for bias, act, ln, res in ((None, None, False, None),
                               (b, None, True, None), (b, "gelu", True, None),
                               (b, None, False, r), (b, "gelu", True, r),
                               (None, None, True, r)):
        kw = dict(ln_scale=g if ln else None, ln_bias=beta if ln else None,
                  residual=res)
        _close(ops.fused_linear(x, w, bias, act, impl="cuda", **kw),
               ops.fused_linear(x, w, bias, act, impl="torch", **kw))


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


def test_torch_cuda_wrappers_check_inputs(gen):
    from vit_tpu_torch import ops

    x = _rnd(gen, torch.float32, 4, 64)
    v = _rnd(gen, torch.float32, 64)
    with pytest.raises(ValueError, match="dtype"):
        ops.layernorm(x, v.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.matmul(x, _rnd(gen, torch.float32, 8, 64).t())
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
                  n=16, k=192, sp=32):
    """Random stacked encoder weights and the inputs of both K9 forms."""
    enc = {
        "ln1": {"scale": _rnd(gen, dtype, layers, d, std=0.1, mean=1.0),
                "bias": _rnd(gen, dtype, layers, d, std=0.05)},
        "qkv": {"kernel": _rnd(gen, dtype, layers, d, 3 * d, std=0.06),
                "bias": _rnd(gen, dtype, layers, 3 * d, std=0.02)},
        "out": {"kernel": _rnd(gen, dtype, layers, d, d, std=0.06),
                "bias": _rnd(gen, dtype, layers, d, std=0.02)},
        "ln2": {"scale": _rnd(gen, dtype, layers, d, std=0.1, mean=1.0),
                "bias": _rnd(gen, dtype, layers, d, std=0.05)},
        "fc1": {"kernel": _rnd(gen, dtype, layers, d, mlp, std=0.06),
                "bias": _rnd(gen, dtype, layers, mlp, std=0.02)},
        "fc2": {"kernel": _rnd(gen, dtype, layers, mlp, d, std=0.04),
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
    (3, 1, 65, 65, 128), (1, 3, 40, 33, 16), (1, 2, 816, 800, 64)])
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
