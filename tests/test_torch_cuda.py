"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA Hopper GPU and ``nvcc``; without a card they
skip. They cover what ``chip_smoke.py`` does not: ragged M, N and K, widths
other than B/16's, and the launch counts of a small forward. The file
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
    assert launch_counts() == {"layernorm": 3, "matmul": 6, "attention": 2,
                               "mlp_block": 2}
    want = vit.forward(params, px, cfg, impl="torch")
    assert launch_counts()["matmul"] == 6  # the plain path launches nothing
    _close(got, want)
