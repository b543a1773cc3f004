"""The port's plain op versions against the JAX package's Pallas kernels.

The plain versions (``vit_tpu_torch/ops/reference.py``) are what each CUDA
kernel is held to on the card, so here they are held to the Pallas kernels
they replace, run in interpret mode on the CPU. The same inputs, made from
a seed with numpy, go to both packages.

Bars: fp32 max|diff| <= 2e-5 (sum order only). bf16 elementwise
|diff| <= 2e-2 * (1 + |ref|), about two bf16 ulps: a flat bar would fail on
a single one-ulp rounding at |x| >= 4, where the ulp is 3.1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops import reference as jax_ref
from vit_tpu.ops.pallas import add as pallas_add
from vit_tpu.ops.pallas import attention as pallas_attention
from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu.ops.pallas import layernorm as pallas_layernorm
from vit_tpu.ops.pallas import matmul as pallas_matmul
from vit_tpu.ops.pallas import matmul3 as pallas_matmul3
from vit_tpu.ops.pallas import softmax as pallas_softmax
from vit_tpu_torch import ops
from vit_tpu_torch.ops import reference

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 2e-5, diff.max()
    else:
        assert (diff <= 2e-2 * (1 + np.abs(want))).all(), diff.max()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_layernorm_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 17, 128)) * 2 + 0.5
    g = 1 + 0.1 * rng.standard_normal(128)
    b = 0.05 * rng.standard_normal(128)
    (jx, tx), (jg, tg), (jb, tb) = (_pair(a, dtype) for a in (x, g, b))
    want = pallas_layernorm.layernorm(jx, jg, jb, eps=1e-12, interpret=True)
    _close(ops.layernorm(tx, tg, tb, eps=1e-12), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_gelu"])
def test_torch_matmul_matches_pallas(dtype, epilogue):
    rng = np.random.default_rng(1)
    # Ragged M (2*17), K (96, not a lane multiple) and N (80).
    x = rng.standard_normal((2, 17, 96))
    w = 0.1 * rng.standard_normal((96, 80))
    b = 0.1 * rng.standard_normal(80)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    bias = epilogue != "none"
    act = "gelu" if epilogue == "bias_gelu" else None
    want = pallas_matmul.matmul(jx, jw, jb if bias else None, act,
                                interpret=True)
    _close(ops.matmul(tx, tw, tb if bias else None, act), want, dtype)


def test_torch_matmul_residual_adds_before_the_cast():
    """The residual extension: ``x@w + b + r`` in fp32, one rounding."""
    rng = np.random.default_rng(2)
    x, w = rng.standard_normal((3, 64)), rng.standard_normal((64, 32))
    b, r = rng.standard_normal(32), 8 * rng.standard_normal((3, 32))
    t = [torch.from_numpy(a.astype(np.float32)) for a in (x, w, b, r)]
    want = (t[0].double() @ t[1].double() + t[2].double() + t[3].double())
    got = ops.matmul(*(a.to(torch.bfloat16) for a in t[:3]),
                     residual=t[3].to(torch.bfloat16))
    exact = ((t[0].to(torch.bfloat16).double() @ t[1].to(torch.bfloat16).double())
             + t[2].to(torch.bfloat16).double() + t[3].to(torch.bfloat16).double())
    assert torch.equal(got, exact.float().to(torch.bfloat16))
    assert (got.double() - want).abs().max() < 0.5


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_mlp_block_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    d, mlp = 128, 256
    arrays = (rng.standard_normal((2, 32, d)),
              1 + 0.1 * rng.standard_normal(d), 0.05 * rng.standard_normal(d),
              0.05 * rng.standard_normal((d, mlp)),
              0.02 * rng.standard_normal(mlp),
              0.05 * rng.standard_normal((mlp, d)),
              0.02 * rng.standard_normal(d))
    j, t = zip(*(_pair(a, dtype) for a in arrays))
    want = pallas_block.mlp_block(*j, eps=1e-12, interpret=True)
    _close(ops.mlp_block(*t, eps=1e-12), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_attn_block_matches_pallas(dtype):
    """Padded S = 32 with 17 real tokens: the key mask is exercised."""
    rng = np.random.default_rng(4)
    b, sp, d, heads, seq_len = 2, 32, 128, 2, 17
    x = rng.standard_normal((b, sp, d))
    x[:, seq_len:] = 0
    arrays = (x, 1 + 0.1 * rng.standard_normal(d),
              0.05 * rng.standard_normal(d),
              0.08 * rng.standard_normal((d, 3 * d)),
              0.02 * rng.standard_normal(3 * d),
              0.08 * rng.standard_normal((d, d)),
              0.02 * rng.standard_normal(d))
    j, t = zip(*(_pair(a, dtype) for a in arrays))
    want = pallas_block.attn_block(*j, num_heads=heads, seq_len=seq_len,
                                   eps=1e-12, interpret=True)
    got = ops.attn_block(*t, num_heads=heads, seq_len=seq_len, eps=1e-12)
    _close(got, want, dtype)


def test_torch_attention_core_matches_head_layout():
    """The packed ``[q|k|v]`` buffer is split per head at columns ``h*d``,
    exactly as ``_attn_core`` slices it, and the masked softmax matches the
    JAX oracle in fp32."""
    rng = np.random.default_rng(5)
    b, s, heads, hd, seq_len = 2, 16, 3, 8, 11
    d = heads * hd
    qkv = rng.standard_normal((b * s, 3 * d)).astype(np.float32)
    got = reference.attention_core(torch.from_numpy(qkv), batch=b,
                                   num_heads=heads, scale=hd ** -0.5,
                                   seq_len=seq_len)
    q, k, v = (qkv.reshape(b, s, 3, heads, hd)[:, :, i].transpose(0, 2, 1, 3)
               for i in range(3))
    want = jax_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=hd ** -0.5, seq_len=seq_len)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b * s, d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_patch_embed_matches_reference(dtype):
    """Unfold + matmul with the (c, kh, kw) per-patch order."""
    rng = np.random.default_rng(6)
    p = 8
    x = rng.standard_normal((2, 3, 32, 32))
    w = 0.1 * rng.standard_normal((3 * p * p, 128))
    b = 0.1 * rng.standard_normal(128)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    np.testing.assert_array_equal(
        ops.patchify(tx, p).float().numpy(),
        np.asarray(jnp.asarray(jax_ref.patchify(jx, p), jnp.float32)))
    # Patch (0, 0)'s vector starts with channel 0's first row, then row 1.
    assert torch.equal(ops.patchify(tx, p)[0, 0, :2 * p],
                       tx[0, 0, :2, :p].reshape(-1))
    _close(ops.patch_embed(tx, tw, tb, p), jax_ref.patch_embed(jx, jw, jb, p),
           dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [96, 128])
def test_torch_layernorm_stats_matches_pallas(dtype, d):
    """Row 0 has mean 100 and std 0.5: a one-pass E[x²] - mean² variance
    would lose about three digits of rstd there."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 11, d)) * 2 + 0.5
    x[0, 0] = 100 + 0.5 * rng.standard_normal(d)
    jx, tx = _pair(x, dtype)
    jmu, jrs = pallas_layernorm.layernorm_stats(jx, eps=1e-12, interpret=True)
    mu, rstd = ops.layernorm_stats(tx, eps=1e-12)
    assert mu.shape == rstd.shape == (33, 1)
    assert mu.dtype == rstd.dtype == torch.float32
    # fp32 outputs in both dtypes: held to the fp32 bar, relative to size.
    for got, want in ((mu, jmu), (rstd, jrs)):
        want = np.asarray(want)
        assert (np.abs(got.numpy() - want) <= 1e-5 * (1 + np.abs(want))).all()
    assert abs(float(rstd[0, 0]) - float(jrs[0, 0])) <= 1e-4


FUSED_FLAGS = {  # (bias, activation, ln, residual)
    "none": (False, None, False, False),
    "ln": (True, None, True, False),
    "ln_gelu": (True, "gelu", True, False),
    "residual": (True, None, False, True),
    "all": (True, "gelu", True, True),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("flags", list(FUSED_FLAGS))
@pytest.mark.parametrize("k", [128, 200])
def test_torch_fused_linear_matches_pallas(dtype, flags, k):
    """Ragged M (2*17) and N (100); K=200 with LN is the zero-fill trap: a
    zero-padded x column would normalise to beta - mu*rstd*gamma, not 0."""
    has_bias, act, has_ln, has_res = FUSED_FLAGS[flags]
    rng = np.random.default_rng(8)
    arrays = (rng.standard_normal((2, 17, k)) * 1.5 + 0.3,
              0.08 * rng.standard_normal((k, 100)),
              0.1 * rng.standard_normal(100),
              1 + 0.1 * rng.standard_normal(k), 0.2 * rng.standard_normal(k),
              rng.standard_normal((2, 17, 100)))
    (jx, tx), (jw, tw), (jb, tb), (jg, tg), (jbe, tbe), (jr, tr) = (
        _pair(a, dtype) for a in arrays)
    want = pallas_matmul.fused_linear(
        jx, jw, jb if has_bias else None, act,
        ln_scale=jg if has_ln else None, ln_bias=jbe if has_ln else None,
        eps=1e-12, residual=jr if has_res else None, interpret=True)
    got = ops.fused_linear(
        tx, tw, tb if has_bias else None, act,
        ln_scale=tg if has_ln else None, ln_bias=tbe if has_ln else None,
        eps=1e-12, residual=tr if has_res else None)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


#: (S, seq_len, force_online) of each regime of the Pallas flash kernel.
FLASH_REGIMES = {
    "group3d": (197, None, False),  # attention.py:246, unaligned S
    "rows": (208, 197, False),      # attention.py:246, aligned S
    "qtile": (800, 790, False),     # attention.py:277, S > 768
    "online": (800, 790, True),     # attention.py:311
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("regime", list(FLASH_REGIMES))
def test_torch_flash_attention_matches_pallas(dtype, hd, regime):
    """The port's one kernel takes all three regimes; its plain version is
    held to each of the Pallas kernels."""
    s, seq_len, online = FLASH_REGIMES[regime]
    rng = np.random.default_rng(9)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((1, 2, s, hd)), dtype) for _ in range(3))
    want = pallas_attention.flash_attention(
        jq, jk, jv, scale=hd ** -0.5, seq_len=seq_len, force_online=online,
        interpret=True)
    got = ops.flash_attention(tq, tk, tv, scale=hd ** -0.5, seq_len=seq_len)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_flash_attention_takes_packed_qkv_views(dtype):
    """q, k and v as strided (B, H, S, d) views of a packed (B*S, 3D)
    buffer, as the model's composed route passes them."""
    rng = np.random.default_rng(10)
    b, s, heads, hd, seq_len = 2, 48, 2, 80, 40
    jqkv, tqkv = _pair(rng.standard_normal((b * s, 3 * heads * hd)), dtype)
    q, k, v = tqkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    assert not q.is_contiguous()
    jq, jk, jv = jqkv.reshape(b, s, 3, heads, hd).transpose(2, 0, 3, 1, 4)
    want = pallas_attention.flash_attention(jq, jk, jv, seq_len=seq_len,
                                            interpret=True)
    _close(ops.flash_attention(q, k, v, seq_len=seq_len), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_add_bit_equal_to_pallas(dtype):
    """The residual add of the ``fused=False`` chain: one rounding of the
    fp32 sum, the same bits as the Pallas kernel."""
    rng = np.random.default_rng(11)
    (jx, tx), (jy, ty) = (_pair(rng.standard_normal((2, 17, 96)) * 3, dtype)
                          for _ in range(2))
    want = pallas_add.add(jx, jy, interpret=True)
    got = ops.add(tx, ty)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)))
    with pytest.raises(ValueError, match="add of"):
        ops.add(tx, ty[:1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [1, 17, 197, 300])
def test_torch_softmax_matches_pallas(dtype, d):
    """Ragged widths, one row of a large constant offset."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, d)) * 4
    x[0, 0] += 80
    jx, tx = _pair(x, dtype)
    want = pallas_softmax.softmax(jx, interpret=True)
    got = ops.softmax(tx)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


#: (x shape, y shape) of each path of the Pallas matmul3.
MATMUL3_PATHS = {
    "group": ((6, 197, 64), (6, 64, 197)),      # matmul3.py:105
    "general": ((2, 300, 200), (2, 200, 260)),  # matmul3.py:130
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("path", list(MATMUL3_PATHS))
@pytest.mark.parametrize("scale", [None, 0.125])
def test_torch_matmul3_matches_pallas(dtype, path, scale):
    """Both pallas_calls of the Pallas matmul3 compute the port's one
    function: the unfused attention's scores and context."""
    xs, ys = MATMUL3_PATHS[path]
    rng = np.random.default_rng(13)
    (jx, tx), (jy, ty) = (_pair(0.3 * rng.standard_normal(s), dtype)
                          for s in (xs, ys))
    want = pallas_matmul3.matmul3(jx, jy, scale=scale, interpret=True)
    got = ops.matmul3(tx, ty, scale=scale)
    assert got.shape == (xs[0], xs[1], ys[2]) and got.dtype == tx.dtype
    _close(got, want, dtype)
    with pytest.raises(ValueError, match="matmul3 shapes"):
        ops.matmul3(tx, ty[:1])


def test_torch_cuda_impl_on_a_cpu_tensor_raises():
    """No hidden fallback: asking for the kernel on a CPU tensor raises."""
    x = torch.zeros(2, 4, 128)
    v = torch.ones(128)
    w = torch.ones(128, 128)
    calls = [
        lambda: ops.layernorm(x, v, v, impl="cuda"),
        lambda: ops.matmul(x, w, v, impl="cuda"),
        lambda: ops.patch_embed(torch.zeros(1, 2, 8, 8), w, v, 8, impl="cuda"),
        lambda: ops.mlp_block(x, v, v, w, v, w, v, impl="cuda"),
        lambda: ops.attn_block(x, v, v, torch.ones(128, 384),
                               torch.ones(384), w, v, num_heads=2,
                               impl="cuda"),
        lambda: ops.layernorm_stats(x, impl="cuda"),
        lambda: ops.fused_linear(x, w, v, ln_scale=v, ln_bias=v, impl="cuda"),
        lambda: ops.flash_attention(x[None], x[None], x[None], impl="cuda"),
        lambda: ops.add(x, x, impl="cuda"),
        lambda: ops.softmax(x, impl="cuda"),
        lambda: ops.matmul3(x, x.transpose(1, 2), impl="cuda"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.layernorm(x, v, v, impl="pallas")


def test_torch_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers themselves check the device before building."""
    from vit_tpu_torch.ops.cuda import block, launch_counts
    from vit_tpu_torch.ops.cuda import layernorm as k_layernorm
    from vit_tpu_torch.ops.cuda import matmul as k_matmul

    before = launch_counts()
    x, v = torch.zeros(4, 128), torch.ones(128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_layernorm.layernorm(x, v, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k_matmul.matmul(x, torch.ones(128, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        block.attention_core(torch.zeros(8, 384), batch=2, num_heads=2,
                             scale=0.1, seq_len=3)
    assert launch_counts() == before


def test_torch_new_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers of layernorm_stats, fused_linear and flash_attention
    check the device before building or counting."""
    from vit_tpu_torch.ops.cuda import attention as k_attention
    from vit_tpu_torch.ops.cuda import launch_counts
    from vit_tpu_torch.ops.cuda import layernorm as k_layernorm
    from vit_tpu_torch.ops.cuda import matmul as k_matmul

    before = launch_counts()
    x, v, w = torch.zeros(4, 128), torch.ones(128), torch.ones(128, 8)
    q = torch.zeros(1, 2, 16, 64)
    calls = [
        lambda: k_layernorm.layernorm_stats(x),
        lambda: k_matmul.fused_linear(x, w),
        lambda: k_matmul.fused_linear(x, w, ln_scale=v, ln_bias=v),
        lambda: k_attention.flash_attention(q, q, q),
        lambda: k_attention.flash_attention(q.transpose(1, 2), q, q),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert launch_counts() == before


def test_torch_reference_chain_wrappers_refuse_cpu_tensors():
    """The wrappers of K14-K16 check the device before building or
    counting."""
    from vit_tpu_torch.ops.cuda import elementwise, launch_counts
    from vit_tpu_torch.ops.cuda import matmul3 as k_matmul3

    before = launch_counts()
    x = torch.zeros(2, 4, 8)
    for call in (lambda: elementwise.add(x, x),
                 lambda: elementwise.softmax(x),
                 lambda: k_matmul3.matmul3(x, x.transpose(1, 2).contiguous())):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert launch_counts() == before


def test_torch_attention_smem_fits_the_slice():
    """The attention core's shared memory at B/16 (S=208, d=64) fits one
    Hopper block in both dtypes; L/16-384's 592 tokens do not (raises)."""
    from vit_tpu_torch.ops.cuda.block import MAX_SMEM, attention_smem_bytes

    assert attention_smem_bytes(208, 64, 2) == 115776
    assert attention_smem_bytes(208, 64, 4) <= MAX_SMEM
    assert attention_smem_bytes(592, 64, 4) > MAX_SMEM
