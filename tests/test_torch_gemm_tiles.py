"""K2's bf16 ``wgmma`` tile (``vit_tpu_torch/csrc/gemm_wgmma.cuh``), its
choice by ``ops.cuda.matmul.gemm_path``, and the training backward's
transposed operands, on the CPU.

CUDA kernels do not run here, so the tile's walk is modelled in this file
(not in the package) and held to the functions its plain version is held
to: ``reference.matmul`` and JAX's Pallas ``matmul`` in interpret mode
(``vit_tpu/ops/pallas/matmul.py:153``, as ``tests/test_torch_ops.py``
runs it). The model cuts the output into 128-row tiles over persistent
blocks as the kernel does, reads each operand box by box from the view it
is given (a ``.t()`` view is read where it lies, as TMA reads it), sums in
fp32 over K in steps of 64 and, inside a step, 16-deep slices in order,
with zeros past M, N and K, then adds the bias, applies GELU and adds the
residual in fp32 and casts once, storing only inside (M, N).

Bars: fp32 max|diff| <= 1e-5 (sum order only); bf16 |diff| <= 2e-2 *
(1 + |ref|), the kernel bar (about two bf16 ulps: one rounding may flip).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas import matmul as pallas_matmul
from vit_tpu_torch.config import VARIANTS
from vit_tpu_torch.ops import autograd, reference
from vit_tpu_torch.ops.cuda import matmul as cuda_matmul

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BM, BK, K16 = 128, 64, 16  # gemm_wgmma.cuh: kBM, kBK, the wgmma depth
SMS = 132  # an H100 SXM's SMs: one persistent block each
#: Every batch of the main paths' K2 calls that the path test walks.
BATCHES = range(1, 257)
#: Classes of the heads the port serves (ImageNet-1k).
CLASSES = 1000


def _close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32)) \
        if not isinstance(want, torch.Tensor) else want.float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5, diff.max()
    else:
        assert (diff <= 2e-2 * (1 + np.abs(want))).all(), diff.max()


def tile_schedule(m: int, n: int, bn: int, sms: int = SMS) -> list:
    """The output tiles ``(m0, n0)`` each persistent block walks: block b
    of ``min(tiles, sms)`` takes tiles b, b + grid, ..., tile t at row
    ``t % tiles_m`` and column ``t // tiles_m``."""
    tiles_m, tiles_n = -(-m // BM), -(-n // bn)
    tiles = tiles_m * tiles_n
    grid = min(tiles, sms)
    return [[((t % tiles_m) * BM, (t // tiles_m) * bn)
             for t in range(b, tiles, grid)] for b in range(grid)]


def _box(t: torch.Tensor, r0: int, c0: int, rows: int, cols: int):
    """The rows x cols box of ``t`` at (r0, c0), zeros outside ``t`` (TMA's
    fill)."""
    out = torch.zeros((rows, cols), dtype=t.dtype)
    part = t[r0:r0 + rows, c0:c0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def k2_tiles(x, w, bias=None, activation=None, residual=None, *,
             bn: int = 128) -> torch.Tensor:
    """``gemm_bf16_wgmma`` on x (M, K) and w (K, N), either of which may
    be a ``.t()`` view; returns (M, N) in x's dtype."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype)
    written = torch.zeros((m, n), dtype=torch.int32)
    for tiles in tile_schedule(m, n, bn):
        for m0, n0 in tiles:
            acc = torch.zeros((BM, bn), dtype=torch.float32)
            for k0 in range(0, k, BK):
                a, b = _box(x, m0, k0, BM, BK), _box(w, k0, n0, BK, bn)
                for kk in range(0, BK, K16):
                    acc += a[:, kk:kk + K16].float() @ b[kk:kk + K16].float()
            rows, cols = min(BM, m - m0), min(bn, n - n0)
            v = acc[:rows, :cols]
            if bias is not None:
                v = v + bias[n0:n0 + cols].float()
            if activation == "gelu":
                v = reference.gelu(v)
            if residual is not None:
                v = v + residual[m0:m0 + rows, n0:n0 + cols].float()
            out[m0:m0 + rows, n0:n0 + cols] = v.to(x.dtype)
            written[m0:m0 + rows, n0:n0 + cols] += 1
    assert (written == 1).all()
    return out


def _operand(a: np.ndarray, dtype: str, trans: bool) -> torch.Tensor:
    """``a`` as a torch tensor: contiguous, or the ``.t()`` view of a
    contiguous copy of its transpose."""
    t = torch.from_numpy(np.ascontiguousarray(a.T if trans else a,
                                              np.float32))
    t = t.to(DTYPES[dtype][1])
    return t.t() if trans else t


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", [(200, 72, 136), (37, 40, 264)])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("epilogue", ["none", "bias_gelu", "bias_residual"])
def test_k2_tiles_match_reference_and_pallas(dtype, m, k, n, trans_a,
                                             trans_b, epilogue):
    """M, N and K not multiples of the tile (128 x 128, K steps of 64) but
    multiples of 8, as TMA needs; K = 40 is shorter than one step."""
    rng = np.random.default_rng(11)
    xa, wa = rng.standard_normal((m, k)), 0.1 * rng.standard_normal((k, n))
    ba, ra = 0.1 * rng.standard_normal(n), rng.standard_normal((m, n))
    x, w = _operand(xa, dtype, trans_a), _operand(wa, dtype, trans_b)
    assert cuda_matmul._transposed(x) == trans_a
    assert cuda_matmul._transposed(w) == trans_b
    bias = _operand(ba, dtype, False) if epilogue != "none" else None
    act = "gelu" if epilogue == "bias_gelu" else None
    res = _operand(ra, dtype, False) if epilogue == "bias_residual" else None
    got = k2_tiles(x, w, bias, act, res)
    _close(got, reference.matmul(x, w, bias, act, res), dtype)
    if res is None:
        jdt = DTYPES[dtype][0]
        want = pallas_matmul.matmul(
            jnp.asarray(xa, jdt), jnp.asarray(wa, jdt),
            None if bias is None else jnp.asarray(ba, jdt), act,
            interpret=True)
        _close(got, want, dtype)


@pytest.mark.parametrize("m,n,bn", [
    (6656, 2304, 128),  # B/16 bs=32's QKV: 936 tiles, 7.1 a block
    (6656, 768, 128),   # its out-projection: 312 tiles
    (768, 2304, 128),   # x.t() @ g of the QKV: 108 tiles, fewer than SMs
    (768, 768, 256),    # the out-projection's dw on the wide tile
    (37, 1000, 128)])   # a ragged head
def test_k2_tile_schedule_covers_each_tile_once(m, n, bn):
    blocks = tile_schedule(m, n, bn)
    tiles = [t for b in blocks for t in b]
    assert len(tiles) == len(set(tiles)) == -(-m // BM) * -(-n // bn)
    assert len(blocks) == min(len(tiles), SMS)
    # Blocks differ by at most one tile: the last wave is the only ragged one.
    sizes = [len(b) for b in blocks]
    assert max(sizes) - min(sizes) <= 1


def k2_calls(cfg, b: int):
    """Every K2 call of ``cfg``'s forward and train step at batch ``b`` as
    ``(patches, x, w)``, bf16 operands on the meta device: each linear
    (m, k) @ (k, n) -- the patch projection (``patches``), QKV,
    out-projection, fc1, fc2 and a 1000-class head -- forward, with its
    backward's ``g @ w.t()`` and ``x.t() @ g`` (the GELU'd linear's
    rematerialised pre-activation is its forward again). The operands are
    whole allocations, so their bases are aligned, and the backward's are
    the views it passes: at b = 1 the head's ``x.t()`` is a (768, 1)
    column, which PyTorch also calls contiguous."""
    d, mlp = cfg.hidden_dim, cfg.mlp_dim
    sp = -(-cfg.seq_len // 16) * 16
    rows = b * sp
    linears = [(b * cfg.num_patches, cfg.patch_dim, d), (rows, d, 3 * d),
               (rows, d, d), (rows, d, mlp), (rows, mlp, d), (b, d, CLASSES)]
    calls = []
    for i, (m, k, n) in enumerate(linears):
        x, w, g = (torch.empty(shape, dtype=torch.bfloat16, device="meta")
                   for shape in ((m, k), (k, n), (m, n)))
        calls += [(i == 0, x, w), (False, g, w.t()), (i == 0, x.t(), g)]
    return calls


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gemm_path_takes_wgmma_on_every_main_path_call(variant):
    """bf16: every K2 call of every variant's forward and train step at
    batches 1-256 takes the wgmma tile, as the wrapper picks it
    (``k2_operands``), but H/14's patch projection and its weight
    gradient, whose patches have rows of 14*14*3 = 588 elements, not a
    multiple of 8 (TMA needs 16-byte row strides): those take wmma, with
    the transposed operand copied by the wrapper. Its input gradient
    ``g @ w.t()`` reads w's 588 rows of 1280 and takes wgmma; only its
    output is 588 wide. fp32 takes its tf32 wgmma tile on every call, H/14's
    patch projection included: rows of 588 floats are 16-byte multiples."""
    cfg = VARIANTS[variant]
    for b in BATCHES:
        for patches, x, w in k2_calls(cfg, b):
            m, k = x.shape
            *_, path = cuda_matmul.k2_operands(x, w, m, k)
            unaligned = patches and cfg.patch_dim % 8 != 0
            assert path == ("wmma" if unaligned else "wgmma"), (
                variant, b, tuple(x.shape), tuple(w.shape))
            *_, path = cuda_matmul.k2_operands(x.float(), w.float(), m, k)
            assert path == "wgmma"


def test_one_row_x_transposed_takes_wgmma():
    """At batch 1 the head's weight gradient reads ``x.t()`` of a (1, 768)
    x: a (768, 1) column that PyTorch calls contiguous both ways. K2 reads
    it as the transpose of the one row, in place, on the wgmma tile; a
    column of 37 rows takes wmma as the (37, 1) matrix it also is."""
    for r, path, ta in ((768, "wgmma", True), (37, "wmma", False)):
        x = torch.empty((1, r), dtype=torch.bfloat16, device="meta").t()
        g = torch.empty((1, CLASSES), dtype=torch.bfloat16, device="meta")
        assert x.is_contiguous() and cuda_matmul._transposed(x)
        xs, _, got_ta, tb, got = cuda_matmul.k2_operands(x, g, r, 1)
        assert (got, got_ta, tb) == (path, ta, False)
        assert xs.data_ptr() == x.data_ptr()


@pytest.mark.parametrize("ptrs,strides,trans,path", [
    ((0, 0), ((768, 1), (2304, 1)), (False, False), "wgmma"),
    ((2, 0), ((768, 1), (2304, 1)), (False, False), "wmma"),    # x + 2 B
    ((0, 48), ((768, 1), (2304, 1)), (False, False), "wgmma"),  # w + 48 B
    ((0, 0), ((588, 1), (2304, 1)), (False, False), "wmma"),    # lda 588
    ((0, 0), ((768, 1), (1, 100)), (False, True), "wmma"),      # ldb 100
    ((0, 0), ((1, 104), (1, 768)), (True, True), "wgmma"),
    ((0, 8), ((1, 104), (1, 768)), (True, True), "wmma")])
def test_gemm_path_by_alignment(ptrs, strides, trans, path):
    """The wgmma tile needs both bases 16-byte aligned and both storage
    row strides multiples of 8 elements; anything else takes wmma."""
    assert cuda_matmul.gemm_path(104, 2304, 768, torch.bfloat16, *trans,
                                 ptrs, strides) == path


@pytest.mark.parametrize("shape,wshape,view,tile,flags", [
    ((2, 256, 588), (588, 1280), False, 0, (0, 0)),  # H/14's patches
    ((2, 196, 768), (768, 768), False, 1, (0, 0)),   # B/16's patches
    ((768, 104), (104, 96), True, 1, (1, 0)),   # x.t() of a (104, 768)
    ((36, 64), (64, 96), True, 0, (0, 0)),      # x.t() with rows of 36
    ((768, 1), (1, 96), True, 1, (1, 0)),       # x.t() of a (1, 768) x
    ((768, 1), (1, 96), False, 1, (1, 0))])     # a (768, 1) column
def test_k2_wrapper_launches_the_tile_gemm_path_picks(monkeypatch, shape,
                                                      wshape, view, tile,
                                                      flags):
    """What ``ops.cuda.matmul`` hands the C launcher, without a card: the
    tile code and transpose flags; an (..., K) x as its (m, K) view, whose
    row stride is K and not its batch stride (H/14's 588 takes wmma); a
    contiguous copy of a ``.t()`` view for the wmma tile."""
    from vit_tpu_torch.ops.cuda import _build

    launches = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args, like: launches.append(args))
    dt = torch.bfloat16
    x = torch.zeros(shape[::-1], dtype=dt).t() if view \
        else torch.zeros(shape, dtype=dt)
    w = torch.zeros(wshape, dtype=dt)
    k, n = wshape
    m = x.numel() // k
    cuda_matmul._k2(x, w, None, None, torch.empty((m, n), dtype=dt), m, n,
                    k, 0)
    (args,) = launches
    xs, ws = args[0], args[1]
    assert args[-3:] == (*flags, tile)
    assert tuple(xs.shape) == (m, k) and ws.is_contiguous()
    assert cuda_matmul._transposed(xs) == bool(flags[0])
    assert (xs.data_ptr() == x.data_ptr()) == (tile == 1 or not view)


def _spy(monkeypatch):
    """Record the operands of every K2 slot call (the plain version on the
    CPU: ``kernel_fn`` looks it up at call time)."""
    calls = []
    plain = reference.matmul

    def spy(x, w, *args, **kw):
        calls.append((x, w))
        return plain(x, w, *args, **kw)
    monkeypatch.setattr(reference, "matmul", spy)
    return calls


def _is_view_of(t: torch.Tensor, base: torch.Tensor) -> bool:
    """``t`` is a transposed view of ``base``'s storage: no copy."""
    return (cuda_matmul._transposed(t)
            and t.untyped_storage().data_ptr()
            == base.untyped_storage().data_ptr())


@pytest.mark.parametrize("fn", ["linear", "fused_linear", "fused_linear_ln",
                                "embed_fused"])
def test_backward_hands_k2_transposed_views(monkeypatch, fn):
    """The backwards of ``Linear``, ``FusedLinear`` (with and without LN)
    and ``EmbedFused`` give K2 ``w.t()`` and ``x.t()`` (or ``LN(x).t()``)
    as views of the tensors they saved, not contiguous copies; on the
    card, ``gemm_path`` sends such views to the wgmma tile. Their
    gradients are held to ``jax.vjp`` by ``tests/test_torch_train.py``."""
    rng = np.random.default_rng(5)
    dt = torch.bfloat16
    k, n = 64, 48

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dt)
    w, b = t(k, n, scale=0.1).requires_grad_(), t(n, scale=0.1)
    calls = _spy(monkeypatch)
    if fn == "embed_fused":
        patches = t(2, 16, k).requires_grad_()
        cls_row, pos = t(n), t(16, n)
        out = autograd.EmbedFused.apply(patches, w, b.requires_grad_(),
                                        cls_row, pos, 32, None)
        x = patches
    else:
        x = t(40, k).requires_grad_()
        if fn == "linear":
            out = autograd.Linear.apply(x, w, b, None, "gelu", None)
        else:
            ln = fn == "fused_linear_ln"
            gam, bet = (t(k, scale=0.1) + 1, t(k, scale=0.1)) if ln \
                else (None, None)
            out = autograd.FusedLinear.apply(x, w, b, gam, bet, None, "gelu",
                                             1e-12, None)
    calls.clear()
    out.float().sum().backward()
    assert x.grad is not None and w.grad is not None
    ws = [wo for xo, wo in calls if _is_view_of(wo, w)]
    xs = [xo for xo, wo in calls if cuda_matmul._transposed(xo)]
    assert len(ws) == 1 and len(xs) == 1, [(tuple(a.stride()),
                                            tuple(c.stride()))
                                           for a, c in calls]
    if fn in ("linear", "fused_linear", "embed_fused"):
        assert _is_view_of(xs[0], x)  # x.t() itself; with LN, LN(x).t()
    for xo, wo in calls:
        assert xo.is_contiguous() or cuda_matmul._transposed(xo)
        assert wo.is_contiguous() or cuda_matmul._transposed(wo)
        ta, tb = cuda_matmul._transposed(xo), cuda_matmul._transposed(wo)
        path = cuda_matmul.gemm_path(
            xo.shape[0], wo.shape[1], wo.shape[0], dt, ta, tb,
            (xo.data_ptr(), wo.data_ptr()),
            (tuple(xo.stride()), tuple(wo.stride())))
        assert path == "wgmma"


# ------------------------------------------------------------------ K6 --
#
# K6 ``fused_linear`` in bf16 on the same tile (``gemm_wgmma.cuh``, flag
# LN): x's raw box arrives by TMA (zeros past M and K), the producer
# warpgroup's three LN warps normalise it in place in fp32 with the rows'
# mu and rstd (K5's) and the step's gamma and beta, rounded to bf16, and
# the consumers' ``wgmma`` reads it by descriptor as K2 reads x; columns
# past K are exact zeros.

K6_KB = 64  # kBK: one K step, one 128-byte box row of bf16


def k6_a_box(x, mu, rstd, gamma, beta, m0: int, k0: int) -> torch.Tensor:
    """The A values of K6's K step at (m0, k0), as the kernel hands them
    to wgmma: TMA's box of x (zeros past M and K) normalised in fp32,
    ``((x - mu) * rstd) * gamma + beta``, rounded to bf16; rows past M take
    mu = rstd = 0; columns past K are set to zero (gamma and beta are not
    read there)."""
    m, k = x.shape
    rows = min(BM, m - m0)
    mt, rt = torch.zeros(BM), torch.zeros(BM)
    mt[:rows], rt[:rows] = mu[m0:m0 + rows], rstd[m0:m0 + rows]
    raw = _box(x, m0, k0, BM, K6_KB).float()
    cols = torch.arange(k0, k0 + K6_KB)
    inside = cols < k
    g, b = torch.zeros(K6_KB), torch.zeros(K6_KB)
    g[inside] = gamma[cols[inside]].float()
    b[inside] = beta[cols[inside]].float()
    a = (raw - mt[:, None]) * rt[:, None] * g + b
    a[:, ~inside] = 0.0
    return a.to(torch.bfloat16)


def k6_tiles(x, w, gamma, beta, bias=None, activation=None, residual=None,
             *, eps=1e-12) -> torch.Tensor:
    """K6's walk on x (M, K) and w (K, N), contiguous bf16: K5's stats,
    then :func:`k2_tiles`'s tiles and k16 slices with A from
    :func:`k6_a_box`."""
    m, k = x.shape
    n = w.shape[1]
    mu, rstd = reference.layernorm_stats(x, eps=eps)
    mu, rstd = mu.reshape(-1), rstd.reshape(-1)
    out = torch.empty((m, n), dtype=x.dtype)
    written = torch.zeros((m, n), dtype=torch.int32)
    for tiles in tile_schedule(m, n, 128):
        for m0, n0 in tiles:
            acc = torch.zeros((BM, 128), dtype=torch.float32)
            for k0 in range(0, k, K6_KB):
                a = k6_a_box(x, mu, rstd, gamma, beta, m0, k0)
                wb = _box(w, k0, n0, K6_KB, 128)
                for kk in range(0, K6_KB, K16):
                    acc += a[:, kk:kk + K16].float() @ wb[kk:kk + K16].float()
            rows, cols = min(BM, m - m0), min(128, n - n0)
            v = acc[:rows, :cols]
            if bias is not None:
                v = v + bias[n0:n0 + cols].float()
            if activation == "gelu":
                v = reference.gelu(v)
            if residual is not None:
                v = v + residual[m0:m0 + rows, n0:n0 + cols].float()
            out[m0:m0 + rows, n0:n0 + cols] = v.to(x.dtype)
            written[m0:m0 + rows, n0:n0 + cols] += 1
    assert (written == 1).all()
    return out


def _k6_inputs(m, k, n, seed=21, beta_std=0.2):
    rng = np.random.default_rng(seed)
    arrays = {"x": 0.3 + 1.5 * rng.standard_normal((m, k)),
              "w": 0.05 * rng.standard_normal((k, n)),
              "bias": 0.1 * rng.standard_normal(n),
              "gamma": 1.0 + 0.1 * rng.standard_normal(k),
              "beta": beta_std * rng.standard_normal(k),
              "res": rng.standard_normal((m, n))}
    tens = {name: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for name, a in arrays.items()}
    return arrays, tens


@pytest.mark.parametrize("m,k,n", [(200, 72, 136), (37, 200, 264),
                                   (130, 520, 96)])
@pytest.mark.parametrize("epilogue", ["bias", "bias_gelu", "bias_residual",
                                      "gelu_residual"])
def test_k6_tiles_match_reference_and_pallas(m, k, n, epilogue):
    """Ragged M, N and K (K not a multiple of 64; multiples of 8, as the
    wgmma tile takes them), with and without GELU and a residual, against
    ``reference.fused_linear`` and JAX's Pallas ``fused_linear`` in
    interpret mode, at the kernel bar."""
    arrays, t = _k6_inputs(m, k, n)
    act = "gelu" if "gelu" in epilogue else None
    bias = t["bias"] if "bias" in epilogue else None
    res = t["res"] if "residual" in epilogue else None
    got = k6_tiles(t["x"], t["w"], t["gamma"], t["beta"], bias, act, res)
    _close(got, reference.fused_linear(
        t["x"], t["w"], bias, act, ln_scale=t["gamma"], ln_bias=t["beta"],
        residual=res), "bfloat16")

    def j(name):
        return jnp.asarray(t[name].float().numpy(), jnp.bfloat16)
    want = pallas_matmul.fused_linear(
        j("x"), j("w"), None if bias is None else j("bias"), act,
        ln_scale=j("gamma"), ln_bias=j("beta"),
        residual=None if res is None else j("res"), interpret=True)
    _close(got, want, "bfloat16")


def test_k6_columns_past_k_are_zeros():
    """K = 200 ends inside the fourth 64-deep step. TMA fills x's box with
    zeros past K, and a zero would normalise to ``beta - mu * rstd *
    gamma`` with any gamma and beta there (``gemm_tile.cuh`` zero-fills
    after normalising for this reason); the kernel sets the A values past K
    to 0 and reads no gamma or beta there. The walk holds the bar with a
    large beta, and the last step's A values past K are 0 at every row,
    the rows past M included, so no NaN or inf can reach the products."""
    arrays, t = _k6_inputs(130, 200, 264, beta_std=3.0)
    _close(k6_tiles(t["x"], t["w"], t["gamma"], t["beta"], t["bias"]),
           reference.fused_linear(t["x"], t["w"], t["bias"],
                                  ln_scale=t["gamma"], ln_bias=t["beta"]),
           "bfloat16")
    mu, rstd = (s.reshape(-1) for s in reference.layernorm_stats(t["x"]))
    for m0 in (0, 128):  # rows 130-255 of the second tile are past M
        a = k6_a_box(t["x"], mu, rstd, t["gamma"], t["beta"], m0, 192)
        assert (a[:, 8:] == 0).all() and torch.isfinite(a.float()).all()
        assert (a[:min(BM, 130 - m0), :8] != 0).any()


LN_THREADS = 96  # gemm_wgmma.cuh: kLnThreads, the producer's warps 1-3


def ln_box_chunks(j: int) -> list:
    """The 16-byte chunks LN thread ``j`` normalises in place in
    ``ln_box``: (row, chunk column, byte address in the stage's 128-row A
    box) for rows j / 8 + 12i below 128, chunk column c = j % 8, at ``row *
    128 + ((c ^ (row % 8)) << 4)`` (TMA's 128-byte swizzle; rows 64-127
    are the second 8 KB box, 64 * 128 bytes on)."""
    c = j % 8
    return [(r, c, r * 128 + ((c ^ (r & 7)) << 4))
            for r in range(j // 8, BM, LN_THREADS // 8)]


def test_k6_ln_box_covers_the_box_once_without_bank_conflicts():
    """The design kept (the producer warpgroup's LN warps normalise the box
    in place): the 96 LN threads normalise every 16-byte chunk of a
    stage's 128 x 64 A box exactly once; each address holds the chunk TMA
    wrote there (decoded back through the swizzle: row ``addr // 128``,
    chunk ``((addr % 128) >> 4) ^ (row % 8)``), so LN's row (its mu and
    rstd) and columns (k0 + 8c ..) are that chunk's; each group of eight
    neighbouring threads (a 16-byte access's phase) reads and writes one
    row's eight chunks, 128 bytes on distinct banks, at every step of its
    row loop."""
    seen = {}
    for j in range(LN_THREADS):
        for r, c, addr in ln_box_chunks(j):
            row = addr // 128
            assert (row, ((addr % 128) >> 4) ^ (row & 7)) == (r, c)
            seen[r, c] = seen.get((r, c), 0) + 1
    assert len(seen) == BM * 8 and set(seen.values()) == {1}
    for j0 in range(0, LN_THREADS, 8):
        phases = [ln_box_chunks(j) for j in range(j0, j0 + 8)]
        for step in zip(*phases):
            assert {a % 128 for _, _, a in step} == set(range(0, 128, 16))
            assert len({r for r, _, _ in step}) == 1


def k6_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The tile ``vit_fused_linear`` runs K6 on for contiguous x (m, k) and
    w (k, n): ``gemm_path``'s choice for K2 on the same operands
    (``csrc/matmul_wgmma.cu:wgmma_takes`` in bf16 and
    ``csrc/matmul_tf32.cu:tf32_takes`` in fp32 apply it in the kernel
    library; the gpu test ``test_torch_cuda_fused_linear_ragged`` holds the
    two together)."""
    k, n = w.shape
    return cuda_matmul.gemm_path(x.numel() // k, n, k, x.dtype, False, False,
                                 (x.data_ptr(), w.data_ptr()),
                                 ((k, 1), (n, 1)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k6_takes_wgmma_on_every_composed_route_call(variant):
    """Every K6 call of the composed route (LN1 + QKV, LN2 + fc1 + GELU,
    contiguous whole allocations) at batches 1-256 takes the wgmma tile,
    the tile ``gemm_path`` gives K2 on the same operands, in bf16 and in
    fp32 (its tf32 tile)."""
    cfg = VARIANTS[variant]
    d, mlp = cfg.hidden_dim, cfg.mlp_dim
    sp = -(-cfg.seq_len // 16) * 16
    for b in BATCHES:
        for n in (3 * d, mlp):
            x = torch.empty((b * sp, d), dtype=torch.bfloat16, device="meta")
            w = torch.empty((d, n), dtype=torch.bfloat16, device="meta")
            assert k6_path(x, w) == "wgmma"
            assert k6_path(x.float(), w.float()) == "wgmma"


@pytest.mark.parametrize("offset,k,n,path", [
    (0, 768, 2304, "wgmma"), (2, 768, 2304, "wmma"), (0, 200, 264, "wgmma"),
    (0, 588, 1280, "wmma"), (0, 768, 100, "wmma")])
def test_fused_linear_path_by_alignment(offset, k, n, path):
    """K6 takes wgmma where TMA reads x and w: bases 16-byte aligned, K and
    N multiples of 8 (x at ``offset`` bytes into its storage)."""
    buf = torch.zeros(37 * k + 8, dtype=torch.bfloat16)
    x = buf[offset // 2:offset // 2 + 37 * k].view(37, k)
    w = torch.zeros((k, n), dtype=torch.bfloat16)
    assert k6_path(x, w) == path
