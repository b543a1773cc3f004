"""K10 ``quantize_rows`` (``vit_tpu_torch/csrc/layernorm.cu``) on the CPU:
its row form (``quantize_rows_reg``) and its scalar form
(``quantize_rows_kernel`` on ``common.cuh:quantize_row``, K12's prologue).

CUDA kernels do not run here, so the arithmetic of a warp is modelled in
numpy fp32, lane by lane: lane l owns elements l + 32 j in both forms, sums
them in j's order, the 32 lanes' sums meet in a butterfly of shuffles
(``warp_sum``: v + v[l ^ o] for o = 16 .. 1), the variance's sum of
squares is an FMA chain (``ss += c * c``, contracted by nvcc), then the LN
value in ``quantize_row``'s order, the row's abs max (exact in any order),
the scale and the codes. The model's rsqrt is the correctly rounded one,
the card's ``rsqrtf`` is within 2 ulp of it; its FMA is the fp32 rounding
of the fp64 sum, which can differ from a fused one only within 2^-53 of a
fp32 tie. The model is held to ``reference.quantize_rows`` and to JAX's
``_ln32`` plus ``attn_block_q``'s quantization: bit for bit without LN,
within the flip bar (<= 0.1% of codes, by one; scales to 1e-5) with it.
The row form's packed stores (four shuffles and three byte permutes a
128-byte chunk) are modelled byte for byte, its division of the codes (a
reciprocal and FMAs, ``quant_code_rcp``) is held to the IEEE quotient, and
the rule that picks a form is pinned.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda import quant as cuda_quant

SRC = (Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"
       / "layernorm.cu").read_text()
COMMON = (Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"
          / "common.cuh").read_text()
EPS = 1e-12
F32 = np.float32


def owned(lane: int, d: int, form: str) -> list[int]:
    """The elements lane ``lane`` holds, in its order: the scalar form's
    loop ``for (i = lane; i < d; i += 32)``, the row form's registers
    ``x[lane + 32 j]``, j < d / 32."""
    if form == "scalar":
        return list(range(lane, d, 32))
    return [lane + 32 * j for j in range(d // 32)]


def warp_sum(v: np.ndarray) -> np.ndarray:
    """``common.cuh:warp_sum`` over the last axis (32 lanes): every lane
    ends with the same fp32 sum."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v


def fma32(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def k10_model(x: np.ndarray, g=None, b=None, form: str = "row"):
    """K10 on fp32 rows ``x`` (M, D) (the input's values, bf16 or fp32,
    read as fp32): (codes int8, scales fp32 (M, 1))."""
    m, d = x.shape
    x = x.astype(F32)
    cols = [owned(lane, d, form) for lane in range(32)]
    depth = max(len(c) for c in cols)
    # v[row, lane, j]: element lane + 32 j (0 where the lane has none, an
    # exact no-op of the sums).
    idx = np.full((32, depth), -1)
    for lane, c in enumerate(cols):
        idx[lane, :len(c)] = c
    have = idx >= 0
    v = np.where(have, x[:, np.maximum(idx, 0)], F32(0))
    val = v
    if g is not None:
        s = np.zeros((m, 32), F32)
        for j in range(depth):
            s = (s + v[:, :, j]).astype(F32)
        mean = (warp_sum(s)[:, :1] / F32(d)).astype(F32)
        ss = np.zeros((m, 32), F32)
        for j in range(depth):
            c = (v[:, :, j] - mean).astype(F32)
            ss = np.where(have[:, j], fma32(c, c, ss), ss)
        var = (warp_sum(ss)[:, :1] / F32(d)).astype(F32)
        rstd = (1.0 / np.sqrt((var + F32(EPS)).astype(F32).astype(
            np.float64))).astype(F32)
        gv = np.where(have, g.astype(F32)[np.maximum(idx, 0)], F32(0))
        bv = np.where(have, b.astype(F32)[np.maximum(idx, 0)], F32(0))
        c = ((v - mean[:, :, None]).astype(F32) * rstd[:, :, None]).astype(F32)
        val = ((c * gv).astype(F32) + bv).astype(F32)
    amax = np.where(have, np.abs(val), F32(0)).max(axis=(1, 2))
    scale = (np.maximum(amax, F32(1e-12)).astype(F32) / F32(127)).astype(F32)
    codes = np.clip(np.rint((val / scale[:, None, None]).astype(F32)),
                    -127, 127)
    q = np.zeros((m, d), np.int8)
    for lane in range(32):
        for j, e in enumerate(cols[lane]):
            q[:, e] = codes[:, lane, j]
    return q, scale[:, None]


def _rows(m: int, d: int, dtype: str, seed: int):
    """Rows of std 1.5, mean 0.2 (chip_smoke.py's K10 inputs), the first
    row zero; in bf16 rounded to it. Gamma, beta in the same dtype."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)) * 1.5 + 0.2
    x[0] = 0
    g = 1.0 + 0.1 * rng.standard_normal(d)
    b = 0.05 * rng.standard_normal(d)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return [torch.from_numpy(a.astype(F32)).to(td) for a in (x, g, b)]


def _flip_bar(q, a, qw, aw):
    q, qw = np.asarray(q, np.int32), np.asarray(qw, np.int32)
    a, aw = np.asarray(a, F32), np.asarray(aw, F32)
    flips = np.abs(q - qw)
    assert flips.max() <= 1
    assert (flips > 0).mean() <= 1e-3
    assert (np.abs(a - aw) <= 1e-5 * aw).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 384, 768, 1280, 200])
@pytest.mark.parametrize("ln", [False, True])
def test_k10_model_matches_reference_and_jax(dtype, d, ln):
    """The lane model against ``reference.quantize_rows`` and against
    JAX's ``_ln32`` (``vit_tpu/ops/pallas/block.py``) plus
    ``attn_block_q``'s quantization (block.py:1218-1221): bit for bit
    without LN (no sum is taken), within the flip bar with it (another sum
    order). D = 200 runs the scalar form."""
    x, g, b = _rows(96, d, dtype, d + 3 * ln)
    form = cuda_quant.quantize_rows_form(d)
    assert form == ("scalar" if d == 200 else "row")
    x32 = x.float().numpy()
    kw = dict(ln_scale=g, ln_bias=b) if ln else {}
    q, a = k10_model(x32, g.float().numpy() if ln else None,
                     b.float().numpy() if ln else None, form)
    qr, ar = reference.quantize_rows(x, **kw)
    jx = jnp.asarray(x32)
    if ln:
        jx = pallas_block._ln32(jx, jnp.asarray(g.float().numpy()),
                                jnp.asarray(b.float().numpy()), EPS)
    aj = jnp.maximum(jnp.max(jnp.abs(jx), axis=-1, keepdims=True),
                     1e-12) / 127.0
    qj = jnp.round(jx / aj).astype(jnp.int8)
    for qw, aw in ((qr.numpy(), ar.numpy()), (np.asarray(qj),
                                              np.asarray(aj))):
        if not ln:
            assert np.array_equal(q, qw) and np.array_equal(a, aw)
        else:
            _flip_bar(q, a, qw, aw)


@pytest.mark.parametrize("d", [128, 384, 768, 1024, 1280])
def test_k10_row_form_keeps_the_scalar_forms_order(d):
    """Where the row form runs, every lane owns the elements the scalar
    form's loop gives it, in the same order, so the two forms take every
    sum in one order (the card holds their codes and scales bit for bit);
    the kernel's sources say so: the row form loads ``x[lane + 32 * j]``,
    the scalar loops run ``i = lane; i < d; i += 32``."""
    for lane in range(32):
        assert owned(lane, d, "row") == owned(lane, d, "scalar")
    x, g, b = _rows(8, d, "float32", d)
    args = (x.numpy(), g.numpy(), b.numpy())
    for want, got in zip(k10_model(*args, form="scalar"),
                         k10_model(*args, form="row")):
        assert np.array_equal(want, got)
    assert "v[j] = x[lane + 32 * j];" in SRC
    assert COMMON.count("for (int i = lane; i < d; i += 32)") >= 4


def chunk_stores(codes: np.ndarray) -> np.ndarray:
    """One 128-element chunk of a row through the row form's stores: lane
    l packs its codes of elements l + 32 i (i = 0..3) into word w (byte
    i), reads the words of lanes src .. src + 3 (src = 4 l % 32) by
    shuffles, takes byte u = l / 8 of each with ``__byte_perm`` (selector
    u | (u + 4) << 4, then 0x5410) and stores the word at byte 4 l.
    Returns the 128 bytes written."""
    byte = codes.astype(np.int8).view(np.uint8).astype(np.uint32)
    w = [sum(int(byte[lane + 32 * i]) << (8 * i) for i in range(4))
         for lane in range(32)]

    def perm(x, y, s):
        src = x | (y << 32)
        return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
                   for n in range(4))

    out = np.zeros(128, np.uint8)
    written = np.zeros(128, np.int32)
    for lane in range(32):
        src, u = 4 * lane % 32, lane // 8
        sel = u | (u + 4) << 4
        w0, w1, w2, w3 = (w[src + v] for v in range(4))
        word = perm(perm(w0, w1, sel), perm(w2, w3, sel), 0x5410)
        for n in range(4):
            out[4 * lane + n] = (word >> (8 * n)) & 0xFF
            written[4 * lane + n] += 1
    assert (written == 1).all()
    return out


def test_k10_packed_stores_are_the_row_in_order():
    """The row form's four-byte stores write each 128-byte chunk of the
    codes in order, every byte once, the selector and source lanes as the
    source has them."""
    codes = np.random.default_rng(1).integers(-127, 128, 128)
    assert np.array_equal(chunk_stores(codes),
                          codes.astype(np.int8).view(np.uint8))
    assert "const int src = 4 * lane % 32, u = lane / 8;" in SRC
    assert "const uint32_t sel = u | (u + 4) << 4;" in SRC
    assert "__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410" in SRC


def _fma32(x, y, z):
    """fp32 FMAs: x y exact in the 64-bit significand of numpy's long
    double, one rounding of the sum there, then to fp32 (a second rounding
    that can differ from a fused one only within 2^-40 of an fp32 tie)."""
    ld = np.longdouble
    return (x.astype(ld) * y.astype(ld) + z.astype(ld)).astype(F32)


def test_quant_code_rcp_division_is_ieee():
    """``quant_code_rcp``'s quotient -- v times the reciprocal rounded to
    nearest, then two correction steps of two FMAs -- is the IEEE quotient
    v / a (``__fdiv_rn``, quant_code's) bit for bit at values on, and two
    ulps around, the fp32 images of (k + 1/2) a (the rounding boundaries
    of the codes) and at random values, across 2^80 of scales, so its
    codes are quant_code's; the product alone is not the quotient."""
    rng = np.random.default_rng(23)
    n = 400_000
    amax = (F32(127) * (2.0 ** rng.uniform(-40, 40, n))).astype(F32)
    a = (np.maximum(amax, F32(1e-12)) / F32(127)).astype(F32)
    k = rng.integers(-127, 127, n).astype(F32)
    ties = ((k + F32(0.5)) * a).astype(F32)
    ties = (ties.view(np.int32) + rng.integers(-2, 3, n).astype(np.int32)
            ).view(F32)
    rand = (rng.uniform(-1, 1, n) * amax).astype(F32)
    for v in (np.clip(ties, -amax, amax), rand):
        ra = (F32(1) / a).astype(F32)
        q0 = (v * ra).astype(F32)
        q = q0
        for _ in range(2):
            q = _fma32(_fma32(-a, q, v), ra, q)
        want = (v / a).astype(F32)
        assert np.array_equal(q, want)
        assert np.array_equal(np.clip(np.rint(q), -127, 127),
                              np.clip(np.rint(want), -127, 127))
    assert not np.array_equal(q0, want)
    body = SRC[SRC.index("quant_code_rcp(float v"):]
    body = body[:body.index("\n}\n")]
    assert "float q = __fmul_rn(v, ra);" in body
    assert body.count("q = __fmaf_rn(__fmaf_rn(-a, q, v), ra, q);") == 2
    assert "ra = __frcp_rn(a)" in SRC


@pytest.mark.parametrize("d,form", [
    (128, "row"), (384, "row"), (768, "row"), (1024, "row"), (1280, "row"),
    (192, "scalar"), (200, "scalar"), (776, "scalar"), (1408, "scalar"),
    (64, "scalar"), (32, "scalar")])
def test_quantize_rows_form_rule(d, form):
    """``quantize_rows_form``: the row form where D is a multiple of 128 up
    to H/14's 1280 (its E = D / 32 registers a lane), the scalar form
    elsewhere; the library's rule (``quantize_rows_reg_takes``, its
    ``kQrMaxD`` and the E it instantiates) is the same."""
    assert cuda_quant.quantize_rows_form(d) == form
    assert int(re.search(r"constexpr int kQrMaxD = (\d+);", SRC).group(1)) \
        == cuda_quant.QUANTIZE_ROWS_MAX_D
    assert "return d % 128 == 0 && d <= kQrMaxD;" in SRC
    inst = {int(e) for e in re.findall(r"VIT_QR_E\((\d+)\)\n", SRC)}
    assert inst == {dd // 32 for dd in range(128, 1281, 128)}
    assert cuda_quant.QUANTIZE_ROWS_FORMS == {"scalar": 0, "row": 1}


def test_quantize_rows_form_refuses_empty_rows():
    with pytest.raises(ValueError, match="rows of 0"):
        cuda_quant.quantize_rows_form(0)


@pytest.mark.parametrize("name", ["fdiv", "ln_one_row", "noln_strided",
                                  "threads256"])
def test_ablation_variants_edit_the_current_source(monkeypatch, tmp_path,
                                                   name):
    """``tools/quantize_rows_ablate.py``: each variant's substitution
    matches ``layernorm.cu`` as it is (a pattern that matches nothing
    raises), and the copy differs from it."""
    from vit_tpu_torch.tools import quantize_rows_ablate as abl
    monkeypatch.setattr(abl, "OUT", tmp_path)
    root = abl.make_variant(name)
    assert (root / "layernorm.cu").read_text() != SRC
    assert (root / "common.cuh").read_text() == COMMON
