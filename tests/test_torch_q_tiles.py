"""K17's bf16 ``wgmma`` tile and K9's bf16 GEMM phases on the CPU:
``vit_tpu_torch/csrc/mlp_q_wgmma.cuh`` (K17 ``mlp_block_q``),
``csrc/stack_wgmma.cuh`` (the GEMM phases of K9 ``encoder_stack``,
``encoder_stack_fused`` and ``encoder_stack_q``) and their shared int8 ->
bf16 conversion, ``csrc/q_convert.cuh``.

CUDA kernels do not run here, so what the tiles do is modelled in this
file (not in the package), byte for byte where it is layout:

- the conversion: the ``prmt`` / bf16x2 arithmetic of ``cvt4`` on every
  int8 code (exact), the chunk order ``chunk_of`` and the raw and
  bf16 byte maps of both raw layouts (K17's dense boxes, K9's swizzled
  128-column boxes): a bijection onto the bf16 box, read back through the
  MN-major B descriptor as ``q[k, n]``, and no bank conflict in any
  16-byte load or store phase of a warp;
- K17's walk (passes of at most three boxes a warpgroup, 128-column chunks,
  the fc2 sums of a 512-column group kept apart and scaled once) against
  ``reference.mlp_block_q`` and JAX's Pallas ``mlp_block_q`` in interpret
  mode at a narrow width and ragged M; the rings' item orders; its
  barrier protocol (two raw rings, each filled by one warpgroup's leader
  inside its walk, both warpgroups taking and releasing every raw box, the
  h exchange) under random interleavings, which must neither deadlock nor
  reuse a buffer early;
- K9's tiling (items of 64 rows x 128 columns, the split of K in the
  out-projection and fc2, slices added in a fixed order) and its bf16
  attention phase (``csrc/encoder_stack.cu:attention_phase`` on K4's
  tensor-core core, ``csrc/attention_mma.cuh``: 32-row query tiles on
  the whole block, the keys in four parts summed in order, each part's
  two passes over 64-key chunks in the core's sum order) against
  ``reference.encoder_stack`` / ``encoder_stack_q`` and JAX's Pallas
  kernels at two layers; the split counts at the B/16 and L/16 stack
  shapes; the attention tiles' cover of every (image, head, query row)
  and of every key;
- the shared-memory budgets: K17 at every width ``ops.mlp_q_plan`` admits
  (D up to 1280), K9's ring, and K9's attention phase (K and V and the
  key parts' exchange) beside the ring's barriers at every geometry the
  stack gates admit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops as jax_ops
from vit_tpu.ops.pallas import block as jax_block
from vit_tpu_torch import ops
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda.block import MAX_SMEM, attention_smem_bytes
from vit_tpu_torch.ops.cuda.quant import MLP_I8_MAX_D
from vit_tpu_torch.ops.cuda.block import attention_mma_smem_bytes
from vit_tpu_torch.ops.cuda.stack import MAX_SPLITS
from vit_tpu_torch.quant import quantize_params, quantize_weight

CSRC = Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"
CONVERT = (CSRC / "q_convert.cuh").read_text()
K17 = (CSRC / "mlp_q_wgmma.cuh").read_text()
K9 = (CSRC / "stack_wgmma.cuh").read_text()
K9_CU = (CSRC / "encoder_stack.cu").read_text()
ATTN_MMA = (CSRC / "attention_mma.cuh").read_text()
EPS = 1e-12
K16 = 16  # the wgmma depth


def _const(text: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([0-9][0-9 +*]*);", text)
    return int(eval(m.group(1), {}, {}))  # noqa: S307


BOX = _const(K17, "kBox")
CT, GROUP_CHUNKS = _const(K17, "kCT"), _const(K17, "kGroupChunks")
SMEM_MAX, BAR_BYTES = _const(K17, "kSmemMax"), _const(K17, "kBarBytes")
MAX_S1, K17_THREADS = _const(K17, "kMaxS1"), _const(K17, "kThreads")
K9_BM, K9_BN, K9_BK = (_const(K9, n) for n in ("kBM", "kBN", "kBK"))
K9_STAGES, K9_SPLITS = _const(K9, "kMaxStages"), _const(K9, "kMaxSplits")
assert "kBarBytes = 2 * kMaxStages * 8;" in K9
K9_BAR = 2 * K9_STAGES * 8
K9_ATTN_PARTS = _const(K9_CU, "kStackAttnParts")

# cvt4's constants and prmt selectors, read from the source.
_CVT4 = re.search(r"void cvt4.*?\n}", CONVERT, re.S).group(0)
_HIGH = int(re.search(r"kHigh = (0x[0-9A-Fa-f]+)u", _CVT4).group(1), 16)
_MASKS = [int(m, 16) for m in re.findall(r"w & (0x[0-9A-Fa-f]+)u", _CVT4)]
_SELS = [int(m, 16) for m in re.findall(r"prmt\(r, kHigh, (0x[0-9a-f]+)\)",
                                        _CVT4)]


# ------------------------------------------------------------ conversion --

def prmt(a: np.ndarray, b, sel: int) -> np.ndarray:
    """PTX ``prmt.b32`` (default mode): result byte i is byte nibble_i of
    the eight bytes of b:a."""
    a = np.asarray(a, np.uint64)
    b = np.broadcast_to(np.asarray(b, np.uint64), a.shape)
    src = np.stack([(a >> np.uint64(8 * i)) & np.uint64(0xFF)
                    for i in range(4)]
                   + [(b >> np.uint64(8 * i)) & np.uint64(0xFF)
                      for i in range(4)], -1)
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[..., (sel >> (4 * i)) & 0xF] << np.uint64(8 * i)
    return out.astype(np.uint32)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    """The float value of bf16 bit patterns (uint16)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def cvt4(w: np.ndarray) -> np.ndarray:
    """``cvt4`` on words of four int8 codes: (..., 4) uint16 bf16 bits. The
    two prmt words of each pair are bf16x2 values, subtracted exactly (the
    difference is an integer of at most 8 bits, so the fp32 difference
    here is the bf16 one)."""
    r, s = w & np.uint32(_MASKS[0]), w & np.uint32(_MASKS[1])
    out = []
    for sel in _SELS:
        a, b = prmt(r, _HIGH, sel), prmt(s, _HIGH, sel)
        for half in (0, 16):
            va = _bf16_value((a >> half) & 0xFFFF)
            vb = _bf16_value((b >> half) & 0xFFFF)
            d = torch.from_numpy(va - vb).to(torch.bfloat16)
            out.append(d.view(torch.int16).numpy().view(np.uint16))
    return np.stack(out, -1)


def bf16_bits(q: np.ndarray) -> np.ndarray:
    """The bf16 bit pattern of each int8 code's value."""
    t = torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def test_cvt4_is_exact_for_every_code():
    """All 256 codes, in every byte position of a word: the bf16 of q."""
    assert len(_MASKS) == 2 and len(_SELS) == 2
    codes = np.arange(-128, 128, dtype=np.int8)
    for pos in range(4):
        words = np.zeros((256, 4), np.int8)
        words[:, pos] = codes
        words[:, (pos + 1) % 4] = codes[::-1]
        got = cvt4(words.view(np.uint32).reshape(-1))
        np.testing.assert_array_equal(got, bf16_bits(words))


def chunk_of(e, rows: int):
    """``chunk_of``: chunk e of a slot of 64-column boxes of ``rows`` rows
    -> (box, row, column chunk)."""
    ell = e & 31
    row = (e >> 5) * 8 + ((ell >> 3) ^ (((ell >> 2) & 1) * 5))
    return row // rows, row % rows, ell & 3


def sw128(addr):
    """The 128-byte swizzle of shared-memory byte addresses (1024-aligned
    atoms): 16-byte chunk j of 128-byte row i at chunk j ^ (i % 8)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def raw_bytes(q: np.ndarray, swizzled: bool) -> np.ndarray:
    """What TMA writes for an int8 box q (rows, cols): dense rows of cols
    bytes, or (cols == 128) the 128-byte swizzle."""
    rows, cols = q.shape
    out = np.zeros(rows * cols, np.uint8)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    addr = r * cols + c
    out[sw128(addr) if swizzled else addr] = q.view(np.uint8)
    return out


def convert_slot(raw: np.ndarray, rows: int, nbox: int, swizzled: bool,
                 threads: list, half: int = 0, loads=None, stores=None):
    """The conversion of a slot's raw chunks into bf16 boxes of 64 columns
    (``rows`` x 128 bytes each) as the kernels do it: chunk e to thread
    ``threads`` order (``e`` per thread, in issue order), K17's dense raw
    or K9's swizzled raw (``half`` the warpgroup's 64 of its 128 columns).
    Returns the bf16 bytes and how often each was written; ``loads`` and
    ``stores`` collect each instruction's (thread, address) pairs."""
    out = np.zeros(nbox * rows * 128, np.uint8)
    hits = np.zeros(out.size, np.int32)
    for instr in threads:
        ld, st0, st1 = [], [], []
        for t, e in instr:
            pb, k, c = chunk_of(e, rows)
            if swizzled:
                src = k * 128 + (((4 * half + c) ^ (k & 7)) << 4)
            else:
                src = pb * rows * 64 + k * 64 + 16 * c
            ld.append((t, src))
            codes = raw[src:src + 16].view(np.int8)
            bits = cvt4(codes.view(np.uint32)).reshape(-1).view(np.uint8)
            for j, st in ((2 * c, st0), (2 * c + 1, st1)):
                dst = pb * rows * 128 + k * 128 + ((j ^ (k & 7)) << 4)
                part = 16 * (j - 2 * c)
                out[dst:dst + 16] = bits[part:part + 16]
                hits[dst:dst + 16] += 1
                st.append((t, dst))
        for rec, lst in ((loads, ld), (stores, st0), (stores, st1)):
            if rec is not None:
                rec.append(lst)
    return out, hits


def b_desc_read(box: np.ndarray, n: int) -> np.ndarray:
    """The (k, n) bf16 values an MN-major B descriptor with the 128-byte
    swizzle reads from one 64-column box (SBO 1024, a k16 step 2048
    bytes), over every k16 slice of the box's rows."""
    rows = box.size // 128
    k = np.arange(rows)[:, None]
    c = np.arange(n)[None, :]
    kk, k16 = k // K16, k % K16
    addr = sw128(kk * 2048 + (k16 // 8) * 1024 + (k16 % 8) * 128 + 2 * c)
    return box.view(np.uint8)[addr[..., None] + np.arange(2)].copy().view(
        np.uint16)[..., 0]


def _phases_conflict_free(instrs) -> bool:
    """Every 8-thread phase of a 16-byte shared access instruction touches
    eight distinct 16-byte bank slots (address mod 128)."""
    for instr in instrs:
        by_t = dict(instr)
        for p0 in range(0, 32, 8):
            slots = [(by_t[t] % 128) // 16 for t in range(p0, p0 + 8)
                     if t in by_t]
            if len(slots) != len(set(slots)):
                return False
    return True


def _warp_instrs(chunks: int, lanes: int = 32, stride: int = 32,
                 first: int = 0):
    """Instructions of a warp converting chunks e = first + lane, + stride,
    ...: one (lane, e) list an iteration."""
    out = []
    for base in range(first, chunks, stride):
        out.append([(t, base + t) for t in range(lanes) if base + t < chunks])
    return out


@pytest.mark.parametrize("rows,nbox", [(64, 1), (32, 4), (16, 4), (32, 2)])
def test_k17_conversion_is_a_bijection_read_back_as_q(rows, nbox):
    """K17's slots (a W1 box of 64 rows, W2 stages of KS2 rows and one to
    four boxes): every bf16 byte written once, the B descriptor reads
    q[k, n] exactly, and no load or store phase has a bank conflict."""
    rng = np.random.default_rng(rows + nbox)
    q = rng.integers(-127, 128, (nbox, rows, 64), dtype=np.int8)
    raw = np.concatenate([raw_bytes(q[p], False) for p in range(nbox)])
    loads, stores = [], []
    out, hits = convert_slot(raw, rows, nbox, False,
                             _warp_instrs(nbox * rows * 4), 0, loads, stores)
    assert (hits == 1).all()
    for p in range(nbox):
        box = out[p * rows * 128:(p + 1) * rows * 128]
        np.testing.assert_array_equal(b_desc_read(box, 64), bf16_bits(q[p]))
    assert _phases_conflict_free(loads) and _phases_conflict_free(stores)


@pytest.mark.parametrize("half", [0, 1])
def test_k9_conversion_is_a_bijection_read_back_as_q(half):
    """K9's stage: a 64 x 128 raw box with the 128-byte swizzle, each
    consumer warpgroup converting its 64 columns (two chunks a thread)."""
    rng = np.random.default_rng(half)
    q = rng.integers(-127, 128, (64, 128), dtype=np.int8)
    raw = raw_bytes(q, True)
    instrs = []
    for j in range(2):  # the kernel's two chunks a thread, four warps
        for w in range(4):
            instrs.append([(t, 128 * j + 32 * w + t) for t in range(32)])
    loads, stores = [], []
    out, hits = convert_slot(raw, 64, 1, True, instrs, half, loads, stores)
    assert (hits == 1).all()
    np.testing.assert_array_equal(b_desc_read(out, 64),
                                  bf16_bits(q[:, 64 * half:64 * half + 64]))
    assert _phases_conflict_free(loads) and _phases_conflict_free(stores)


def test_chunk_order_is_a_bijection_and_pairs_rows_r_and_r_xor_5():
    for rows in (16, 32, 64):
        seen = {chunk_of(e, rows) for e in range(4 * rows * 4)}
        assert len(seen) == 4 * rows * 4
        for e0 in range(0, 4 * rows * 4, 8):
            ks = sorted({chunk_of(e, rows)[1] for e in range(e0, e0 + 8)})
            assert len(ks) == 2 and ks[0] ^ ks[1] == 5


# -------------------------------------------------------------- K17 walk --

def k17_cfg(d: int) -> dict:
    """``mqw::Cfg<T>`` for D = 128 T."""
    t = d // 128
    free = SMEM_MAX - 1024 - BAR_BYTES - (2 * t + 4) * BOX - 2 * BOX

    def w1_slots(nb, ks2):
        return (free - ks2 * 128 * 2 * nb - 2 * ks2 * 64 * 2 * nb) // 4096

    def pick(want):
        for nb, ks2 in ((3, 32), (3, 16), (2, 32), (2, 16), (1, 32),
                        (1, 16)):
            if w1_slots(nb, ks2) >= want:
                return nb, ks2
        return None

    c = {"T": t}
    c["NBmax"], c["KS2"] = pick(4) or pick(2)
    c["BP"] = min(t, 2 * c["NBmax"])
    c["NP"] = -(-t // c["BP"])
    c["NB"] = (c["BP"] + 1) // 2
    c["xn"] = d // 64 * BOX
    c["w1_off"] = c["xn"] + 4 * BOX
    c["w2_off"] = c["w1_off"] + 2 * BOX
    c["box2"] = c["KS2"] * 128
    c["stage2"] = c["box2"] * 2 * c["NBmax"]
    c["raw2"] = c["KS2"] * 64 * 2 * c["NBmax"]
    c["S1"] = min(w1_slots(c["NBmax"], c["KS2"]), MAX_S1)
    c["S2"] = 2
    c["smem"] = (c["w2_off"] + c["stage2"] + c["S1"] * 4096
                 + c["S2"] * c["raw2"] + BAR_BYTES + 1024)
    c["ldc"] = 64 * c["NB"] + 8
    return c


def pass_boxes(c: dict, q: int) -> int:
    return min(c["BP"], c["T"] - q * c["BP"])


def real_boxes(c: dict, q: int, wg: int) -> int:
    return max(0, min(c["NB"], pass_boxes(c, q) - wg * c["NB"]))


def walk(c: dict, nchunks: int) -> list:
    """``walk``: the slots in the consumers' order, (ring, pass, chunk,
    step)."""
    out, nkb, nks = [], c["T"] * 2, CT // c["KS2"]
    for q in range(c["NP"]):
        for ci in range(nchunks + 1):
            ks = 0
            if ci < nchunks:
                for kb in range(0, nkb, 2):
                    out += [(0, q, ci, kb), (0, q, ci, kb + 1)]
                    while ci >= 1 and kb >= 2 and ks < kb * nks // nkb:
                        out.append((1, q, ci - 1, ks))
                        ks += 1
            while ci >= 1 and ks < nks:
                out.append((1, q, ci - 1, ks))
                ks += 1
    return out


@pytest.mark.parametrize("d", [128, 384, 768, 1024, 1280])
@pytest.mark.parametrize("nchunks", [4, 24])
def test_k17_rings_follow_the_consumers_walk(d, nchunks):
    """Thread 0 fills each ring in item order (W1 item j: K-step j % NKB of
    chunk j / NKB; W2 item j: stage j % NKS of chunk j / NKS, over the
    passes): the walk's W1 and W2 items, taken apart, are those orders."""
    c = k17_cfg(d)
    nkb, nks = 2 * c["T"], CT // c["KS2"]
    items = walk(c, nchunks)
    w1 = [(q, ci, st) for r, q, ci, st in items if r == 0]
    w2 = [(q, ci, st) for r, q, ci, st in items if r == 1]
    assert w1 == [(j // nkb // nchunks, j // nkb % nchunks, j % nkb)
                  for j in range(c["NP"] * nchunks * nkb)]
    assert w2 == [(j // nks // nchunks, j // nks % nchunks, j % nks)
                  for j in range(c["NP"] * nchunks * nks)]


def k17_model(x, g, b, w1q, s1, b1, w2q, s2, b2, *, partial=False):
    """The tile's arithmetic on x (M, D): 64-row tiles, each block's two
    warpgroups over the pass's boxes, fc1 by 64-column chunk halves
    (scaled, biased, GELU, rounded), fc2 by chunk into the group's own
    sums p, ``acc + p * s2`` at each group's end, one cast."""
    m, d = x.shape
    mlp = w1q.shape[1]
    dt = x.dtype
    c = k17_cfg(d)
    f32 = torch.float32
    out = torch.empty_like(x)
    written = torch.zeros((m, d), dtype=torch.int32)
    for m0 in range(0, m, 64):
        rows = min(64, m - m0)
        xn = torch.zeros((64, d), dtype=dt)
        xn[:rows] = reference.layernorm(x[m0:m0 + rows], g, b, eps=EPS)
        for q in range(c["NP"]):
            parts = []
            for rank in range(2):
                for wg in range(2):
                    real = real_boxes(c, q, wg)
                    col0 = rank * d // 2 + 64 * (q * c["BP"] + c["NB"] * wg)
                    cols = slice(col0, col0 + 64 * real)
                    acc = torch.zeros((64, 64 * real), dtype=f32)
                    if not partial:
                        acc[:rows] = (x[m0:m0 + rows, cols].to(f32)
                                      + b2[cols].to(f32))
                    parts.append((cols, acc))
            p = [torch.zeros_like(a) for _, a in parts]
            for ci in range(mlp // CT):
                # h of the chunk: each block's 64 columns, rounded.
                hc = slice(ci * CT, ci * CT + CT)
                pre = xn.to(f32) @ w1q[:, hc].to(f32)
                h = reference.gelu(pre * s1[hc] + b1[hc].to(f32)).to(dt)
                for i, (cols, _) in enumerate(parts):
                    for kk in range(0, CT, K16):
                        p[i] += (h[:, kk:kk + K16].to(f32)
                                 @ w2q[ci * CT + kk:ci * CT + kk + K16,
                                       cols].to(f32))
                if ci % GROUP_CHUNKS == GROUP_CHUNKS - 1:
                    for i, (cols, acc) in enumerate(parts):
                        acc += p[i] * s2[cols]
                        p[i].zero_()
            for cols, acc in parts:
                out[m0:m0 + rows, cols] = acc[:rows].to(dt)
                written[m0:m0 + rows, cols] += 1
    assert (written == 1).all()
    return out


def _k17_inputs(rng, m, d, mlp, dtype):
    w1 = quantize_weight(torch.from_numpy(
        (0.03 * rng.standard_normal((d, mlp))).astype(np.float32)))
    w2 = quantize_weight(torch.from_numpy(
        (0.03 * rng.standard_normal((mlp, d))).astype(np.float32)))
    vec = [1.5 * rng.standard_normal((m, d)) + 0.2,
           1 + 0.1 * rng.standard_normal(d), 0.05 * rng.standard_normal(d),
           0.02 * rng.standard_normal(mlp), 0.02 * rng.standard_normal(d)]
    x, g, b, b1, b2 = (torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
                       for a in vec)
    return x, g, b, w1["q"], w1["scale"], b1, w2["q"], w2["scale"], b2


def _close(got, want, dtype) -> None:
    got = got.float()
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.from_numpy(np.asarray(jnp.asarray(want, jnp.float32))))
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got - want).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-5, diff.max()
    else:
        assert (diff <= 2e-2 * (1 + want.abs())).all(), diff.max()
        assert diff.mean() <= 3e-3, diff.mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,mlp,partial", [
    (64, 128, 512, False), (33, 384, 1024, False), (70, 1024, 512, False),
    (33, 384, 1024, True)])
def test_k17_walk_matches_reference(dtype, m, d, mlp, partial):
    """One to eight boxes a block, one or two passes (D = 1024: six boxes
    then two), one or two quant groups, ragged M, the partial form."""
    args = _k17_inputs(np.random.default_rng(m + d), m, d, mlp, dtype)
    got = k17_model(*args, partial=partial)
    want = reference.mlp_block_q(*args, partial_out=partial)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k17_walk_matches_pallas(dtype, monkeypatch):
    """Against JAX's Pallas ``mlp_block_q`` in interpret mode, its plan
    pinned to the port's 512-column group, at ragged M (40 rows)."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    args = _k17_inputs(np.random.default_rng(5), 40, 128, 1024, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = [jnp.asarray(a.float().numpy(), jnp.int8 if a.dtype == torch.int8
                     else jnp.float32 if a.dtype == torch.float32 and
                     i in (4, 7) else jdt) for i, a in enumerate(args)]
    want = jax_block.mlp_block_q(j[0][None], *j[1:], interpret=True)[0]
    _close(k17_model(*args), want, dtype)


def test_k17_rows_do_not_depend_on_m():
    args = _k17_inputs(np.random.default_rng(9), 70, 256, 512,
                       torch.bfloat16)
    whole = k17_model(*args)
    part = k17_model(args[0][:33], *args[1:])
    assert torch.equal(whole[:33], part)


@pytest.mark.parametrize("d", range(128, MLP_I8_MAX_D + 1, 128))
def test_k17_budgets_fit_every_admitted_width(d):
    """Every width ``ops.mlp_q_plan`` admits: shared memory under 227 KB
    with two raw W1 slots at least (a fc1 pair) and two raw W2 slots, the
    barriers in their bytes, every region 1024-byte aligned, the passes
    covering the block's boxes once, three boxes a warpgroup at most (acc
    and p, 192 sums a thread beside fc1's 16, inside the 255 registers of a
    256-thread block), one pass and eight W1 slots at B/16's D = 768, and
    the output staging inside the LN(x) region."""
    assert ops.mlp_q_plan(d, 4 * d)
    c = k17_cfg(d)
    assert c["smem"] <= SMEM_MAX
    assert c["S1"] >= 2 and c["S2"] == 2
    assert (2 * c["S1"] + 2 * c["S2"] + 4) * 8 <= BAR_BYTES
    for off in (c["xn"], c["w1_off"], c["w2_off"], c["box2"], c["raw2"]):
        assert off % 1024 == 0
    assert sum(pass_boxes(c, q) for q in range(c["NP"])) == c["T"]
    assert c["NB"] <= 3 and 2 * 32 * c["NB"] + 16 <= 255 - 40
    assert K17_THREADS == 256
    if d == 768:
        assert c["NP"] == 1 and c["NB"] == 3 and c["S1"] == 8
    staging = 64 * (c["ldc"] + 64 * real_boxes(c, c["NP"] - 1, 1) + 8) * 2
    assert staging <= c["xn"]


class _Barrier:
    """An mbarrier: ``count`` arrivals and the expected bytes complete a
    phase; a wait on parity p passes once the phase of parity p is done
    (a fresh barrier passes a wait on parity 1)."""

    def __init__(self, count: int):
        self.count, self.pending, self.tx, self.phases = count, count, 0, 0

    def arrive(self, n: int = 1, tx: int = 0):
        self.pending -= n
        self.tx += tx
        assert self.pending >= 0, "more arrivals than the phase takes"
        if self.pending == 0 and self.tx == 0:
            self.phases += 1
            self.pending = self.count

    def complete_tx(self, n: int):
        self.tx -= n
        self.arrive(0)

    def passed(self, parity: int) -> bool:
        return self.phases % 2 != parity


def _wait(bar: _Barrier, parity: int):
    while not bar.passed(parity):
        yield


def _k17_protocol(d: int, nchunks: int, seed: int) -> None:
    """``mlp_q_bf16_wgmma``'s barriers under a seeded random interleaving
    of both blocks' two warpgroups, each warpgroup's leader filling one raw
    ring (W1, W2) inside its warpgroup's walk. Every raw slot and h slice carries
    the tag of what was last written into it, checked where it is read and
    again where it is released; a state where no agent can move is a
    deadlock."""
    c = k17_cfg(d)
    items = walk(c, nchunks)
    nkb, nks = 2 * c["T"], CT // c["KS2"]

    def tag(it):
        ring, q, ci, step = it
        return (ring, q * nchunks + ci, step)

    w1 = [it for it in items if it[0] == 0]
    w2 = [it for it in items if it[0] == 1]
    sizes = (c["S1"], c["S2"])
    blocks = [{"f": [[_Barrier(1) for _ in range(n)] for n in sizes],
               "e": [[_Barrier(2) for _ in range(n)] for n in sizes],
               "hfull": [_Barrier(256 + 1) for _ in range(2)],
               "hempty": [_Barrier(4) for _ in range(2)],
               "raw": [[None] * n for n in sizes], "h": [{}, {}],
               "bar": [0, 0], "np": [0, 0], "inflight": []}
              for _ in range(2)]

    def issue(blk, ring, wait):
        # One item of ``ring`` into its slot once both warpgroups have
        # released the slot's previous item; without ``wait``, only if
        # they already have.
        seq, n_s = (w1, w2)[ring], sizes[ring]
        n = blk["np"][ring]
        bar = blk["e"][ring][n % n_s]
        if not wait and not bar.passed((n // n_s) % 2 ^ 1):
            return False
        yield from _wait(bar, (n // n_s) % 2 ^ 1)
        blk["raw"][ring][n % n_s] = tag(seq[n])
        blk["f"][ring][n % n_s].arrive(tx=1)
        blk["inflight"].append((ring, n % n_s))
        blk["np"][ring] += 1
        return True

    def land(blk):
        # The TMA engine: copies in flight complete in any order.
        rng_l = np.random.default_rng(seed + 7)
        while True:
            if blk["inflight"]:
                ring, s_ = blk["inflight"].pop(
                    rng_l.integers(len(blk["inflight"])))
                blk["f"][ring][s_].complete_tx(1)
            yield

    def consumer(rank, wg):
        blk, peer = blocks[rank], blocks[rank ^ 1]
        whole = {(r, w) for r in range(2) for w in range(2)}
        st = {"taken": [0, 0], "released": [0, 0]}

        def take(want):
            ring = want[0]
            n = st["taken"][ring]
            # Warpgroup wg's leader produces ring wg: every item whose slot
            # is free, then the one it takes now, waiting for its slot.
            seq = (w1, w2)[wg]
            while (blk["np"][wg] < len(seq) and blk["np"][wg]
                   < st["released"][wg] + sizes[wg]):
                if not (yield from issue(blk, wg, False)):
                    break
            while ring == wg and blk["np"][wg] <= n:
                yield from issue(blk, wg, True)
            yield from _wait(blk["f"][ring][n % sizes[ring]],
                             (n // sizes[ring]) % 2)
            assert blk["raw"][ring][n % sizes[ring]] == tag(want)
            st["taken"][ring] += 1

        def release():
            for ring in range(2):
                for n in range(st["released"][ring], st["taken"][ring]):
                    blk["e"][ring][n % sizes[ring]].arrive()
                st["released"][ring] = st["taken"][ring]

        for q in range(c["NP"]):
            for ci in range(nchunks + 1):
                g = q * nchunks + ci
                hb2 = (g - 1) % 2
                groups, ks = [], 0
                if ci < nchunks:
                    for kb in range(0, nkb, 2):
                        groups.append([(0, q, ci, kb), (0, q, ci, kb + 1)])
                        while ci >= 1 and kb >= 2 and ks < kb * nks // nkb:
                            groups.append([(1, q, ci - 1, ks)])
                            ks += 1
                while ci >= 1 and ks < nks:
                    groups.append([(1, q, ci - 1, ks)])
                    ks += 1
                for group in groups:
                    if group[0][0] == 1 and group[0][3] == 0:
                        yield from _wait(blk["hfull"][hb2], (g - 1) // 2 % 2)
                        assert set(blk["h"][hb2]) == whole and set(
                            blk["h"][hb2].values()) == {g - 1}
                    for want in group:
                        yield from take(want)
                    yield  # the warpgroup converts
                    release()
                    yield  # the wgmma group runs
                if ci >= 1:
                    assert set(blk["h"][hb2].values()) == {g - 1}
                    for other in blocks:
                        other["hempty"][hb2].arrive()
                if ci < nchunks:
                    hb = g % 2
                    if g >= 2:
                        yield from _wait(blk["hempty"][hb], (g - 2) // 2 % 2)
                    blk["h"][hb][rank, wg] = g
                    blk["hfull"][hb].arrive(128)
                    # The block barrier of the 256 threads.
                    gen = blk["bar"][wg]
                    blk["bar"][wg] += 1
                    while blk["bar"][wg ^ 1] <= gen:
                        yield
                    if wg == 0:
                        # Thread 0 copies the block's half to the peer.
                        peer["hfull"][hb].arrive(tx=1)
                        yield
                        for w in range(2):
                            assert blk["h"][hb][rank, w] == g
                            peer["h"][hb][rank, w] = g
                        peer["hfull"][hb].complete_tx(1)
        assert st["taken"] == [len(w1), len(w2)]

    agents = [consumer(r, wg) for r in range(2) for wg in range(2)]
    engines = [land(blk) for blk in blocks]
    rng = np.random.default_rng(seed)
    idle = 0
    while agents:
        a = (agents + engines)[rng.integers(len(agents) + len(engines))]
        try:
            next(a)
            idle += 1
        except StopIteration:
            agents.remove(a)
            idle = 0
        assert idle < 20000 * (len(agents) + 1), "deadlock"


@pytest.mark.parametrize("d", [128, 384, 768, 1024, 1280])
@pytest.mark.parametrize("nchunks", [4, 8])
def test_k17_protocol_has_no_deadlock_or_reuse(d, nchunks):
    """One and two quant groups (B/16's mlp takes 24 chunks: the same
    steady state), at one to five boxes a block and one to three passes,
    in two interleavings each."""
    for seed in range(2):
        _k17_protocol(d, nchunks, seed)


# ---------------------------------------------------------- K9's phases --

def k9_geo(m: int, n: int, k: int, split: bool, grid: int = 132) -> dict:
    """``sw::Geo``: tiles and the split of K."""
    g = {"nk": k // K9_BK, "tm": -(-m // K9_BM), "tn": -(-n // K9_BN)}
    s = max(1, grid // (g["tm"] * g["tn"])) if split else 1
    g["splits"] = min(s, K9_SPLITS, g["nk"])
    g["items"] = g["tm"] * g["tn"] * g["splits"]
    return g


def k9_items(g: dict):
    """Item i -> (row tile, column tile, slice, K steps [lo, hi))."""
    for i in range(g["items"]):
        rt, ns = i % g["tm"], i // g["tm"]
        s, nt = ns % g["splits"], ns // g["splits"]
        yield (rt, nt, s, s * g["nk"] // g["splits"],
               (s + 1) * g["nk"] // g["splits"])


@pytest.mark.parametrize("m,d,mlp,want", [
    (208, 768, 3072, (72, 120, 96, 120)), (416, 768, 3072, (126, 126, 168,
                                                            126)),
    (208, 1024, 4096, (96, 128, 128, 128))])
def test_k9_items_cover_every_step_once(m, d, mlp, want):
    """B/16 at bs = 1 and 2 and L/16 at bs = 1 on 132 blocks: the items of
    the QKV, out-projection, fc1 and fc2 (split 5, 3 and 4 ways), and each
    (row tile, column tile, K step) of each phase in exactly one item."""
    phases = ((3 * d, d, False), (d, d, True), (mlp, d, False),
              (d, mlp, True))
    for (n, k, split), items in zip(phases, want):
        g = k9_geo(m, n, k, split)
        assert g["items"] == items
        assert g["splits"] <= MAX_SPLITS == K9_SPLITS
        seen = {}
        for rt, nt, s, lo, hi in k9_items(g):
            assert hi > lo
            for kb in range(lo, hi):
                seen[rt, nt, kb] = seen.get((rt, nt, kb), 0) + 1
        assert len(seen) == g["tm"] * g["tn"] * g["nk"]
        assert set(seen.values()) == {1}


def _split_matmul(a, w, split: bool, grid: int):
    """x @ w as the phase sums it: each item's slice of K in fp32 over
    k16 steps in order; the slices added in ascending order."""
    m, k = a.shape
    g = k9_geo(m, w.shape[1], k, split, grid)
    parts = []
    for s in range(g["splits"]):
        lo, hi = s * g["nk"] // g["splits"], (s + 1) * g["nk"] // g["splits"]
        acc = torch.zeros((m, w.shape[1]), dtype=torch.float32)
        for kk in range(lo * K9_BK, hi * K9_BK, K16):
            acc += a[:, kk:kk + K16].float() @ w[kk:kk + K16].float()
        parts.append(acc)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


K9_GRID = 132  # one persistent block an SM at K9's 227 KB
K9_WARPS = 8  # K9's 256 threads
ATTN_CHUNK = 64  # keys a chunk of the core's two passes


def k9_attn_parts(b: int, heads: int, sp: int, grid: int = K9_GRID) -> int:
    """``attention_phase``'s key parts: ``kStackAttnParts`` where its
    tiles (16 rows a row warp, 8 / parts row warps) fit the grid in one
    round, else half as many."""
    qt = 16 * (K9_WARPS // K9_ATTN_PARTS)
    return K9_ATTN_PARTS if b * heads * -(-sp // qt) <= grid \
        else K9_ATTN_PARTS // 2


def k9_attention_tiles(b: int, heads: int, sp: int, grid: int = K9_GRID):
    """``attention_tiles_mma``'s walk at :func:`k9_attn_parts` parts:
    (parts, block -> its tiles (image, head, first row, rows)); block i
    takes tiles i, i + grid, ..."""
    parts = k9_attn_parts(b, heads, sp, grid)
    qt = 16 * (K9_WARPS // parts)
    q_tiles = -(-sp // qt)
    tiles = b * heads * q_tiles
    return parts, {i: [(t // (heads * q_tiles), t // q_tiles % heads,
                        t % q_tiles * qt, qt)
                       for t in range(i, tiles, grid)]
                   for i in range(grid)}


def k9_key_parts(seq_len: int, parts: int) -> list:
    """The keys [kb, ke) of each part in ``attention_tile_mma``: part j of
    kend / 16 steps of 16 keys takes steps j * steps / parts .. (j + 1) *
    steps / parts (integer division)."""
    steps = -(-seq_len // 16)
    return [(16 * (j * steps // parts), 16 * ((j + 1) * steps // parts))
            for j in range(parts)]


def mma_core_rows(qkv, img, h, q0, rows, *, sp, d, dh, scale, seq_len,
                  parts=1):
    """``attention_tile_mma`` on rows q0 .. q0 + rows - 1 (those below sp)
    of head h of image img of the packed bf16 (b*sp, 3d) qkv, the keys in
    ``parts`` parts (:func:`k9_key_parts`): s = (q . k) * scale in fp32,
    keys >= seq_len at -inf, the row max over all keys; then in each part,
    per 64-key chunk and 16-key group, p = exp(s - max), each lane's share
    of l (keys 8j + 2t, + 1 of lane t of a quad) in order, the context +=
    (p in bf16) @ v in fp32; a part's l = (l0 + l1) + (l2 + l3) across the
    quad; l and the context summed over the parts in order; the context / l
    rounded to bf16."""
    r1 = min(q0 + rows, sp)
    base = img * sp
    q = qkv[base + q0:base + r1, h * dh:(h + 1) * dh].float()
    k = qkv[base:base + seq_len, d + h * dh:d + (h + 1) * dh].float()
    v = qkv[base:base + seq_len, 2 * d + h * dh:2 * d + (h + 1) * dh].float()
    kend = -(-seq_len // 16) * 16
    k = torch.nn.functional.pad(k, (0, 0, 0, kend - seq_len))
    v = torch.nn.functional.pad(v, (0, 0, 0, kend - seq_len))
    s = (q @ k.t()) * scale
    s[:, seq_len:] = float("-inf")
    mx = s.amax(-1, keepdim=True)
    l = torch.zeros(r1 - q0)
    ctx = torch.zeros((r1 - q0, dh))
    for kb, ke in k9_key_parts(seq_len, parts):
        lanes = torch.zeros((r1 - q0, 4))
        part = torch.zeros((r1 - q0, dh))
        for k0 in range(kb, ke, ATTN_CHUNK):
            for g0 in range(k0, min(k0 + ATTN_CHUNK, ke), 16):
                p = torch.exp(s[:, g0:g0 + 16] - mx)
                for j in range(2):
                    for e in range(2):
                        for t in range(4):
                            lanes[:, t] += p[:, 8 * j + 2 * t + e]
                part += p.to(torch.bfloat16).float() @ v[g0:g0 + 16]
        l += (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
        ctx += part
    return (ctx / l[:, None]).to(torch.bfloat16)


def k9_attention(qkv, *, batch, num_heads, scale, seq_len, grid=K9_GRID):
    """K9's bf16 attention phase on the packed (b*sp, 3d) qkv: every tile
    of :func:`k9_attention_tiles` through :func:`mma_core_rows` with the
    keys in :func:`k9_attn_parts` parts, each context row written once;
    returns (b*sp, d)."""
    m, d = qkv.shape[0], qkv.shape[1] // 3
    sp, dh = m // batch, d // num_heads
    out = torch.empty((m, d), dtype=torch.bfloat16)
    written = torch.zeros((m, num_heads), dtype=torch.int32)
    parts, walk = k9_attention_tiles(batch, num_heads, sp, grid)
    for tiles in walk.values():
        for img, h, q0, rows in tiles:
            r1 = min(q0 + rows, sp)
            out[img * sp + q0:img * sp + r1, h * dh:(h + 1) * dh] = \
                mma_core_rows(qkv, img, h, q0, rows, sp=sp, d=d, dh=dh,
                              scale=scale, seq_len=seq_len, parts=parts)
            written[img * sp + q0:img * sp + r1, h] += 1
    assert (written == 1).all()
    return out


def k9_model(x, enc, *, num_heads, scale, seq_len, grid=132, quantized=False):
    """K9's layer loop with its phases as modelled: LN rounded to the
    dtype before the products, the out-projection and fc2 split over K,
    the epilogues of ``encoder_stack.cu`` (scale before bias); in bf16 the
    attention phase of :func:`k9_attention`, in fp32 the FFMA tile's
    function, ``reference.attention_core``."""
    b, sp, d = x.shape
    dt = x.dtype
    xf = x.reshape(b * sp, d)

    def w(name, i):
        k = enc[name]["kernel"]
        if quantized:
            return k["q"][i], k["scale"][i], enc[name]["bias"][i]
        return k[i], None, enc[name]["bias"][i]

    def scaled(acc, s, bias):
        y = acc * s if s is not None else acc
        return y + bias.float()

    for i in range(enc["qkv"]["bias"].shape[0]):
        wq, sq, bq = w("qkv", i)
        xn = reference.layernorm(xf, enc["ln1"]["scale"][i],
                                 enc["ln1"]["bias"][i], eps=EPS)
        qkv = scaled(_split_matmul(xn, wq, False, grid), sq, bq).to(dt)
        if dt == torch.bfloat16:
            ctx = k9_attention(qkv, batch=b, num_heads=num_heads,
                               scale=scale, seq_len=seq_len, grid=grid)
        else:
            ctx = reference.attention_core(qkv, batch=b, num_heads=num_heads,
                                           scale=scale, seq_len=seq_len)
        wo, so, bo = w("out", i)
        xf = (scaled(_split_matmul(ctx, wo, True, grid), so, bo)
              + xf.float()).to(dt)
        w1, s1, b1 = w("fc1", i)
        xn = reference.layernorm(xf, enc["ln2"]["scale"][i],
                                 enc["ln2"]["bias"][i], eps=EPS)
        h = reference.gelu(scaled(_split_matmul(xn, w1, False, grid), s1,
                                  b1)).to(dt)
        w2, s2, b2 = w("fc2", i)
        y = _split_matmul(h, w2, True, grid)
        y = y * s2 if s2 is not None else y
        xf = ((xf.float() + b2.float()) + y).to(dt)
    return xf.reshape(b, sp, d)


def _k9_inputs(dtype, b, *, d=128, mlp=256, layers=2, sp=32, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, std, mean=0.0):
        a = mean + std * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    enc = {"ln1": {"scale": t(layers, d, std=0.1, mean=1.0),
                   "bias": t(layers, d, std=0.05)},
           "qkv": {"kernel": t(layers, d, 3 * d, std=0.06),
                   "bias": t(layers, 3 * d, std=0.02)},
           "out": {"kernel": t(layers, d, d, std=0.06),
                   "bias": t(layers, d, std=0.02)},
           "ln2": {"scale": t(layers, d, std=0.1, mean=1.0),
                   "bias": t(layers, d, std=0.05)},
           "fc1": {"kernel": t(layers, d, mlp, std=0.06),
                   "bias": t(layers, mlp, std=0.02)},
           "fc2": {"kernel": t(layers, mlp, d, std=0.04),
                   "bias": t(layers, d, std=0.02)}}
    x = t(b, sp, d, std=1.0)
    x[:, 17:] = 0
    return enc, x


def _close_model(got, want, dtype) -> None:
    got = got.float()
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.from_numpy(np.asarray(jnp.asarray(want, jnp.float32))))
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got - want).abs()
    if dtype == torch.float32:
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert (diff <= 5e-2 * (1 + want.abs())).all(), diff.max()
        assert diff.mean() <= 1e-2, diff.mean()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,grid", [(1, 132), (2, 132), (3, 7), (3, 5)])
def test_k9_phases_match_reference(dtype, b, grid):
    """Two layers at D = 128, mlp 256, 17 real tokens of 32, against
    ``reference.encoder_stack``: split 2 and 4 ways at b = 1, 2 on 132
    blocks, 2 and 4 ways on 7 blocks at b = 3 (two row tiles); on 5 blocks
    the attention's six 32-row tiles would take two rounds, so it runs
    three 64-row tiles in two key parts."""
    enc, x = _k9_inputs(dtype, b)
    kw = dict(num_heads=2, scale=64 ** -0.5, seq_len=17)
    _close_model(k9_model(x, enc, grid=grid, **kw),
                 reference.encoder_stack(x, enc, eps=EPS, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_phases_match_pallas(dtype):
    """The float stack against JAX's Pallas ``encoder_stack`` (interpret
    mode) and the int8 one against ``encoder_stack_q``, b = 1; in bf16 the
    attention phase in the tensor-core core's order (:func:`k9_attention`),
    within the bf16 model bar."""
    enc, x = _k9_inputs(dtype, 1, seed=3)
    kw = dict(num_heads=2, scale=64 ** -0.5, seq_len=17)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def jx(t):
        if t.dtype == torch.int8:
            return jnp.asarray(t.numpy(), jnp.int8)
        if t.dtype == torch.float32 and dtype != torch.float32:
            return jnp.asarray(t.numpy(), jnp.float32)
        return jnp.asarray(t.float().numpy(), jdt)

    def tree(e):
        if isinstance(e, dict):
            return {k: tree(v) for k, v in e.items()}
        return jx(e)

    want = jax_ops.encoder_stack(jx(x), tree(enc), impl="pallas", eps=EPS,
                                 **kw)
    _close_model(k9_model(x, enc, **kw), want, dtype)
    qenc = quantize_params({"encoder": enc})["encoder"]
    want = jax_block.encoder_stack_q(jx(x), tree(qenc), interpret=True,
                                     eps=EPS, **kw)
    got = k9_model(x, qenc, quantized=True, **kw)
    _close_model(got[:, :17], np.asarray(want)[:, :17], dtype)
    _close_model(got, reference.encoder_stack_q(x, qenc, eps=EPS, **kw),
                 dtype)


def test_k9_split_sum_is_the_fixed_order():
    """The reduction adds slices 0, 1, ... in that order: its result is
    the left fold of the slices, whatever the grid's block order."""
    torch.manual_seed(0)
    a = torch.randn(64, 512)
    w = torch.randn(512, 128)
    g = k9_geo(64, 128, 512, True, grid=5)
    assert g["splits"] == 5
    first = _split_matmul(a, w, True, 5)
    assert torch.equal(first, _split_matmul(a, w, True, 5))
    assert (first - a @ w).abs().max() <= 1e-3


@pytest.mark.parametrize("i8", [False, True])
def test_k9_budgets_fit(i8):
    """``sw::Layout``: the int8 conversion buffer and the ring fit the
    kernel's 227 KB whatever D is (LN(x) goes through the context buffer):
    9 stages of the A box and two bf16 weight boxes, or 12 of the A box
    and a raw int8 box; every stage 1024-byte aligned."""
    ring = 2 * BOX if i8 else 0
    stage = BOX + (BOX if i8 else 2 * BOX)
    stages = min(K9_STAGES, (SMEM_MAX - 1024 - K9_BAR - ring) // stage)
    assert stages == (12 if i8 else 9)
    assert ring % 1024 == 0 and stage % 1024 == 0
    assert ring + stages * stage + K9_BAR + 1024 <= SMEM_MAX


@pytest.mark.parametrize("heads,b", [(12, 1), (12, 2), (16, 1), (16, 2)])
@pytest.mark.parametrize("seq_len", [197, 50])
def test_k9_attention_tiles_cover_every_row_once(heads, b, seq_len):
    """B/16 (12 heads) and L/16 (16 heads) at 208 tokens, b = 1 and 2, on
    132 blocks: four key parts on 32-row tiles at b = 1 (84 and 112
    tiles), two on 64-row tiles at b = 2 (96 and 128), one round each;
    every (image, head, query row) in exactly one tile; the tiles on the
    grid's first blocks, one a block; each tile's key parts cover [0,
    kend) once, in whole 16-key steps, every part with keys, so that all
    eight warps of a busy block work (at seq_len 50 one or two steps a
    part)."""
    sp = 208
    parts, walk = k9_attention_tiles(b, heads, sp)
    assert parts == (K9_ATTN_PARTS if b == 1 else K9_ATTN_PARTS // 2)
    seen = {}
    for i, tiles in walk.items():
        assert len(tiles) <= 1
        for img, h, q0, rows in tiles:
            assert rows == 16 * (K9_WARPS // parts)
            for r in range(q0, min(q0 + rows, sp)):
                seen[img, h, r] = seen.get((img, h, r), 0) + 1
    assert len(seen) == b * heads * sp and set(seen.values()) == {1}
    tiles = b * heads * -(-sp // (16 * (K9_WARPS // parts)))
    assert tiles == {(12, 1): 84, (12, 2): 96, (16, 1): 112,
                     (16, 2): 128}[heads, b]
    busy = [i for i, t in walk.items() if t]
    assert busy == list(range(tiles))
    keys = k9_key_parts(seq_len, parts)
    kend = -(-seq_len // 16) * 16
    assert keys[0][0] == 0 and keys[-1][1] == kend
    for (kb, ke), (nb, _) in zip(keys, keys[1:] + [(kend, None)]):
        assert ke == nb and kb % 16 == 0 and ke > kb


def k9_attention_bytes(sp: int, dh: int, parts: int = K9_ATTN_PARTS) -> int:
    """``stack_attn_smem``: K and V (``attention_mma_smem``), then the
    parts' exchange at ``kStackAttnParts`` parts (at half as many it is
    smaller) (``attn_mma_xbytes``: one fp32 slot a lane for each
    warp's two row maxima, and for each warp of parts 1 .. P-1 two row sums
    and 8 NK context values, NK = ``attn_mma_nk_of(dh)``)."""
    steps = -(-dh // 16)
    nk = 2 if steps <= 2 else 4 if steps <= 4 else 8
    others = K9_WARPS // parts * (parts - 1)
    x = 4 * 32 * (2 * K9_WARPS + others * (2 + 8 * nk)) if parts > 1 else 0
    return attention_mma_smem_bytes(sp, dh) + x


def _stack_geometries():
    """Every (sp, d, heads) the stack gates admit in bf16 (``ops.
    stack_plan``, which ``stack_q_plan`` and ``stack_fused_plan`` narrow):
    D = 768 (MLP 3072) with any head count that divides it, at every sp
    ``attn_plan`` takes, and L/16 at 208 tokens."""
    bf = torch.bfloat16
    out = [(208, 1024, 16)] if ops.stack_plan(1, 208, 1024, 4096, 16, bf) \
        else []
    for heads in (h for h in range(1, 769) if 768 % h == 0):
        for sp in range(1, 1025):
            if ops.stack_plan(1, sp, 768, 3072, heads, bf):
                out.append((sp, 768, heads))
    return out


def test_k9_attention_regions_fit_every_admitted_geometry():
    """At every geometry the gates admit, the tensor-core core takes the
    head in K9 (K and V and the key parts' exchange,
    :func:`k9_attention_bytes`, fit the block's 227 KB) wherever the FFMA
    tile's budget, which the gates read, admits it. At B/16 and L/16's 208
    tokens the phase's bytes end before the bf16 ring's barriers
    (``Layout<bf16>::kBars`` past the 1024-aligned base); past them the
    barriers would be overwritten, and ``wgmma_phase`` sets its barriers up
    at its start and invalidates them at its end, so the attention phase
    may take every byte."""
    geos = _stack_geometries()
    assert (208, 768, 12) in geos and (208, 1024, 16) in geos
    assert len({sp for sp, d, h in geos if h == 12}) > 400
    for sp, d, heads in geos:
        hd = d // heads
        assert attention_smem_bytes(sp, hd, 2) <= MAX_SMEM
        assert k9_attention_bytes(sp, hd) <= MAX_SMEM, (sp, d, heads)
        assert (k9_attention_bytes(sp, hd, K9_ATTN_PARTS // 2)
                <= k9_attention_bytes(sp, hd))
    stage = 3 * BOX
    stages = min(K9_STAGES, (SMEM_MAX - 1024 - K9_BAR) // stage)
    bars = stages * stage
    assert k9_attention_bytes(208, 64) == 59904 + 28160
    assert k9_attention_bytes(208, 64) <= bars
    # The kernel's own budget is the one modelled here.
    assert ("return attention_mma_smem(sp, dh) +\n"
            "         attn_mma_xbytes(kMmThreads / 32, kStackAttnParts,\n"
            "                         attn_mma_nk_of(dh));") in K9_CU
    assert "stack_attn_smem(sp, dh) > kStackMaxSmem" in K9_CU
    assert ("const int others = warps / parts * (parts - 1);\n"
            "  return 4 * 32 * (2 * static_cast<size_t>(warps) +\n"
            "                   static_cast<size_t>(others) * (2 + 8 * nk));"
            ) in ATTN_MMA
    assert "return steps <= 2 ? 2 : steps <= 4 ? 4 : 8;" in ATTN_MMA
    phase = re.search(r"void wgmma_phase\(.*?\n}\n", K9, re.S).group(0)
    init, inval = phase.find("mbar_init(full0"), phase.find("mbarrier.inval")
    first_tma = phase.find("tma_load(")
    assert 0 < init < first_tma < inval

