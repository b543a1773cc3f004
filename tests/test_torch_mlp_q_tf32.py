"""K17's fp32 form on the tensor cores (``csrc/mlp_tf32.cuh`` with its Q
flag, launched by ``csrc/mlp_block_q_tf32.cu``) modelled on the CPU:

- the int8 codes: every one of the 256 is exact in fp32 and in TF32 (so the
  weights, wgmma's A operand, need no split: its lo part is zero), and the
  kernel's conversion (``codes_f32``: the byte, sign flipped, put into the
  mantissa of 2^23 by ``prmt``, then 2^23 + 128 subtracted) gives it;
- the sums in PyTorch (each product as its two TF32 passes, a B_lo + a B_hi,
  over K = D in one accumulator up to D = 1024 and in accumulators of
  K = 128 past it; fc1's sums times s1, then b1 and the erf GELU in fp32, h
  unrounded; each 128-column chunk's fc2 sums times s2 added to the totals
  in order) against ``reference.mlp_block_q`` and JAX's Pallas
  ``mlp_block_q`` in interpret mode at the fp32 bar, whole and partial;
- the int8 weight box byte for byte (TMA's 128-byte swizzle, ``load_wq``'s
  2-byte loads and the bank wavefronts each takes), and one step through
  the maps equal to the transposed product; the other place to convert,
  ``tools/mlp_tf32_ablate.py``'s ``q_box`` variant (the helper warps into
  an fp32 box), likewise;
- the order of the scaling (per chunk, in order) against the plain
  version's per-group order;
- ``mlp_q_f32_form`` and every geometry ``ops.mlp_q_plan`` admits fitting
  the tile's shared memory and registers;
- the ablation tool's K17 variants edit the path the tile runs.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mlp_tf32 import FORMS, perm8, sw, tile_for, wavefronts
from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu_torch import ops
from vit_tpu_torch.config import VARIANTS
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda import quant as cuda_quant
from vit_tpu_torch.ops.cuda.block import MAX_SMEM
from vit_tpu_torch.quant import quantize_weight
from vit_tpu_torch.tools.tf32_probe import split, tf32, truncate

BAR = 1e-4
CT = 128  # hidden columns a chunk
CSRC = Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"


# ------------------------------------------------------------ the codes --

def codes_f32(byte: int) -> float:
    """``mlp_tf32.cuh:codes_f32`` on one code's byte (0-255): flip its sign
    bit, put it into the low byte of 2^23's bits (``prmt`` with 0x4B000000),
    subtract 2^23 + 128 in fp32."""
    bits = np.array([0x4B000000 | (byte ^ 0x80)], np.uint32)
    return float(bits.view(np.float32)[0] - np.float32(8388736.0))


def test_every_code_is_exact_in_tf32_and_needs_no_split():
    q = torch.arange(-128, 128, dtype=torch.int8)
    f = q.float()
    assert torch.equal(f.long(), q.long())
    assert torch.equal(tf32(f), f) and torch.equal(truncate(f), f)
    hi, lo = split(f)
    assert torch.equal(hi, f) and not lo.any()
    # The kernel's conversion, on each code's byte as it lies in the box.
    for code in range(-128, 128):
        assert codes_f32(code & 0xFF) == float(code)


# ------------------------------------------------------------- the sums --

def mm_q2(a: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``a @ codes`` as the tile's two passes take it: ``a`` (fp32) split as
    ``tools/tf32_probe.py`` splits it, the codes exact; a B_lo first, then
    a B_hi, into one fp32 accumulator."""
    hi, lo = split(a)
    c = codes.float()
    return torch.matmul(lo, c) + torch.matmul(hi, c)


def k17_tf32_model(x, g, b, w1q, s1, b1, w2q, s2, b2, *, eps=1e-12,
                   partial=False):
    """The tile's arithmetic on (M, D) fp32 rows (``mlp_tf32.cuh``'s Q
    walk): LN(x) in fp32 from two-pass statistics; per 128-column hidden
    chunk, fc1 over K = D in one accumulator up to D = 1024 (the forms of
    G <= 8 groups), past it in accumulators of K = 128 added in order; h =
    gelu(sums * s1 + b1) unrounded; fc2 over the chunk (K = 128) in one
    accumulator, times s2, added to the totals, which start at x + b2
    (zero for the partial form)."""
    x, g, b, s1, b1, s2, b2 = (t.float() for t in (x, g, b, s1, b1, s2, b2))
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    xn = (x - mean) * rstd * g + b
    d, mlp = w1q.shape
    step = CT if tile_for(d)[1] > 8 else d
    tot = torch.zeros_like(x) if partial else x + b2
    for c0 in range(0, mlp, CT):
        hacc = None
        for k0 in range(0, d, step):
            part = mm_q2(xn[:, k0:k0 + step], w1q[k0:k0 + step, c0:c0 + CT])
            hacc = part if hacc is None else hacc + part
        h = reference.gelu(hacc * s1[c0:c0 + CT] + b1[c0:c0 + CT])
        tot = tot + mm_q2(h, w2q[c0:c0 + CT]) * s2
    return tot


def _inputs(seed, m, d, mlp):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    w1 = quantize_weight(t(0.03 * rng.standard_normal((d, mlp))))
    w2 = quantize_weight(t(0.03 * rng.standard_normal((mlp, d))))
    return (t(1.5 * rng.standard_normal((m, d)) + 0.2),
            t(1 + 0.1 * rng.standard_normal(d)),
            t(0.05 * rng.standard_normal(d)), w1["q"], w1["scale"],
            t(0.02 * rng.standard_normal(mlp)), w2["q"], w2["scale"],
            t(0.02 * rng.standard_normal(d)))


@pytest.mark.parametrize("m,d,mlp,partial", [
    (37, 128, 512, False),     # ragged M, one quant group
    (70, 256, 1024, True),     # the partial form, two groups
    (33, 768, 512, False),     # B/16's width, one accumulator over K = 768
    (24, 1280, 512, False),    # H/14's width: fc1 in K = 128 parts
    (40, 768, 1536, True),     # the TP shard of B/16 over model=2
])
def test_model_matches_the_plain_version(m, d, mlp, partial):
    args = _inputs(m + d + mlp, m, d, mlp)
    got = k17_tf32_model(*args, partial=partial)
    want = reference.mlp_block_q(*args, eps=1e-12, partial_out=partial)
    assert float((got - want).abs().max()) <= BAR


def test_one_pass_misses_the_bar():
    """A B_hi alone (one TF32 pass, the codes exact) is what the second
    pass exists to mend: it misses the bar where the two passes hold it."""
    args = _inputs(3, 96, 768, 3072)
    want = reference.mlp_block_q(*args, eps=1e-12)
    x, g, b, w1q, s1, b1, w2q, s2, b2 = args
    xn = reference.layernorm(x, g, b, eps=1e-12)
    one = x + b2
    for c0 in range(0, 3072, CT):
        cols = slice(c0, c0 + CT)
        h = reference.gelu(torch.matmul(tf32(xn), w1q[:, cols].float())
                           * s1[cols] + b1[cols])
        one = one + torch.matmul(tf32(h), w2q[cols].float()) * s2
    assert float((one - want).abs().max()) > BAR
    assert float((k17_tf32_model(*args) - want).abs().max()) <= BAR


@pytest.mark.parametrize("d,partial", [(128, False), (128, True),
                                       (256, False), (256, True)])
def test_model_matches_pallas_interpret(monkeypatch, d, partial):
    """JAX's fp32 kernel (``_mlp_q_kernel`` at ``Precision.HIGHEST``) in
    interpret mode, its plan pinned to the port's 512-column group, over
    three layers' worth of rows of a narrow model (ragged M, 3 x 25)."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    args = _inputs(11 + d, 75, d, 1024)
    j = [jnp.asarray(a.numpy()) for a in args]
    want = np.asarray(pallas_block.mlp_block_q(
        j[0][None], *j[1:], eps=1e-12, partial_out=partial,
        interpret=True))[0]
    got = k17_tf32_model(*args, partial=partial).numpy()
    assert np.abs(got - want).max() <= BAR


def test_rows_do_not_depend_on_m():
    args = _inputs(9, 70, 256, 512)
    whole = k17_tf32_model(*args)
    head = k17_tf32_model(args[0][:33], *args[1:])
    assert torch.equal(whole[:33], head)


# ------------------------------------------------------ the scaling order --

def test_fc2_is_scaled_per_chunk_in_order():
    """The tile scales each 128-column chunk's fc2 sums by s2 and adds them
    to the totals chunk after chunk (``run_chunks``: ``tot + part * s2``,
    two roundings, no FMA); the plain version scales once a 512-column
    group, JAX once a chunk of its plan's ct. The orders give other bits
    but the same sums within fp32 rounding, far inside the bar; in numpy
    fp32 the per-chunk order is what the model computes, bit for bit."""
    rng = np.random.default_rng(4)
    m, mlp, d = 16, 1024, 256
    h = rng.standard_normal((m, mlp)).astype(np.float32)
    w2q = rng.integers(-127, 128, (mlp, d)).astype(np.float32)
    s2 = (0.01 * rng.random(d) + 0.001).astype(np.float32)
    tot = np.zeros((m, d), np.float32)
    for c0 in range(0, mlp, CT):
        part = (h[:, c0:c0 + CT].astype(np.float64)
                @ w2q[c0:c0 + CT]).astype(np.float32)
        tot = (tot + part * s2).astype(np.float32)
    group = np.zeros((m, d), np.float32)
    for c0 in range(0, mlp, 512):
        part = (h[:, c0:c0 + 512].astype(np.float64)
                @ w2q[c0:c0 + 512]).astype(np.float32)
        group = (group + part * s2).astype(np.float32)
    exact = (h.astype(np.float64) @ w2q) * s2
    assert not np.array_equal(tot, group)
    assert np.abs(tot - exact).max() <= 1e-5 * np.abs(exact).max()
    assert np.abs(group - exact).max() <= 1e-5 * np.abs(exact).max()
    # The model's order on the same values (its fc2 with h exact in TF32
    # splits to hi + 0, so only the sum order is left).
    th, tw = torch.from_numpy(h), torch.from_numpy(w2q)
    ts2 = torch.from_numpy(s2)
    model = torch.zeros(m, d)
    for c0 in range(0, mlp, CT):
        model = model + torch.matmul(th[:, c0:c0 + CT], tw[c0:c0 + CT]) * ts2
    assert np.abs(model.numpy() - tot).max() <= 1e-5 * np.abs(exact).max()


def test_fc1_scale_comes_before_the_bias():
    """h = gelu(sums * s1 + b1): the scale multiplies the raw code sums
    (``quantize_weight``'s per-column scale), and the bias is in the
    dequantized units, as in ``reference.matmul(..., wscale=s1)``."""
    args = _inputs(2, 8, 128, 512)
    x, g, b, w1q, s1, b1 = args[:6]
    xn = reference.layernorm(x, g, b, eps=1e-12)
    want = reference.matmul(xn, w1q, b1, "gelu", wscale=s1)
    got = reference.gelu(torch.matmul(xn, w1q.float()) * s1 + b1)
    assert torch.equal(got, want)
    other = reference.gelu((torch.matmul(xn, w1q.float()) + b1) * s1)
    assert float((other - want).abs().max()) > BAR


# ---------------------------------------------------- the int8 weight box --

def box_offset(k, i):
    """Byte of element (k, i) in a 32-row x 128-column int8 box TMA writes
    with the 128-byte swizzle: row k at 128 k, its 16-byte chunk i / 16 at
    (i / 16) ^ (k % 8)."""
    return k * 128 + ((((i >> 4) ^ (k & 7)) & 7) << 4) + (i & 15)


def load_wq_addr(wgi, warp, lane, s, second):
    """``load_wq``'s byte address for slice s (``second``: slots t + 4) of
    warp ``warp``'s lane in warpgroup ``wgi``, the (k, column) it reads
    first (the second byte is column + 1)."""
    g, q = lane // 4, lane % 4
    chunk = 4 * wgi + warp
    k = 8 * s + perm8(q + 4 * second)
    return k * 128 + ((chunk ^ (k & 7)) << 4) + 2 * g, k, \
        64 * wgi + 16 * warp + 2 * g


@pytest.mark.parametrize("wgi", [0, 1])
def test_code_loads_read_the_fragment_map(wgi):
    """Each 2-byte load holds columns col and col + 1 of row k, where (k,
    col) is the slot and row that ``load_w``'s fp32 map gives the same
    fragment value; the warpgroup reads every (k, column) of its half of
    the box once."""
    seen = set()
    for warp in range(4):
        for lane in range(32):
            for s in range(4):
                for second in (0, 1):
                    addr, k, col = load_wq_addr(wgi, warp, lane, s, second)
                    assert addr % 2 == 0
                    assert addr == box_offset(k, col)
                    assert addr + 1 == box_offset(k, col + 1)
                    seen |= {(k, col), (k, col + 1)}
    assert seen == {(k, c) for k in range(32)
                    for c in range(64 * wgi, 64 * wgi + 64)}


def test_box_map_is_a_bijection():
    offsets = {box_offset(k, i) for k in range(32) for i in range(128)}
    assert offsets == set(range(4096))


def wavefronts_2b(addrs):
    """Wavefronts of one warp instruction of 2-byte loads: the 32 lanes in
    one phase, as many wavefronts as the most distinct 4-byte words it
    asks of one bank."""
    banks: dict[int, set[int]] = {}
    for a in addrs:
        banks.setdefault((a // 4) % 32, set()).add(a // 4)
    return max(len(v) for v in banks.values())


def test_code_loads_take_one_wavefront():
    """Each load instruction reads 64 bytes: four K rows (8 s + 2 t, or +
    1) of 16 bytes, whose swizzled chunks are four distinct ones, so one
    wavefront (K3's fp32 fragment loads take two for 256 bytes)."""
    for wgi in (0, 1):
        for warp in range(4):
            for s in range(4):
                for second in (0, 1):
                    got = [load_wq_addr(wgi, warp, lane, s, second)
                           for lane in range(32)]
                    assert wavefronts_2b([a for a, _, _ in got]) == 1
                    # Rows of 128 bytes without the swizzle would put the
                    # four rows on the same four banks.
                    dense = [128 * k + col for _, k, col in got]
                    assert wavefronts_2b(dense) == 4
    # K3's 8-byte loads of the fp32 box for comparison.
    from test_torch_mlp_tf32 import load_w_index
    addrs = [4 * load_w_index(0, 0, lane, 0, 0)[0] for lane in range(32)]
    assert wavefronts(addrs, 8) == 2


def test_mapped_step_is_the_transposed_product():
    """One fc1 step through the maps: the warpgroup's A (codes from a random
    int8 box through ``load_wq``'s addresses and ``codes_f32``) times B
    (LN(x)'s box through its permuted slots) gives accumulator row r of
    warp w as hidden column 64 wgi + 16 w + 2 (r % 8) + r // 8, column n
    as row n: h^T's block over the step, the codes exact."""
    rng = np.random.default_rng(3)
    w = rng.integers(-128, 128, (32, 128))
    xn = rng.standard_normal((32, 32))
    box = np.zeros(4096, np.uint8)
    for k in range(32):
        for i in range(128):
            box[box_offset(k, i)] = w[k, i] & 0xFF
    bbox = np.zeros(32 * 32)
    for n in range(32):
        for p in range(32):
            bbox[int(sw(n, p))] = xn[n, 8 * (p // 8) + perm8(p % 8)]
    for wgi in (0, 1):
        acc = np.zeros((64, 32))
        for s in range(4):
            a = np.zeros((64, 8))
            for warp in range(4):
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    for second in (0, 1):
                        addr = load_wq_addr(wgi, warp, lane, s, second)[0]
                        a[16 * warp + g, q + 4 * second] = codes_f32(
                            int(box[addr]))
                        a[16 * warp + g + 8, q + 4 * second] = codes_f32(
                            int(box[addr + 1]))
            b = np.array([[bbox[int(sw(n, 8 * s + u))] for n in range(32)]
                          for u in range(8)])
            acc += a @ b
        rows = [64 * wgi + 16 * (r // 16) + 2 * (r % 8) + (r % 16) // 8
                for r in range(64)]
        np.testing.assert_allclose(acc, (xn @ w[:, rows]).T, atol=1e-9)


def convert_addrs(u, i):
    """``convert_stage``'s (``tools/mlp_tf32_ablate.py:Q_BOX_CONVERT``, the
    ``q_box`` variant's) unit u (row k = u / 8, raw chunk c = u % 8) at
    its store i: the raw chunk's byte address, the 32-bit word ii it
    stores, and the fp32 stage's byte address (box c / 2, its row k,
    columns (c % 2) 16 + 4 ii .. + 3) the four values go to."""
    k, c = u >> 3, u & 7
    ii = (i + (c >> 1)) & 3
    raw = k * 128 + ((c ^ (k & 7)) << 4)
    fp = (c >> 1) * 4096 + 4 * int(sw(k, (c & 1) * 16 + 4 * ii))
    return raw, ii, fp


def test_convert_stage_writes_load_ws_layout_once():
    """Every code of the int8 stage (k, n) lands once in the fp32 box at
    the float ``load_w`` / ``load_wf`` read for (k, n): box n / 32, its
    128-byte swizzled row k, column n % 32."""
    where = {}
    for u in range(256):
        k, c = u >> 3, u & 7
        for i in range(4):
            raw, ii, fp = convert_addrs(u, i)
            for e in range(4):
                n = 16 * c + 4 * ii + e
                assert raw + 4 * ii + e == box_offset(k, n)
                assert fp + 4 * e not in where
                where[fp + 4 * e] = (k, n)
    assert len(where) == 32 * 128
    for fp, (k, n) in where.items():
        assert fp == (n >> 5) * 4096 + 4 * int(sw(k, n & 31))


def test_convert_stage_loads_and_stores_take_no_bank_conflict():
    """Helper j's units are j, j + 96, j + 192: a warp's 32 lanes take 32
    consecutive units from a multiple of 32, so each quarter-warp phase is
    one row's eight raw chunks (distinct under the swizzle), and the
    rotation by c / 2 sends its eight stores of each round to eight
    distinct chunks of the row: four wavefronts an instruction."""
    for j0 in (0, 32, 64):
        for it in range(3):
            units = [j0 + lane + 96 * it for lane in range(32)]
            if units[0] >= 256:
                continue
            units = [u if u < 256 else units[0] for u in units]
            loads = [convert_addrs(u, 0)[0] for u in units]
            assert wavefronts(loads, 16) == 4
            for i in range(4):
                stores = [convert_addrs(u, i)[2] for u in units]
                assert wavefronts(stores, 16) == 4


# ------------------------------------------------ forms and budgets --

def q_smem(bm, box=False):
    """``(bytes, weight stages, barrier bytes)`` of the Q tile's shared
    memory at ``bm`` rows a block (``mlp_tf32.cuh:Cfg<BM, true>``): K3's
    fixed part (x stages, h buffers, LN's parameters, statistics, and
    barriers: K3's 256 bytes, twice that in the ``q_box`` variant), then as
    many weight stages as fit, at most 8 (a 4 KB int8 box, and its 16 KB
    fp32 box with ``box``), and 1024 bytes to align."""
    x_box = bm * 128
    bars = 512 if box else 256
    stage = 4096 + (16384 if box else 0)
    fixed = 4 * 3 * x_box + 2 * 8 * x_box + 2 * 1536 * 4 + 2 * bm * 4 + bars
    stages = min(8, (MAX_SMEM - 1024 - fixed) // stage)
    return stages * stage + fixed + 1024, stages, bars


def _q_geometries():
    """Every (D, mlp) K17 runs on: each variant's width and its TP shards
    over model=2 and 4 where ``mlp_q_plan`` admits them, and the narrow
    widths of the tests."""
    out = set()
    for cfg in VARIANTS.values():
        for model in (1, 2, 4):
            d, mlp = cfg.hidden_dim, cfg.mlp_dim // model
            if ops.mlp_q_plan(d, mlp):
                out.add((d, mlp))
    return sorted(out | {(128, 512), (256, 1024), (1280, 512)})


@pytest.mark.parametrize("d,mlp", _q_geometries())
def test_every_admitted_geometry_has_a_tf32_form_that_fits(d, mlp):
    assert cuda_quant.mlp_q_f32_form(d, mlp, (0, 256, 1024)) == "tf32"
    bm, groups = tile_for(d)
    assert d // 128 <= groups
    # The fc2 sums a consumer thread holds, with a step's sums (BM / 2) and
    # the 16 unsplit fragment registers (K3's split ones are 32): inside
    # the 168 registers ptxas gives a thread of a 384-thread block.
    assert groups * bm // 2 <= 96
    # wfull, wempty (and the q_box variant's wconv) a stage, three a stage
    # of x, and ydone.
    for box in (False, True):
        smem, stages, bars = q_smem(bm, box)
        assert smem <= MAX_SMEM and stages >= 4
        assert ((3 if box else 2) * stages + 3 * 4 + 1) * 8 <= bars


def test_form_helper_rule():
    """``"tf32"`` where every base is 16-byte aligned, ``"ffma"`` where one
    is not; geometries ``mlp_q_plan`` refuses raise."""
    assert cuda_quant.mlp_q_f32_form(768, 3072, (0, 16, 32)) == "tf32"
    assert cuda_quant.mlp_q_f32_form(768, 3072, (4, 16, 32)) == "ffma"
    assert cuda_quant.mlp_q_f32_form(1280, 512, (0, 16, 8)) == "ffma"
    for d, mlp in ((200, 512), (768, 3000), (1408, 512)):
        with pytest.raises(ValueError):
            cuda_quant.mlp_q_f32_form(d, mlp, (0, 0, 0))
    assert cuda_quant.MLP_Q_F32_FORMS == {"ffma": 0, "tf32": 1}


def test_sources_match_the_mirror():
    """This module's mirror of the launcher's forms and of ``Cfg<BM,
    true>`` reads the same constants as the sources; the entry point
    sends form 1 to the tile and form 0 to the FFMA kernel."""
    launch = (CSRC / "mlp_block_q_tf32.cu").read_text()
    for bm, g in FORMS:
        assert f"VIT_MQ({bm}, {g})" in launch
    assert "tensor_map_i8(&m1, w1, d, mlp, mlp, 128, mt::kBK)" in launch
    tile = (CSRC / "mlp_tf32.cuh").read_text()
    for const in ("constexpr int kWStageQ = 4096;",
                  "constexpr int kBarBytes = 256;",
                  "static constexpr int kWSt = Q ? kWStageQ : kWStage;",
                  "static constexpr int kSW = kSWraw < 8 ? kSWraw : 8;",
                  '"r"(0x7540u)',
                  "8388736.f"):
        assert const in tile
    entry = (CSRC / "mlp_block_q.cu").read_text()
    assert "if (dtype == kF32 && form == 1)" in entry
    assert "if (dtype == kF32 && form == 0)" in entry


@pytest.mark.parametrize("name", ["q_no_mma", "q_ring16", "q_box",
                                  "q_nopipe", "q_no_cvt", "q_no_ln"])
def test_ablation_variants_edit_the_current_sources(monkeypatch, tmp_path,
                                                    name):
    """``tools/mlp_tf32_ablate.py``'s K17 variants: each substitution
    matches the tile's sources as they are (a pattern that matches nothing
    raises); ``q_box`` and ``q_nopipe`` put their own unpipelined loop in
    place of ``run_acc_qp``, ``q_box`` reading the fp32 box its helper
    warps write."""
    from vit_tpu_torch.tools import mlp_tf32_ablate as abl
    monkeypatch.setattr(abl, "OUT", tmp_path)
    root = abl.make_variant(name)
    text = (root / "mlp_tf32.cuh").read_text()
    assert (root / "mlp_block_q_tf32.cu").exists()
    assert text != (abl.CSRC / "mlp_tf32.cuh").read_text()
    if name in ("q_box", "q_nopipe"):
        q = _body(text, "void run_acc(")
        assert "run_acc_qp<" not in q and "mma_q<BM>(acc, aq," in q
        assert ("load_wf(" in q) == (name == "q_box")
    if name == "q_box":
        assert "convert_stage(sm.wstage(w.s), j);" in text
        assert "mbar_init(sm.wconv(s), kHelpThreads / 32);" in text


def _body(text: str, signature: str) -> str:
    """The body of the function whose definition starts at ``signature``,
    from its first brace to the one that closes it."""
    i = text.index("{", text.index(signature))
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError(f"{signature} does not close")


def test_q_path_starts_its_wgmma_in_mma_q_only():
    """K17's walk: run_acc sends Q to run_acc_qp, which runs step_qp, whose
    products are started by mma_q alone; so ``q_no_mma``, which makes
    mma_q's one call dead, leaves the walk that ``base`` runs without a
    wgmma (the tool checks the build's SASS on the card as well)."""
    from vit_tpu_torch.tools import mlp_tf32_ablate as abl
    text = (CSRC / "mlp_tf32.cuh").read_text()
    run_acc = _body(text, "void run_acc(")
    assert "if constexpr (Q) {\n    run_acc_qp<BM, FC1>(" in run_acc
    assert "step_qp<BM, FC1>(" in _body(text, "void run_acc_qp(")
    step_qp = _body(text, "void step_qp(")
    assert step_qp.count("mma_q<BM>(") == 1
    mma = _body(text, "void mma_q(")
    assert "wgmma_n<BM>(acc, a[s], dh);" in mma
    for body in (run_acc, step_qp, _body(text, "void run_acc_qp(")):
        assert "wgmma_n" not in body
    assert text.count("mma_q<BM>(") == 1  # step_qp's: the only caller
    edited = abl.VARIANTS["q_no_mma"][0]
    assert edited[0] == "mlp_tf32.cuh"
    import re
    variant = re.sub(edited[1], edited[2], text, flags=re.M)
    assert "if (0) mma_q<BM>(" in _body(variant, "void step_qp(")
    assert variant.count("mma_q<BM>(") == 1


def test_ablation_refuses_a_no_mma_build_that_keeps_wgmma(monkeypatch):
    """``hgmma_counts`` sums each tile kernel's HGMMA over its forms by its
    demangled name (K17's is not counted as K3's); the tool's guard reads
    it per variant."""
    from vit_tpu_torch.tools import mlp_tf32_ablate as abl
    from vit_tpu_torch.tools import sass_count
    k3 = "void vit::mt::mlp_tf32_kernel<32, 6>(CUtensorMap_st, ...)"
    k17 = "void vit::mt::mlp_q_tf32_kernel<16, 8>(CUtensorMap_st, ...)"
    k17b = "void vit::mt::mlp_q_tf32_kernel<32, 2>(CUtensorMap_st, ...)"
    sass = {k3: [["/*0010*/ HGMMA.64x32x8.F32.TF32 R24, gdesc[UR4], R24 ;",
                  "/*0020*/ FFMA R1, R2, R3, R4 ;"]],
            k17: [["/*0010*/ HGMMA.64x16x8.F32.TF32 R24, gdesc[UR4], R24 ;"],
                  ["/*0010*/ @P0 HGMMA.64x16x8.F32.TF32 R2, gdesc[UR4], R2 ;"]],
            k17b: [["/*0010*/ NOP ;"]]}
    monkeypatch.setattr(sass_count, "by_name", lambda lib: sass)
    assert abl.hgmma_counts("lib") == {"vit::mt::mlp_tf32_kernel": 1,
                                       "vit::mt::mlp_q_tf32_kernel": 2}
    assert abl.NO_MMA == {"no_mma": "vit::mt::mlp_tf32_kernel",
                          "q_no_mma": "vit::mt::mlp_q_tf32_kernel"}
