"""The int8 tier's s8 ``wgmma`` tiles on the CPU: K11's
(``vit_tpu_torch/csrc/matmul_i8_wgmma.cu``) and K12's
(``vit_tpu_torch/csrc/mlp_i8_wgmma.cuh``), with their shared pieces in
``csrc/i8_wgmma.cuh``.

CUDA kernels do not run here, so what the tiles do is modelled in this
file (not in the package), byte for byte where it is layout:

- TMA's 128-byte swizzle puts byte (r, c) of a 128-byte-wide box at
  ``sw128(r * 128 + c)``; ``transpose_box`` turns a raw box of W (128 K
  rows x 128 N bytes, N-major as the weights lie) K-major, lane by lane
  and pass by pass with the kernel's ``prmt`` selectors; the s8 descriptor
  walk (a k32 step moves the start 32 bytes, 8-row groups are 1024 bytes
  apart) must read ``q[k, n]`` for every element of every fragment, and
  each warp instruction's 32 shared-memory words must fall in 32 banks;
- the codes K12 stores itself (xq after LN, hq after GELU) land where the
  A descriptor reads them;
- K11's walk (contiguous tile ranges, the panel kept or streamed),
  its int32 sums and its epilogue order, bit for bit with
  ``reference.matmul_i8`` and within fp32 rounding of JAX's
  ``vit_tpu/quant.py:int8_matmul``;
- K12's group protocol (W1 and W2 rings fed by the transposers, the
  partial row maxima and the hq slices exchanged across the cluster)
  under random interleavings with every buffer tagged, and K12's epilogue
  order in float32 / int32 numpy, bit for bit with
  ``reference.mlp_block_i8dot``;
- the shared-memory and register budgets of every geometry
  ``ops.mlp_q_plan`` admits.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu import quant as jquant
from vit_tpu_torch import ops
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.cuda.quant import MLP_I8_MAX_D, i8_path
from vit_tpu_torch.quant import quantize_weight

CSRC = Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"
I8_HEADER = (CSRC / "i8_wgmma.cuh").read_text()
K11_SOURCE = (CSRC / "matmul_i8_wgmma.cu").read_text()
K12_HEADER = (CSRC / "mlp_i8_wgmma.cuh").read_text()


def _const(text: str, name: str) -> int:
    m = re.search(rf"\b{name} = ([0-9][0-9 +*]*)[;,]", text)
    return int(eval(m.group(1), {}, {}))  # noqa: S307


_CONSTS: dict = {}
for _name in ("kBK", "kBox", "kHalf", "kThreads", "kTransposers",
              "kProducerRegs", "kConsumerRegs"):
    _CONSTS[_name] = _const(I8_HEADER, _name)
BK, BOX, HALF = _CONSTS["kBK"], _CONSTS["kBox"], _CONSTS["kHalf"]
TRANSPOSERS = _CONSTS["kTransposers"]
K11_SA, K11_SR, K11_SB = (_const(K11_SOURCE, n) for n in ("kSA", "kSR", "kSB"))
for _name in ("kGroup", "kPairs", "kSRMax", "kS1", "kS2", "kSmemMax",
              "kTail"):
    _CONSTS["k12_" + _name] = _const(K12_HEADER, _name)
GROUP, PAIRS = _CONSTS["k12_kGroup"], _CONSTS["k12_kPairs"]
SMEM_MAX = _CONSTS["k12_kSmemMax"]
EPS = 1e-12

# The prmt selectors of transpose4, read from the source.
_SEL = [int(s, 16) for s in re.findall(r"0x([0-9a-f]{4})", re.search(
    r"void transpose4.*?\n}", I8_HEADER, re.S).group(0))]


def sw128(addr):
    """TMA's and wgmma's 128-byte swizzle of a shared-memory byte address
    (the base 1024-aligned): 16-byte chunk bits 4-6 XOR row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(mat: np.ndarray, r0: int, c0: int, rows: int = 128) -> np.ndarray:
    """The bytes TMA writes for the box of ``rows`` x 128 int8 at (r0, c0)
    of ``mat`` with the 128-byte swizzle, zeros outside the matrix."""
    box = np.zeros((rows, 128), np.uint8)
    part = mat[r0:r0 + rows, c0:c0 + 128].view(np.uint8)
    box[:part.shape[0], :part.shape[1]] = part
    out = np.zeros(rows * 128, np.uint8)
    r, c = np.meshgrid(np.arange(rows), np.arange(128), indexing="ij")
    out[sw128(r * 128 + c)] = box
    return out


def prmt(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """PTX ``prmt.b32`` (default mode): result byte i is byte nibble_i of
    the eight bytes of b:a."""
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)], -1)
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[..., (sel >> (4 * i)) & 0xF] << (8 * i)
    return out


def transpose_box(raw: np.ndarray, banks: list | None = None) -> np.ndarray:
    """``transpose_box`` of ``i8_wgmma.cuh`` on a raw box (16384 bytes):
    pass d, lane l take block (k4, n4) = (l ^ d, l); four 32-bit loads,
    eight prmt, four 32-bit stores. With ``banks``, each load and store
    instruction's 32 banks are appended."""
    src = raw.view("<u4")
    dst = np.zeros(BOX // 4, "<u4")
    lane = np.arange(32)
    for d in range(32):
        n4, k4 = lane, lane ^ d
        w = []
        for i in range(4):
            k = 4 * k4 + i
            addr = k * 128 + ((((n4 >> 2) ^ (k & 7)) << 4) | ((n4 & 3) << 2))
            w.append(src[addr // 4].astype(np.uint64))
            if banks is not None:
                banks.append((addr // 4) % 32)
        t0, t1 = prmt(w[0], w[1], _SEL[0]), prmt(w[0], w[1], _SEL[1])
        t2, t3 = prmt(w[2], w[3], _SEL[2]), prmt(w[2], w[3], _SEL[3])
        o = [prmt(t0, t2, _SEL[4]), prmt(t0, t2, _SEL[5]),
             prmt(t1, t3, _SEL[6]), prmt(t1, t3, _SEL[7])]
        for j in range(4):
            n = 4 * n4 + j
            addr = n * 128 + ((((k4 >> 2) ^ (n & 7)) << 4) | ((k4 & 3) << 2))
            dst[addr // 4] = o[j]
            if banks is not None:
                banks.append((addr // 4) % 32)
    return dst.view(np.uint8)


def desc_read(smem: np.ndarray, start: int, rows: int) -> np.ndarray:
    """What a K-major, 128-byte-swizzled s8 descriptor at byte ``start``
    (a box's base plus a k32 step's 32-byte offset) reads: ``rows`` rows of
    32 K bytes, 8-row groups 1024 bytes apart, as int8 (rows, 32)."""
    r, k = np.meshgrid(np.arange(rows), np.arange(32), indexing="ij")
    lin = start + (r // 8) * 1024 + (r % 8) * 128 + k
    return smem[sw128(lin)].view(np.int8)


def store_addr(row, col):
    """Where K12 stores the code of (row, col) of a K-major int8 tile of
    64-row boxes (``store_codes``, and the LN pass's store)."""
    k = col % BK
    return (col // BK) * HALF + row * 128 + ((((k >> 4) ^ (row & 7)) << 4)
                                             | (k & 15))


def _q(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# ----------------------------------------------------------- the layouts --


@pytest.mark.parametrize("k,n", [(256, 256), (200, 136), (128, 40)])
def test_transposed_box_reads_q_through_the_s8_descriptor(k, n):
    """Every raw box of a ragged (K, N) weight, turned K-major, read by
    every k32 step's descriptor (N = 128 and both 64-row halves, K12's
    fc2), gives ``q[k, n]``, zeros past the edges."""
    rng = np.random.default_rng(k + n)
    w = _q(rng, k, n)
    pad = np.zeros((-(-k // BK) * BK, -(-n // 128) * 128), np.int8)
    pad[:k, :n] = w
    for kb in range(0, k, BK):
        for nb in range(0, n, 128):
            kmaj = transpose_box(tma_box(w, kb, nb))
            for kk in range(BK // 32):
                want = pad[kb + 32 * kk:kb + 32 * kk + 32, nb:nb + 128].T
                np.testing.assert_array_equal(
                    desc_read(kmaj, 32 * kk, 128), want)
                for half in range(2):
                    np.testing.assert_array_equal(
                        desc_read(kmaj, half * HALF + 32 * kk, 64),
                        want[64 * half:64 * half + 64])


def test_transposition_is_bank_conflict_free():
    """Each of the 256 load and 128 store instructions of a warp's passes
    touches 32 distinct banks."""
    banks: list = []
    transpose_box(np.zeros(BOX, np.uint8), banks)
    assert len(banks) == 32 * 8
    for b in banks:
        assert len(set(b.tolist())) == 32


def test_transposer_passes_cover_every_block_once():
    """The transposer warps' passes (warp w takes d = w, w + 3, ...) and
    the lanes cover the 32 x 32 blocks of a box exactly once."""
    seen = np.zeros((32, 32), int)
    for warp in range(TRANSPOSERS // 32):
        for d in range(warp, 32, TRANSPOSERS // 32):
            for lane in range(32):
                seen[lane ^ d, lane] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("d", [128, 768, 1280])
def test_code_stores_match_the_a_descriptor(d):
    """xq (64 rows x D, the LN pass) and hq (64 x 512) stored by the
    kernel's address map are read back by the A descriptor of every box
    and k32 step; the map is a bijection onto the tile."""
    rng = np.random.default_rng(d)
    codes = _q(rng, 64, d)
    tile = np.zeros(64 * d, np.uint8)
    r, c = np.meshgrid(np.arange(64), np.arange(d), indexing="ij")
    addr = store_addr(r, c)
    assert len(np.unique(addr)) == addr.size and addr.max() < tile.size
    tile[addr] = codes.view(np.uint8)
    for kb in range(d // BK):
        for kk in range(BK // 32):
            np.testing.assert_array_equal(
                desc_read(tile, kb * HALF + 32 * kk, 64),
                codes[:, kb * BK + 32 * kk:kb * BK + 32 * kk + 32])


# ------------------------------------------------------------------ K11 --


def k11_blocks(m: int, n: int, sms: int) -> list[tuple[int, int]]:
    """Each block's range of the column-major tile walk."""
    tiles = -(-m // 128) * -(-n // 128)
    g = min(tiles, sms)
    return [(tiles * b // g, tiles * (b + 1) // g) for b in range(g)]


def k11_model(xq, ax, wq, ws, bias, residual, out_dtype, *, sms=132,
              slots=K11_SB):
    """K11's tile: every block walks its tiles; the A box of each K step
    and the panel's raw boxes go through TMA's swizzle, the panel through
    ``transpose_box`` into ``slots`` slots (kept where the K steps fit,
    else streamed), each warpgroup's 64 rows through the descriptors in
    k32 steps; then ``I8Epilogue::store``'s order in float32."""
    m, k = xq.shape
    n = wq.shape[1]
    tiles_m, nk = -(-m // 128), -(-k // BK)
    resident = nk <= slots
    out = np.zeros((m, n), np.float32)
    panels = 0
    for t0, t1 in k11_blocks(m, n, sms):
        kept = None
        for t in range(t0, t1):
            m0, n0 = (t % tiles_m) * 128, (t // tiles_m) * 128
            if not resident or t == t0 or t // tiles_m != (t - 1) // tiles_m:
                kept = [transpose_box(tma_box(wq, kb * BK, n0))
                        for kb in range(nk)]
                panels += 1
            acc = np.zeros((128, 128), np.int64)
            for kb in range(nk):
                a_box = tma_box(xq, m0, kb * BK)  # 128 rows x 128 K bytes
                for wg in range(2):
                    for kk in range(BK // 32):
                        a = desc_read(a_box, wg * HALF + 32 * kk, 64)
                        b = desc_read(kept[kb], 32 * kk, 128)
                        acc[64 * wg:64 * wg + 64] += (
                            a.astype(np.int64) @ b.astype(np.int64).T)
            rows, cols = min(128, m - m0), min(128, n - n0)
            v = (acc[:rows, :cols].astype(np.float32)
                 * ax[m0:m0 + rows]) * ws[n0:n0 + cols]
            if bias is not None:
                v = v + bias[n0:n0 + cols]
            if residual is not None:
                v = v + residual[m0:m0 + rows, n0:n0 + cols]
            out[m0:m0 + rows, n0:n0 + cols] = v
    return torch.from_numpy(out).to(out_dtype), panels


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,sms,slots", [
    (200, 272, 144, 132, K11_SB),   # ragged M, K, N; one tile a block
    (300, 256, 272, 2, K11_SB),     # blocks walk rows under kept panels
    (300, 640, 144, 2, 2),          # the panel streamed (K steps > slots)
])
def test_k11_tile_matches_reference_bit_for_bit(out_dtype, m, k, n, sms,
                                                slots):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xq_t, ax_t = reference.quantize_rows(torch.from_numpy(x))
    wq = quantize_weight(torch.from_numpy(
        rng.standard_normal((k, n)).astype(np.float32) * .05))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * .1)
    res = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    bias_o, res_o = bias.to(out_dtype), res.to(out_dtype)
    got, panels = k11_model(
        xq_t.numpy(), ax_t.numpy(), wq["q"].numpy(), wq["scale"].numpy(),
        bias_o.float().numpy(), res_o.float().numpy(), out_dtype, sms=sms,
        slots=slots)
    want = reference.matmul_i8(xq_t, ax_t, wq["q"], wq["scale"], bias_o,
                               residual=res_o, out_dtype=out_dtype)
    assert torch.equal(got, want)
    tiles_m, tiles_n = -(-m // 128), -(-n // 128)
    if -(-k // BK) > slots:
        assert panels == tiles_m * tiles_n
    else:
        assert panels <= min(tiles_m * tiles_n, sms) + tiles_n
    # JAX's int8_matmul quantizes x itself, to the same codes and scales
    # here (no zero row); its sums are exact, its epilogue fp32.
    jax_out = np.asarray(jquant.int8_matmul(
        jnp.asarray(x), {"q": jnp.asarray(wq["q"].numpy()),
                         "scale": jnp.asarray(wq["scale"].numpy())},
        jnp.asarray(bias.numpy())))
    no_res, _ = k11_model(xq_t.numpy(), ax_t.numpy(), wq["q"].numpy(),
                          wq["scale"].numpy(), bias.numpy(), None,
                          torch.float32, sms=sms, slots=slots)
    np.testing.assert_allclose(no_res.numpy(), jax_out, rtol=1e-6,
                               atol=1e-6)


def test_i8_path_by_shape_alone():
    """The wgmma tile where TMA can read both operands (16-byte aligned
    bases, K and N multiples of 16), gemm_tile.cuh's tile otherwise; the
    B/16, L/16-384 and H/14 projections and their model=2 and 4 shards all
    take the wgmma tile."""
    for d, mlp in ((768, 3072), (1024, 4096), (1280, 5120)):
        for model in (1, 2, 4):
            for k, n in ((d, 3 * d // model), (d // model, d),
                         (d, mlp // model), (mlp // model, d)):
                assert i8_path(6656, n, k, (0, 256)) == "wgmma"
    assert i8_path(37, 100, 588, (0, 0)) == "wmma"
    assert i8_path(130, 9, 24, (0, 0)) == "wmma"
    assert i8_path(64, 1280, 5120, (0, 8)) == "wmma"
    with pytest.raises(ValueError):
        i8_path(0, 16, 16, (0, 0))


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


def _run(agents, bars, seed: int) -> None:
    """Step seeded-random agents until all finish; a long run of steps in
    which no barrier moves is a deadlock."""
    rng = np.random.default_rng(seed)
    idle = 0
    while agents:
        a = agents[rng.integers(len(agents))]
        before = [(b.phases, b.pending, b.tx) for b in bars]
        try:
            next(a)
        except StopIteration:
            agents.remove(a)
            idle = 0
            continue
        after = [(b.phases, b.pending, b.tx) for b in bars]
        idle = 0 if after != before else idle + 1
        assert idle < 50 * len(agents) + 1000, "deadlock"


def _k11_protocol(tiles_m: int, t0: int, t1: int, nk: int, seed: int):
    """K11's rings (A, raw, panel slots) for one block's walk: the TMA
    thread, the transposers and both consumer warpgroups, every stage and
    slot tagged with what was last written there."""
    resident = nk <= K11_SB
    bars = {"af": [_Barrier(1) for _ in range(K11_SA)],
            "ae": [_Barrier(2) for _ in range(K11_SA)],
            "rf": [_Barrier(1) for _ in range(K11_SR)],
            "re": [_Barrier(TRANSPOSERS) for _ in range(K11_SR)],
            "bf": [_Barrier(TRANSPOSERS) for _ in range(K11_SB)],
            "be": [_Barrier(2) for _ in range(K11_SB)]}
    a, raw, slot = [None] * K11_SA, [None] * K11_SR, [None] * K11_SB

    def load_b(t):
        return not resident or t == t0 or t // tiles_m != (t - 1) // tiles_m

    def release_b(t):
        return not resident or t + 1 == t1 or (t + 1) // tiles_m != t // tiles_m

    def tma():
        sa = sr = 0
        for t in range(t0, t1):
            for kb in range(nk):
                if load_b(t):
                    yield from _wait(bars["re"][sr % K11_SR],
                                     (sr // K11_SR) % 2 ^ 1)
                    bars["rf"][sr % K11_SR].arrive(tx=1)
                    yield
                    raw[sr % K11_SR] = (t // tiles_m, kb)
                    bars["rf"][sr % K11_SR].complete_tx(1)
                    sr += 1
                yield from _wait(bars["ae"][sa % K11_SA],
                                 (sa // K11_SA) % 2 ^ 1)
                bars["af"][sa % K11_SA].arrive(tx=1)
                yield
                a[sa % K11_SA] = (t, kb)
                bars["af"][sa % K11_SA].complete_tx(1)
                sa += 1

    def transposer():
        sr = sb = 0
        for t in range(t0, t1):
            if not load_b(t):
                continue
            for kb in range(nk):
                yield from _wait(bars["rf"][sr % K11_SR], (sr // K11_SR) % 2)
                yield from _wait(bars["be"][sb % K11_SB],
                                 (sb // K11_SB) % 2 ^ 1)
                assert raw[sr % K11_SR] == (t // tiles_m, kb)
                slot[sb % K11_SB] = (t // tiles_m, kb)
                yield
                bars["bf"][sb % K11_SB].arrive(TRANSPOSERS)
                bars["re"][sr % K11_SR].arrive(TRANSPOSERS)
                sr += 1
                sb += 1

    def consumer():
        sa = bc = bbase = 0
        for t in range(t0, t1):
            if load_b(t):
                bbase, bc = bc, bc + nk
            rel = release_b(t)
            for kb in range(nk):
                yield from _wait(bars["af"][sa % K11_SA], (sa // K11_SA) % 2)
                c = bbase + kb
                yield from _wait(bars["bf"][c % K11_SB], (c // K11_SB) % 2)
                assert a[sa % K11_SA] == (t, kb)
                assert slot[c % K11_SB] == (t // tiles_m, kb)
                yield  # the step's products (released one step late)
                assert a[sa % K11_SA] == (t, kb)
                assert slot[c % K11_SB] == (t // tiles_m, kb)
                bars["ae"][sa % K11_SA].arrive()
                if rel:
                    bars["be"][c % K11_SB].arrive()
                sa += 1

    _run([tma(), transposer(), consumer(), consumer()],
         [b for v in bars.values() for b in v], seed)


@pytest.mark.parametrize("tiles_m,t0,t1,nk", [
    (52, 0, 8, 6),      # B/16's QKV: 936 tiles over 132 blocks, K = 768
    (52, 47, 55, 6),    # a range across two panels
    (3, 0, 7, 8),       # three panels, slots exactly full
    (2, 1, 6, 40),      # streamed: fc2's K = 5120
    (1, 0, 3, 9),       # streamed, one row tile a panel
])
def test_k11_protocol_has_no_deadlock_or_reuse(tiles_m, t0, t1, nk):
    for seed in range(3):
        _k11_protocol(tiles_m, t0, t1, nk, seed)


# ------------------------------------------------------------------ K12 --


def k12_layout(t: int) -> dict:
    """``mq::Layout`` of D = 128 t (mlp_i8_wgmma.cuh)."""
    c = {"T": t, "P": (t + 1) // 2}
    c["NP"] = -(-c["P"] // PAIRS)
    c["hq"] = t * HALF
    c["w1"] = c["hq"] + 4 * HALF
    boxes = (SMEM_MAX - 1024 - _CONSTS["k12_kTail"] - c["w1"]) // BOX
    s1, s2 = _CONSTS["k12_kS1"], _CONSTS["k12_kS2"]
    c["S1"], c["S2"] = s1, s2
    c["SR"] = min(_CONSTS["k12_kSRMax"], boxes - 2 * s1 - s2)
    c["w2"] = c["w1"] + 2 * s1 * BOX
    c["raw"] = c["w2"] + s2 * BOX
    c["pmax"] = c["raw"] + c["SR"] * BOX
    c["bar"] = c["pmax"] + 2048 + 256
    c["smem"] = c["bar"] + 256 + 1024
    return c


def pass_pairs(c: dict, q: int) -> range:
    return range(PAIRS * q, min(c["P"], PAIRS * (q + 1)))


@pytest.mark.parametrize("d", range(128, MLP_I8_MAX_D + 1, 128))
def test_k12_budgets_fit_every_admitted_width(d):
    """Every geometry ``ops.mlp_q_plan`` admits (D a multiple of 128 up to
    1280): the layout under 227 KB, every box 1024-byte aligned, the
    barriers in their bytes, every output box in exactly one pass and one
    warpgroup, and the consumer's live sums (96 fp32 and fc1's 64 int32)
    inside its setmaxnreg share; K11's layout too."""
    assert ops.mlp_q_plan(d, 4 * d) and ops.mlp_q_plan(d, GROUP)
    assert not ops.mlp_q_plan(d, 4 * d + 128)
    c = k12_layout(d // 128)
    assert c["smem"] <= SMEM_MAX and c["SR"] >= 2
    for off in ("hq", "w1", "w2", "raw", "pmax"):
        assert c[off] % 1024 == 0
    assert (2 * 2 * c["S1"] + 2 * c["S2"] + 2 * _CONSTS["k12_kSRMax"] + 2
            + 2) * 8 <= 256
    boxes = [2 * p + w for q in range(c["NP"]) for p in pass_pairs(c, q)
             for w in range(2) if 2 * p + w < c["T"]]
    assert sorted(boxes) == list(range(c["T"]))
    assert 32 * PAIRS + 64 + 32 <= _CONSTS["kConsumerRegs"]
    assert (256 * _CONSTS["kConsumerRegs"] + 128 * _CONSTS["kProducerRegs"]
            <= 65536)
    k11 = (K11_SA + K11_SR + K11_SB) * BOX + 256 + 1024
    assert k11 <= SMEM_MAX and 2 * (K11_SA + K11_SR + K11_SB) * 8 <= 256


def k12_model(x, g, b, w1q, s1, b1, w2q, s2, b2, *, partial=False):
    """K12's tile for fp32 or bf16 ``x`` (M, D): per cluster of 64 rows,
    xq and ax as the kernel's LN pass computes them (here
    ``reference.quantize_rows``, so that the model isolates the rest); the
    fp32 sums seeded with x + b2 (zero for the partial form) in each
    block's boxes; per group and pass, each block's warpgroups compute
    their 128 fc1 columns (int32 through the layouts above), h in float32
    in the kernel's order, the partial row maxima of the four warpgroups,
    ah, the codes into both blocks' hq tiles, and fc2 box by box, added in
    float32 in ascending group order; one cast."""
    m, d = x.shape
    t, mlp = d // 128, w1q.shape[1]
    c = k12_layout(t)
    xq, ax = reference.quantize_rows(x, ln_scale=g, ln_bias=b, eps=EPS)
    xq, ax = xq.numpy(), ax.numpy()[:, 0]
    x32, b2_32 = x.float().numpy(), b2.float().numpy()
    b1_32, s1n, s2n = b1.float().numpy(), s1.numpy(), s2.numpy()
    w1n, w2n = w1q.numpy(), w2q.numpy()
    out = np.zeros((m, d), np.float32)
    for m0 in range(0, m, 64):
        rows = min(64, m - m0)
        xq_t = np.zeros((64, d), np.int8)
        xq_t[:rows] = xq[m0:m0 + rows]
        ax_t = np.zeros(64, np.float32)
        ax_t[:rows] = ax[m0:m0 + rows]
        xtile = np.zeros(64 * d, np.uint8)
        r, cc = np.meshgrid(np.arange(64), np.arange(d), indexing="ij")
        xtile[store_addr(r, cc)] = xq_t.view(np.uint8)
        for q in range(c["NP"]):
            # acc[(rank, box)]: 64 rows x 64 columns.
            acc = {}
            for rank in range(2):
                for p in pass_pairs(c, q):
                    for w in range(2):
                        box = 2 * p + w
                        if box >= t:
                            continue
                        cols = slice(rank * d // 2 + 64 * box,
                                     rank * d // 2 + 64 * box + 64)
                        seed = np.zeros((64, 64), np.float32)
                        if not partial:
                            seed[:rows] = (x32[m0:m0 + rows, cols]
                                           + b2_32[cols])
                        acc[rank, box] = seed
            for grp in range(mlp // GROUP):
                h, pmax = {}, {}
                for rank in range(2):
                    for w in range(2):
                        h0 = GROUP * grp + 256 * rank + 128 * w
                        a1 = np.zeros((64, 128), np.int64)
                        for kb in range(t):
                            kmaj = transpose_box(tma_box(w1n, kb * BK, h0))
                            for kk in range(BK // 32):
                                a = desc_read(xtile, kb * HALF + 32 * kk, 64)
                                bb = desc_read(kmaj, 32 * kk, 128)
                                a1 += a.astype(np.int64) @ bb.astype(
                                    np.int64).T
                        pre = ((a1.astype(np.float32) * ax_t[:, None])
                               * s1n[h0:h0 + 128]) + b1_32[h0:h0 + 128]
                        hv = reference.gelu(torch.from_numpy(pre)).numpy()
                        h[rank, w] = hv
                        pmax[rank, w] = np.abs(hv).max(axis=1)
                amax = np.maximum.reduce([pmax[k] for k in sorted(pmax)])
                ah = (np.maximum(amax, np.float32(1e-12)) / np.float32(127))
                ah = ah.astype(np.float32)
                hq = np.zeros(64 * GROUP, np.uint8)
                for (rank, w), hv in h.items():
                    codes = np.clip(np.rint(hv / ah[:, None]), -127, 127)
                    r, cc = np.meshgrid(np.arange(64),
                                        256 * rank + 128 * w + np.arange(128),
                                        indexing="ij")
                    hq[store_addr(r, cc)] = codes.astype(np.int8).view(
                        np.uint8)
                for (rank, box), sums in acc.items():
                    pair_col = rank * d // 2 + 128 * (box // 2)
                    a2 = np.zeros((64, 64), np.int64)
                    for ks in range(GROUP // BK):
                        kmaj = transpose_box(tma_box(
                            w2n, GROUP * grp + BK * ks, pair_col))
                        for kk in range(BK // 32):
                            a = desc_read(hq, ks * HALF + 32 * kk, 64)
                            bb = desc_read(kmaj, (box % 2) * HALF + 32 * kk,
                                           64)
                            a2 += a.astype(np.int64) @ bb.astype(np.int64).T
                    col0 = rank * d // 2 + 64 * box
                    assert np.abs(a2).max() < 2 ** 24
                    acc[rank, box] = sums + (
                        (a2.astype(np.float32) * ah[:, None])
                        * s2n[col0:col0 + 64])
            for (rank, box), sums in acc.items():
                col0 = rank * d // 2 + 64 * box
                out[m0:m0 + rows, col0:col0 + 64] = sums[:rows]
    return torch.from_numpy(out).to(x.dtype)


def _k12_inputs(rng, m, d, mlp, dtype):
    def f(*shape, std=1.0, mean=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std + mean).astype(np.float32))
    w1, w2 = quantize_weight(f(d, mlp, std=.03)), quantize_weight(
        f(mlp, d, std=.03))
    return (f(m, d, std=1.5, mean=.2).to(dtype),
            f(d, std=.1, mean=1.).to(dtype), f(d, std=.05).to(dtype),
            w1["q"], w1["scale"], f(mlp, std=.02).to(dtype), w2["q"],
            w2["scale"], f(d, std=.02).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,mlp,partial", [
    (70, 256, 1024, False),    # two clusters, the second ragged
    (33, 384, 512, True),      # an odd pair (T = 3): a padding box
    (20, 1152, 512, False),    # two passes (T = 9)
])
def test_k12_epilogue_order_is_bit_for_bit(dtype, m, d, mlp, partial):
    rng = np.random.default_rng(m + d + mlp)
    args = _k12_inputs(rng, m, d, mlp, dtype)
    got = k12_model(*args, partial=partial)
    want = reference.mlp_block_i8dot(*args, eps=EPS, partial_out=partial)
    assert torch.equal(got, want)


def _k12_protocol(t: int, ngroups: int, seed: int) -> None:
    """K12's barriers for one cluster: per block the TMA thread, the
    transposers, both consumer warpgroups (thread 0 of the first issues
    the hq copy after the 256 consumers' named barrier). Every ring slot,
    partial-maximum slot and hq box carries a tag of what was last
    written there; each reader asserts its tag when its wait passes and
    when it is done, so a wait passing on a phase two ahead, or a write
    into a buffer still read, fails."""
    c = k12_layout(t)
    s1n, s2n, srn = c["S1"], c["S2"], c["SR"]
    nbox = [(ring, w, grp, q, i) for q in range(c["NP"])
            for grp in range(ngroups)
            for ring, w, i in ([(0, w, kb) for kb in range(t) for w in (0, 1)]
                               + [(1, 0, (p, ks)) for p in pass_pairs(c, q)
                                  for ks in range(GROUP // BK)])]
    blocks = []
    for _ in range(2):
        blocks.append({
            "w1f": [[_Barrier(TRANSPOSERS) for _ in range(s1n)]
                    for _ in range(2)],
            "w1e": [[_Barrier(1) for _ in range(s1n)] for _ in range(2)],
            "w2f": [_Barrier(TRANSPOSERS) for _ in range(s2n)],
            "w2e": [_Barrier(2) for _ in range(s2n)],
            "rf": [_Barrier(1) for _ in range(srn)],
            "re": [_Barrier(TRANSPOSERS) for _ in range(srn)],
            # 32 writers a consumer warpgroup, four warpgroups
            "mx": [_Barrier(128) for _ in range(2)],
            "hfull": _Barrier(256 + 1), "hempty": _Barrier(4),
            "named": [0],
            "w1": [[None] * s1n for _ in range(2)], "w2": [None] * s2n,
            "raw": [None] * srn, "pmax": [{}, {}], "hq": {}})
    bars = []
    for blk in blocks:
        bars += blk["w1f"][0] + blk["w1f"][1] + blk["w1e"][0] + blk["w1e"][1]
        bars += blk["w2f"] + blk["w2e"] + blk["rf"] + blk["re"] + blk["mx"]
        bars += [blk["hfull"], blk["hempty"]]

    def tma(blk):
        for i, item in enumerate(nbox):
            yield from _wait(blk["re"][i % srn], (i // srn) % 2 ^ 1)
            blk["rf"][i % srn].arrive(tx=1)
            yield
            blk["raw"][i % srn] = item
            blk["rf"][i % srn].complete_tx(1)

    def transposer(blk):
        n1, n2 = [0, 0], 0
        for i, item in enumerate(nbox):
            yield from _wait(blk["rf"][i % srn], (i // srn) % 2)
            assert blk["raw"][i % srn] == item
            ring, w = item[0], item[1]
            if ring == 0:
                s = n1[w]
                yield from _wait(blk["w1e"][w][s % s1n], (s // s1n) % 2 ^ 1)
                blk["w1"][w][s % s1n] = item
                yield
                blk["w1f"][w][s % s1n].arrive(TRANSPOSERS)
                n1[w] += 1
            else:
                yield from _wait(blk["w2e"][n2 % s2n], (n2 // s2n) % 2 ^ 1)
                blk["w2"][n2 % s2n] = item
                yield
                blk["w2f"][n2 % s2n].arrive(TRANSPOSERS)
                n2 += 1
            blk["re"][i % srn].arrive(TRANSPOSERS)

    def consumer(rank, w):
        blk, peer = blocks[rank], blocks[rank ^ 1]
        n1 = n2 = gw = 0
        for q in range(c["NP"]):
            for grp in range(ngroups):
                for kb in range(t):
                    s = n1 % s1n
                    yield from _wait(blk["w1f"][w][s], (n1 // s1n) % 2)
                    assert blk["w1"][w][s] == (0, w, grp, q, kb)
                    yield  # the wgmma group
                    assert blk["w1"][w][s] == (0, w, grp, q, kb)
                    blk["w1e"][w][s].arrive()
                    n1 += 1
                gb = gw % 2
                for b in blocks:
                    b["pmax"][gb][rank, w] = gw
                    b["mx"][gb].arrive(32)
                yield from _wait(blk["mx"][gb], (gw // 2) % 2)
                assert blk["pmax"][gb] == {(r, v): gw for r in (0, 1)
                                           for v in (0, 1)}
                if gw >= 1:
                    yield from _wait(blk["hempty"], (gw - 1) % 2)
                blk["hq"][rank, w] = gw
                blk["hfull"].arrive(128)
                blk["named"][0] += 1
                while blk["named"][0] < 2 * (gw + 1):  # bar.sync 3, 256
                    yield
                if w == 0:  # thread 0: the copy into the other block
                    peer["hfull"].arrive(tx=1)
                    yield
                    for v in (0, 1):
                        assert blk["hq"][rank, v] == gw
                        peer["hq"][rank, v] = gw
                    peer["hfull"].complete_tx(1)
                yield from _wait(blk["hfull"], gw % 2)
                for p in pass_pairs(c, q):
                    for ks in range(GROUP // BK):
                        s = n2 % s2n
                        yield from _wait(blk["w2f"][s], (n2 // s2n) % 2)
                        assert blk["w2"][s] == (1, 0, grp, q, (p, ks))
                        assert blk["hq"] == {(r, v): gw for r in (0, 1)
                                             for v in (0, 1)}
                        yield
                        assert blk["w2"][s] == (1, 0, grp, q, (p, ks))
                        blk["w2e"][s].arrive()
                        n2 += 1
                assert blk["hq"] == {(r, v): gw for r in (0, 1)
                                     for v in (0, 1)}
                for b in blocks:
                    b["hempty"].arrive()
                gw += 1

    agents = [f(blk) for blk in blocks for f in (tma, transposer)]
    agents += [consumer(r, w) for r in (0, 1) for w in (0, 1)]
    _run(agents, bars, seed)


@pytest.mark.parametrize("d", [128, 384, 768, 1024, 1280])
@pytest.mark.parametrize("ngroups", [1, 3, 6])
def test_k12_group_protocol_has_no_deadlock_or_reuse(d, ngroups):
    """The rings, the maxima and the hq exchange at one pair, an odd pair,
    B/16's three pairs (6 groups: mlp 3072), L/16's and H/14's two passes
    (the raw ring 3 and 2 deep there), in three interleavings each."""
    for seed in range(3):
        _k12_protocol(d // 128, ngroups, seed)
