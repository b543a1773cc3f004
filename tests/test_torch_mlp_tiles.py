"""K3's bf16 ``wgmma`` tile (``vit_tpu_torch/csrc/mlp_wgmma.cuh``) on the
CPU.

CUDA kernels do not run here, so the tile's walk is modelled in this file
(not in the package) and held to the functions its plain version is held
to: ``reference.mlp_block`` and JAX's Pallas ``mlp_block`` in interpret
mode (``vit_tpu/ops/pallas/block.py:190``, as ``tests/test_torch_ops.py``
runs it). The model follows the kernel through a byte-addressed model of
shared memory with the hardware's 128-byte swizzle:

- a cluster of two blocks owns 64 rows; both write LN(x) of the rows,
  rounded to the dtype, in 16-byte chunks into D/64 swizzled boxes;
- the MLP columns go in chunks of 128; block r computes chunk columns
  [64r, 64r + 64) of fc1 in k16 steps read through the K-major A
  descriptor and the N-major B descriptor of a TMA box of W1, adds b1,
  applies GELU, rounds, and writes the slice from its accumulator
  fragments into the chunk's h buffer, which is then copied into the
  other block's;
- each block's two consumer warpgroups run ceil(T/2) boxes each of 64
  output columns of the block's D/2 (D = 128 T; where T is odd the
  second's last box reads padding and is not stored), seeded with
  x + b2 (zero in the partial form), and add h @ W2 chunk by chunk in
  ascending order, k16 slice by k16 slice, read through the descriptors
  of KS2-row W2 stages; one cast at the end.

It also checks the fragment -> swizzled-address map of h (a bijection
onto fc2's A tile) and the shared-memory and register budgets of every
geometry ``ops.mlp_plan`` admits in bf16.

Bars: fp32 max|diff| <= 1e-5 (sum order only); bf16 |diff| <= 2e-2 *
(1 + |ref|), the kernel bar.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas import block as pallas_block
from vit_tpu_torch import ops
from vit_tpu_torch.ops import reference

HEADER = (Path(__file__).resolve().parents[1] / "vit_tpu_torch" / "csrc"
          / "mlp_wgmma.cuh").read_text()
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
EPS = 1e-12


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


BM, CT, BOX = _const("kBM"), _const("kCT"), _const("kBox")
SMEM_MAX, BAR_BYTES = _const("kSmemMax"), _const("kBarBytes")
THREADS = _const("kThreads")
CONSUMER_REGS, PRODUCER_REGS = _const("kConsumerRegs"), _const("kProducerRegs")
HC = CT // 2  # a block's share of a chunk
K16 = 16      # the wgmma depth


def cfg(d: int) -> dict:
    """``mw::Cfg<T>`` for D = 128 T: passes, boxes a warpgroup, the W2
    stage, the ring depths and the shared-memory layout."""
    t = d // 128
    c = {"T": t, "NP": 2 if t >= 7 else 1, "S2": 2}
    c["BP"] = -(-t // c["NP"])
    c["NB"] = -(-c["BP"] // 2)
    c["xn"] = d // 64 * BOX
    c["h"] = 2 * 2 * BOX
    c["w1_off"] = c["xn"] + c["h"]
    free = SMEM_MAX - 1024 - BAR_BYTES - c["w1_off"]
    c["KS2"] = 32 if free >= 2 * 32 * 128 * 2 * c["NB"] + 4 * BOX else 16
    c["box2"] = c["KS2"] * 128
    c["stage2"] = c["box2"] * 2 * c["NB"]  # padded to both warpgroups' boxes
    c["S1"] = min((free - c["S2"] * c["stage2"]) // BOX, 8)
    c["w2_off"] = c["w1_off"] + c["S1"] * BOX
    c["bar_off"] = c["w2_off"] + c["S2"] * c["stage2"]
    c["smem"] = c["bar_off"] + BAR_BYTES + 1024
    c["ldc"] = 64 * c["NB"] + 8
    return c


def pass_boxes(c: dict, q: int) -> int:
    """The block's boxes in pass q."""
    return min(c["BP"], c["T"] - q * c["BP"])


def real_boxes(c: dict, q: int, wg: int) -> int:
    """``Cfg::boxes``: warpgroup wg's real boxes in pass q."""
    return max(0, min(c["NB"], pass_boxes(c, q) - wg * c["NB"]))


def swizzle(addr):
    """The 128-byte swizzle on shared-memory byte addresses (atoms 1024-byte
    aligned): 16-byte chunk j of 128-byte row i lands at chunk j ^ (i % 8)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def a_desc(start: int, rows: int = BM):
    """Byte addresses read by a K-major A descriptor with 128-byte swizzle
    (start, SBO 1024): element (row, k) of a 64 x 16 k16 slice."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(K16)[None, :]
    return swizzle(start + (r // 8) * 1024 + (r % 8) * 128 + 2 * k)


def b_desc(start: int, lbo: int, n: int):
    """Byte addresses read by an N-major B descriptor with 128-byte swizzle
    (start, LBO between 64-column boxes, SBO 1024): element (k, col) of a
    16 x n k16 slice."""
    k = torch.arange(K16)[:, None]
    c = torch.arange(n)[None, :]
    return swizzle(start + (c // 64) * lbo + (k // 8) * 1024 + (k % 8) * 128
                   + 2 * (c % 64))


def tma_box(rows: int):
    """Byte offsets TMA writes element (row, col) of a rows x 64 box to."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(64)[None, :]
    return swizzle(r * 128 + 2 * c)


def frag(n: int):
    """Row and column of accumulator value 4j + i of thread t of a
    warpgroup's m64nN fragment, as (128, n/2) tensors."""
    t = torch.arange(128)[:, None]
    v = torch.arange(n // 2)[None, :]
    warp, lane, j, i = t // 32, t % 32, v // 4, v % 4
    return (16 * warp + lane // 4 + 8 * (i // 2),
            8 * j + 2 * (lane % 4) + i % 2)


def h_store_addr(wg: int):
    """Byte offsets in an h box (64 rows x the block's 64 chunk columns)
    that warpgroup ``wg``'s threads store their m64n32 fc1 values to, as
    the kernel computes them: a pair (4j + 2hh, 4j + 2hh + 1) as 4 bytes at
    row * 128 + (((4 wg + j) ^ (lane / 4)) * 16) + 4 * (lane % 4), value
    4j + i at + 2 (i % 2)."""
    t = torch.arange(128)[:, None]
    v = torch.arange(16)[None, :]
    warp, lane, j, i = t // 32, t % 32, v // 4, v % 4
    row = 16 * warp + lane // 4 + 8 * (i // 2)
    return (row * 128 + (((4 * wg + j) ^ (lane // 4)) * 16)
            + 4 * (lane % 4) + 2 * (i % 2))


def ln_store_addr(d: int):
    """Byte offsets ``ln_rows`` writes element (row, k) of LN(x) to: 16-byte
    chunk ch of row r at box ch / 8, r * 128 + ((ch % 8) ^ (r % 8)) * 16."""
    r = torch.arange(BM)[:, None]
    k = torch.arange(d)[None, :]
    ch = k // 8
    return (ch // 8) * BOX + r * 128 + ((ch % 8) ^ (r % 8)) * 16 + 2 * (k % 8)


class Smem:
    """A block's shared memory as bf16 or fp32 elements at 2-byte
    granularity (the model stores each element in the slot of its bf16
    address, whatever its dtype)."""

    def __init__(self, nbytes: int, dtype: torch.dtype):
        self.mem = torch.full((nbytes // 2,), float("nan"), dtype=dtype)

    def write(self, addr, values):
        assert (addr % 2 == 0).all()
        self.mem[(addr // 2).reshape(-1)] = values.reshape(-1).to(
            self.mem.dtype)

    def read(self, addr):
        return self.mem[addr // 2]


def _gelu_round(pre: torch.Tensor, dtype) -> torch.Tensor:
    return reference.gelu(pre).to(dtype)


def k3_tiles(x, g, b, w1, b1, w2, b2, *, partial: bool = False):
    """``mlp_bf16_wgmma``'s walk on x (M, D): returns (M, D) in x.dtype."""
    m, d = x.shape
    mlp = w1.shape[1]
    dtype = x.dtype
    c = cfg(d)
    assert d % 128 == 0 and mlp % CT == 0
    nchunks = mlp // CT
    out = torch.empty((m, d), dtype=dtype)
    written = torch.zeros((m, d), dtype=torch.int32)
    ln_addr = ln_store_addr(d)
    h_addr = [h_store_addr(wg) for wg in range(2)]
    fr, fc = frag(32)
    w1_box = tma_box(64)
    w2_box = tma_box(c["KS2"])
    nb = c["NB"]
    for m0 in range(0, m, BM):
        rows = min(BM, m - m0)
        blocks = [Smem(c["smem"], dtype) for _ in range(2)]
        # LN(x), zeros past m, in both blocks.
        xn = torch.zeros((BM, d), dtype=dtype)
        xn[:rows] = reference.layernorm(x[m0:m0 + rows], g, b, eps=EPS)
        for blk in blocks:
            blk.write(ln_addr, xn)
        for q in range(c["NP"]):
            # Warpgroup wg runs NB boxes from the pass's box wg * NB; `real`
            # of them are the block's (the second's last one is padding
            # where the pass has an odd count).
            accs = {}
            for rank in range(2):
                for wg in range(2):
                    real = real_boxes(c, q, wg)
                    col0 = rank * d // 2 + 64 * (q * c["BP"] + nb * wg)
                    acc = torch.zeros((BM, 64 * nb), dtype=torch.float32)
                    if not partial:
                        acc[:rows, :64 * real] = (
                            x[m0:m0 + rows, col0:col0 + 64 * real].float()
                            + b2[col0:col0 + 64 * real].float())
                    accs[rank, wg] = (col0, nb * wg, real, acc)
            for ci in range(nchunks):
                gi = q * nchunks + ci  # the chunk's place in the walk
                h_base = c["xn"] + (gi % 2) * 2 * BOX
                # fc1: block r's 64 chunk columns, K-step by K-step (a TMA
                # box of W1 into the ring), warpgroup wg the box's columns
                # [32 wg, 32 wg + 32) (its descriptor 64 bytes in), k16
                # slice by k16 slice.
                for rank, blk in enumerate(blocks):
                    h0 = ci * CT + rank * HC
                    pre = [torch.zeros((BM, 32), dtype=torch.float32)
                           for _ in range(2)]
                    for kb in range(d // 64):
                        qs = gi * (d // 64) + kb
                        stage = c["w1_off"] + (qs % c["S1"]) * BOX
                        blk.write(stage + w1_box, w1[kb * 64:kb * 64 + 64,
                                                     h0:h0 + HC])
                        for wg in range(2):
                            for kk in range(4):
                                a = blk.read(a_desc(kb * BOX + kk * 32))
                                bm = blk.read(b_desc(
                                    stage + 64 * wg + kk * 2048, BOX, 32))
                                pre[wg] += a.float() @ bm.float()
                    for wg in range(2):
                        cols = slice(h0 + 32 * wg, h0 + 32 * wg + 32)
                        hv = _gelu_round(pre[wg] + b1[cols].float(), dtype)
                        # The fragment values land in this block's h box.
                        blk.write(h_base + rank * BOX + h_addr[wg],
                                  hv[fr, fc])
                # Each block's box is copied, byte for byte, into the
                # other's.
                for rank in range(2):
                    box = slice((h_base + rank * BOX) // 2,
                                (h_base + rank * BOX + BOX) // 2)
                    blocks[rank ^ 1].mem[box] = blocks[rank].mem[box]
                # fc2: each warpgroup, its boxes, the chunk's KS2-row
                # stages of the pass's boxes.
                for (rank, wg), (col0, b0, real, acc) in accs.items():
                    blk = blocks[rank]
                    for ks in range(CT // c["KS2"]):
                        qs = gi * (CT // c["KS2"]) + ks
                        stage = c["w2_off"] + (qs % c["S2"]) * c["stage2"]
                        r0 = ci * CT + ks * c["KS2"]
                        for p in range(pass_boxes(c, q)):
                            cb = rank * d // 2 + 64 * (q * c["BP"] + p)
                            blk.write(stage + p * c["box2"] + w2_box,
                                      w2[r0:r0 + c["KS2"], cb:cb + 64])
                        for kk in range(c["KS2"] // K16):
                            kg = ks * (c["KS2"] // K16) + kk
                            a = blk.read(a_desc(h_base + (kg // 4) * BOX
                                                + (kg % 4) * 32)).float()
                            bm = blk.read(b_desc(stage + b0 * c["box2"]
                                                 + kk * 2048, c["box2"],
                                                 64 * nb)).float()
                            acc += a @ bm
            for (rank, wg), (col0, b0, real, acc) in accs.items():
                cols = 64 * real
                out[m0:m0 + rows, col0:col0 + cols] = \
                    acc[:rows, :cols].to(dtype)
                written[m0:m0 + rows, col0:col0 + cols] += 1
    assert (written == 1).all()
    return out


def _inputs(rng, m, d, mlp, dtype):
    arrays = (1.5 * rng.standard_normal((m, d)) + 0.2,
              1 + 0.1 * rng.standard_normal(d), 0.05 * rng.standard_normal(d),
              0.03 * rng.standard_normal((d, mlp)),
              0.02 * rng.standard_normal(mlp),
              0.03 * rng.standard_normal((mlp, d)),
              0.02 * rng.standard_normal(d))
    jd, td = DTYPES[dtype]
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(td) for a in arrays]
    j = [jnp.asarray(np.asarray(a, np.float32), jd) for a in arrays]
    return t, j


def _close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-5, diff.max()
    else:
        assert (diff <= 2e-2 * (1 + np.abs(want))).all(), diff.max()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [64, 33])
def test_k3_tiles_match_reference_and_pallas_small(dtype, m):
    """d = 128, mlp = 256 (T = 1: the second warpgroup owns no columns),
    where no tuned entry exists; one ragged block at m = 33."""
    t, j = _inputs(np.random.default_rng(31), m, 128, 256, dtype)
    got = k3_tiles(*t)
    _close(got, reference.mlp_block(*t, eps=EPS), dtype)
    _close(got, pallas_block.mlp_block(*j, eps=EPS, interpret=True), dtype)


def test_k3_tiles_b16_fp32_every_hidden_column(monkeypatch):
    """(208, 768, 3072) fp32 with the plan pinned to the whole hidden
    (``tests/test_torch_mlp_pin.py``, ROADMAP C1): the walk computes every
    hidden column."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    t, j = _inputs(np.random.default_rng(41), 208, 768, 3072, "float32")
    got = k3_tiles(*t)
    _close(got, reference.mlp_block(*t, eps=EPS), "float32")
    _close(got, pallas_block.mlp_block(*j, eps=EPS, interpret=True),
           "float32")


@pytest.mark.parametrize("m,d,mlp", [(70, 1024, 256), (70, 384, 256),
                                     (33, 896, 128)])
def test_k3_tiles_split_widths_bf16(m, d, mlp):
    """D = 1024 (KS2 = 16, four boxes a warpgroup), and the odd box counts
    (D = 384: two and one; 896: four and three), ragged M."""
    t, _ = _inputs(np.random.default_rng(d + m), m, d, mlp, "bfloat16")
    _close(k3_tiles(*t), reference.mlp_block(*t, eps=EPS), "bfloat16")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mlp", [1536, 768])
def test_k3_tiles_partial_form(dtype, mlp):
    """The tensor-parallel shard form at B/16's mlp / 2 and / 4: zero seed,
    b2 not read (NaN here), ragged M."""
    t, j = _inputs(np.random.default_rng(mlp), 70, 768, mlp, dtype)
    t[6] = torch.full_like(t[6], float("nan"))
    got = k3_tiles(*t, partial=True)
    _close(got, reference.mlp_block(*t, eps=EPS, partial_out=True), dtype)
    if dtype == "float32":
        _close(got, pallas_block.mlp_block(*j, eps=EPS, interpret=True,
                                           partial_out=True), dtype)


def test_k3_tiles_rows_do_not_depend_on_m():
    """A row's result is the same bits at M = 33 and M = 200 (no sum runs
    over rows; the ragged block's extra rows are zeros)."""
    t, _ = _inputs(np.random.default_rng(5), 200, 256, 256, "bfloat16")
    whole = k3_tiles(*t)
    assert torch.equal(k3_tiles(t[0][:33], *t[1:]), whole[:33])


def test_h_fragment_map_is_a_bijection_onto_the_a_tile():
    """The stores of both warpgroups' m64n32 fc1 fragments (256 threads,
    16 values each) cover the block's 8 KB h box once each, and every value
    lands where fc2's K-major A descriptor reads its (row, chunk
    column)."""
    addr = torch.cat([h_store_addr(wg) for wg in range(2)])
    assert sorted(addr.reshape(-1).tolist()) == list(range(0, BOX, 2))
    fr, fc = frag(32)
    want = torch.full((BM, HC), -1, dtype=torch.int64)
    for kk in range(HC // K16):
        want[:, kk * K16:(kk + 1) * K16] = a_desc(kk * 32)
    for wg in range(2):
        assert torch.equal(h_store_addr(wg), want[fr, fc + 32 * wg])


def test_ln_store_map_matches_the_a_descriptor():
    """``ln_rows``' 16-byte chunk stores put LN(x) where fc1's descriptors
    read it, for every admitted width."""
    for d in range(128, 1025, 128):
        addr = ln_store_addr(d)
        want = torch.cat([a_desc(kb * BOX + kk * 32)
                          for kb in range(d // 64) for kk in range(4)], 1)
        assert torch.equal(addr, want)
        assert sorted(addr.reshape(-1).tolist()) == \
            list(range(0, d // 64 * BOX, 2))


@pytest.mark.parametrize("d", range(128, 1025, 128))
def test_budgets_fit_every_admitted_width(d):
    """Every bf16 geometry ``ops.mlp_plan`` admits (D a multiple of 128 up
    to 1024, any mlp multiple of 128): shared memory under 227 KB with two
    W1 and two W2 stages at least, the output staging inside the LN(x)
    region, the barriers in their bytes, every region 1024-byte aligned
    for the swizzle, and the consumer's live accumulators (fc2's 32 per
    64-column box, fc1's 32, the 16 packed h words) well inside its
    setmaxnreg share."""
    for mlp in (128, 256, 4 * d):
        assert ops.mlp_plan(d, mlp, torch.bfloat16)
    assert not ops.mlp_plan(d + 64, 4 * d, torch.bfloat16)
    c = cfg(d)
    assert c["smem"] <= SMEM_MAX
    assert c["S1"] >= 4 and c["S2"] >= 2
    assert (2 * c["S1"] + 2 * c["S2"] + 8) * 8 <= BAR_BYTES
    staging = 64 * (c["ldc"] + 64 * real_boxes(c, c["NP"] - 1, 1) + 8) * 2
    assert staging <= c["xn"]
    for off in (c["xn"], c["w1_off"], c["w2_off"], c["stage2"], c["box2"]):
        assert off % 1024 == 0
    assert sum(pass_boxes(c, q) for q in range(c["NP"])) == c["T"]
    assert all(real_boxes(c, q, 0) + real_boxes(c, q, 1) == pass_boxes(c, q)
               for q in range(c["NP"]))
    # fc2's sums and fc1's: at four boxes (128 a thread) ptxas gave both
    # the same registers, so no width runs more than three.
    assert c["NB"] <= 3
    assert 32 * c["NB"] + 16 + 8 <= CONSUMER_REGS - 48
    assert 256 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536
    assert THREADS == 384


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


def _protocol(d: int, chunks: int, order_seed: int) -> None:
    """Run the kernel's barrier protocol (``mlp_bf16_wgmma``: the W1 and
    W2 producer threads, the h copier and both consumer warpgroups of the
    two blocks of a cluster) under a seeded random interleaving. Every ring stage and h
    slice carries the tag of what was last written into it; a consumer
    asserts the tag it expects when its wait passes and again when it
    releases, so a wait that passes on a phase two ahead, or a write into
    a buffer still read, fails; a state where no agent can move is a
    deadlock."""
    c = cfg(d)
    s1, s2, ks_n, kb_n = c["S1"], c["S2"], CT // c["KS2"], d // 64
    walk = c["NP"] * chunks  # the chunks over all passes
    blocks = [{"w1f": [_Barrier(1) for _ in range(s1)],
               "w1e": [_Barrier(2) for _ in range(s1)],
               "w2f": [_Barrier(1) for _ in range(s2)],
               "w2e": [_Barrier(2) for _ in range(s2)],
               "hfull": [_Barrier(256 + 1) for _ in range(2)],
               "hempty": [_Barrier(2) for _ in range(2)],
               "hready": [_Barrier(256) for _ in range(2)],
               "hdone": [_Barrier(2) for _ in range(2)],
               "w1": [None] * s1, "w2": [None] * s2,
               "h": [{}, {}]} for _ in range(2)]

    def producer(blk, ring, stages, steps, tag):
        for q in range(walk * steps):
            st = q % stages
            while not blk[ring + "e"][st].passed((q // stages) % 2 ^ 1):
                yield
            blk[ring][st] = (tag, q // steps, q % steps)
            blk[ring + "f"][st].arrive(tx=1)
            blk[ring + "f"][st].complete_tx(1)

    def wait_stage(blk, ring, stages, q, want):
        st = q % stages
        while not blk[ring + "f"][st].passed((q // stages) % 2):
            yield
        assert blk[ring][st] == want

    def consumer(rank, wg):
        # fc1(ci)'s K-steps two at a time (one group over two W1 stages),
        # the pair at kb >= 2 followed by the fc2(ci - 1) stages up to
        # kb * ks_n / kb_n, the rest after the last pair; h(ci - 1) is
        # waited for just before its first stage. Each group is waited
        # for, then its stages released.
        blk = blocks[rank]
        whole = {(r, w): None for r in range(2) for w in range(2)}
        for qp in range(c["NP"]):
            for ci in range(chunks + 1):
                g = qp * chunks + ci  # the chunk's place in the walk
                hb = (g - 1) % 2
                f1, f2 = ci < chunks, ci >= 1
                groups = []
                ks = 0
                for kb in range(0, kb_n if f1 else 0, 2):
                    groups.append([("w1", s1, g * kb_n + k, ("w1", g, k))
                                   for k in (kb, kb + 1)])
                    while f2 and kb >= 2 and ks < kb * ks_n // kb_n:
                        groups.append([("w2", s2, (g - 1) * ks_n + ks,
                                        ("w2", g - 1, ks))])
                        ks += 1
                while f2 and ks < ks_n:
                    groups.append([("w2", s2, (g - 1) * ks_n + ks,
                                    ("w2", g - 1, ks))])
                    ks += 1
                for group in groups:
                    for ring, stages, q, tag in group:
                        if ring == "w2" and tag[2] == 0:
                            while not blk["hfull"][hb].passed(
                                    (g - 1) // 2 % 2):
                                yield
                            assert blk["h"][hb] == dict.fromkeys(whole,
                                                                 g - 1)
                        yield from wait_stage(blk, ring, stages, q, tag)
                    yield  # the group runs (wgmma_wait<0>)
                    for ring, stages, q, tag in group:
                        assert blk[ring][q % stages] == tag
                        blk[ring + "e"][q % stages].arrive()
                if f2:
                    assert blk["h"][hb] == dict.fromkeys(whole, g - 1)
                    blk["hdone"][hb].arrive()
                if f1:
                    hb = g % 2
                    if g >= 2:
                        while not blk["hempty"][hb].passed((g - 2) // 2 % 2):
                            yield
                    blk["h"][hb][rank, wg] = g
                    blk["hfull"][hb].arrive(128)
                    blk["hready"][hb].arrive(128)

    def copier(rank):
        # Once both warpgroups are done with h(ci - 1), free its buffer in
        # both blocks; then the block's slice of h(ci) into the other
        # block's buffer: an arrival with the bytes to come, then the
        # bytes.
        blk, peer = blocks[rank], blocks[rank ^ 1]
        for ci in range(walk + 1):
            if ci >= 1:
                hb = (ci - 1) % 2
                while not blk["hdone"][hb].passed((ci - 1) // 2 % 2):
                    yield
                for other in blocks:
                    other["hempty"][hb].arrive()
            if ci == walk:
                break
            hb = ci % 2
            while not blk["hready"][hb].passed(ci // 2 % 2):
                yield
            if ci >= 2:
                while not blk["hempty"][hb].passed((ci - 2) // 2 % 2):
                    yield
            peer["hfull"][hb].arrive(tx=1)
            yield  # the copy is in flight
            for wg in range(2):
                assert blk["h"][hb][rank, wg] == ci
                peer["h"][hb][rank, wg] = ci
            peer["hfull"][hb].complete_tx(1)

    agents = [g for blk in blocks for g in (
        producer(blk, "w1", s1, kb_n, "w1"),
        producer(blk, "w2", s2, ks_n, "w2"))]
    agents += [copier(r) for r in range(2)]
    agents += [consumer(r, w) for r in range(2) for w in range(2)]
    rng = np.random.default_rng(order_seed)
    keys = ("w1f", "w1e", "w2f", "w2e", "hfull", "hempty", "hready",
            "hdone")
    idle = 0
    while agents:
        a = agents[rng.integers(len(agents))]
        before = [(b.phases, b.pending) for blk in blocks for k in keys
                  for b in blk[k]]
        try:
            next(a)
        except StopIteration:
            agents.remove(a)
            idle = 0
            continue
        after = [(b.phases, b.pending) for blk in blocks for k in keys
                 for b in blk[k]]
        idle = 0 if after != before else idle + 1
        assert idle < 50 * len(agents) + 1000, "deadlock"


@pytest.mark.parametrize("d", range(128, 1025, 128))
@pytest.mark.parametrize("chunks", [1, 3, 24])
def test_barrier_protocol_has_no_deadlock_or_reuse(d, chunks):
    """The rings, h buffers and cluster barriers at every admitted width
    (one to eight 64-column boxes a block; 768 is B/16's, 1024 L/16's),
    over one, three and 24 chunks (B/16's mlp 3072), in three
    interleavings each."""
    for seed in range(3):
        _protocol(d, chunks, seed)
