"""The port's int8 tier (``vit_tpu_torch/quant.py``) against the JAX
package's (``vit_tpu/quant.py``).

One set of float weights, made from a seed, is quantized by both packages;
the JAX int8 pytree, carried across with ``params_from_numpy``, feeds the
port. The JAX Pallas kernels run in interpret mode, with their plans pinned
through the environment (nothing in the JAX package changes):

- ``VIT_TPU_MLP_PLAN="0,1,512"`` makes JAX's hidden quant group 512, the
  port's fixed group;
- ``VIT_TPU_STACK_PLAN="8,8"`` (infeasible) turns JAX's stack route off.

Bars, by relative norm ``|got - want| / |want|``, since a code can flip at
a .5 boundary where two LN sum orders differ: fp32 <= 1e-3, bf16 <= 2e-2
(``tests/test_quant.py:183``). A whole fp32 forward on the per-layer route
quantizes activations four times a layer, and one flipped code there moves
the result by about 1e-3 at this width (1.6e-3 measured, one flip in layer
1's attention half, where the two kernels on the same input differ by
1.3e-3 at most): whole forwards are held to 5e-3 in fp32. ``-s`` prints
the measured values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops.dispatch as jax_dispatch
from vit_tpu import quant as jax_quant
from vit_tpu.config import VARIANTS as JAX_VARIANTS
from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.models import vit as jax_vit
from vit_tpu.ops.pallas import block as jax_block
from vit_tpu_torch import ops, quant
from vit_tpu_torch.config import VARIANTS, ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.serving import Predictor
from vit_tpu_torch.weights.convert import params_from_numpy

TINY = dict(image_size=32, patch_size=16, hidden_dim=128, num_heads=4,
            num_layers=2, mlp_dim=512)
DTYPES = ["float32", "bfloat16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
REL_BAR = {"float32": 1e-3, "bfloat16": 2e-2}
FORWARD_REL_BAR = {"float32": 5e-3, "bfloat16": 2e-2}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _rel(got, want, label: str, capsys) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    with capsys.disabled():
        print(f"\n[int8] {label}: rel {rel:.3e}")
    return rel


def _close(got, want, dtype: str, label: str, capsys, bars=REL_BAR) -> None:
    rel = _rel(got, want, f"{label} {dtype}", capsys)
    assert rel <= bars[dtype], rel


def _models(dtype, **kw):
    """JAX config and float params with non-trivial LN and biases, the JAX
    int8 params, and the port's config and those int8 params carried
    across."""
    jcfg = JaxConfig(**TINY, dtype=JDT[dtype], **kw)
    tcfg = ViTConfig(**TINY, dtype=getattr(torch, dtype), **kw)
    jparams = jax_vit.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype),
        jparams)
    jq = jax_quant.quantize_params(jparams)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    return jcfg, jparams, jq, tcfg, tq


def _pair(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _qpair(rng, *shape, std=0.05):
    """A quantized weight from both packages: JAX's, and JAX's carried
    across."""
    w = jax_quant.quantize_weight(
        jnp.asarray(std * rng.standard_normal(shape), jnp.float32))
    return w, {k: torch.from_numpy(np.array(v)) for k, v in w.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_quantize_params_bit_equal_to_jax(dtype):
    """``quantize_params`` of the same float weights gives JAX's q and
    scale bit for bit; the carried-across JAX int8 params equal the port's
    own; LN scales keep ``cfg.dtype``."""
    _, jparams, jq, tcfg, tq = _models(dtype)
    tfloat = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                               device="cpu")
    mine = quant.quantize_params(tfloat)
    for name in quant.QUANTIZED:
        for part, dt in (("q", torch.int8), ("scale", torch.float32)):
            got = mine["encoder"][name]["kernel"][part]
            assert got.dtype == dt
            assert torch.equal(got, tq["encoder"][name]["kernel"][part])
            assert np.array_equal(
                got.numpy(), np.asarray(jq["encoder"][name]["kernel"][part]))
        assert mine["encoder"][name]["bias"].dtype == tcfg.dtype
    for ln in ("ln1", "ln2"):
        assert tq["encoder"][ln]["scale"].dtype == tcfg.dtype
    assert tq["ln_final"]["scale"].dtype == tcfg.dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", [None, "gelu"])
def test_torch_int8_matmul_matches_jax(dtype, activation, capsys):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 96))
    x[1, 5:9] = 0  # zero rows (sequence padding) stay finite
    jx, tx = _pair(x, dtype)
    jw, tw = _qpair(rng, 96, 64, std=1.0)
    jb, tb = _pair(rng.standard_normal(64), dtype)
    want = jax_quant.int8_matmul(jx, jw, jb, activation)
    got = quant.int8_matmul(tx, tw, tb, activation)
    assert got.dtype == tx.dtype
    _close(got, want, dtype, f"int8_matmul {activation}", capsys)
    zeros = quant.int8_matmul(torch.zeros_like(tx), tw)
    assert torch.equal(zeros, torch.zeros_like(zeros))


def _block_weights(rng, d, mlp, dtype):
    """JAX's and the port's arguments of ``attn_block_q`` (after x) and
    ``mlp_block_i8dot`` (after x), from one numpy seed."""
    vec = lambda n, s=0.1, m=0.0: _pair(m + s * rng.standard_normal(n), dtype)
    out = {"j": {}, "t": {}}
    for half, spec in (("attn", ("ln", (d, 3 * d), 3 * d, (d, d), d)),
                       ("mlp", ("ln", (d, mlp), mlp, (mlp, d), d))):
        (jg, tg), (jbe, tbe) = vec(d, m=1.0), vec(d)
        jw1, tw1 = _qpair(rng, *spec[1])
        jb1, tb1 = vec(spec[2])
        jw2, tw2 = _qpair(rng, *spec[3])
        jb2, tb2 = vec(spec[4])
        out["j"][half] = (jg, jbe, jw1["q"], jw1["scale"], jb1, jw2["q"],
                          jw2["scale"], jb2)
        out["t"][half] = (tg, tbe, tw1["q"], tw1["scale"], tb1, tw2["q"],
                          tw2["scale"], tb2)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3])
def test_torch_attn_block_q_matches_pallas(dtype, b, capsys):
    """Masked keys: 13 real tokens of 16."""
    rng = np.random.default_rng(3 + b)
    sp, d, nh, seq = 16, 128, 4, 13
    x = rng.standard_normal((b, sp, d))
    x[:, seq:] = 0
    jx, tx = _pair(x, dtype)
    w = _block_weights(rng, d, 512, dtype)
    want = jax_block.attn_block_q(jx, *w["j"]["attn"], num_heads=nh,
                                  seq_len=seq, interpret=True)
    got = ops.attn_block_q(tx, *w["t"]["attn"], num_heads=nh, seq_len=seq)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got[:, :seq], want[:, :seq], dtype, f"attn_block_q b={b}", capsys)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mlp", [512, 1024])
def test_torch_mlp_block_i8dot_matches_pallas(dtype, mlp, monkeypatch,
                                              capsys):
    """One and two quant groups of 512 hidden columns."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    rng = np.random.default_rng(5)
    d = 128
    jx, tx = _pair(rng.standard_normal((2, 16, d)), dtype)
    w = _block_weights(rng, d, mlp, dtype)
    want = jax_block.mlp_block_i8dot(jx, *w["j"]["mlp"], interpret=True)
    got = ops.mlp_block_i8dot(tx, *w["t"]["mlp"])
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got, want, dtype, f"mlp_block_i8dot mlp={mlp}", capsys)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mlp", [512, 1024])
def test_torch_mlp_block_q_matches_pallas(dtype, mlp, monkeypatch, capsys):
    """The weight-only int8 MLP, JAX's plan pinned to chunks of 512 hidden
    columns (the port's chunk): one and two chunks. Nothing is quantized
    but the weights, so only the sum order differs: fp32 to 2e-5."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    rng = np.random.default_rng(7)
    d = 128
    jx, tx = _pair(rng.standard_normal((2, 16, d)), dtype)
    w = _block_weights(rng, d, mlp, dtype)
    want = jax_block.mlp_block_q(jx, *w["j"]["mlp"], interpret=True)
    got = ops.mlp_block_q(tx, *w["t"]["mlp"])
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got, want, dtype, f"mlp_block_q mlp={mlp}", capsys,
           {"float32": 2e-5, "bfloat16": 2e-2})
    if dtype == "float32":
        assert np.abs(_np(got) - _np(want)).max() <= 2e-5


def test_torch_mlp_block_i8dot_needs_whole_groups():
    rng = np.random.default_rng(6)
    w = _block_weights(rng, 128, 256, "float32")["t"]["mlp"]
    with pytest.raises(ValueError, match="quant group"):
        ops.mlp_block_i8dot(torch.zeros(4, 128), *w)
    cfg = ViTConfig(**dict(TINY, mlp_dim=256))
    with pytest.raises(ValueError, match="quant group"):
        quant.forward_quant({}, torch.zeros(1, 3, 32, 32), cfg)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 2])
def test_torch_encoder_stack_q_matches_pallas(dtype, b, capsys):
    _, _, jq, _, tq = _models(dtype)
    x = np.random.default_rng(b).standard_normal((b, 16, 128))
    x[:, 5:] = 0
    jx, tx = _pair(x, dtype)
    kw = dict(num_heads=4, scale=32 ** -0.5, seq_len=5, eps=1e-12)
    want = jax_block.encoder_stack_q(jx, jq["encoder"], interpret=True, **kw)
    got = ops.encoder_stack_q(tx, tq["encoder"], **kw)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    _close(got[:, :5], want[:, :5], dtype, f"encoder_stack_q b={b}", capsys)


def _spy(monkeypatch, names):
    """Count the calls of each op in ``names`` (they still run)."""
    calls = {}
    for name in names:
        def spy(*a, _name=name, _fn=getattr(ops, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    return calls


ROUTE_OPS = ("embed_fused", "encoder_stack_q", "attn_block_q",
             "mlp_block_i8dot", "layernorm")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["stack", "layers"])
def test_torch_forward_quant_matches_jax_pallas(dtype, route, monkeypatch,
                                                capsys):
    """Both routes, with the plans patched on both sides: the port's
    ``forward_quant`` against JAX ``forward_quant(impl="pallas")`` on the
    same int8 params, and against JAX ``impl="xla"`` at rel < 2e-2."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    if route == "layers":
        monkeypatch.setenv("VIT_TPU_STACK_PLAN", "8,8")
    monkeypatch.setattr(ops, "stack_q_plan", lambda *a: route == "stack")
    jcfg, _, jq, tcfg, tq = _models(dtype)
    px = np.random.default_rng(8).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    want = jax_quant.forward_quant(jq, jnp.asarray(px, jcfg.dtype), jcfg,
                                   impl="pallas")
    xla = jax_quant.forward_quant(jq, jnp.asarray(px, jcfg.dtype), jcfg,
                                  impl="xla")
    calls = _spy(monkeypatch, ROUTE_OPS)
    got = quant.forward_quant(tq, torch.from_numpy(px), tcfg, impl="torch")
    assert calls == ({"embed_fused": 1, "encoder_stack_q": 1, "layernorm": 1}
                     if route == "stack" else
                     {"embed_fused": 1, "attn_block_q": 2,
                      "mlp_block_i8dot": 2, "layernorm": 1})
    assert got.shape == (2, tcfg.seq_len, 128) and got.dtype == tcfg.dtype
    _close(got, want, dtype, f"forward_quant {route} vs pallas", capsys,
           FORWARD_REL_BAR)
    assert _rel(got, xla, f"forward_quant {route} {dtype} vs xla",
                capsys) < 2e-2


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_forward_quant_weight_only_mlp_matches_jax(dtype, monkeypatch,
                                                         capsys):
    """``int8_dot=False`` on the per-layer route against JAX
    ``forward_quant(impl="pallas")`` with ``VIT_TPU_INT8_DOT=0`` (its
    weight-only ``mlp_block_q``), set inside this test only."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    monkeypatch.setenv("VIT_TPU_STACK_PLAN", "8,8")
    monkeypatch.setenv("VIT_TPU_INT8_DOT", "0")
    monkeypatch.setattr(ops, "stack_q_plan", lambda *a: False)
    jcfg, _, jq, tcfg, tq = _models(dtype)
    px = np.random.default_rng(8).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    want = jax_quant.forward_quant(jq, jnp.asarray(px, jcfg.dtype), jcfg,
                                   impl="pallas")
    calls = _spy(monkeypatch, ROUTE_OPS + ("mlp_block_q",))
    got = quant.forward_quant(tq, torch.from_numpy(px), tcfg, int8_dot=False)
    assert calls == {"embed_fused": 1, "attn_block_q": 2, "mlp_block_q": 2,
                     "layernorm": 1}
    assert got.shape == (2, tcfg.seq_len, 128) and got.dtype == tcfg.dtype
    _close(got, want, dtype, "forward_quant int8_dot=False vs pallas", capsys,
           FORWARD_REL_BAR)
    dot = quant.forward_quant(tq, torch.from_numpy(px), tcfg)
    assert not torch.equal(got, dot)  # another MLP kernel ran


def test_torch_quant_predictor_weight_only_mlp():
    """``Predictor(quant=True, int8_dot=False)``: a request of 5 on buckets
    (1, 4) equals its bucket forwards of ``forward_quant(int8_dot=False)``
    bit for bit."""
    _, _, _, tcfg, _ = _models("float32", num_classes=8)
    params = vit.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    pred = Predictor(params, tcfg, buckets=(1, 4), device="cpu", quant=True,
                     int8_dot=False)
    px = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (5, 3, 32, 32)).astype(np.float32))
    out = pred(px)
    qp = quant.quantize_params(params)
    fwd = quant.make_forward_quant(tcfg, int8_dot=False)
    assert torch.equal(out, torch.cat([fwd(qp, px[:4]), fwd(qp, px[4:])]))
    assert not torch.equal(out, Predictor(params, tcfg, buckets=(1, 4),
                                          device="cpu", quant=True)(px))


def test_torch_forward_quant_close_to_float_forward(capsys):
    """fp32, with a head: the int8 logits stay within the bars of
    ``tests/test_quant.py:95-96`` of the float forward's."""
    jcfg, jparams, _, tcfg, tq = _models("float32", num_classes=16)
    tfloat = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                               device="cpu")
    px = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 3, 32, 32)).astype(np.float32))
    got = quant.forward_quant(quant.quantize_params(tfloat), px, tcfg)
    assert torch.equal(got, quant.forward_quant(tq, px, tcfg))
    want = vit.forward(tfloat, px, tcfg)
    assert _rel(got, want, "forward_quant vs float forward", capsys) < 5e-2
    corr = np.corrcoef(_np(got).ravel(), _np(want).ravel())[0, 1]
    assert corr > 0.999, corr


BATCHES = (1, 2, 3, 4, 8)
S, L = "stack", "layers"
#: The port's int8 encoder route per variant and dtype at batch 1, 2, 3, 4,
#: 8. Every per-layer geometry runs the int8 kernels in both dtypes.
ROUTES_Q = {
    ("B/16", "float32"): (L, L, L, L, L),
    ("B/16", "bfloat16"): (S, L, L, L, L),
    ("B/32", "float32"): (L, L, L, L, L),
    ("B/32", "bfloat16"): (S, S, L, L, L),
    ("L/16", "float32"): (L, L, L, L, L),
    ("L/16", "bfloat16"): (S, L, L, L, L),
    ("L/16-384", "float32"): (L, L, L, L, L),
    ("L/16-384", "bfloat16"): (L, L, L, L, L),
    ("H/14", "float32"): (L, L, L, L, L),
    ("H/14", "bfloat16"): (L, L, L, L, L),
    ("DeiT-B/16", "float32"): (L, L, L, L, L),
    ("DeiT-B/16", "bfloat16"): (S, L, L, L, L),
}


def _jax_route_q(cfg, b: int) -> str:
    """JAX ``forward_quant(impl="pallas")``'s encoder route on the TPU."""
    it = jnp.dtype(cfg.dtype).itemsize
    sp = -(-cfg.seq_len // 16) * 16
    d, mlp, nh = cfg.hidden_dim, cfg.mlp_dim, cfg.num_heads
    if jax_block.encoder_stack_plan_q(b, sp, d, mlp, nh, it):
        return S
    attn = jax_block.attn_block_q_plan(b, sp, d, nh, it) is not None
    mlp_k = jax_block.mlp_block_plan_i8(b * sp, d, mlp, it) is not None
    return {(True, True): L, (False, True): "xla attention + mlp kernel"}[
        attn, mlp_k]


@pytest.mark.parametrize("variant,dtype", list(ROUTES_Q))
def test_torch_int8_route_table(variant, dtype, monkeypatch):
    """The port's int8 route at every variant, dtype and batch, beside
    JAX's on the TPU (interpret mode patched off). They agree except at
    L/16-384 fp32, where JAX's VMEM plan for ``attn_block_q`` refuses
    (over 22 MB) and composes the attention half through XLA; the port's
    attention is K7, which has no token limit, so it runs the int8
    kernels."""
    cfg = VARIANTS[variant].replace(dtype=getattr(torch, dtype))
    sp = vit._padded_seq(cfg)
    got = tuple(S if ops.stack_q_plan(b, sp, cfg.hidden_dim, cfg.mlp_dim,
                                      cfg.num_heads, cfg.dtype) else L
                for b in BATCHES)
    assert got == ROUTES_Q[variant, dtype]
    assert cfg.mlp_dim % 512 == 0
    monkeypatch.setattr(jax_dispatch, "interpret_mode", lambda *a: False)
    jcfg = JAX_VARIANTS[variant].replace(dtype=JDT[dtype])
    jax_routes = tuple(_jax_route_q(jcfg, b) for b in BATCHES)
    expect = list(got)
    if (variant, dtype) == ("L/16-384", "float32"):
        expect = ["xla attention + mlp kernel"] * len(BATCHES)
    assert jax_routes == tuple(expect)


def test_torch_smooth_params_matches_jax_and_is_float_identity(capsys):
    """fp32: the port's fold equals JAX's to the calibration's sum order,
    and leaves the float model's output unchanged."""
    jcfg, jparams, _, tcfg, _ = _models("float32")
    px = np.random.default_rng(10).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    tfloat = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                               device="cpu")
    tpx = torch.from_numpy(px)
    got = quant.smooth_params(tfloat, tcfg, tpx)
    want = jax_quant.smooth_params(jparams, jcfg, jnp.asarray(px))
    for ln, w in (("ln1", "qkv"), ("ln2", "fc1")):
        for t, k in ((ln, "scale"), (ln, "bias"), (w, "kernel")):
            g = got["encoder"][t][k]
            assert g.dtype == torch.float32
            assert _rel(g, want["encoder"][t][k], f"smooth {t}.{k}",
                        capsys) < 1e-5
    a = vit.forward(tfloat, tpx, tcfg)
    b = vit.forward(got, tpx, tcfg)
    assert float((a - b).abs().max()) <= 1e-4


def test_torch_quant_predictor_request_equals_bucket_forwards():
    """A request of 5 on buckets (1, 4) is one bs=4 forward and one bs=1
    forward of the int8 tier, bit for bit."""
    _, _, _, tcfg, _ = _models("float32", num_classes=8)
    params = vit.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    pred = Predictor(params, tcfg, buckets=(1, 4), device="cpu", quant=True)
    assert pred.params["encoder"]["fc1"]["kernel"]["q"].dtype == torch.int8
    px = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (5, 3, 32, 32)).astype(np.float32))
    out = pred(px)
    assert out.shape == (5, 8)
    qp = quant.quantize_params(params)
    want = torch.cat([quant.forward_quant(qp, px[:4], tcfg),
                      quant.forward_quant(qp, px[4:], tcfg)])
    assert torch.equal(out, want)


def test_torch_predictor_defaults_to_the_card():
    """Without ``device`` the Predictor serves on the card; on a machine
    without one it raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, _, tcfg, _ = _models("float32")
    params = vit.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    for kw in ({}, {"quant": True}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor(params, tcfg, **kw)
