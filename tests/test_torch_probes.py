"""The port's three probes (``vit_tpu_torch/tools/``) against the JAX
package's (``tools/``), each plain version against its Pallas kernel in
interpret mode at a tiny size:

- ``int8_probe``: the plain dot of K22 against ``pallas_dot``, int8 bit for
  bit, bf16 within 1e-5 relative; K12's refusal of the JAX probe's
  mlp=256;
- ``attn_core_probe``: every one of the 18 modes of ``probe`` at B=2,
  sp=32, seq_len=27, D=64, 4 heads, group 1 and 2, in fp32 (1e-5) and bf16
  (the kernel bar, 2e-2 * (1 + |ref|), mean 3e-3; ``qcore`` within one
  int8 step of its codes);
- ``encstack_minrepro``: every variant of ``make_variant``, with and
  without ``@flat``, in fp32 (1e-5; ``dma`` equal to x bit for bit), and
  ``full`` (``ops.encoder_stack``) against JAX's ``encoder_stack`` with
  ``VIT_TPU_STACK_PLAN`` pinned on the JAX side.

The JAX probes take no ``interpret=`` flag (but ``pallas_dot``): their
``pl.pallas_call`` is wrapped with ``interpret=True`` through
``monkeypatch``. Importing two of them sets JAX's persistent compilation
cache; the loader puts the settings back right after the import, before
anything compiles.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vit_tpu_torch import ops
from vit_tpu_torch.tools import attn_core_probe, encstack_minrepro, int8_probe

ROOT = Path(__file__).resolve().parents[1]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")
_loaded = {}


def _jax_tool(name: str, monkeypatch):
    """``tools/<name>.py`` as a module, imported once with JAX's cache
    settings and ``JAX_COMPILATION_CACHE_DIR`` put back right after."""
    if name not in _loaded:
        saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
        with monkeypatch.context() as mp:
            mp.setenv("JAX_COMPILATION_CACHE_DIR", "")
            spec = importlib.util.spec_from_file_location(
                f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            try:
                spec.loader.exec_module(mod)
            finally:
                for k, v in saved.items():
                    jax.config.update(k, v)
        _loaded[name] = mod
    return _loaded[name]


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode."""
    real = pl.pallas_call

    def call(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)
    monkeypatch.setattr(pl, "pallas_call", call)
    return monkeypatch


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got: torch.Tensor, want, dtype: str, *, fp32_bar: float = 1e-5):
    g, w = got.float().numpy(), _np(want)
    assert g.shape == w.shape
    assert np.isfinite(g).all()
    diff = np.abs(g - w)
    if dtype == "float32":
        assert diff.max() <= fp32_bar, diff.max()
    else:
        assert (diff <= 2e-2 * (1 + np.abs(w))).all(), diff.max()
        assert diff.mean() <= 3e-3, diff.mean()


# ------------------------------------------------------------ int8_probe --

def test_torch_int8_probe_dot_matches_pallas_int8_bit_for_bit(monkeypatch):
    jt = _jax_tool("int8_probe", monkeypatch)
    rng = np.random.default_rng(0)
    for m, k, n in ((128, 128, 128), (40, 200, 72)):
        x = rng.integers(-127, 128, (m, k)).astype(np.int8)
        w = rng.integers(-127, 128, (k, n)).astype(np.int8)
        want = np.asarray(jt.pallas_dot(jnp.asarray(x), jnp.asarray(w),
                                        jnp.int32, interpret=True))
        got = int8_probe.dot(torch.from_numpy(x), torch.from_numpy(w))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_torch_int8_probe_dot_matches_pallas_bf16(monkeypatch):
    """bf16 operands, fp32 sums: within 1e-5 relative."""
    jt = _jax_tool("int8_probe", monkeypatch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    want = _np(jt.pallas_dot(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16), jnp.float32,
                             interpret=True))
    got = int8_probe.dot(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_torch_int8_probe_dot_checks_operands():
    x = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        int8_probe.dot(x, torch.zeros((8, 4)))
    with pytest.raises(ValueError):
        int8_probe.dot(x, torch.zeros((4, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        int8_probe.dot(x, torch.zeros((8, 4), dtype=torch.int8),
                       impl="cuda")


def test_torch_int8_probe_k12_refuses_the_jax_probes_mlp_256():
    """JAX compile-checks ``mlp_block_i8dot`` at d=128, mlp=256; the port's
    K12 takes whole 512-column quant groups, so the probe runs mlp=512 and
    refuses 256."""
    assert not ops.mlp_q_plan(128, 256) and ops.mlp_q_plan(128, 512)
    with pytest.raises(ValueError, match="512-column"):
        int8_probe.mlp_i8dot_tiny("cpu", d=128, mlp=256, m=16)
    out = int8_probe.mlp_i8dot_tiny("cpu", d=128, mlp=512, m=16)
    assert out.shape == (1, 16, 128) and torch.isfinite(out).all()


def test_torch_int8_probe_main_on_cpu(capsys):
    assert int8_probe.main(["--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"int8_dot": true' in last and '"int8_ms": null' in last


# ------------------------------------------------------- attn_core_probe --

B, SP, SEQ, D, HEADS = 2, 32, 27, 64, 4


def _jax_probe(jt, mode, inputs, dtype, group):
    """JAX's ``probe`` on the same numbers (xcore on (D, B*SP))."""
    x, *w = (jnp.asarray(t.float().numpy(), JDT[dtype]) for t in inputs)
    if mode == "xcore":
        x = x.reshape(B * SP, D).T
    return jt.probe(mode, x, *w, num_heads=HEADS, seq_len=SEQ, group=group,
                    shape=(B, SP, D))


def _qcore_close(got: torch.Tensor, want, inputs, dtype):
    """qcore: within one int8 step of its codes
    (``attn_core_probe.qcore_step``; bf16 plus the kernel bar)."""
    step = attn_core_probe.qcore_step(*inputs[:6], num_heads=HEADS)
    g, w = got.float().numpy(), _np(want)
    bar = step + (2e-2 * (1 + np.abs(w)) if dtype == "bfloat16" else 1e-5)
    assert np.isfinite(g).all()
    assert (np.abs(g - w) <= bar).all(), (np.abs(g - w).max(), step)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(attn_core_probe.MODES))
def test_torch_attn_core_probe_matches_pallas(mode, dtype, group,
                                              interpret):
    jt = _jax_tool("attn_core_probe", interpret)
    inputs = attn_core_probe.make_inputs(B, SP, D, SEQ, getattr(torch, dtype))
    want = _jax_probe(jt, mode, inputs, dtype, group)
    x, *w = inputs
    if mode == "xcore":
        x = x.reshape(B * SP, D).t().contiguous()
    got = attn_core_probe.probe(mode, x, *w, num_heads=HEADS, seq_len=SEQ,
                                group=group, shape=(B, SP, D))
    assert got.dtype == x.dtype
    if mode == "qcore":
        _qcore_close(got, want, inputs, dtype)
    else:
        _close(got, want, dtype)


def test_torch_attn_core_probe_function_modes_agree():
    """kt, addmask, vsum and xcore compute full's function (vsum and the
    reciprocal modes within rounding); tcore rounds once more."""
    inputs = attn_core_probe.make_inputs(B, SP, D, SEQ, torch.float32)
    x, *w = inputs
    kw = dict(num_heads=HEADS, seq_len=SEQ)
    full = attn_core_probe.probe("full", x, *w, **kw)
    assert torch.equal(attn_core_probe.probe("kt", x, *w, **kw), full)
    for mode in ("addmask", "vsum", "tcore"):
        torch.testing.assert_close(attn_core_probe.probe(mode, x, *w, **kw),
                                   full, rtol=0, atol=1e-5)
    xt = x.reshape(B * SP, D).t().contiguous()
    got = attn_core_probe.probe("xcore", xt, *w, shape=(B, SP, D), **kw)
    torch.testing.assert_close(got.t().reshape(B, SP, D), full, rtol=0,
                               atol=1e-5)


def test_torch_attn_core_probe_checks_its_arguments():
    inputs = attn_core_probe.make_inputs(B, SP, D, SEQ, torch.float32)
    x, *w = inputs
    with pytest.raises(ValueError, match="group"):
        attn_core_probe.probe("full", x, *w, num_heads=HEADS, seq_len=SEQ,
                              group=3)
    with pytest.raises(ValueError, match="unknown mode"):
        attn_core_probe.probe("nope", x, *w, num_heads=HEADS, seq_len=SEQ)
    with pytest.raises(ValueError, match="xcore takes"):
        attn_core_probe.probe("xcore", x, *w, num_heads=HEADS, seq_len=SEQ)
    with pytest.raises(ValueError, match="even"):
        attn_core_probe.probe("wide", x, *w, num_heads=1, seq_len=SEQ)


def test_torch_attn_core_probe_launch_table():
    """Every mode's launches: K1 and two K2 around one core launch, but
    for the layout modes and projonly, whose GEMMs are K23's."""
    packed = {"layernorm": 1, "matmul": 2, "attn_core_probe": 1}
    special = {"projonly": {"layernorm": 1, "attn_core_probe": 1,
                            "matmul": 1},
               "kt": {"layernorm": 1, "attn_core_probe": 2, "matmul": 1},
               "tcore": {"layernorm": 1, "attn_core_probe": 3},
               "xcore": {"attn_core_probe": 4}}
    for mode in attn_core_probe.MODES:
        assert attn_core_probe.launches(mode) == special.get(mode, packed)
    # wide's core fits at B/16's 208 tokens in both dtypes (fp32 on K4's
    # tf32 tile: K and V, 219,648 bytes); in fp32 not at 224.
    assert attn_core_probe.core_smem_bytes(208, 128, 4, "wide") == 219648
    assert attn_core_probe.core_smem_bytes(224, 128, 4, "wide") > 232448
    assert attn_core_probe.core_smem_bytes(208, 128, 2) <= 232448
    assert attn_core_probe.core_smem_bytes(208, 64, 4) <= 232448


def test_torch_attn_core_probe_main_on_cpu(capsys):
    assert attn_core_probe.main(
        ["--device", "cpu", "--batch", "2", "--sp", "32", "--seq-len", "27",
         "-D", "64", "--heads", "4", "--group", "2", "--modes", "full",
         "xcore", "wide"]) == 0
    assert '"modes": {}' in capsys.readouterr().out.strip().splitlines()[-1]


# ----------------------------------------------------- encstack_minrepro --

SB, SSP, SD, SMLP, SL, SHEADS = 2, 16, 64, 128, 2, 4


def _stack_inputs(dtype="float32", d=SD, mlp=SMLP):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((SB * SSP, d)) * 0.05).astype(np.float32)
    w = [a.float().numpy() for a in encstack_minrepro.make_weights(
        SL, d, mlp, torch.float32, rng=rng)]
    t = getattr(torch, dtype)
    return ((jnp.asarray(x, JDT[dtype]),
             *(jnp.asarray(a, JDT[dtype]) for a in w)),
            (torch.from_numpy(x).to(t), *(torch.from_numpy(a).to(t)
                                          for a in w)))


@pytest.mark.parametrize("flat", ["", "@flat"])
@pytest.mark.parametrize("variant", list(encstack_minrepro.VARIANTS))
def test_torch_encstack_variant_matches_pallas(variant, flat, interpret):
    """Each stripped variant of K24 against ``make_variant`` in fp32 at
    b=2, sp=16, d=64, mlp=128, L=2 (cq=64, mt=64: three QKV and two MLP
    chunks on the JAX side)."""
    jt = _jax_tool("encstack_minrepro", interpret)
    jin, tin = _stack_inputs()
    kw = dict(b=SB, sp=SSP, d=SD, mlp=SMLP, L=SL, cq=64, mt=64,
              heads=SHEADS)
    want = jt.make_variant(variant + flat, dtype=jnp.float32, **kw)(*jin)
    got = encstack_minrepro.make_variant(variant + flat,
                                         dtype=torch.float32, **kw)(*tin)
    if variant == "dma":
        assert torch.equal(got, tin[0])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, "float32")


def test_torch_encstack_chunks_change_only_the_sum_order(interpret):
    """On the JAX side, (cq, mt) change only the fp32 order of the sums:
    the same variant under two chunkings agrees within fp32 rounding, so
    the port's one tiling stands for every pair."""
    jt = _jax_tool("encstack_minrepro", interpret)
    jin, _ = _stack_inputs()
    kw = dict(b=SB, sp=SSP, d=SD, mlp=SMLP, L=SL, heads=SHEADS,
              dtype=jnp.float32)
    for variant in ("lnqkv", "core"):
        a = _np(jt.make_variant(variant, cq=64, mt=64, **kw)(*jin))
        b = _np(jt.make_variant(variant, cq=192, mt=128, **kw)(*jin))
        assert 0 < np.abs(a).max() and np.abs(a - b).max() <= 1e-6


def test_torch_encstack_full_matches_pallas_encoder_stack(monkeypatch):
    """``full`` is K9, ``ops.encoder_stack``, on the probe's weights (unit
    LN, zero biases, no key masked), against JAX's ``encoder_stack`` with
    its plan pinned by ``VIT_TPU_STACK_PLAN`` (set on the JAX side only) at
    d=128, a width JAX's plan takes."""
    from vit_tpu.ops.pallas import block as jax_block

    d, mlp = 128, 256
    jin, tin = _stack_inputs(d=d, mlp=mlp)
    fn = encstack_minrepro.make_variant(
        "full", b=SB, sp=SSP, d=d, mlp=mlp, L=SL, cq=128, mt=128,
        dtype=torch.float32, heads=SHEADS)
    got = fn(*tin)
    f32 = jnp.float32
    enc = {"ln1": {"scale": jnp.ones((SL, d), f32),
                   "bias": jnp.zeros((SL, d), f32)},
           "qkv": {"kernel": jin[1], "bias": jnp.zeros((SL, 3 * d), f32)},
           "out": {"kernel": jin[2], "bias": jnp.zeros((SL, d), f32)},
           "ln2": {"scale": jnp.ones((SL, d), f32),
                   "bias": jnp.zeros((SL, d), f32)},
           "fc1": {"kernel": jin[3], "bias": jnp.zeros((SL, mlp), f32)},
           "fc2": {"kernel": jin[4], "bias": jnp.zeros((SL, d), f32)}}
    monkeypatch.setenv("VIT_TPU_STACK_PLAN", "128,128")
    want = jax_block.encoder_stack(jin[0].reshape(SB, SSP, d), enc,
                                   num_heads=SHEADS, seq_len=SSP,
                                   interpret=True)
    _close(got, want.reshape(SB * SSP, d), "float32")


def test_torch_encstack_dma_weight_sums():
    """``dma``'s kept sums: a (layer, tensor) table equal to numpy's
    float64 sums within the check's bar, which fails a stream that skips
    one layer of one tensor or a 64th of a tensor."""
    _, (x, *ws) = _stack_inputs()
    fn = encstack_minrepro.make_variant(
        "dma", b=SB, sp=SSP, d=SD, mlp=SMLP, L=SL, cq=64, mt=64,
        dtype=torch.float32, heads=SHEADS)
    with pytest.raises(RuntimeError, match="no dma call"):
        fn.weight_sums()
    assert torch.equal(fn(x, *ws), x)
    got = fn.weight_sums()
    want = np.stack([w.double().numpy().sum((1, 2)) for w in ws], 1)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=1e-5)
    assert encstack_minrepro.check_weight_sums(got, *ws) <= 1e-5
    for bad in (got * torch.tensor([[1.0], [0.0]]),  # layer 1 skipped
                got - torch.stack([w[:, :, ::64].float().sum((1, 2))
                                   for w in ws], 1)):
        with pytest.raises(AssertionError, match="weight sums"):
            encstack_minrepro.check_weight_sums(bad, *ws)


def test_torch_encstack_variant_checks():
    with pytest.raises(ValueError, match="unknown variant"):
        encstack_minrepro.parse_variant("full@flat")
    with pytest.raises(ValueError, match="cq"):
        encstack_minrepro.make_variant("dma", b=1, sp=16, d=64, mlp=128, L=1,
                                       cq=100, mt=64, dtype=torch.float32)
    assert encstack_minrepro.parse_variant("core@flat") == "core"


def test_torch_encstack_main_on_cpu(capsys):
    assert encstack_minrepro.main(
        ["--device", "cpu", "--cases", "1,192,64", "--variants", "dma",
         "lnqkv@flat", "core", "full", "--sp", "16", "-d", "64", "--mlp",
         "128", "--heads", "4", "-L", "2", "--dtype", "float32"]) == 0
    assert '"rows": []' in capsys.readouterr().out.strip().splitlines()[-1]
