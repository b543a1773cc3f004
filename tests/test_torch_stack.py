"""The port's small-batch route against the JAX package's.

``vit_tpu_torch/models/vit.py:forward`` embeds through ``embed_fused`` at
batch <= 4 and runs the whole encoder as one ``encoder_stack`` (or, with
patch embed and final LN folded in, ``encoder_stack_fused``) where
``ops.stack_plan`` says so, as ``vit_tpu/models/vit.py:forward`` does. Here:

- the three plain versions against the Pallas kernels in interpret mode at
  the tiny config (17 tokens padded to 32, 2 layers), batch 1 and 2;
- the port's ``forward`` with its stack plans patched on against JAX
  ``forward(impl="pallas")``, which takes the stack at the tiny config in
  interpret mode (its geometry gate only holds off the TPU);
- how far the fold's two rounding points put the fused form from the
  per-layer route, in bf16;
- the route table of every variant, dtype and batch size.

Bars: fp32 max|diff| <= 1e-4; bf16 |diff| <= 2e-2 * (1 + |ref|), the
Pallas bar of ``tests/test_torch_composed.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops as jax_ops
import vit_tpu.ops.dispatch as jax_dispatch
from vit_tpu.config import VARIANTS as JAX_VARIANTS
from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.models import vit as jax_vit
from vit_tpu.ops.pallas import patch_embed as pallas_patch_embed
from vit_tpu_torch import ops
from vit_tpu_torch.config import VARIANTS, ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.weights.convert import params_from_numpy

TINY = dict(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
            num_layers=2, mlp_dim=256)
DTYPES = ["float32", "bfloat16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _models(dtype, **kw):
    """JAX config and params, and the port's config and the same params,
    with non-trivial LN and biases."""
    jcfg = JaxConfig(**TINY, dtype=JDT[dtype], **kw)
    tcfg = ViTConfig(**TINY, dtype=getattr(torch, dtype), **kw)
    jparams = jax_vit.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype),
        jparams)
    return jcfg, jparams, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _pair(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _diff(got: torch.Tensor, want):
    """|got - want| and |want| as numpy arrays."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return np.abs(got - want), np.abs(want)


def _close(got: torch.Tensor, want, dtype: str) -> None:
    diff, ref = _diff(got, want)
    if dtype == "float32":
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert (diff <= 2e-2 * (1 + ref)).all(), diff.max()


def _patches_and_base(tcfg, tparams, b, seed=5):
    """Patches of ``b`` images and the fold's base rows, as the model
    builds them."""
    px = np.random.default_rng(seed).standard_normal(
        (b, 3, 32, 32)).astype(np.float32)
    patches = ops.patchify(torch.from_numpy(px).to(tcfg.dtype),
                           tcfg.patch_size)
    return patches, vit.fold_base(tparams, tcfg)


def _jax(t: torch.Tensor, dtype: str):
    return jnp.asarray(t.float().numpy(), JDT[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 2])
def test_torch_embed_fused_matches_pallas(dtype, b):
    rng = np.random.default_rng(b)
    n, k, d, sp = 16, 192, 128, 32
    arrays = (rng.standard_normal((b, n, k)), 0.05 * rng.standard_normal((k, d)),
              0.1 * rng.standard_normal(d), rng.standard_normal(d),
              rng.standard_normal((n, d)))
    j, t = zip(*(_pair(a, dtype) for a in arrays))
    want = pallas_patch_embed.embed_fused(*j, sp, interpret=True)
    got = ops.embed_fused(*t, sp)
    assert got.shape == (b, sp, d) and got.dtype == t[0].dtype
    assert not got[:, n + 1:].any()
    _close(got, want, dtype)


def test_torch_embed_fused_equals_composed_embed():
    """The fused embedding is the composed one zero-padded, bit for bit."""
    _, _, tcfg, tparams = _models("bfloat16")
    px = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 3, 32, 32)).astype(np.float32))
    fused = vit.embed(tparams, px, tcfg, sp=32)
    composed = vit.embed(tparams, px, tcfg)
    assert fused.shape == (3, 32, 128) and composed.shape == (3, 17, 128)
    assert torch.equal(fused[:, :17], composed)
    assert not fused[:, 17:].any()


def test_torch_embed_pads_where_the_fused_form_is_refused(monkeypatch):
    """At batch 8 ``embed_fused_ok`` refuses, and ``embed`` with ``sp``
    returns the composed embedding zero-padded to ``sp`` rows."""
    _, _, tcfg, tparams = _models("bfloat16")
    px = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 3, 32, 32)).astype(np.float32))
    composed = vit.embed(tparams, px, tcfg)
    calls = _spy(monkeypatch, ("embed_fused", "patch_embed"))
    padded = vit.embed(tparams, px, tcfg, sp=32)
    assert calls == {"patch_embed": 1}
    assert padded.shape == (8, 32, 128)
    assert torch.equal(padded[:, :17], composed)
    assert not padded[:, 17:].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 2])
def test_torch_encoder_stack_matches_pallas(dtype, b):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    x = np.random.default_rng(b).standard_normal((b, 32, 128))
    x[:, 17:] = 0
    jx, tx = _pair(x, dtype)
    kw = dict(num_heads=2, scale=64 ** -0.5, seq_len=17, eps=1e-12)
    want = jax_ops.encoder_stack(jx, jparams["encoder"], impl="pallas", **kw)
    got = ops.encoder_stack(tx, tparams["encoder"], **kw)
    assert got.shape == (b, 32, 128) and got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 2])
def test_torch_encoder_stack_fused_matches_pallas(dtype, b):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    patches, base = _patches_and_base(tcfg, tparams, b)
    kw = dict(num_heads=2, sp=32, scale=64 ** -0.5, seq_len=17, eps=1e-12)
    enc, wemb = tparams["encoder"], tparams["embeddings"]["patch_embed"]
    want = jax_ops.encoder_stack_fused(
        _jax(patches, dtype), jparams["encoder"],
        jparams["embeddings"]["patch_embed"]["kernel"], _jax(base, dtype),
        jparams["ln_final"], **kw)
    got = ops.encoder_stack_fused(patches, enc, wemb["kernel"], base,
                                  tparams["ln_final"], **kw)
    assert got.shape == (b, 32, 128) and got.dtype == tcfg.dtype
    _close(got, want, dtype)


def _spy(monkeypatch, names):
    """Count the calls of each op in ``names`` (they still run)."""
    calls = {}
    for name in names:
        def spy(*a, _name=name, _fn=getattr(ops, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    return calls


ROUTE_OPS = ("encoder_stack_fused", "encoder_stack", "embed_fused",
             "patch_embed", "attn_block", "mlp_block", "layernorm")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("prefix", [1, 2])
def test_torch_stack_forward_matches_jax_pallas(dtype, b, prefix,
                                                monkeypatch):
    """With its stack plans patched on, the port takes the route JAX
    takes at the tiny config in interpret mode: the fold with one prefix
    token, composed embed + ``encoder_stack`` + final LN with two."""
    jcfg, jparams, tcfg, tparams = _models(dtype, num_prefix_tokens=prefix,
                                           num_classes=10)
    monkeypatch.setattr(ops, "stack_plan", lambda *a: True)
    monkeypatch.setattr(ops, "stack_fused_plan", lambda *a: a[-1] == 1)
    px = np.random.default_rng(b).standard_normal(
        (b, 3, 32, 32)).astype(np.float32)
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="pallas")
    calls = _spy(monkeypatch, ROUTE_OPS)
    got = vit.forward(tparams, torch.from_numpy(px), tcfg)
    assert calls == ({"encoder_stack_fused": 1} if prefix == 1 else
                     {"patch_embed": 1, "encoder_stack": 1, "layernorm": 1})
    assert got.shape == (b, 10) and got.dtype == tcfg.dtype
    _close(got, want, dtype)


def test_torch_fold_rounding_against_per_layer_route(monkeypatch, capsys):
    """bf16, batch 1: the fused form and the per-layer route on the same
    inputs, both against JAX ``encoder_stack_fused``. The fold rounds the
    patch rows and the last MLP sum once fewer; this records how far
    apart that puts the two routes and holds only the fused form."""
    jcfg, jparams, tcfg, tparams = _models("bfloat16")
    px = np.random.default_rng(7).standard_normal(
        (1, 3, 32, 32)).astype(np.float32)
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="pallas")
    monkeypatch.setattr(ops, "stack_fused_plan", lambda *a: True)
    fused = vit.forward(tparams, torch.from_numpy(px), tcfg)
    monkeypatch.setattr(ops, "stack_fused_plan", lambda *a: False)
    monkeypatch.setattr(ops, "stack_plan", lambda *a: False)
    layers = vit.forward(tparams, torch.from_numpy(px), tcfg)
    _close(fused, want, "bfloat16")
    d_fused, _ = _diff(fused, want)
    d_layers, _ = _diff(layers, want)
    with capsys.disabled():
        print(f"\n[fold rounding] bf16 bs=1 max|diff| vs JAX "
              f"encoder_stack_fused: fused {d_fused.max():.3e}, per-layer "
              f"route {d_layers.max():.3e}")


def _route(cfg: ViTConfig, b: int) -> str:
    """The route the port's forward takes, from its predicates."""
    sp = vit._padded_seq(cfg)
    geometry = (b, sp, cfg.hidden_dim, cfg.mlp_dim, cfg.num_heads, cfg.dtype)
    if ops.stack_fused_plan(*geometry, cfg.num_prefix_tokens):
        return "stack_fused"
    embed = ("embed_fused" if ops.embed_fused_ok(
        b, cfg.num_patches, cfg.hidden_dim, sp, cfg.num_prefix_tokens)
        else "composed")
    return f"{embed}+{'stack' if ops.stack_plan(*geometry) else 'layers'}"


def _jax_route(cfg, b: int) -> str:
    """The route JAX's forward takes on the TPU (interpret mode off)."""
    it = jnp.dtype(cfg.dtype).itemsize
    sp = -(-cfg.seq_len // 16) * 16
    if cfg.num_prefix_tokens == 1 and jax_ops.stack_fused_plan(
            b, cfg.num_patches, cfg.patch_dim, sp, cfg.hidden_dim,
            cfg.mlp_dim, cfg.num_heads, it):
        return "stack_fused"
    embed = ("embed_fused" if cfg.num_prefix_tokens == 1
             and sp != cfg.seq_len and jax_ops.embed_fused_ok(
                 b, cfg.num_patches, cfg.patch_dim, cfg.hidden_dim, sp, it)
             else "composed")
    stack = jax_ops.stack_plan(b, sp, cfg.hidden_dim, cfg.mlp_dim,
                               cfg.num_heads, it)
    return f"{embed}+{'stack' if stack else 'layers'}"


BATCHES = (1, 2, 3, 4, 8)
F, EL, CL, CS = ("stack_fused", "embed_fused+layers", "composed+layers",
                 "composed+stack")
#: The port's route per variant and dtype at batch 1, 2, 3, 4, 8.
ROUTES = {
    ("B/16", "float32"): (EL, EL, EL, EL, CL),
    ("B/16", "bfloat16"): (F, F, EL, EL, CL),
    ("B/32", "float32"): (EL, EL, EL, EL, CL),
    ("B/32", "bfloat16"): (F, F, EL, EL, CL),
    ("L/16", "float32"): (EL, EL, EL, EL, CL),
    ("L/16", "bfloat16"): (F, EL, EL, EL, CL),
    ("L/16-384", "float32"): (EL, EL, EL, EL, CL),
    ("L/16-384", "bfloat16"): (EL, EL, EL, EL, CL),
    ("H/14", "float32"): (EL, EL, EL, EL, CL),
    ("H/14", "bfloat16"): (EL, EL, EL, EL, CL),
    ("DeiT-B/16", "float32"): (CL, CL, CL, CL, CL),
    ("DeiT-B/16", "bfloat16"): (CS, CS, CL, CL, CL),
}


@pytest.mark.parametrize("variant,dtype", list(ROUTES))
def test_torch_small_batch_route_table(variant, dtype, monkeypatch):
    """The port's route at every variant, dtype and batch, and JAX's on
    the TPU beside it: they agree except at L/16 bf16 batch 1, where
    JAX's VMEM model refuses the fold (embed_fused + encoder_stack there)
    and the port, which keeps nothing resident, folds."""
    cfg = VARIANTS[variant].replace(dtype=getattr(torch, dtype))
    got = tuple(_route(cfg, b) for b in BATCHES)
    assert got == ROUTES[variant, dtype]
    monkeypatch.setattr(jax_dispatch, "interpret_mode", lambda *a: False)
    jcfg = JAX_VARIANTS[variant].replace(dtype=JDT[dtype])
    jax_routes = tuple(_jax_route(jcfg, b) for b in BATCHES)
    expect = list(got)
    if (variant, dtype) == ("L/16", "bfloat16"):
        expect[0] = "embed_fused+stack"
    assert jax_routes == tuple(expect)


def test_torch_stack_plan_needs_the_attention_phase():
    """B/16's widths at 384 px (577 tokens padded to 592): K9's attention
    phase, the attention core's routine, cannot hold 592 tokens in shared
    memory, so the stack route is refused and the model embeds through
    embed_fused, then runs the per-layer route."""
    cfg = VARIANTS["B/16"].replace(image_size=384, dtype=torch.bfloat16)
    assert vit._padded_seq(cfg) == 592
    assert not ops.attn_plan(1, 592, 768, 12, cfg.dtype)
    assert not ops.stack_plan(1, 592, 768, 3072, 12, cfg.dtype)
    assert _route(cfg, 1) == EL
