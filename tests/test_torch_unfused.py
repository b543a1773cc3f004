"""The port's other forward modes against the JAX package's:
``attention="flash" | "unfused"`` and ``fused=True | False`` of
``vit_tpu/models/vit.py:encoder_block``.

- ``forward`` on each of the four routes against JAX ``forward(impl=
  "pallas")`` (interpret mode: the Pallas ``add``, ``softmax`` and
  ``matmul3`` kernels on the unfused and ``fused=False`` routes) and
  against ``impl="xla"``; ``forward_with_intermediates`` per layer;
- op-count spies: the unfused route runs at the real token count, and the
  stack plans and mega-kernels are off unless ``("flash", True)``;
- the ``Matmul3``, ``Softmax`` and ``Add`` Functions against ``jax.vjp``
  of ``vit_tpu/ops/pallas/vjp.py:matmul3``, ``softmax`` and ``add``;
- three fp32 ``make_train_step(attention="unfused")`` steps against JAX's
  step, and ``Predictor(attention="unfused")``.

Bars: fp32 max|diff| <= 1e-4; bf16 |diff| <= 2e-2 * (1 + |ref|) against
the Pallas tier and 5e-2 * (1 + |ref|) against the XLA tier, as in
``tests/test_torch_composed.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.models import vit as jax_vit
from vit_tpu.ops.pallas import vjp as jax_vjp
from vit_tpu.serving import Predictor as JaxPredictor
from vit_tpu.train import make_optimizer as jax_make_optimizer
from vit_tpu.train import make_train_step as jax_make_train_step
from vit_tpu_torch import ops
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops import reference
from vit_tpu_torch.serving import Predictor
from vit_tpu_torch.train import make_optimizer, make_train_step
from vit_tpu_torch.weights.convert import params_from_numpy

#: 16 patches + CLS = 17 tokens: padded to 32 on the flash route only.
TINY = dict(image_size=32, patch_size=8, hidden_dim=128, num_heads=2,
            num_layers=2, mlp_dim=256)
DTYPES = ["float32", "bfloat16"]
ROUTES = [("flash", True), ("flash", False), ("unfused", True),
          ("unfused", False)]
ROUTE_IDS = [f"{a}-{'fused' if f else 'chain'}" for a, f in ROUTES]


def _models(dtype="float32", **kw):
    """JAX config and params with non-trivial LN and biases, and the port's
    config and the same params on the CPU."""
    geometry = dict(TINY, **kw)
    jcfg = JaxConfig(**geometry, dtype=getattr(jnp, dtype))
    tcfg = ViTConfig(**geometry, dtype=getattr(torch, dtype))
    jparams = jax_vit.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape), a.dtype),
        jparams)
    return jcfg, jparams, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _pixels(cfg, n=2, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, cfg.image_size, cfg.image_size)).astype(np.float32)


def _close(got: torch.Tensor, want, dtype: str, bf16_bar: float) -> None:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    if dtype == "float32":
        assert diff.max() <= 1e-4, diff.max()
    else:
        assert (diff <= bf16_bar * (1 + np.abs(want))).all(), diff.max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attention,fused", ROUTES, ids=ROUTE_IDS)
def test_torch_forward_route_matches_jax_pallas(dtype, attention, fused):
    jcfg, jparams, tcfg, tparams = _models(dtype, num_classes=10)
    px = _pixels(tcfg)
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="pallas",
                           attention=attention, fused=fused)
    got = vit.forward(tparams, torch.from_numpy(px), tcfg,
                      attention=attention, fused=fused)
    assert got.dtype == tcfg.dtype
    _close(got, want, dtype, 2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("attention,fused", ROUTES, ids=ROUTE_IDS)
def test_torch_forward_route_matches_jax_xla(dtype, attention, fused):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    px = _pixels(tcfg)
    want = jax_vit.forward(jparams, jnp.asarray(px), jcfg, impl="xla",
                           attention=attention, fused=fused)
    got = vit.make_forward(tcfg, attention=attention, fused=fused)(
        tparams, torch.from_numpy(px))
    _close(got, want, dtype, 5e-2)


@pytest.mark.parametrize("fused", [True, False])
def test_torch_unfused_forward_with_intermediates_per_layer(fused):
    jcfg, jparams, tcfg, tparams = _models()
    px = _pixels(tcfg)
    jfinal, jh = jax_vit.forward_with_intermediates(
        jparams, jnp.asarray(px), jcfg, impl="pallas", attention="unfused",
        fused=fused)
    final, hiddens = vit.forward_with_intermediates(
        tparams, torch.from_numpy(px), tcfg, attention="unfused", fused=fused)
    assert len(hiddens) == len(jh) == TINY["num_layers"] + 1
    for i, (got, want) in enumerate(zip(hiddens, jh)):
        assert got.shape == (2, 17, 128), i
        _close(got, want, "float32", 0)
    _close(final, jfinal, "float32", 0)
    torch.testing.assert_close(
        final, vit.forward(tparams, torch.from_numpy(px), tcfg,
                           attention="unfused", fused=fused), rtol=0, atol=0)


SPIED = ("embed_fused", "encoder_stack_fused", "encoder_stack", "attn_block",
         "mlp_block", "flash_attention_qkv", "fused_linear", "layernorm",
         "matmul", "add", "matmul3", "softmax")


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("attention,fused", ROUTES, ids=ROUTE_IDS)
def test_torch_route_op_counts(attention, fused, n, monkeypatch):
    """The stack plans patched on: only ``("flash", True)`` takes them.
    ``fused=False`` runs layernorm -> matmul -> add for every linear; the
    unfused attention is matmul3 -> softmax -> matmul3 at the real 17
    tokens on contiguous operands (the kernel's, at every batch), and
    embeds through the composed patch projection (nothing to pad); the
    flash chain keeps ``embed_fused``."""
    _, _, tcfg, tparams = _models()
    monkeypatch.setattr(ops, "stack_plan", lambda *a: True)
    monkeypatch.setattr(ops, "stack_fused_plan", lambda *a: True)
    calls, shapes = {}, []
    for name in SPIED:
        def spy(*a, _name=name, _fn=getattr(ops, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            if _name == "matmul3":
                assert a[0].is_contiguous() and a[1].is_contiguous()
                shapes.append(tuple(a[0].shape))
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    out = vit.forward(tparams, torch.from_numpy(_pixels(tcfg, n)), tcfg,
                      attention=attention, fused=fused)
    assert out.shape == (n, 17, 128)
    layers = TINY["num_layers"]
    chain = dict(layernorm=2 * layers + 1, matmul=4 * layers, add=2 * layers)
    fused_chain = dict(fused_linear=4 * layers, layernorm=1)
    unfused = dict(matmul3=2 * layers, softmax=layers)
    expect = {
        ("flash", True): dict(encoder_stack_fused=1),
        ("flash", False): dict(chain, embed_fused=1,
                               flash_attention_qkv=layers),
        ("unfused", True): dict(fused_chain, **unfused, matmul=1),
        ("unfused", False): dict(chain, **unfused, matmul=4 * layers + 1),
    }[attention, fused]
    assert calls == expect
    # The scores' and the context's left operands: (B*H, S, .) at S = 17.
    assert shapes == ([(2 * n, 17, 64), (2 * n, 17, 17)] * layers
                      if attention == "unfused" else [])


def test_torch_unfused_route_refuses_padded_tokens():
    _, _, tcfg, tparams = _models()
    x = torch.zeros(1, 32, 128)
    with pytest.raises(ValueError, match="no padded tokens"):
        vit.encoder_block(x, vit._layers(tparams["encoder"])[0], tcfg,
                          attention="unfused", seq_len=17)
    with pytest.raises(ValueError, match="attention mode"):
        vit.forward(tparams, torch.zeros(1, 3, 32, 32), tcfg,
                    attention="sparse")
    assert vit._padded_seq(tcfg, "unfused") == 17
    assert vit._padded_seq(tcfg) == 32


def _jax_op_cases():
    """(port op, JAX custom-VJP op in interpret mode, input shapes)."""
    return {
        "matmul3": (lambda x, y: ops.matmul3(x, y, scale=0.25),
                    lambda x, y: jax_vjp.matmul3(x, y, 0.25, True),
                    [(3, 17, 16), (3, 16, 17)]),
        "matmul3_noscale": (lambda x, y: ops.matmul3(x, y),
                            lambda x, y: jax_vjp.matmul3(x, y, None, True),
                            [(2, 17, 17), (2, 17, 16)]),
        "softmax": (ops.softmax, lambda x: jax_vjp.softmax(x, True),
                    [(2, 5, 17)]),
        "add": (ops.add, lambda x, y: jax_vjp.add(x, y, True),
                [(2, 5, 16), (2, 5, 16)]),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(_jax_op_cases()))
def test_torch_reference_chain_function_matches_jax_vjp(name, dtype,
                                                        monkeypatch):
    """Each Function's forward and backward against ``jax.vjp`` of JAX's
    custom VJP (the Pallas kernels in interpret mode); ``Matmul3``'s
    backward calls its kernel slot twice, as JAX's calls its kernel."""
    port, jax_op, shapes = _jax_op_cases()[name]
    rng = np.random.default_rng(3)
    args = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_y, vjp_fn = jax.vjp(jax_op, *(jnp.asarray(a, jdt) for a in args))
    g = rng.standard_normal(want_y.shape).astype(np.float32)
    want = vjp_fn(jnp.asarray(g, jdt))
    targs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in args]
    y = port(*targs)
    assert y.grad_fn is not None and y.dtype == tdt
    _close(y, want_y, dtype, 2e-2)
    slot = []
    real = reference.matmul3
    monkeypatch.setattr(reference, "matmul3",
                        lambda *a, **k: slot.append(1) or real(*a, **k))
    y.backward(torch.from_numpy(g).to(tdt))
    assert len(slot) == (2 if name.startswith("matmul3") else 0)
    for t, w in zip(targs, want):
        assert t.grad.dtype == tdt
        _close(t.grad, w, dtype, 2e-2)


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def test_torch_unfused_train_steps_match_jax():
    """Three fp32 AdamW steps through the unfused route, the Functions on
    the CPU, against JAX's ``make_train_step(attention="unfused")``, held
    as ``tests/test_torch_train.py:_close_params`` holds the flash route's:
    every element within ``lr * steps``, all but 0.1% within 1e-5 (the key
    third of each QKV bias, a gradient of round-off, is held to the
    first only)."""
    lr, wd, steps = 1e-3, 0.05, 3
    geometry = dict(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
                    num_classes=8)
    jcfg, jparams, tcfg, tparams = _models(**geometry)
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((2, 3, 32, 32)).astype(np.float32),
                rng.integers(0, 8, (2,)).astype(np.int32))
               for _ in range(steps)]
    jinit, jstep = jax_make_train_step(jcfg, jax_make_optimizer(lr, wd),
                                       impl="xla", attention="unfused")
    state = jinit(jparams)
    init_fn, step_fn = make_train_step(tcfg, make_optimizer(lr, wd),
                                       attention="unfused", device="cpu")
    opt = init_fn(tparams)
    for px, lb in batches:
        jparams, state, wloss = jstep(jparams, state, jnp.asarray(px),
                                      jnp.asarray(lb))
        tparams, opt, loss = step_fn(tparams, opt, torch.from_numpy(px),
                                     torch.from_numpy(lb))
        assert abs(float(loss) - float(wloss)) <= 1e-5
    d = geometry["hidden_dim"]
    for path, got in _paths(tparams):
        w = np.asarray(_at(jparams, path), np.float32)
        diff = np.abs(got.detach().numpy() - w)
        assert diff.max() <= lr * steps, (path, diff.max())
        if path == ("encoder", "qkv", "bias"):
            diff[:, d:2 * d] = 0
        assert (diff > 1e-5 + 1e-5 * np.abs(w)).mean() <= 1e-3, path


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_torch_unfused_predictor_matches_jax():
    """``Predictor(attention="unfused")``: a request of 5 on buckets (1, 4)
    equals its bucket forwards on the unfused route bit for bit, and JAX's
    ``Predictor(attention="unfused")`` to 1e-4."""
    jcfg, jparams, tcfg, tparams = _models(num_classes=10)
    pred = Predictor(tparams, tcfg, buckets=(1, 4), device="cpu",
                     attention="unfused")
    px = _pixels(tcfg, n=5, seed=6)
    out = pred(px)
    fwd = vit.make_forward(tcfg, attention="unfused")
    tpx = torch.from_numpy(px)
    assert torch.equal(out, torch.cat([fwd(tparams, tpx[:4]),
                                       fwd(tparams, tpx[4:])]))
    want = JaxPredictor(jparams, jcfg, buckets=(1, 4),
                        attention="unfused")(px)
    _close(out, want, "float32", 0)
