"""The port's training step against the JAX package's.

- (a) ``reference.flash_attention_bwd`` against ``jax.vjp`` of
  ``vit_tpu/ops/pallas/vjp.py:attention`` in interpret mode (the Pallas
  backward kernel ``_flash_bwd_group_kernel``), aligned and with keys
  masked, fp32 and bf16;
- (b) each ``torch.autograd.Function`` of ``vit_tpu_torch/ops/autograd.py``
  (``impl=None`` on the CPU: JAX's VJP composition with every kernel slot
  on its plain version) against ``jax.vjp`` of the JAX op at
  ``impl="xla"``, fp32;
- (c) the gradients of the port's ``forward`` on both tiers against
  ``jax.grad`` of JAX ``forward(impl="xla")``, which does not pad: the
  port's 5 tokens padded to 16 show that pad rows never leak into the
  real rows' gradients;
- (d) every parameter gets a finite, nonzero gradient on each route;
- (e)-(f) ``make_train_step`` and ``adamw_state_from_numpy`` against
  JAX's ``make_train_step(impl="xla")`` and optax;
- (g) convergence on ``examples/train_tiny.py``'s task.

Bars: fp32 op gradients |diff| <= 5e-4 + 1e-5 |ref| (``tests/test_vjp.py``'s
absolute bar, plus the fp32 sum order of gradients far above 1);
the Pallas backward kernel: fp32 1e-5 (sum order only), bf16
|diff| <= 2e-2 * (1 + |ref|) (one bf16 rounding of p or ds may flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops as jax_ops
from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.models import vit as jax_vit
from vit_tpu.ops.pallas import vjp as jax_vjp
from vit_tpu.train import make_optimizer as jax_make_optimizer
from vit_tpu.train import make_train_step as jax_make_train_step
from vit_tpu_torch import ops
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops import reference
from vit_tpu_torch.train import (cross_entropy_loss, make_optimizer,
                                 make_train_step)
from vit_tpu_torch.weights.convert import (adamw_state_from_numpy,
                                           params_from_numpy, tree_leaves)

#: ``tests/test_vjp.py:178``'s config: 4 patches + CLS, padded to 16.
TINY = dict(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
            num_layers=2, mlp_dim=128, num_classes=8)
GRAD_BAR = 5e-4


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a: np.ndarray, dtype=torch.float32, grad=False) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        dtype).requires_grad_(grad)


def _models(dtype="float32", **kw):
    """JAX config and params with non-trivial LN and biases, and the port's
    config and the same params on the CPU."""
    cfg = dict(TINY, **kw)
    jcfg = JaxConfig(**cfg, dtype=getattr(jnp, dtype))
    tcfg = ViTConfig(**cfg, dtype=getattr(torch, dtype))
    jparams = jax_vit.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                  a.dtype), jparams)
    return jcfg, jparams, tcfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _batch(n=2, size=32, classes=8, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, size, size)).astype(np.float32),
            rng.integers(0, classes, (n,)).astype(np.int32))


def _close(got: torch.Tensor, want, atol=GRAD_BAR) -> None:
    """|got - want| <= atol + 1e-5 |want|: the relative part is the fp32
    sum order of gradients far above 1 (attention at these widths)."""
    got = got.detach().float().numpy()
    want = _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


# ----------------------------------------- (a) the attention backward ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq_len", [None, 27])
def test_torch_flash_attention_bwd_matches_pallas(dtype, seq_len):
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((1, 2, 32, 16)).astype(np.float32)
                  for _ in range(4))
    jdt = getattr(jnp, dtype)
    _, vjp_fn = jax.vjp(
        lambda *a: jax_vjp.attention(*a, None, seq_len, True),
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp_fn(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    got = reference.split_qkv(reference.flash_attention_bwd(
        *(_t(a, tdt) for a in (q, k, v, g)), seq_len=seq_len))
    for gt, w in zip(got, want):
        assert gt.dtype == tdt
        diff = np.abs(gt.float().numpy() - _np(w))
        if dtype == "float32":
            assert diff.max() <= 1e-5, diff.max()
        else:
            assert (diff <= 2e-2 * (1 + np.abs(_np(w)))).all(), diff.max()


def test_torch_flash_attention_bwd_zero_for_masked_keys():
    """Keys at index >= seq_len get zero dk and dv; the packed buffer is
    ``(B, S, 3, H, d)``."""
    rng = np.random.default_rng(4)
    q, k, v, g = (_t(rng.standard_normal((2, 3, 20, 16))) for _ in range(4))
    dqkv = reference.flash_attention_bwd(q, k, v, g, seq_len=13)
    assert dqkv.shape == (2, 20, 3, 3, 16)
    _, dk, dv = reference.split_qkv(dqkv)
    assert not dk[:, :, 13:].any() and not dv[:, :, 13:].any()
    assert dk[:, :, :13].abs().min() > 0


# ------------------------------------------------ (b) each Function ----

def _op_cases():
    """(name, port op, JAX op at impl="xla", input shapes)."""
    eps = 1e-6

    def lin(act):
        return (lambda x, w, b: ops.matmul(x, w, b, act),
                lambda x, w, b: jax_ops.matmul(x, w, b, act, impl="xla"),
                [(2, 24, 32), (32, 40), (40,)])

    def fused(act, ln, res):
        shapes = [(2, 24, 32), (32, 32), (32,)]
        if ln:
            shapes += [(32,), (32,)]
        if res:
            shapes += [(2, 24, 32)]

        def split(a):
            gam, bet = (a[3], a[4]) if ln else (None, None)
            return a[:3], gam, bet, a[-1] if res else None

        def port(*a):
            (x, w, b), gam, bet, r = split(a)
            return ops.fused_linear(x, w, b, act, ln_scale=gam, ln_bias=bet,
                                    eps=eps, residual=r)

        def jax_op(*a):
            (x, w, b), gam, bet, r = split(a)
            return jax_ops.fused_linear(x, w, b, act, ln_scale=gam,
                                        ln_bias=bet, eps=eps, residual=r,
                                        impl="xla")
        return port, jax_op, shapes

    blk = [(2, 16, 32), (32,), (32,)]
    return {
        "linear": lin(None),
        "linear_gelu": lin("gelu"),
        "fused_ln_res": fused(None, True, True),
        "fused_ln_gelu": fused("gelu", True, False),
        "fused_res": fused(None, False, True),
        "fused_gelu_res": fused("gelu", False, True),
        "layernorm": (lambda x, s, b: ops.layernorm(x, s, b, eps=eps),
                      lambda x, s, b: jax_ops.layernorm(x, s, b, eps=eps,
                                                        impl="xla"),
                      blk),
        "attention": (
            lambda q, k, v: ops.flash_attention(q, k, v, seq_len=27),
            lambda q, k, v: jax_ops.flash_attention(q, k, v, seq_len=27,
                                                    impl="xla"),
            [(1, 2, 32, 16)] * 3),
        "attention_qkv": (
            lambda qkv: ops.flash_attention_qkv(qkv, seq_len=27),
            lambda qkv: jax_ops.flash_attention(
                *(jnp.swapaxes(qkv[:, :, i], 1, 2) for i in range(3)),
                seq_len=27, impl="xla"),
            [(2, 32, 3, 2, 16)]),
        # Beyond 768 padded tokens JAX differentiates a jnp chain
        # (vjp.py:378-385); the port keeps K13, whose plain version is
        # the same function.
        "attention_long": (
            lambda q, k, v: ops.flash_attention(q, k, v),
            lambda q, k, v: jax_ops.flash_attention(q, k, v, impl="xla"),
            [(1, 1, 800, 16)] * 3),
        "mlp_block": (
            lambda *a: ops.mlp_block(*a, eps=eps),
            lambda *a: jax_ops.mlp_block(*a, eps=eps, impl="xla"),
            blk + [(32, 64), (64,), (64, 32), (32,)]),
        "attn_block": (
            lambda *a: ops.attn_block(*a, num_heads=2, seq_len=13, eps=eps),
            lambda *a: jax_ops.attn_block(*a, num_heads=2, seq_len=13,
                                          eps=eps, impl="xla"),
            blk + [(32, 96), (96,), (32, 32), (32,)]),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_torch_autograd_function_matches_jax(name):
    port, jax_op, shapes = _op_cases()[name]
    rng = np.random.default_rng(5)
    args = [(0.5 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]
    if name in ("layernorm", "mlp_block", "attn_block"):
        args[1] += 1.0  # LN scale near 1
    if name.startswith("fused_ln"):
        args[3] += 1.0
    want_y, vjp_fn = jax.vjp(jax_op, *(jnp.asarray(a) for a in args))
    g = rng.standard_normal(want_y.shape).astype(np.float32)
    want = vjp_fn(jnp.asarray(g))
    targs = [_t(a, grad=True) for a in args]
    y = port(*targs)
    assert y.grad_fn is not None
    _close(y, want_y, atol=1e-4)
    y.backward(_t(g))
    for t, w in zip(targs, want):
        _close(t.grad, w)


# -------------------------------------------------- (c) the forward ----

def _jax_grads(jcfg, jparams, pixels, labels):
    from vit_tpu.train import cross_entropy_loss as jax_loss
    return jax.value_and_grad(jax_loss)(jparams, jnp.asarray(pixels),
                                        jnp.asarray(labels), jcfg,
                                        impl="xla")


def _port_grads(tparams, tcfg, pixels, labels, impl):
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss = cross_entropy_loss(tparams, _t(pixels), torch.from_numpy(labels),
                              tcfg, impl=impl)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, grads


@pytest.mark.parametrize("impl", [None, "torch"])
def test_torch_forward_grads_match_jax(impl):
    jcfg, jparams, tcfg, tparams = _models()
    pixels, labels = _batch()
    want_loss, want = _jax_grads(jcfg, jparams, pixels, labels)
    loss, grads = _port_grads(tparams, tcfg, pixels, labels, impl)
    _close(loss, want_loss, atol=1e-5)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(grads) == len(want_leaves)
    for got, w in zip(grads, want_leaves):
        assert got is not None
        _close(got, w)


# ------------------------------------------------ (d) every route ----

def _spy(monkeypatch, name):
    calls = []
    real = getattr(ops, name)

    def spy(*a, **kw):
        calls.append(name)
        return real(*a, **kw)
    monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("route", ["layers", "composed", "embed_fused",
                                   "stack", "stack_fused"])
def test_torch_every_param_gets_a_gradient(route, monkeypatch):
    """D=128 at bs=2, so that ``embed_fused`` takes the embedding unless
    refused; each route's gradients also match the plain tier's."""
    _, _, tcfg, tparams = _models(hidden_dim=128, num_heads=2)
    pixels, labels = _batch()
    if route in ("layers", "composed"):
        monkeypatch.setattr(ops, "embed_fused_ok", lambda *a: False)
    if route == "composed":
        monkeypatch.setattr(ops, "attn_plan", lambda *a: False)
        monkeypatch.setattr(ops, "mlp_plan", lambda *a: False)
    if route.startswith("stack"):
        monkeypatch.setattr(ops, "stack_plan", lambda *a: True)
        monkeypatch.setattr(ops, "stack_fused_plan",
                            lambda *a: route == "stack_fused")
    marker = {"layers": "attn_block", "composed": "flash_attention_qkv",
              "embed_fused": "embed_fused", "stack": "encoder_stack",
              "stack_fused": "encoder_stack_fused"}[route]
    calls = _spy(monkeypatch, marker)
    _, grads = _port_grads(tparams, tcfg, pixels, labels, None)
    assert calls
    _, want = _port_grads(tparams, tcfg, pixels, labels, "torch")
    for got, w in zip(grads, want):
        assert got is not None and torch.isfinite(got).all()
        assert got.abs().max() > 0
        _close(got, w.numpy())


# ------------------------------------------ (e)-(f) the train step ----

def _jax_steps(jcfg, jparams, batches, lr, wd):
    init_fn, step_fn = jax_make_train_step(
        jcfg, jax_make_optimizer(lr, wd), impl="xla")
    params = jax.tree.map(jnp.copy, jparams)
    state = init_fn(params)
    out = []
    for px, lb in batches:
        params, state, loss = step_fn(params, state, jnp.asarray(px),
                                      jnp.asarray(lb))
        out.append((float(loss), jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, state)))
    return out


#: Adam divides each gradient by its own scale, so a parameter moves by
#: about ``lr`` a step whatever its gradient; the fp32 sum-order
#: differences of the gradients (<= 5e-4 of their size, (c)) move the
#: step by far less than that.
STEP_BAR = 1e-5


def _close_params(tparams, jparams, lr, steps):
    """Params after ``steps`` AdamW steps at ``lr``: every element within
    ``lr * steps`` (Adam moves none further), and all but 0.1% of each
    tensor within :data:`STEP_BAR`. Adam divides a gradient by its own
    size, so an element whose gradient is near zero by chance takes a step
    set by round-off. The key third of each QKV bias is all such: adding a
    constant to every key of a row leaves its softmax unchanged, so that
    gradient is zero up to round-off, and it is held to ``lr * steps``
    only."""
    d = TINY["hidden_dim"]
    for path, got in _paths(tparams):
        w = _np(_at(jparams, path))
        diff = np.abs(got.detach().float().numpy() - w)
        assert diff.max() <= lr * steps, (path, diff.max())
        if path == ("encoder", "qkv", "bias"):
            diff[:, d:2 * d] = 0
        assert (diff > STEP_BAR + 1e-5 * np.abs(w)).mean() <= 1e-3, path


def _paths(tree, prefix=()):
    """(key path, leaf) in :func:`tree_leaves` order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_torch_train_steps_match_jax():
    """fp32: the step's composition (loss, gradients, AdamW) against JAX's.
    The fp32 case stands for bf16 here: the bf16 gradients are held by the
    route tests (and on the card by ``chip_smoke.py`` phase 12), and the
    bf16 optimizer update, which differs from optax's by design, by
    :func:`test_torch_bf16_adamw_step_within_an_ulp_of_optax`."""
    jcfg, jparams, tcfg, tparams = _models()
    batches = [_batch(seed=s) for s in (2, 3, 4)]
    want = _jax_steps(jcfg, jparams, batches, 1e-3, 0.05)
    init_fn, step_fn = make_train_step(tcfg, make_optimizer(1e-3, 0.05),
                                       device="cpu")
    opt = init_fn(tparams)
    for (px, lb), (wloss, wparams, _) in zip(batches, want):
        tparams, opt, loss = step_fn(tparams, opt, _t(px),
                                     torch.from_numpy(lb))
        assert abs(float(loss) - wloss) <= 1e-5
    _close_params(tparams, wparams, 1e-3, 3)


def test_torch_bf16_adamw_step_within_an_ulp_of_optax():
    """``make_optimizer`` on one bf16 tensor against ``optax.adamw`` on the
    same weight and three bf16 gradients. The two are not bit-equal, by
    design: torch rounds the decayed parameter, then the Adam step (two
    bf16 roundings), and keeps fp32-rounded moments; optax keeps its
    moments and bias corrections in bf16 and rounds once in
    ``apply_updates``. So each element is held to ``lr * steps`` plus one
    bf16 ulp of the pre-step weight from optax's (Adam moves no element
    further than ``lr`` a step), and the mean step size to 1% of optax's
    (ROADMAP queue C, deliberate differences)."""
    import optax

    lr, wd, steps = 1e-3, 0.05, 3
    rng = np.random.default_rng(7)
    w0 = (0.02 * rng.standard_normal((256, 256))).astype(np.float32)
    grads = [(1e-3 * rng.standard_normal(w0.shape)).astype(np.float32)
             for _ in range(steps)]
    opt = optax.adamw(lr, weight_decay=wd)
    jw = jnp.asarray(w0, jnp.bfloat16)
    state = opt.init(jw)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g, jnp.bfloat16), state, jw)
        jw = optax.apply_updates(jw, upd)
    want = _np(jw)
    tw = _t(w0, torch.bfloat16, grad=True)
    topt = make_optimizer(lr, wd)([tw])
    for g in grads:
        tw.grad = _t(g, torch.bfloat16)
        topt.step()
    got = tw.detach().float().numpy()
    start = _t(w0, torch.bfloat16).float().numpy()
    ulp = np.spacing(np.abs(start).astype(np.float32)) * 2 ** 16
    assert (np.abs(got - want) <= lr * steps + ulp).all()
    ratio = np.abs(got - start).mean() / np.abs(want - start).mean()
    assert abs(ratio - 1) <= 1e-2, ratio


def test_torch_adamw_state_from_numpy_continues_a_jax_run():
    jcfg, jparams, tcfg, _ = _models()
    batches = [_batch(seed=s) for s in (2, 3, 4)]
    want = _jax_steps(jcfg, jparams, batches, 1e-3, 0.05)
    _, params2, state2 = want[1]
    tparams = params_from_numpy(params2, tcfg, device="cpu")
    init_fn, step_fn = make_train_step(tcfg, make_optimizer(1e-3, 0.05),
                                       device="cpu")
    opt = init_fn(tparams)
    adam = state2[0]
    assert int(adam.count) == 2
    adamw_state_from_numpy(opt, tparams, adam.count, adam.mu, adam.nu)
    px, lb = batches[2]
    tparams, opt, loss = step_fn(tparams, opt, _t(px), torch.from_numpy(lb))
    assert abs(float(loss) - want[2][0]) <= 1e-5
    _close_params(tparams, want[2][1], 1e-3, 3)


def test_torch_train_step_refuses_params_off_its_device():
    _, _, tcfg, tparams = _models()
    init_fn, _ = make_train_step(tcfg, device="cuda")
    with pytest.raises(ValueError, match="on cpu"):
        init_fn(tparams)


# -------------------------------------------------- (g) convergence ----

def _quadrant_dataset(n, size, num_classes, seed):
    """``examples/train_tiny.py:make_dataset``: class k brightens quadrant
    k, plus noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, (n,)).astype(np.int32)
    pixels = rng.normal(0.0, 0.3, (n, 3, size, size)).astype(np.float32)
    h = size // 2
    quads = [(slice(0, h), slice(0, h)), (slice(0, h), slice(h, None)),
             (slice(h, None), slice(0, h)), (slice(h, None), slice(h, None))]
    for i, k in enumerate(labels):
        ys, xs = quads[int(k) % 4]
        pixels[i, :, ys, xs] += 1.0 + (int(k) // 4) * 0.5
    return pixels, labels


def test_torch_train_tiny_converges():
    """``examples/train_tiny.py``'s model and data, 40 steps at lr 3e-3
    without decay, through the Functions: the bar of
    ``tests/test_examples.py:41``, train accuracy >= 0.95."""
    cfg = ViTConfig(image_size=32, patch_size=8, hidden_dim=64, num_heads=4,
                    num_layers=2, mlp_dim=128, num_classes=4)
    params = vit.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    pixels, labels = _quadrant_dataset(64, 32, 4, seed=0)
    init_fn, step_fn = make_train_step(cfg, make_optimizer(3e-3, 0.0),
                                       device="cpu")
    opt = init_fn(params)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(40):
        idx = rng.choice(64, size=32, replace=False)
        params, opt, loss = step_fn(params, opt, _t(pixels[idx]),
                                    torch.from_numpy(labels[idx]))
        losses.append(float(loss))
    with torch.no_grad():
        logits = vit.forward(params, _t(pixels), cfg)
    acc = float((logits.argmax(-1).numpy() == labels).mean())
    assert losses[-1] < losses[0]
    assert acc >= 0.95, (acc, losses[::10])
