"""The port's tensor-parallel and batch-parallel path
(``vit_tpu_torch/parallel``, ``Predictor(mesh=)``, ``make_train_step(mesh=)``)
against the JAX package's (``vit_tpu/parallel``), on the CPU.

Kernel level, in this process: each shard-form op's plain version against
its Pallas kernel in interpret mode, at JAX's kernel-path geometry
(``tests/test_parallel.py:180-185``: D=256, 4 heads, MLP 512 split over
model=2, so 2 local heads, dl=128 and 256 local MLP columns; 5 real tokens
of 16), and at 577 of 592 tokens, so that the masked keys span more than
one tile (at D=256: JAX's partial kernels need dl % 128 == 0). Bars: fp32
max|diff| <= 1e-5, bf16 |diff| <= 2e-2 (1 + |ref|); the int8 ops, whose
activation codes can flip at a .5 boundary where the LN sum orders differ,
take ``tests/test_torch_quant.py``'s relative bars. The int8 MLP kernels
run with JAX's plan pinned to one 512-column group
(``VIT_TPU_MLP_PLAN="0,1,512"``), the port's fixed group, so those shards
hold 512 MLP columns (MLP 1024 over model=2).

Multi-process: two spawns of two ranks each (``tests/
test_torch_parallel_worker.py``), joined through a ``file://`` store under
the test's temporary directory (gloo; no TCP rendezvous), each collective
with a 120 s timeout and each rank killed if the spawn outlives 240 s. The
parent computes JAX's side on the conftest's 8 host devices; the workers
never import JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu import quant as jax_quant
from vit_tpu.config import ViTConfig as JaxConfig
from vit_tpu.models import vit as jax_vit
from vit_tpu.ops.pallas import block as jax_block
from vit_tpu.parallel import make_mesh as jax_make_mesh
from vit_tpu.parallel import make_tp_forward as jax_make_tp_forward
from vit_tpu.parallel import param_shardings as jax_param_shardings
from vit_tpu.parallel import prepare_tp_params as jax_prepare_tp_params
from vit_tpu.parallel.tp_pallas import (
    repack_qkv_headmajor as jax_repack_qkv_headmajor)
from vit_tpu.serving import Predictor as JaxPredictor
from vit_tpu_torch import ops, parallel, quant
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.parallel import Mesh
from vit_tpu_torch.train import make_optimizer, make_train_step
from vit_tpu_torch.weights.convert import (params_from_numpy, tree_leaves,
                                           tree_map)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "test_torch_parallel_worker.py"
SPAWN_TIMEOUT_S = 240
CPU = torch.device("cpu")

#: JAX's kernel-path geometry, its TINY (``tests/test_parallel.py:13``),
#: and the kernel geometry with MLP 1024 for the int8 MLP kernels.
KERNEL = dict(image_size=32, patch_size=16, hidden_dim=256, num_heads=4,
              num_layers=2, mlp_dim=512, num_classes=8)
TINY = dict(image_size=32, patch_size=16, hidden_dim=64, num_heads=4,
            num_layers=2, mlp_dim=128, num_classes=8)
INT8 = dict(KERNEL, mlp_dim=1024)
DTYPES = ["float32", "bfloat16"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: ``tests/test_torch_quant.py``'s relative bars of the int8 tier: an op,
#: and a whole forward (activations quantized four times a layer).
REL_BAR = {"float32": 1e-3, "bfloat16": 2e-2}
FORWARD_REL_BAR = 5e-3


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _pair(a, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _qpair(rng, *shape, std=0.05):
    """A JAX int8 weight and the same codes and scales as tensors."""
    w = jax_quant.quantize_weight(
        jnp.asarray(std * rng.standard_normal(shape), jnp.float32))
    return w, {k: torch.from_numpy(np.array(v)) for k, v in w.items()}


def _close(got, want, dtype: str, *, fp32=1e-5) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if dtype == "float32":
        assert np.abs(g - w).max() <= fp32, np.abs(g - w).max()
    else:
        excess = np.abs(g - w) - 2e-2 * (1 + np.abs(w))
        assert excess.max() <= 0, excess.max()


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


# ------------------------------------------------------- kernel level --

def _shard_inputs(rng, dtype, *, b=2, sp=16, d=256, dl=128, mlp_l=256):
    """One shard's arguments of every partial op, from one numpy seed:
    ``x`` (B, S, D) and the attention half's and MLP half's weights, float
    and int8, as JAX arrays ("j") and tensors ("t")."""
    vec = lambda n, s=0.1, m=0.0: _pair(m + s * rng.standard_normal(n), dtype)
    out = {"j": {}, "t": {}}

    def put(name, pair):
        out["j"][name], out["t"][name] = pair
    put("x", _pair(rng.standard_normal((b, sp, d)), dtype))
    for ln in ("ln1", "ln2"):
        put(f"{ln}_g", vec(d, m=1.0))
        put(f"{ln}_b", vec(d))
    put("wqkv", _pair(0.05 * rng.standard_normal((d, 3 * dl)), dtype))
    put("bqkv", vec(3 * dl))
    put("wout", _pair(0.05 * rng.standard_normal((dl, d)), dtype))
    put("w1", _pair(0.05 * rng.standard_normal((d, mlp_l)), dtype))
    put("b1", vec(mlp_l))
    put("w2", _pair(0.05 * rng.standard_normal((mlp_l, d)), dtype))
    put("b2", vec(d))
    for name, shape in (("qqkv", (d, 3 * dl)), ("qout", (dl, d)),
                        ("q1", (d, mlp_l)), ("q2", (mlp_l, d))):
        put(name, _qpair(rng, *shape))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geometry", ["kernel", "long"])
def test_torch_attn_block_partial_matches_pallas(dtype, geometry):
    """B16: 5 of 16 tokens at b=2, and 577 of 592 at b=1."""
    b, sp, seq = (2, 16, 5) if geometry == "kernel" else (1, 592, 577)
    a = _shard_inputs(np.random.default_rng(1), dtype, b=b, sp=sp)
    args = lambda s: (s["x"], s["ln1_g"], s["ln1_b"], s["wqkv"], s["bqkv"],
                      s["wout"])
    want = jax_block.attn_block_partial(*args(a["j"]), num_heads=2,
                                        seq_len=seq, interpret=True)
    got = ops.attn_block_partial(*args(a["t"]), num_heads=2, seq_len=seq)
    assert got.dtype == a["t"]["x"].dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_attn_block_q_partial_matches_pallas(dtype):
    """B17 at the kernel-path geometry: the context rows are quantized
    over the shard's 128 columns on both sides."""
    a = _shard_inputs(np.random.default_rng(2), dtype)

    def args(s):
        return (s["x"], s["ln1_g"], s["ln1_b"], s["qqkv"]["q"],
                s["qqkv"]["scale"], s["bqkv"], s["qout"]["q"],
                s["qout"]["scale"])
    want = jax_block.attn_block_q_partial(*args(a["j"]), num_heads=2,
                                          seq_len=5, interpret=True)
    got = ops.attn_block_q_partial(*args(a["t"]), num_heads=2, seq_len=5)
    assert got.dtype == a["t"]["x"].dtype
    assert _rel(got[:, :5], want[:, :5]) <= REL_BAR[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_mlp_block_partial_matches_pallas(dtype):
    """K3 with ``partial_out=True``: 256 local MLP columns, no residual,
    ``b2`` ignored (JAX's plan chunks the hidden by 128: the fp32 sum order
    differs)."""
    a = _shard_inputs(np.random.default_rng(3), dtype)
    args = lambda s: (s["x"], s["ln2_g"], s["ln2_b"], s["w1"], s["b1"],
                      s["w2"], s["b2"])
    want = jax_block.mlp_block(*args(a["j"]), interpret=True,
                               partial_out=True)
    got = ops.mlp_block(*args(a["t"]), partial_out=True)
    _close(got, want, dtype)
    t = a["t"]
    whole = ops.mlp_block(*args(t))
    assert not torch.equal(got, whole)
    # No residual and no b2: the shard sum is the whole block less both.
    no_b2 = ops.mlp_block(*args(t)[:-1], torch.zeros_like(t["b2"]),
                          partial_out=True)
    assert torch.equal(got, no_b2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["mlp_block_i8dot", "mlp_block_q"])
def test_torch_int8_mlp_partial_matches_pallas(dtype, kernel, monkeypatch):
    """K12 and K17 with ``partial_out=True`` on a shard of 512 MLP columns,
    JAX's plan pinned to one group of 512."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    a = _shard_inputs(np.random.default_rng(4), dtype, mlp_l=512)

    def args(s):
        return (s["x"], s["ln2_g"], s["ln2_b"], s["q1"]["q"], s["q1"]["scale"],
                s["b1"], s["q2"]["q"], s["q2"]["scale"], s["b2"])
    want = getattr(jax_block, kernel)(*args(a["j"]), interpret=True,
                                      partial_out=True)
    got = getattr(ops, kernel)(*args(a["t"]), partial_out=True)
    assert got.dtype == a["t"]["x"].dtype
    assert _rel(got, want) <= REL_BAR[dtype]
    if kernel == "mlp_block_q" and dtype == "float32":
        assert np.abs(_np(got) - _np(want)).max() <= 2e-5


def _models(cfg_kw: dict, dtype: str = "float32", seed: int = 0):
    """JAX config and params with non-trivial LN and biases, and the same
    numbers as the port's config and params on the CPU."""
    jcfg = JaxConfig(**cfg_kw, dtype=JDT[dtype])
    tcfg = ViTConfig(**cfg_kw, dtype=getattr(torch, dtype))
    jparams = jax_vit.init_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    jparams = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                  a.dtype), jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _layer(params, i: int):
    return tree_map(lambda t: t[i], params["encoder"])


@pytest.mark.parametrize("half", ["attn", "mlp", "mlp_i8dot", "mlp_q"])
def test_torch_shard_sum_equals_full_block(half):
    """fp32: the partials of both shards of model=2 (the head-major repack
    and ``shard_params`` of the whole weights), summed, plus the bias and
    the residual, equal the whole-block op to 1e-5. The int8 MLP's shards
    (MLP 1024 over 2) hold whole 512-column quant groups, so their sum is
    the whole K12 or K17 up to the fp32 sum order."""
    kw = INT8 if half.startswith("mlp_") else KERNEL
    _, _, cfg, params = _models(kw, seed=5)
    if half.startswith("mlp_"):
        params = quant.quantize_params(params)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 16, 256)).astype(np.float32))
    shards = [_layer(parallel.prepare_tp_params(params, cfg,
                                                Mesh(1, 2, r, CPU)), 0)
              for r in range(2)]
    lp = _layer(params, 0)
    if half == "attn":
        parts = [ops.attn_block_partial(
            x, s["ln1"]["scale"], s["ln1"]["bias"], s["qkv"]["kernel"],
            s["qkv"]["bias"], s["out"]["kernel"], num_heads=2, seq_len=5)
            for s in shards]
        bias = lp["out"]["bias"]
        whole = ops.attn_block(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                               lp["qkv"]["kernel"], lp["qkv"]["bias"],
                               lp["out"]["kernel"], bias, num_heads=4,
                               seq_len=5)
    elif half == "mlp":
        def mlp(p, **k):
            return ops.mlp_block(x, p["ln2"]["scale"], p["ln2"]["bias"],
                                 p["fc1"]["kernel"], p["fc1"]["bias"],
                                 p["fc2"]["kernel"], p["fc2"]["bias"], **k)
        parts = [mlp(s, partial_out=True) for s in shards]
        bias, whole = lp["fc2"]["bias"], mlp(lp)
    else:
        op = getattr(ops, half.replace("mlp_i8dot", "mlp_block_i8dot")
                     .replace("mlp_q", "mlp_block_q"))

        def mlp(p, **k):
            k1, k2 = p["fc1"]["kernel"], p["fc2"]["kernel"]
            return op(x, p["ln2"]["scale"], p["ln2"]["bias"], k1["q"],
                      k1["scale"], p["fc1"]["bias"], k2["q"], k2["scale"],
                      p["fc2"]["bias"], **k)
        parts = [mlp(s, partial_out=True) for s in shards]
        bias, whole = lp["fc2"]["bias"], mlp(lp)
    got = x + (parts[0] + parts[1]) + bias
    rows = slice(0, 5) if half == "attn" else slice(None)
    _close(got[:, rows], whole[:, rows], "float32")


@pytest.mark.parametrize("tier", ["float", "int8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_repack_and_shard_params_match_jax(tier, dtype):
    """``repack_qkv_headmajor`` and ``shard_params`` on a 2 x 2 mesh give,
    leaf by leaf and bit for bit, JAX's repack and the slice that
    ``param_shardings`` places on the device at the rank's mesh position;
    ``model == 1`` is the identity."""
    jcfg, jparams, tcfg, tparams = _models(KERNEL, dtype, seed=7)
    if tier == "int8":
        jparams = jax_quant.quantize_params(jparams)
        tparams = quant.quantize_params(tparams)
    assert parallel.repack_qkv_headmajor(tparams, 1) is tparams
    jrep = jax_repack_qkv_headmajor(jparams, 2)
    trep = parallel.repack_qkv_headmajor(tparams, 2)
    jmesh = jax_make_mesh(data=2, model=2)
    placed = jax.device_put(jrep, jax_param_shardings(jrep, jmesh, jcfg))
    jleaves = jax.tree_util.tree_flatten_with_path(placed)[0]
    for i in range(2):
        for j in range(2):
            dev = jmesh.devices[i, j]
            mine = tree_leaves(parallel.shard_params(
                trep, tcfg, Mesh(2, 2, i * 2 + j, CPU)))
            assert len(mine) == len(jleaves)
            for (path, leaf), got in zip(jleaves, mine):
                want = next(np.asarray(s.data) for s in leaf.addressable_shards
                            if s.device == dev)
                assert got.is_contiguous()
                assert tuple(got.shape) == want.shape, path
                assert np.array_equal(_np(got), np.asarray(want, np.float64)), (
                    jax.tree_util.keystr(path))


def _spy(monkeypatch, names):
    calls = {}
    for name in names:
        def spy(*a, _name=name, _fn=getattr(ops, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    return calls


@pytest.mark.parametrize("tier", ["float", "int8"])
def test_torch_tp_gates_take_the_partials_where_jax_composes(tier,
                                                             monkeypatch):
    """The deliberate difference of ROADMAP C: at TINY over model=2 (dl=32,
    64 MLP columns a shard) JAX's partial kernels refuse (they need dl %
    128 == 0 and 128-column MLP shards) and JAX composes in jnp; the port
    runs B16/B17 at every width, K3's partial where ``ops.mlp_plan`` takes
    the shard (fp32 up to D=1536), and the int8 MLP half composed on K10
    and K11 as JAX composes it (D=64 and 64 MLP columns: no 128-column
    tiles, so no int8 MLP plan on either side; each quantizes the hidden
    per row over the shard's columns). One rank's route, traced with its
    collectives switched off."""
    assert jax_block.attn_block_partial_plan(2, 16, 64, 32, 4) is None
    assert jax_block.mlp_block_plan(32, 64, 64, 4) is None
    _, _, cfg, params = _models(TINY, seed=8)
    if tier == "int8":
        params = quant.quantize_params(params)
    mesh = Mesh(1, 2, 0, CPU)
    calls = _spy(monkeypatch, ["attn_block_partial", "attn_block_q_partial",
                               "mlp_block", "mlp_block_i8dot",
                               "quantize_rows", "matmul_i8"])
    fn = parallel.make_tp_forward(cfg, mesh, quant=tier == "int8")
    out = fn(parallel.prepare_tp_params(params, cfg, mesh),
             torch.zeros((2, 3, 32, 32)))
    assert out.shape == (2, 8)
    assert calls == ({"attn_block_partial": 2, "mlp_block": 2}
                     if tier == "float" else
                     {"attn_block_q_partial": 2, "quantize_rows": 4,
                      "matmul_i8": 4})


#: Shards whose MLP columns are multiples of 128 but not whole 512-column
#: quant groups: (config, model axis, rows of JAX's MLP plan).
PARTIAL_GROUPS = {"B/16 model=4": ("B/16", 4, 8 * 208),
                  "H/14 model=4": ("H/14", 4, 2 * 272),
                  "kernel model=2": (KERNEL, 2, 2 * 16)}


@pytest.mark.parametrize("name", list(PARTIAL_GROUPS))
def test_torch_int8_tp_refuses_a_shard_of_partial_quant_groups(name):
    """B/16 and H/14 over model=4 (768 and 1280 MLP columns a shard) and
    the kernel geometry over model=2 (256): JAX's int8 MLP plan takes the
    shard and quantizes the hidden per chunk of its ``ct``, never 512
    there, which the port's fixed group cannot match, so the int8
    ``make_tp_forward`` raises; the float one and the int8 one over
    model=2 at B/16 (1536 columns, three groups) do not."""
    from vit_tpu_torch.config import VARIANTS

    geometry, model, rows = PARTIAL_GROUPS[name]
    cfg = (VARIANTS[geometry] if isinstance(geometry, str)
           else ViTConfig(**geometry))
    mlp_l = cfg.mlp_dim // model
    plan = jax_block.mlp_block_plan_i8(rows, cfg.hidden_dim, mlp_l, 4)
    assert plan is not None and plan[2] != 512 and mlp_l % 128 == 0
    mesh = Mesh(1, model, 0, CPU)
    with pytest.raises(ValueError, match="not whole quant groups"):
        parallel.make_tp_forward(cfg, mesh, quant=True)
    parallel.make_tp_forward(cfg, mesh)
    parallel.make_tp_forward(VARIANTS["B/16"], Mesh(1, 2, 0, CPU), quant=True)


def test_torch_make_tp_forward_refuses_an_uneven_split():
    cfg = ViTConfig(**dict(TINY, num_heads=2))
    with pytest.raises(ValueError, match="split over model=4"):
        parallel.make_tp_forward(cfg, Mesh(1, 4, 0, CPU))
    with pytest.raises(ValueError, match="model must be 1"):
        make_train_step(cfg, mesh=Mesh(1, 2, 0, CPU))


# ------------------------------------------------------- multi-process --

def _spawn(tmp_path: Path, job: dict, world: int) -> list[dict]:
    """Run ``job`` on ``world`` ranks of the worker; return each rank's
    results. A rank that fails fails the test with every rank's output; a
    spawn that outlives its time is killed."""
    path = tmp_path / "job.pt"
    torch.save(job, path)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(path), str(r), str(world),
         str(tmp_path / "store")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" + \
            "\n".join(outs)
    results = [torch.load(f"{path}.rank{r}", weights_only=False)
               for r in range(world)]
    assert not any(r.pop("jax_loaded") for r in results)
    return results


def _pixels(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 32, 32)).astype(np.float32)


#: The cases of the tensor-parallel spawn (data=1, model=2): name ->
#: (kind, geometry, quant, batch).
TP_CASES = {"kernel": ("tp_forward", KERNEL, False, 2),
            "tiny": ("tp_forward", TINY, False, 2),
            "int8": ("tp_forward", INT8, True, 2),
            "pred": ("predictor", TINY, False, 5),
            "pred_q": ("predictor", TINY, True, 5)}


@pytest.fixture(scope="module")
def tp_results(tmp_path_factory):
    cases = {}
    for name, (kind, kw, q, n) in TP_CASES.items():
        _, _, tcfg, tparams = _models(kw, seed=10)
        cases[name] = {"kind": kind, "cfg": dict(kw), "quant": q,
                       "params": tparams, "buckets": (2, 4),
                       "pixels": torch.from_numpy(_pixels(n, 11))}
    return _spawn(tmp_path_factory.mktemp("tp"),
                  {"data": 1, "model": 2, "cases": cases}, 2)


def _both_ranks(results, name, key="out"):
    """The case's output, the same on both ranks."""
    a, b = (r[name][key] for r in results)
    assert torch.equal(a, b)
    return a


@pytest.mark.parametrize("name", ["kernel", "tiny"])
def test_torch_tp_forward_matches_jax(tp_results, name):
    """The float TP forward over model=2 against JAX's ``make_tp_forward``
    on a ``make_mesh(data=1, model=2)`` mesh, fp32: at the kernel-path
    geometry (JAX's partial kernels) to 2e-5, at TINY (JAX's jnp fallback)
    to 1e-5."""
    _, kw, _, n = TP_CASES[name]
    jcfg, jparams, _, _ = _models(kw, seed=10)
    mesh = jax_make_mesh(data=1, model=2)
    want = jax_make_tp_forward(jcfg, mesh)(
        jax_prepare_tp_params(jparams, jcfg, mesh), jnp.asarray(_pixels(n, 11)))
    got = _both_ranks(tp_results, name)
    assert got.shape == (n, 8)
    _close(got, want, "float32", fp32=2e-5 if name == "kernel" else 1e-5)


def test_torch_int8_tp_forward_matches_jax(tp_results, monkeypatch):
    """The int8 TP forward (B17, K12 partial over 512-column shards)
    against JAX's ``make_tp_forward(quant=True)`` with its MLP plan pinned
    to the port's group, fp32: rel <= 5e-3, the bar of a whole int8
    forward against JAX (``tests/test_torch_quant.py``)."""
    monkeypatch.setenv("VIT_TPU_MLP_PLAN", "0,1,512")
    jcfg, jparams, _, _ = _models(INT8, seed=10)
    mesh = jax_make_mesh(data=1, model=2)
    want = jax_make_tp_forward(jcfg, mesh, quant=True)(
        jax_prepare_tp_params(jax_quant.quantize_params(jparams), jcfg, mesh),
        jnp.asarray(_pixels(2, 11)))
    assert _rel(_both_ranks(tp_results, "int8"), want) <= FORWARD_REL_BAR


@pytest.mark.parametrize("name", ["pred", "pred_q"])
def test_torch_tp_predictor_matches_jax(tp_results, name):
    """``Predictor(mesh=make_mesh(data=1, model=2))`` answers a request of
    5 on buckets (2, 4) as JAX's ``Predictor(impl="pallas", mesh=)`` does:
    float to 1e-5. ``quant=True`` within rel 2e-2, the bar of the port's
    int8 kernels against JAX's XLA int8 numerics
    (``tests/test_torch_quant.py``): TINY's shards take JAX's jnp fallback
    (``int8_matmul``, an XLA softmax) where the port runs B17 and the
    composed int8 MLP. The function is the same in fp32, but a context row
    of a 32-column shard has coarse quantization steps, so a code flipped
    by the two softmax orders moves more than at the kernel geometry
    (measured 7.9e-3)."""
    q = TP_CASES[name][2]
    jcfg, jparams, _, _ = _models(TINY, seed=10)
    pred = JaxPredictor(jparams, jcfg, buckets=(2, 4), impl="pallas",
                        mesh=jax_make_mesh(data=1, model=2), quant=q)
    want = pred(jnp.asarray(_pixels(5, 11)))
    got = _both_ranks(tp_results, name)
    assert tuple(tp_results[0][name]["buckets"].tolist()) == pred.buckets
    assert got.shape == (5, 8)
    if q:
        assert _rel(got, want) <= 2e-2
    else:
        _close(got, want, "float32")


TRAIN_LR = 1e-4


@pytest.fixture(scope="module")
def dp_results(tmp_path_factory):
    _, _, tcfg, tparams = _models(TINY, seed=12)
    labels = torch.from_numpy(np.random.default_rng(13).integers(0, 8, 4))
    cases = {"pred": {"kind": "predictor", "cfg": dict(TINY),
                      "params": tparams, "buckets": (3, 4),
                      "pixels": torch.from_numpy(_pixels(5, 14))},
             "train": {"kind": "train_step", "cfg": dict(TINY),
                       "params": tparams, "lr": TRAIN_LR, "labels": labels,
                       "pixels": torch.from_numpy(_pixels(4, 15))}}
    return _spawn(tmp_path_factory.mktemp("dp"),
                  {"data": 2, "model": 1, "cases": cases}, 2)


def test_torch_dp_predictor_matches_jax(dp_results):
    """``Predictor(mesh=make_mesh(data=2, model=1))``: buckets (3, 4) round
    up to (4,), as JAX's; a request of 5 runs two buckets of 4, each rank
    its 2 rows, and matches JAX's batch-DP ``Predictor(impl="pallas")`` to
    1e-5."""
    jcfg, jparams, _, _ = _models(TINY, seed=12)
    pred = JaxPredictor(jparams, jcfg, buckets=(3, 4), impl="pallas",
                        mesh=jax_make_mesh(data=2, model=1))
    want = pred(jnp.asarray(_pixels(5, 14)))
    assert tuple(dp_results[0]["pred"]["buckets"].tolist()) == pred.buckets \
        == (4,)
    got = _both_ranks(dp_results, "pred")
    assert got.shape == (5, 8)
    _close(got, want, "float32")


def test_torch_dp_train_step_matches_single_process(dp_results):
    """One batch-DP step over data=2 (2 of 4 images a rank) against the
    single-process step on the whole batch, fp32: the averaged gradients
    within 1e-6 of each tensor's largest entry, the loss within 1e-5 and
    every parameter within 1e-4 (JAX's bars,
    ``tests/test_parallel.py:64-81``); both ranks hold the same params."""
    _, _, tcfg, tparams = _models(TINY, seed=12)
    labels = torch.from_numpy(np.random.default_rng(13).integers(0, 8, 4))
    init_fn, step_fn = make_train_step(tcfg, make_optimizer(TRAIN_LR, 0.05),
                                       device="cpu")
    opt = init_fn(tparams)
    tparams, opt, loss = step_fn(tparams, opt,
                                 torch.from_numpy(_pixels(4, 15)), labels)
    want = tree_leaves(tparams)
    a, b = (r["train"] for r in dp_results)
    assert torch.equal(a["loss"], b["loss"])
    assert abs(float(a["loss"]) - float(loss)) <= 1e-5
    for pa, pb, ga, w in zip(a["params"], b["params"], a["grads"], want):
        assert torch.equal(pa, pb)
        assert (ga - w.grad).abs().max() <= 1e-6 * w.grad.abs().max()
        assert (pa - w.detach()).abs().max() <= 1e-4
