"""One rank of the multi-process cases of ``tests/test_torch_parallel.py``.

    python tests/test_torch_parallel_worker.py JOB RANK WORLD STORE

Joins a gloo process group of ``WORLD`` ranks through the ``file://``
store ``STORE`` (no TCP rendezvous), with a 120 s timeout on every
collective, on one CPU thread; builds the job's mesh, runs each of its
cases on the port and writes the results next to the job as
``JOB.rank<RANK>``. Imports torch, numpy and the port only, never JAX: the
parent computes JAX's side. The module holds no tests of its own.
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]


def _cfg(kw: dict):
    from vit_tpu_torch.config import ViTConfig
    return ViTConfig(**kw)


def run_case(case: dict, mesh) -> dict:
    """One case of a job, on this rank."""
    from vit_tpu_torch.parallel import make_tp_forward, prepare_tp_params
    from vit_tpu_torch.quant import quantize_params
    from vit_tpu_torch.serving import Predictor
    from vit_tpu_torch.train import make_optimizer, make_train_step
    from vit_tpu_torch.weights.convert import tree_leaves

    cfg = _cfg(case["cfg"])
    params, px = case["params"], case["pixels"]
    if case["kind"] == "tp_forward":
        quant = case.get("quant", False)
        tp = prepare_tp_params(quantize_params(params) if quant else params,
                               cfg, mesh)
        fn = make_tp_forward(cfg, mesh, quant=quant)
        return {"out": fn(tp, px)}
    if case["kind"] == "predictor":
        pred = Predictor(params, cfg, case["buckets"], mesh=mesh,
                         quant=case.get("quant", False))
        return {"out": pred(px), "buckets": torch.tensor(pred.buckets)}
    if case["kind"] == "train_step":
        init_fn, step_fn = make_train_step(
            cfg, make_optimizer(case["lr"], 0.05), mesh=mesh)
        opt = init_fn(params)
        params, opt, loss = step_fn(params, opt, px, case["labels"])
        leaves = tree_leaves(params)
        return {"loss": loss, "params": [t.detach() for t in leaves],
                "grads": [t.grad for t in leaves]}
    raise ValueError(f"unknown case kind {case['kind']!r}")


def main(argv: list[str]) -> int:
    job_path, rank, world, store = argv[1], int(argv[2]), int(argv[3]), argv[4]
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from vit_tpu_torch.parallel import make_mesh

    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(job["data"], job["model"], device="cpu")
        results = {name: run_case(case, mesh)
                   for name, case in job["cases"].items()}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    results["jax_loaded"] = any(m.split(".")[0] in ("jax", "vit_tpu")
                                for m in sys.modules)
    torch.save(results, f"{job_path}.rank{rank}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
