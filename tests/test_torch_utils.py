"""The port's developer utilities (``vit_tpu_torch/utils/``), the four
tests of ``tests/test_utils.py`` on ``timed``, ``do_bench`` and
``tensor_info``, and the profiler and determinism switches. On the CPU the
times come from the host clock; on a card, from CUDA events."""

import logging
from types import SimpleNamespace

import pytest
import torch

from vit_tpu_torch.utils import do_bench, tensor_info, timed
from vit_tpu_torch.utils import profiling
from vit_tpu_torch.utils.profiling import (deterministic, kernel_times,
                                           launch_ms, trace)
from vit_tpu_torch.utils.timing import benchmark_sweep, pipelined_ms


def test_torch_tensor_info_logs_shapes(caplog):
    @tensor_info
    def f(x, y):
        return x + y

    with caplog.at_level(logging.INFO, logger="vit_tpu_torch"):
        out = f(torch.ones((2, 3)), torch.ones((2, 3)))
    assert torch.equal(out, 2 * torch.ones((2, 3)))
    msgs = [r.message for r in caplog.records]
    assert any("(2, 3)" in m and "<-" in m for m in msgs)
    assert any("(2, 3)" in m and "->" in m for m in msgs)


def test_torch_tensor_info_named(caplog):
    @tensor_info(name="custom")
    def f(x):
        return x * 2

    with caplog.at_level(logging.INFO, logger="vit_tpu_torch"):
        assert torch.equal(f(torch.ones(3)), 2 * torch.ones(3))
    assert all(r.message.startswith("custom ") for r in caplog.records)


def test_torch_timed_returns_result_and_ms():
    out, ms = timed(lambda a: a * 2, torch.ones((4,)))
    assert torch.equal(out, 2 * torch.ones(4))
    assert ms > 0


def test_torch_do_bench_quantiles():
    p50, p20, p80 = do_bench(lambda: torch.ones((8,)) + 1, warmup=1, reps=5)
    assert 0 < p20 <= p50 <= p80


def test_torch_benchmark_sweep_rows():
    rows = list(benchmark_sweep(
        lambda n: {"add": lambda: torch.ones(n) + 1}, [4, 8], warmup=1,
        reps=3))
    assert [r["size"] for r in rows] == [4, 8]
    assert all(r["add_ms_lo"] <= r["add_ms"] <= r["add_ms_hi"] for r in rows)


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    @tensor_info(name="scaled")
    def f(x):
        return x * 3

    with trace(str(tmp_path)) as prof:
        f(torch.ones(16))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("mul" in e.key for e in prof.key_averages())


def test_torch_deterministic_sets_and_restores():
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with deterministic():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
    with pytest.raises(RuntimeError), deterministic():
        raise RuntimeError("restored on the way out")
    assert torch.are_deterministic_algorithms_enabled() == before[0]


def test_torch_pipelined_ms_on_the_cpu():
    """Off the card the calls are timed one by one, on the host clock."""
    assert pipelined_ms(lambda: torch.ones((8,)) + 1, warmup=1, reps=5) > 0


def _fake_profiler(monkeypatch, *windows):
    """``torch.profiler.profile`` replaced by windows of (kernel, total
    us, records), one a profile in turn, and no card to synchronise."""
    import torch.profiler

    windows = iter(windows)

    class Profile:
        def __init__(self, activities):
            self.events = next(windows)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [SimpleNamespace(key=k, self_device_time_total=us, count=n)
                    for k, us, n in self.events]
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize", lambda: None)


def test_torch_kernel_times_divides_by_the_records(monkeypatch):
    """A launch's time is the total over the records kept; the launches a
    call are the records over the calls rounded (records the profiler
    missed), where that is at least one, and as they stand below."""
    _fake_profiler(monkeypatch, [("core", 8000.0, 8), ("gemm", 380.0, 19),
                                 ("lazy", 60.0, 3), ("idle", 0.0, 10)])
    got = kernel_times(lambda: None, 10)
    assert got["core"] == (1.0, 1) and got["gemm"] == (0.02, 2)
    assert got["lazy"] == (pytest.approx(0.02), pytest.approx(0.3))
    assert "idle" not in got
    assert sum(ms * n for ms, n in got.values()) == pytest.approx(1.046)


def test_torch_launch_ms_takes_the_first_window_that_kept_the_kernel(
        monkeypatch):
    _fake_profiler(monkeypatch, [("copy", 50.0, 10)],
                   [("copy", 50.0, 10), ("void stack_kernel<bf16>", 700.0, 2)],
                   [("copy", 50.0, 10)], [("copy", 50.0, 10)],
                   [("copy", 50.0, 10)])
    assert launch_ms(lambda: None, "stack_kernel", 10) == 0.35
    assert launch_ms(lambda: None, "stack_kernel", 10) is None


def test_torch_turns_times_chip_smoke_cases():
    """``tools/turns.py`` takes its kernel cases from ``chip_smoke.py``'s
    builders by name, so the two cannot drift apart: every builder it names
    exists there, with a float dtype, and its worker compiles."""
    import importlib.util
    from pathlib import Path

    from vit_tpu_torch.tools import turns

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    compile(turns.WORKER, "turns-worker", "exec")
    for builder, dtype, name, label, library in turns.CASES.values():
        assert callable(getattr(smoke, builder)), builder
        assert dtype in ("bfloat16", "float32") and name and label
        assert isinstance(library, bool)
