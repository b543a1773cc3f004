"""Developer utilities (counterpart of ``vit_tpu/utils/``): timing on the
card, the profiler and determinism switches, and shape tracing."""

from vit_tpu_torch.utils.timing import benchmark_sweep, do_bench, timed
from vit_tpu_torch.utils.tracing import tensor_info

__all__ = ["tensor_info", "timed", "do_bench", "benchmark_sweep"]
