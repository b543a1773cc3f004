"""The JAX package's kernel probes on the card (counterparts of
``tools/int8_probe.py``, ``tools/attn_core_probe.py`` and
``tools/encstack_minrepro.py``), each on a hand-written kernel of its own:

- :mod:`~vit_tpu_torch.tools.int8_probe` -- K22 ``dot_probe``;
- :mod:`~vit_tpu_torch.tools.attn_core_probe` -- K23 ``attn_core_probe``;
- :mod:`~vit_tpu_torch.tools.encstack_minrepro` -- K24 ``encstack_probe``.

Run each as ``python -m vit_tpu_torch.tools.<name>``; ``--device cpu``
runs the plain versions and times nothing.
"""

from __future__ import annotations

import shutil
import subprocess


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    None where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def require_device(device: str) -> None:
    """Raise where ``device`` is a card and there is none."""
    import torch
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "versions")
