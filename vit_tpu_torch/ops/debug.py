"""In-kernel debugging, the host side (counterpart of
``vit_tpu/ops/pallas/debug.py``).

A condition string gates a kernel's print on its block's index, as JAX's
``print_if`` gates ``pl.debug_print`` on ``pl.program_id``: ``'=0,>1'``
means "grid axis 0 == 0 and grid axis 1 > 1", and an empty entry
(``'=0,,<=2'``) is always true. :func:`pid_conds` parses it here, once, into
one ``(op, rhs)`` pair an axis; a CUDA kernel takes the pairs by value and
tests them against ``blockIdx`` (``csrc/debug.cuh``: ``vit::print_if``).

:func:`print_if_smoke` is the counterpart of the Pallas smoke kernel of
``tests/test_ops_pallas.py:235-256``, a copy that prints its block's sum
where the conditions hold: kernel K20 (``csrc/debug.cu``) on a CUDA tensor,
its plain version on a CPU tensor.
"""

from __future__ import annotations

import operator

import torch

from vit_tpu_torch.ops.dispatch import resolve_impl

#: Comparison codes of the C interface (``csrc/debug.cuh``: ``PidOp``);
#: 0 is "always".
OPS = {"=": 1, "==": 1, "!=": 2, "<": 3, "<=": 4, ">": 5, ">=": 6}
_TESTS = {1: operator.eq, 2: operator.ne, 3: operator.lt, 4: operator.le,
          5: operator.gt, 6: operator.ge}
#: Grid axes a condition may name: a CUDA grid's x, y and z.
AXES = 3
#: The line a matching block of the smoke kernel prints.
SMOKE_FMT = "block ({}, {}, {}) sum = {:.9g}"


def pid_conds(conds: str) -> tuple[tuple[int, int] | None, ...]:
    """``'=0,>1'`` -> one entry an axis, ``(op code, rhs)`` or None (always
    true), parsed as ``vit_tpu/ops/pallas/debug.py:pid_conds`` parses it.
    A condition with no known operator or no integer after it raises
    ``ValueError``, as does one past the third axis."""
    parsed = []
    for cond in conds.split(","):
        cond = cond.strip()
        if not cond:
            parsed.append(None)
            continue
        op = cond[:2] if cond[:2] in OPS else cond[:1]
        if op not in OPS:
            raise ValueError(f"no comparison in condition {cond!r}")
        parsed.append((OPS[op], int(cond[len(op):])))
    if len(parsed) > AXES and any(parsed[AXES:]):
        raise ValueError(f"{conds!r} has conditions past the {AXES} grid axes")
    return tuple(parsed[:AXES])


def pid_matches(conds: str, pid: tuple[int, ...]) -> bool:
    """Whether the block at ``pid`` (its index on each axis, missing axes 0)
    satisfies every condition of ``conds``."""
    pid = tuple(pid) + (0,) * (AXES - len(pid))
    return all(c is None or _TESTS[c[0]](v, c[1])
               for c, v in zip(pid_conds(conds), pid))


def conds_args(conds: str) -> tuple[int, ...]:
    """The C interface's ``(op, rhs)`` of axes 0, 1 and 2, flattened."""
    parsed = pid_conds(conds)
    parsed += (None,) * (AXES - len(parsed))
    return tuple(v for c in parsed for v in (c or (0, 0)))


def smoke_grid(x: torch.Tensor, grid: tuple[int, ...]) -> tuple[int, int]:
    """``(gx, gy)`` of a one- or two-axis grid over the rows and columns of
    a 2-D ``x``; raise unless its tiles divide ``x`` evenly."""
    if x.dim() != 2 or not 1 <= len(grid) <= 2:
        raise ValueError(f"x {tuple(x.shape)} and grid {grid}: need a 2-D x "
                         "and a grid of one or two axes")
    gx, gy = (tuple(grid) + (1,))[:2]
    rows, cols = x.shape
    if gx <= 0 or gy <= 0 or rows % gx or cols % gy:
        raise ValueError(f"grid {grid} does not tile x {tuple(x.shape)}")
    return gx, gy


def print_if_lines(x: torch.Tensor, conds: str = "=0", *,
                   grid: tuple[int, ...] = (2,)) -> list[str]:
    """The lines the smoke kernel prints, in block order: for each block
    ``(i, j)`` of ``grid`` over ``x`` whose index satisfies ``conds``, the
    fp32 sum of its ``(R/gx, C/gy)`` tile."""
    gx, gy = smoke_grid(x, grid)
    tr, tc = x.shape[0] // gx, x.shape[1] // gy
    return [SMOKE_FMT.format(i, j, 0, float(
                x[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc].float().sum()))
            for i in range(gx) for j in range(gy)
            if pid_matches(conds, (i, j))]


def print_if_smoke(x: torch.Tensor, conds: str = "=0", *,
                   grid: tuple[int, ...] = (2,),
                   impl: str | None = None) -> torch.Tensor:
    """A copy of the 2-D ``x`` over ``grid`` whose matching blocks print
    their tile's sum to standard output. On a CUDA tensor, kernel K20: the
    device's ``printf`` reaches the process's standard output at the next
    synchronisation. On a CPU tensor, its plain version prints
    :func:`print_if_lines` at once."""
    if resolve_impl(impl, x) == "cuda":
        from vit_tpu_torch.ops.cuda.debug import print_if_smoke as kernel
        return kernel(x, conds, grid=grid)
    for line in print_if_lines(x, conds, grid=grid):
        print(line)
    return x.clone()
