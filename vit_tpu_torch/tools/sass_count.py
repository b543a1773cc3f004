"""Count the tensor-core instructions of each kernel in the built library,
and say which kernels compile to other code than in a second build.

``cuobjdump -sass`` of the kernel library (``ops.cuda._build``) is split
by function; for each kernel whose demangled name holds one of
``--match`` it prints the count of each tensor-core opcode: ``HMMA``
(``mma.sync`` in bf16 and tf32), ``IMMA`` (``mma.sync`` in int8), ``HGMMA``
and ``IGMMA`` (``wgmma`` in bf16 and tf32, and in int8); and of ``FFMA``,
the fp32 multiply-adds of the FMA units (static counts: a loop counts
once). With ``--other`` (another build
of the library, such as the parent's under ``build/parent/``), it also
lists the kernels present in both (by demangled name, every copy) whose
instructions differ, addresses, column padding, encodings and the
constant-bank offsets of kernel parameters aside, or, with ``--exact``,
instruction for instruction with their encodings (addresses and padding
aside). One JSON line::

    python -m vit_tpu_torch.tools.sass_count --match attn_probe dot_probe
    python -m vit_tpu_torch.tools.sass_count --match attention_kernel \\
        --other build/parent/build/vit_tpu_torch/libvit_kernels_<hash>.so
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys

OPCODES = ("HMMA", "IMMA", "HGMMA", "IGMMA", "FFMA")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")
_ENC = re.compile(r"/\* 0x[0-9a-f]+ \*/")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or "/usr/local/cuda/bin/cuobjdump"


def copies(lib: str) -> dict[str, list[list[str]]]:
    """The SASS lines of each copy of each function (mangled name) of
    ``lib``: a kernel instantiated in several units has a copy in each."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = []
            funcs.setdefault(m.group(1), []).append(cur)
        elif cur is not None and line.strip().startswith("/*"):
            cur.append(line.strip())
    return funcs


def functions(lib: str) -> dict[str, list[str]]:
    """The SASS lines of each function (mangled name) of ``lib``, its
    first copy."""
    return {m: c[0] for m, c in copies(lib).items()}


def by_name(lib: str) -> dict[str, list[list[str]]]:
    """Every copy of each function of ``lib`` under its demangled name:
    a kernel of internal linkage is mangled with a hash of its unit's
    path, so two builds in two directories name it differently."""
    funcs = copies(lib)
    names = demangle(list(funcs))
    out: dict[str, list[list[str]]] = {}
    for m, c in funcs.items():
        out.setdefault(names[m], []).extend(c)
    return out


def demangle(names: list[str]) -> dict[str, str]:
    """Mangled -> demangled names (cu++filt, else c++filt, else as is)."""
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def counts(lines: list[str]) -> dict[str, int]:
    """Tensor-core opcodes and FFMA in a function's SASS."""
    got = dict.fromkeys(OPCODES, 0)
    for line in lines:
        body = _ADDR.sub("", line).strip()
        op = body.split()[0] if body.split() else ""
        if op.startswith("@"):  # a predicate
            op = body.split()[1] if len(body.split()) > 1 else ""
        base = op.split(".")[0]
        if base in got:
            got[base] += 1
    return got


def _norm(lines: list[str], exact: bool) -> list[str]:
    """A function's SASS lines without their addresses and with runs of
    blanks as one (cuobjdump pads each unit's columns to its widest line,
    so a kernel's text moves when another kernel of its unit changes);
    unless ``exact``, also without the instruction encodings and with the
    constant-bank offsets of kernel parameters masked."""
    text = [" ".join(_ADDR.sub("", ln).split()) for ln in lines]
    if exact:
        return text
    return [_PARAM.sub("c[param]", _ENC.sub("", ln)).strip() for ln in text]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", help="the library (default: build it, "
                    "ops.cuda._build.build())")
    ap.add_argument("--match", nargs="+", default=[""],
                    help="substrings of the demangled kernel names")
    ap.add_argument("--other", help="a second build to compare with")
    ap.add_argument("--exact", action="store_true",
                    help="compare parameter offsets too")
    args = ap.parse_args(argv)
    lib = args.lib
    if lib is None:
        from vit_tpu_torch.ops.cuda import _build
        lib = str(_build.build())
    funcs = functions(lib)
    names = demangle(list(funcs))
    picked = {m: names[m] for m in funcs
              if any(s in names[m] for s in args.match)}
    res = {"lib": lib, "kernels": {names[m]: counts(funcs[m])
                                   for m in sorted(picked)}}
    if args.other:
        here, other = by_name(lib), by_name(args.other)
        mine = sorted(set(picked.values()))
        both = [n for n in mine if n in other]

        def text(cs):
            return sorted(tuple(_norm(c, args.exact)) for c in cs)
        res["compared"] = len(both)
        res["differ"] = [n for n in both
                         if text(here[n]) != text(other[n])]
        res["only_here"] = [n for n in mine if n not in other]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
