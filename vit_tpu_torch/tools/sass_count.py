"""Count the tensor-core instructions of each kernel in the built library,
and say which kernels compile to other code than in a second build.

``cuobjdump -sass`` of the kernel library (``ops.cuda._build``) is split
by function; for each kernel whose demangled name holds one of
``--match`` it prints the count of each tensor-core opcode: ``HMMA``
(``mma.sync`` in bf16), ``IMMA`` (``mma.sync`` in int8), ``HGMMA`` and
``IGMMA`` (``wgmma`` in bf16 and int8). With ``--other`` (another build
of the library, such as the parent's under ``build/parent/``), it also
lists the kernels present in both whose instructions differ, addresses
and the constant-bank offsets of kernel parameters aside, or, with
``--exact``, byte for byte as printed. One JSON line::

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

OPCODES = ("HMMA", "IMMA", "HGMMA", "IGMMA")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or "/usr/local/cuda/bin/cuobjdump"


def functions(lib: str) -> dict[str, list[str]]:
    """The SASS lines of each function (mangled name) of ``lib``."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None and line.strip().startswith("/*"):
            cur.append(line.strip())
    return funcs


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
    """Tensor-core opcodes in a function's SASS."""
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
    text = [_ADDR.sub("", ln).strip() for ln in lines]
    return text if exact else [_PARAM.sub("c[param]", ln) for ln in text]


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
        other = functions(args.other)
        both = [m for m in picked if m in other]
        res["compared"] = len(both)
        res["differ"] = sorted(
            names[m] for m in both
            if _norm(funcs[m], args.exact) != _norm(other[m], args.exact))
        res["only_here"] = sorted(names[m] for m in picked if m not in other)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
