"""What nvcc made of chosen kernels of a ``csrc/*.cu`` source: registers,
spills and an opcode count per kernel, and the SASS itself.

Compiles the source to a cubin with the flags of ``cuda_build`` (``-cubin``
in place of ``-shared``), reads ptxas's report (``-Xptxas -v``) and
``cuobjdump -sass``, and for every kernel whose mangled name contains one
of ``--kernel`` prints one JSON line: the demangled name, registers, spill
bytes, instructions, the count of each opcode (the part before the first
dot: LDG, LDS, ATOMS, F2FP, ...), and the longest run of global loads
issued before any of their results is waited on (``max_ldg_batch``: the
loads in flight one thread can have). The SASS of each kernel goes to
``--out``. Needs the CUDA toolkit (nvcc and cuobjdump):

    python -m dgl1_tpu_torch.tools.sass_report \\
        --source dgl1_tpu_torch/csrc/hub_kernels.cu --kernel chunk_rhs \\
        --out sass_out
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

from dgl1_tpu_torch import cuda_build


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return str(Path(cuda_build.nvcc_path()).parent / name)


def _demangle(names):
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def _ptxas_usage(log: str) -> dict:
    """mangled name -> (registers, spill store bytes, spill load bytes)."""
    usage, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            usage.setdefault(cur, [0, 0, 0])[1:] = [int(m.group(1)),
                                                   int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            usage.setdefault(cur, [0, 0, 0])[0] = int(m.group(1))
    return usage


_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def _functions(sass: str) -> dict:
    """mangled name -> list of (opcode, operands) in order."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = _INSN.search(line)
        if m and cur:
            funcs[cur].append((m.group(1), m.group(2)))
    return funcs


def max_ldg_batch(insns) -> int:
    """The longest run of LDG instructions whose destination registers are
    not read before the last of them is issued (a rough count of the
    global loads one thread keeps in flight)."""
    best, pending = 0, []
    for op, args in insns:
        regs = re.findall(r"\bR\d+\b", args)
        if op.startswith("LDG"):
            dst = regs[0] if regs else None
            srcs = set(regs[1:])
            if any(d in srcs for d in pending):
                pending = []
            pending.append(dst)
            best = max(best, len(pending))
            continue
        reads = set(regs[1:]) if regs else set()
        # Stores, branches and compares read every register they name.
        if op.startswith(("ST", "RED", "ATOM", "ISETP", "FSETP", "BRA")):
            reads = set(regs)
        if any(d in reads for d in pending):
            pending = []
    return best


def report(source: Path, kernels, out_dir: Path | None):
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        flags = [f for f in cuda_build.FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        res = subprocess.run([cuda_build.nvcc_path(), *flags, "-cubin",
                              "-o", str(cubin), str(source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(res.stdout + res.stderr)
        usage = _ptxas_usage(res.stdout + res.stderr)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
    funcs = _functions(sass)
    chosen = [n for n in funcs if any(k in n for k in kernels)]
    rows = []
    for mangled, pretty in zip(chosen, _demangle(chosen)):
        insns = funcs[mangled]
        ops = Counter(op.split(".")[0] for op, _ in insns)
        regs, st, ld = usage.get(mangled, [None, None, None])
        row = {"kernel": pretty, "registers": regs, "spill_stores": st,
               "spill_loads": ld, "instructions": len(insns),
               "max_ldg_batch": max_ldg_batch(insns),
               "opcodes": dict(ops.most_common())}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            safe = re.sub(r"[^A-Za-z0-9_]+", "_", pretty)[:120]
            (out_dir / f"{safe}.sass").write_text(
                "\n".join(f"{op}{args};" for op, args in insns) + "\n")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--source", required=True, type=Path)
    p.add_argument("--kernel", action="append", required=True,
                   help="substring of the mangled kernel name (repeatable)")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    rows = report(args.source, args.kernel, args.out)
    return 0 if rows else 1


if __name__ == "__main__":
    raise SystemExit(main())
