#!/usr/bin/env python3
"""The geofence kernel's compiled code, counted: instructions per edge test.

Builds ``sitewhere_tpu_torch/csrc/pip_kernel.cu`` (or the source named by
``--source``, e.g. an older tree's) with the wrapper's ``nvcc`` flags,
disassembles it with ``cuobjdump -sass`` and, for each instantiation of
``pip_parity_kernel``, finds the loop that holds the edge tests: of the
loops (backward branches), the one whose body has the most ``FMUL`` (one
multiply per edge test; the smallest such body, the innermost).  Its
instructions over its multiplies are the issue slots a test costs there,
the loop's own overhead per point included.  Prints one JSON line: per
kernel, the registers and spills of ``-Xptxas -v``, the loop's
instructions and edge tests, the instructions per test, and each opcode's
count per test.  Needs the CUDA toolkit (the card's machine); the card
itself is not used.

    python3 tools/torch_pip_sass.py [--source PATH] [--out DIR]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

REPO = Path(__file__).resolve().parent.parent

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?\s*([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(0x[0-9a-f]+)|`?\((\.L_x_\d+)\)")


def toolkit_bin(name: str) -> str:
    """``name`` from the CUDA toolkit beside ``nvcc``."""
    sys.path.insert(0, str(REPO))
    from sitewhere_tpu_torch.ops import geo_cuda

    return str(Path(geo_cuda._nvcc()).parent / name)


def build(source: Path, out_dir: Path) -> Tuple[Path, str]:
    """``source`` built as the wrapper builds it; (library, ptxas log)."""
    sys.path.insert(0, str(REPO))
    from sitewhere_tpu_torch.ops import geo_cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"pip_sass-{os.getpid()}.so"
    cmd = [geo_cuda._nvcc(), *geo_cuda.NVCC_FLAGS, "-o", str(so),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {proc.stdout}{proc.stderr}")
    return so, proc.stdout + proc.stderr


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each entry function in a ``-Xptxas -v``
    log, by mangled name."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def functions(sass: str) -> Dict[str, List[str]]:
    """The ``cuobjdump -sass`` listing split by function."""
    out: Dict[str, List[str]] = {}
    current: Optional[List[str]] = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), [])
        elif current is not None:
            current.append(line)
    return out


def edge_test_loop(lines: Sequence[str]) -> Optional[Dict[str, object]]:
    """The loop with the most FMUL in one function's listing, counted."""
    insns: List[Tuple[int, str, str]] = []     # (address, opcode, operands)
    labels: Dict[str, int] = {}
    pending: List[str] = []
    for line in lines:
        lm = _LABEL.match(line)
        if lm:
            pending.append(lm.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        insns.append((addr, m.group(2), m.group(4)))
    best = None
    for addr, op, args in insns:
        if op != "BRA":
            continue
        t = _TARGET.search(args)
        if not t:
            continue
        target = int(t.group(1), 16) if t.group(1) else labels.get(t.group(2))
        if target is None or target >= addr:
            continue
        body = [o for a, o, _ in insns if target <= a <= addr]
        fmul = body.count("FMUL")
        key = (fmul, -len(body))
        if fmul and (best is None or key > best[0]):
            best = (key, body)
    if best is None:
        return None
    body = best[1]
    tests = body.count("FMUL")
    hist = collections.Counter(body)
    return {"instructions": len(body), "edge_tests": tests,
            "per_test": len(body) / tests,
            "by_opcode_per_test": {op: n / tests
                                   for op, n in hist.most_common()}}


def count(so: Path, log: str = "") -> Dict[str, Dict[str, object]]:
    """Per ``pip_parity_kernel`` instantiation in ``so``, by mangled name
    (``...pip_parity_kernelILi16ELb1E...`` is ``<16, true>``): its
    edge-test loop counted, with the registers and spills of ``log`` (a
    ``-Xptxas -v`` build log, when there is one)."""
    sass = subprocess.run([toolkit_bin("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    regs = ptxas_report(log)
    return {name: {**regs.get(name, {}), "loop": edge_test_loop(lines)}
            for name, lines in sorted(functions(sass).items())
            if "pip_parity_kernel" in name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=REPO / "sitewhere_tpu_torch" / "csrc"
                    / "pip_kernel.cu")
    ap.add_argument("--out", type=Path,
                    default=REPO / "sitewhere_tpu_torch" / "_build")
    args = ap.parse_args(argv)
    so, log = build(args.source, args.out)
    try:
        print(json.dumps({"source": str(args.source),
                          "kernels": count(so, log)}))
    finally:
        so.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
