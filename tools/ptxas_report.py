#!/usr/bin/env python3
"""What ptxas makes of the port's CUDA kernels: each kernel's registers,
spills, stack and barriers (``nvcc -Xptxas -v``), the compiler's wgmma notes
(C75xx: a ``warpgroup.arrive`` it injected, or wgmma it serialized), and
the highest register each kernel's machine code names (``cuobjdump
-sass``), which for a kernel that raises its warps' limit with
``setmaxnreg`` is above the count ptxas reports for the launch.

    python3 tools/ptxas_report.py                 # csrc/attention.cu
    python3 tools/ptxas_report.py distance        # csrc/distance.cu

Builds with the flags of ``kernels/_build.py``, less ``-split-compile``
(its parallel ptxas runs interleave their reports), into a temporary
directory; needs ``nvcc`` (and ``cuobjdump`` beside it), not a GPU.
Prints one JSON object per kernel.
"""
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main():
    from repro_torch.kernels import _build

    name = sys.argv[1] if len(sys.argv) > 1 else "attention"
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / f"{name}.so"
        proc = subprocess.run(
            [nvcc, *(f for f in _build.NVCC_FLAGS if not f.startswith("-split-compile")),
             "-Xptxas", "-v", "-o", str(lib),
             str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        sass = subprocess.run(
            [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib)],
            capture_output=True, text=True, check=True).stdout
    log = proc.stdout + proc.stderr
    notes = Counter((kernel, code) for code, kernel in
                    re.findall(r"\((C75\d\d)\)[^']*'([^']+)'", log))
    max_reg = {}
    for sec in sass.split("Function : ")[1:]:
        head, body = sec.split("\n", 1)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        max_reg[head.strip()] = max(regs) if regs else None
    # ptxas prints "Compiling entry function 'K'", then K's properties
    blocks = re.split(r"Compiling entry function '([^']+)'", log)
    for kernel, text in zip(blocks[1::2], blocks[2::2]):
        row = {"kernel": kernel}
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("barriers", r"used (\d+) barriers"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads"),
                         ("static_smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, text)
            row[key] = int(m.group(1)) if m else 0
        row["sass_max_register"] = max_reg.get(kernel)
        row["wgmma_notes"] = {code: n for (k, code), n in notes.items()
                              if k == kernel}
        print(json.dumps(row))


if __name__ == "__main__":
    main()
