#!/usr/bin/env python3
"""Compile CUDA sources as the package builds them and report each kernel's resources.

For comparing one kernel source across two trees without a card: each
``.cu`` file given is compiled to a cubin with the package's nvcc flags
(``repro_torch.kernels._build.NVCC_FLAGS``, sm_90a) and the package's
``csrc`` on the include path, and for every kernel in it the script prints
one JSON line: the file, the demangled name, ptxas's registers, stack
frame and spilled bytes, the number of SASS instructions, and a hash of
the SASS with addresses, encodings and the kernel's own name taken out,
so that two builds of the same instructions hash alike.  ``--out`` also
writes each kernel's SASS so taken out there, for ``diff``.  Needs the
CUDA toolkit's ``nvcc`` and ``cuobjdump``.

    python scripts/kernel_resources.py src/repro_torch/csrc/flash_attention_tc.cu \\
        parent/src/repro_torch/csrc/flash_attention_tc.cu --out build/sass
"""

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LINK_ONLY = {"-shared", "-fPIC"}  # flags of the shared library, not a cubin


def tool(name: str) -> str:
    found = shutil.which(name) or str(Path("/usr/local/cuda/bin") / name)
    if not Path(found).exists():
        raise SystemExit(f"{name} not found: the CUDA toolkit is needed")
    return found


def nvcc_flags() -> list[str]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import NVCC_FLAGS, SOURCES
    flags = list(NVCC_FLAGS)
    while "-Xcompiler" in flags:  # drop "-Xcompiler -fPIC"
        i = flags.index("-Xcompiler")
        del flags[i:i + 2]
    return [f for f in flags if f not in LINK_ONLY] + ["-I", str(SOURCES)]


def ptxas_report(text: str) -> dict[str, dict]:
    """Per mangled kernel name: registers, stack frame and spill bytes,
    from ``ptxas -v``'s lines."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_by_kernel(cubin: Path) -> dict[str, list[str]]:
    """Per mangled kernel name, its SASS instructions without addresses,
    encodings or the kernel's own name, its labels numbered from 0 in the
    order they appear (cuobjdump numbers them across the file)."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*(/\*.*)?$", line)
        if m and name:
            out[name].append(m.group(1).replace(name, "<self>"))
    for name, body in out.items():
        labels: dict[str, str] = {}
        out[name] = [re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
            m.group(), f".L{len(labels)}"), ins) for ins in body]
    return out


def short_name(demangled: str) -> str:
    """``kernel<1,2,0>`` from a demangled template kernel's name."""
    m = re.search(r"(\w+)<([^<>]*)>", demangled)
    if m is None:
        return re.sub(r"\W+", "_", demangled)[:80]
    args = re.sub(r"\((?:unsigned )?\w+\)|\s", "", m.group(2))
    return f"{m.group(1)}<{args}>"


def demangle(names: list[str]) -> dict[str, str]:
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt is None:
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), check=True,
                         capture_output=True, text=True).stdout.splitlines()
    return dict(zip(names, res))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    flags = nvcc_flags()
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(args.sources):
            cubin = Path(tmp) / f"{i}.cubin"
            res = subprocess.run([tool("nvcc"), *flags, "-cubin", "-o",
                                  str(cubin), str(src)],
                                 capture_output=True, text=True)
            if res.returncode:
                raise SystemExit(f"nvcc failed for {src}:\n{res.stderr}")
            ptxas = ptxas_report(res.stdout + res.stderr)
            sass = sass_by_kernel(cubin)
            names = demangle(sorted(sass))
            for mangled in sorted(sass):
                body = sass[mangled]
                rec = {"file": str(src), "kernel": names[mangled],
                       **ptxas.get(mangled, {}),
                       "instructions": len(body),
                       "sass_sha1": hashlib.sha1(
                           "\n".join(body).encode()).hexdigest()[:16]}
                print(json.dumps(rec))
                if args.out is not None:
                    where = args.out / f"{i}_{src.stem}"
                    where.mkdir(parents=True, exist_ok=True)
                    (where / f"{short_name(names[mangled])}.sass"
                     ).write_text("\n".join(body) + "\n")


if __name__ == "__main__":
    main()
