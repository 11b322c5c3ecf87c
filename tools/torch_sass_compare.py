#!/usr/bin/env python3
"""Compare the SASS of one CUDA source's kernels between two source trees,
over several compiles of each: ``ptxas`` can give one source different code
from one compile to the next (the 255-register kernels of
``whole_solve.cu``, more so in a loaded build), so one compile a tree shows
nothing.

    python3 tools/torch_sass_compare.py --a DIR [--b .] [--source whole_solve.cu]
        [--compiles 2] [--jobs 4] [--ptx]

``DIR`` is an unpacked checkout of another commit. Each compile is ``nvcc
-cubin`` of ``regneuralde_tpu_torch/csrc/<source>`` of a tree with the flags
``ops/_cuda.py`` of this tree builds it with, into ``build/sass/``, ``--jobs``
at a time; ``cuobjdump -sass`` of each cubin is hashed per kernel, its branch
labels numbered within the kernel and the translation unit's tags taken out
(as ``tools/torch_kernel_ab.py`` does). With ``--ptx`` each compile is
``nvcc -ptx`` instead, the step before ``ptxas``, and each function's PTX is
hashed with its virtual registers, branch labels and the translation unit's
tags numbered away, so a source edit that leaves a kernel's instructions as
they were reads ``same`` (the PTX too can differ between two compiles of one
source, in a split vector load or two). For each kernel it prints how many
distinct SASS (or PTX) each tree's compiles gave, and ``same`` where some
compile of A equals some compile of B, ``differs`` where none does, or the
tree it is only in. Needs ``nvcc`` and ``cuobjdump``, no card.
"""

import argparse
import hashlib
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path


def _sass(cubin, cuobjdump):
    """Kernel name -> hash of its SASS in ``cubin``."""
    dump = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
            name = re.sub(r"_cu_[0-9a-f]{8}", "_cu_", name)
            out[name], labels = hashlib.sha256(), {}
        elif name and line.strip().startswith(("/*", ".L_x_")):
            line = re.sub(r"\.L_x_\d+",
                          lambda l: "L%d" % labels.setdefault(l.group(0), len(labels)), line)
            line = re.sub(r"\$__internal_\d+_", "$__internal_", line)
            out[name].update(" ".join(line.split()).encode())
    return {k: h.hexdigest() for k, h in out.items()}


def _ptx(path):
    """Function name -> hash of its PTX in ``path``, registers and labels
    numbered away."""
    text = Path(path).read_text()
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    text = re.sub(r"_INTERNAL_[0-9a-f]+_", "_INTERNAL_", text)
    text = re.sub(r"_cu_[0-9a-f]{8}", "_cu_", text)
    text = re.sub(r"%(r|rd|f|fd|p|rs|h)\d+", r"%\1", text)
    text = re.sub(r"\$L__BB\d+_\d+", "$L", text)
    text = re.sub(r"<\d+>", "<N>", text)
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*(?:\.visible\s+|\.weak\s+)?\.(?:entry|func)\s+(?:\([^)]*\)\s*)?(\S+?)\(",
                     line)
        if m:
            name = m.group(1)
            out[name] = hashlib.sha256()
        if name:
            out[name].update(line.encode())
    return {k: h.hexdigest() for k, h in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="the other tree")
    ap.add_argument("--b", default=".", help="this tree (default: the current directory)")
    ap.add_argument("--source", default="whole_solve.cu")
    ap.add_argument("--compiles", type=int, default=2, help="compiles of each tree")
    ap.add_argument("--jobs", type=int, default=4, help="compiles at a time")
    ap.add_argument("--ptx", action="store_true", help="compare PTX, not SASS")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.b).resolve()))
    from regneuralde_tpu_torch.ops import _cuda

    nvcc = _cuda._nvcc()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    flags = [*_cuda._FLAGS, *_cuda._SOURCE_FLAGS.get(args.source, [])]
    out_dir = Path(args.b).resolve() / "build" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, Path(tree).resolve(), k) for k in range(args.compiles)
            for tag, tree in (("A", args.a), ("B", args.b))]
    running, done = [], []
    start = time.perf_counter()
    while jobs or running:
        while jobs and len(running) < args.jobs:
            tag, tree, k = jobs.pop(0)
            kind = "ptx" if args.ptx else "cubin"
            out = out_dir / f"{tag}{k}_{Path(args.source).stem}.{kind}"
            src = tree / "regneuralde_tpu_torch" / "csrc" / args.source
            proc = subprocess.Popen([nvcc, *flags, f"-{kind}", "-o", str(out), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running.append((tag, k, out, proc))
        tag, k, out, proc = running.pop(0)
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"[sass] nvcc failed on tree {tag}:\n{err[-3000:]}", file=sys.stderr)
            return 1
        done.append((tag, k, _ptx(out) if args.ptx else _sass(out, cuobjdump)))
        print(f"[sass] {tag} compile {k} done at {time.perf_counter() - start:.0f} s",
              flush=True)
    by_tree = {t: [s for tag, _, s in done if tag == t] for t in ("A", "B")}
    names = sorted({n for _, _, s in done for n in s})
    for name in names:
        seen = {t: {s[name] for s in by_tree[t] if name in s} for t in ("A", "B")}
        if not seen["A"] or not seen["B"]:
            verdict = "only in " + ("B" if seen["B"] else "A")
        else:
            verdict = "same" if seen["A"] & seen["B"] else "differs"
        print(f"[sass] {name[:100]}: {verdict}; distinct over "
              f"{args.compiles} compiles A {len(seen['A'])}, B {len(seen['B'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
