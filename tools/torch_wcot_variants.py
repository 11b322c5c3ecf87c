#!/usr/bin/env python3
"""Build variants of the weight-cotangent contraction
(``regneuralde_tpu_torch/csrc/weight_cotangents.cu``) with some of its
constants or lines replaced, and check and time each on one GPU.

    python3 tools/torch_wcot_variants.py [--variants shipped,stages3,...]

Each variant is the source with the substitutions of ``VARIANTS`` made,
compiled by ``nvcc`` (as ``ops/_cuda.py`` compiles it, ``-Xptxas -v``) into
a library of its own under ``build/wcot_variants/``. For each variant it
prints what ``ptxas`` reported for the chunk kernel's two instantiations
(registers, spills), then on seeded random rows at D x H = 784 x 100 and
each K of ``CASES``, with the chunk rows given there: the largest distance
of each product from the float64 product beside that of the float32
``torch.mm`` (TF32 off), whether two runs are bitwise equal, and the
device time of the chunk and chunk-sum kernels under ``torch.profiler``
(median of 5 windows of 10 calls). ``torch.mm``'s time is printed once a K.
"""

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SRC = ROOT / "regneuralde_tpu_torch" / "csrc" / "weight_cotangents.cu"
OUT = ROOT / "build" / "wcot_variants"
REMAP = ("const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;",
         "const int tx = (threadIdx.x & 7) | (((threadIdx.x >> 5) & 1) << 3), "
         "ty = ((threadIdx.x >> 3) & 3) | ((threadIdx.x >> 6) << 2);")
# name -> substitutions (each must occur in the source)
VARIANTS = {
    "shipped": [],
    "stages3": [("kStages = 4;", "kStages = 3;")],
    "stages2": [("kStages = 4;", "kStages = 2;")],
    "bk16_stages3": [("kBK = 8;", "kBK = 16;"), ("kStages = 4;", "kStages = 3;")],
    "bk32_stages2": [("kBK = 8;", "kBK = 32;"), ("kStages = 4;", "kStages = 2;")],
    "warps_4x8": [REMAP],  # a warp spans 4 x 8 threads of the tile, not 2 x 16
    "warps_4x8_3blocks": [REMAP, ("__launch_bounds__(kThreads, 4)",
                                  "__launch_bounds__(kThreads, 3)")],
}
# K and the chunk rows to run it in: one chunk of 384 rows against
# ops/weight_cotangents.py plan()'s six of 64, then plan()'s rows at the
# step kernels' 6 * 512 and K4's 6 * 512 * 33
CASES = ((384, 384), (384, 64), (3072, 160), (101376, 5072))
D, H = 784, 100


def build(names):
    import shutil

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    procs = {}
    for name in names:
        text = src
        for a, b in VARIANTS[name]:
            if a not in text:
                raise SystemExit(f"variant {name}: {a!r} is not in the source")
            text = text.replace(a, b)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o", str(OUT / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        report, kernel = [], None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and "wcot_chunk_kernel" in kernel and (
                    "spill" in line or "registers" in line):
                report.append(line.split(":", 1)[-1].strip())
        print(f"[ptxas] {name}: " + "; ".join(report))
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).regnde_weight_cotangents
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_wcot_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = build(names)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    r4 = lambda x: -(-x // 4) * 4
    per_chunk = r4(D) * r4(H + 2) + r4(H) * r4(D + 2)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    gen = torch.Generator().manual_seed(41)
    rows_of = {}
    for K, chunk_rows in CASES:
        if K not in rows_of:
            rows_of.clear()
            rows_of[K] = [torch.randn(K, w, generator=gen).to(dev)
                          for w in (D, H + 2, H, D + 2)]
            cp2, he, cp1, ye = rows_of[K]
            exact = [torch.mm(cp2.double().t(), he.double()),
                     torch.mm(cp1.double().t(), ye.double())]
            d_mm = [(torch.mm(a.t(), b).double() - x).abs().max().item()
                    for (a, b), x in zip(((cp2, he), (cp1, ye)), exact)]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                torch.mm(cp2.t(), he), torch.mm(cp1.t(), ye)
            end.record()
            torch.cuda.synchronize()
            print(f"[K={K}] torch.mm, both products: {start.elapsed_time(end) / 20:.4f} ms; "
                  f"distance from float64 {d_mm}")
        cp2, he, cp1, ye = rows_of[K]
        nchunks = max(1, -(-K // chunk_rows))
        part = torch.empty(nchunks * per_chunk, device=dev)
        outs = [torch.empty((H, D + 1), device=dev), torch.empty(H, device=dev),
                torch.empty((D, H + 1), device=dev), torch.empty(D, device=dev)]
        for name, fn in libs.items():
            call = lambda: fn(*map(ptr, (cp2, he, cp1, ye, *outs, part)), K, D, H, chunk_rows,
                              nchunks * per_chunk, stream)
            if call() != 0:
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            first = [o.clone() for o in outs]
            call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(first, outs))
            got = [torch.cat([outs[2], outs[3][:, None]], 1).double(),
                   torch.cat([outs[0], outs[1][:, None]], 1).double()]
            d_k = [(g - x).abs().max().item() for g, x in zip(got, exact)]
            windows = []
            for _ in range(5):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                windows.append(sum(e.self_device_time_total for e in prof.key_averages()
                                   if e.device_type == DeviceType.CUDA and "wcot_" in e.key)
                               / 1e3 / 10)
            print(f"[K={K} chunks={nchunks}x{chunk_rows}] {name}: device "
                  f"{statistics.median(windows):.4f} ms (windows {min(windows):.4f}-"
                  f"{max(windows):.4f}); bitwise twice {same}; distance from float64 {d_k}, "
                  f"{max(a / b for a, b in zip(d_k, d_mm)):.2f}x torch.mm's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
