"""The generated gather-reduce kernels (next/unstructured_codegen.py) run on
the host: each source compiled by the host's C++ compiler under a stand-in
for CUDA that runs every thread of every block one after another (the
kernels share nothing between threads). It runs the kernel's own
indexing, its walk of elements and its arithmetic in the source's order,
so a kernel run here equals another kernel of the same DAG to the bit
where the card's would (``-ffp-contract=off`` for nvcc's
``--fmad=false``); it says nothing of the card's timing or of what
``nvcc`` accepts.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

import torch

PRELUDE = r"""
#include <cmath>
struct gt_dim3 { unsigned x; };
static gt_dim3 threadIdx, blockIdx;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
template <class T> inline T __ldg(const T* p) { return *p; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
using std::fmax; using std::fmin;
typedef void* cudaStream_t;
enum { cudaErrorInvalidConfiguration = 9 };
inline int cudaGetLastError() { return 0; }
template <class K, class P>
inline void gt_emu_launch(K kernel, long long blocks, int threads, const P& p) {
    for (long long b = 0; b < blocks; ++b) {
        for (int t = 0; t < threads; ++t) {
            blockIdx.x = (unsigned)b;
            threadIdx.x = (unsigned)t;
            kernel(p);
        }
    }
}
"""


def available() -> bool:
    return shutil.which("g++") is not None


def host_source(source: str) -> str:
    """``source`` with CUDA's names stood in for (:data:`PRELUDE`)."""
    src = source.replace("#include <cuda_runtime.h>", PRELUDE)
    return re.sub(r"(\w+)<<<([^,]+), ([^,]+), 0, [^>]*>>>\((\w+)\);",
                  r"gt_emu_launch(\1, \2, \3, \4);", src)


_BUILT: dict = {}
_FOLDER = None


def _folder() -> str:
    """A temporary folder for the builds, removed when the process ends."""
    global _FOLDER
    if _FOLDER is None:
        _FOLDER = tempfile.TemporaryDirectory(prefix="gt_neighbor_host_")
    return _FOLDER.name


def build(source: str):
    """The host library of ``source`` (built once per source)."""
    key = hashlib.sha1(source.encode()).hexdigest()[:16]
    lib = _BUILT.get(key)
    if lib is not None:
        return lib
    cpp, so = (os.path.join(_folder(), f"{key}.{ext}") for ext in ("cpp", "so"))
    with open(cpp, "w") as f:
        f.write(host_source(source))
    out = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                          "-w", "-o", so, cpp], capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(out.stderr)
    lib = _BUILT[key] = ctypes.CDLL(so)
    return lib


def launch(program, values, outs, scalars, providers) -> int:
    """``program``'s kernel run on the host on CPU fields: its launcher's
    return code."""
    ins, out_t, tables = program.tensors(values, outs, providers, torch.device("cpu"))
    fn = getattr(build(program.source), f"{program.kernel}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_double),
                   ctypes.c_void_p]
    buffers = ins + out_t + tables
    ptrs = (ctypes.c_void_p * len(buffers))(*[t.data_ptr() for t in buffers])
    c_scalars = (ctypes.c_double * max(len(scalars), 1))(*[float(s) for s in scalars])
    return fn(ptrs, c_scalars, None)
