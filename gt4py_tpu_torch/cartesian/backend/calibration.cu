// The calibration probes of bench.py::main as hand-written kernels for the
// H100 (sm_90a). gt4py_tpu_torch/cartesian/backend/calibration.py builds this
// file with the stencil kernels' flags (cuda_backend.NVCC_FLAGS: -O3,
// --fmad=false, no fast math), binds the three launchers with ctypes and
// holds each kernel against its plain PyTorch version.
//
// They replace the TPU's three pallas_calls in bench.py::main:
//   probe_walk<M, N>  _mk_probe(m_fma, n_div).kern   (bench.py:1484, call :1494)
//   plane_walk5       _pw_kernel                     (bench.py:1410, call :1414)
//   bf16_windows<N>   _mk_bf16_probe(n_windows).kern (bench.py:1339, call :1351)
//
// Design: each has the execution shape of the port's column walks, the
// kernel class the probes calibrate: one thread per (i, j) point, blocks of
// CAL_BJ points along J by CAL_BI along I (cuda_codegen.COL_BJ, COL_BI), each
// thread walking the nk planes of its point. Loads are coalesced along J and
// nothing is staged in shared memory: no cp.async ring, no TMA. The probes
// measure what such a plain walk costs. Each is bound by bytes at the
// counts bench.py uses (every input read once, the output written once);
// the larger instantiations (128, 0) and (0, 64), the card's own reading,
// are meant to spend longer on their arithmetic than on their bytes.
//
// Arithmetic: --fmad=false keeps x * y + z as a rounded product and a
// rounded sum, and float division is IEEE (no fast math), so each kernel
// equals its plain version, which rounds every operation separately, to the
// bit. The bfloat16 probe computes in float32 and rounds to bfloat16 after
// every add, as torch's bfloat16 add does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CAL_BJ 32
#define CAL_BI 8
// what the launchers return on an empty grid (cuda_codegen.NOTHING_LAUNCHED),
// and for a variant that was not instantiated
#define CAL_NOTHING_LAUNCHED (-1)
#define CAL_NOT_INSTANTIATED (-2)

// A float32 load issued where it stands in the source. P1 loads a level's
// four values through it, before the level's arithmetic: with plain loads
// the compiler sinks each load to its first use, behind the division before
// it, and no load is hoisted over a division's slow-path branch, so a level
// of (0, 4) waited for four load latencies in a row (the first design: 110.1
// us against 27.5 with no division, PERF.md). ld.global.nc: the inputs are
// read-only during the launch.
__device__ __forceinline__ float cal_load(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// P1: accs = (a, b, c, d); M times accs[s % 4] = accs[s % 4] * 1.0000001f +
// accs[(s + 1) % 4]; N times accs[s % 4] = accs[s % 4] / (accs[(s + 1) % 4] +
// 2.0f); o = accs[0] + accs[1] * accs[2] - accs[3]. 1.0000001f is
// np.float32(1.0000001), 1 + 2^-23.
template <int M, int N>
__global__ void __launch_bounds__(CAL_BJ * CAL_BI)
probe_walk(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, const float* __restrict__ d,
           float* __restrict__ o, long long ni, long long nj, long long nk) {
  const long long j = (long long)blockIdx.x * CAL_BJ + threadIdx.x;
  const long long i = (long long)blockIdx.y * CAL_BI + threadIdx.y;
  if (i >= ni || j >= nj) return;
  const long long plane = ni * nj;
  long long p = i * nj + j;
  for (long long k = 0; k < nk; ++k, p += plane) {
    float acc[4] = {cal_load(a + p), cal_load(b + p), cal_load(c + p), cal_load(d + p)};
#pragma unroll
    for (int s = 0; s < M; ++s) acc[s % 4] = acc[s % 4] * 1.0000001f + acc[(s + 1) % 4];
#pragma unroll
    for (int s = 0; s < N; ++s) acc[s % 4] = acc[s % 4] / (acc[(s + 1) % 4] + 2.0f);
    o[p] = acc[0] + acc[1] * acc[2] - acc[3];
  }
}

// P2: o = a + b * c - d, a walk of five float32 streams.
__global__ void __launch_bounds__(CAL_BJ * CAL_BI)
plane_walk5(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, const float* __restrict__ d,
            float* __restrict__ o, long long ni, long long nj, long long nk) {
  const long long j = (long long)blockIdx.x * CAL_BJ + threadIdx.x;
  const long long i = (long long)blockIdx.y * CAL_BI + threadIdx.y;
  if (i >= ni || j >= nj) return;
  const long long plane = ni * nj;
  long long p = i * nj + j;
  for (long long k = 0; k < nk; ++k, p += plane) o[p] = a[p] + b[p] * c[p] - d[p];
}

// P3: x = a; N times x = x + a shifted by w + 1 along J with wrap-around
// (jnp.concatenate([a[:, :, w + 1:], a[:, :, :w + 1]], axis=2), i.e.
// torch.roll(a, -(w + 1), dims=2)); o = x. bfloat16 in and out, each add in
// float32 rounded to bfloat16. The wrapper keeps N below nj.
template <int N>
__global__ void __launch_bounds__(CAL_BJ * CAL_BI)
bf16_windows(const __nv_bfloat16* __restrict__ a, __nv_bfloat16* __restrict__ o,
             long long ni, long long nj, long long nk) {
  const long long j = (long long)blockIdx.x * CAL_BJ + threadIdx.x;
  const long long i = (long long)blockIdx.y * CAL_BI + threadIdx.y;
  if (i >= ni || j >= nj) return;
  const long long plane = ni * nj;
  long long row = i * nj;
  for (long long k = 0; k < nk; ++k, row += plane) {
    __nv_bfloat16 x = a[row + j];
#pragma unroll
    for (int w = 0; w < N; ++w) {
      long long jw = j + w + 1;
      if (jw >= nj) jw -= nj;
      x = __float2bfloat16_rn(__bfloat162float(x) + __bfloat162float(a[row + jw]));
    }
    o[row + j] = x;
  }
}

static dim3 cal_grid(long long ni, long long nj) {
  return dim3((unsigned)((nj + CAL_BJ - 1) / CAL_BJ), (unsigned)((ni + CAL_BI - 1) / CAL_BI), 1u);
}

// The instantiated (M, N) of probe_walk: bench.py's three (:1525-1527), then
// two larger ones that only the card's own reading uses.
#define CAL_PROBE_WALK_VARIANTS(X) X(0, 0) X(16, 0) X(0, 4) X(128, 0) X(0, 64)
// The instantiated N of bf16_windows: bench.py's two (:1378-1386).
#define CAL_BF16_WINDOWS_VARIANTS(X) X(0) X(1)

extern "C" int gt_probe_walk(int m, int n, const void* a, const void* b, const void* c,
                             const void* d, void* o, long long ni, long long nj,
                             long long nk, void* stream) {
  const dim3 grid = cal_grid(ni, nj), block(CAL_BJ, CAL_BI);
  if (grid.x == 0 || grid.y == 0) return CAL_NOTHING_LAUNCHED;
  const cudaStream_t s = (cudaStream_t)stream;
#define CAL_LAUNCH(M, N)                                                                 \
  if (m == M && n == N) {                                                                \
    probe_walk<M, N><<<grid, block, 0, s>>>((const float*)a, (const float*)b,            \
                                           (const float*)c, (const float*)d, (float*)o, \
                                           ni, nj, nk);                                  \
    return (int)cudaGetLastError();                                                      \
  }
  CAL_PROBE_WALK_VARIANTS(CAL_LAUNCH)
#undef CAL_LAUNCH
  return CAL_NOT_INSTANTIATED;
}

extern "C" int gt_plane_walk5(const void* a, const void* b, const void* c, const void* d,
                              void* o, long long ni, long long nj, long long nk,
                              void* stream) {
  const dim3 grid = cal_grid(ni, nj), block(CAL_BJ, CAL_BI);
  if (grid.x == 0 || grid.y == 0) return CAL_NOTHING_LAUNCHED;
  plane_walk5<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)c, (const float*)d, (float*)o, ni, nj, nk);
  return (int)cudaGetLastError();
}

extern "C" int gt_bf16_windows(int n, const void* a, void* o, long long ni, long long nj,
                               long long nk, void* stream) {
  const dim3 grid = cal_grid(ni, nj), block(CAL_BJ, CAL_BI);
  if (grid.x == 0 || grid.y == 0) return CAL_NOTHING_LAUNCHED;
  const cudaStream_t s = (cudaStream_t)stream;
#define CAL_LAUNCH(N)                                                                    \
  if (n == N) {                                                                          \
    bf16_windows<N><<<grid, block, 0, s>>>((const __nv_bfloat16*)a, (__nv_bfloat16*)o,  \
                                           ni, nj, nk);                                  \
    return (int)cudaGetLastError();                                                      \
  }
  CAL_BF16_WINDOWS_VARIANTS(CAL_LAUNCH)
#undef CAL_LAUNCH
  return CAL_NOT_INSTANTIATED;
}
