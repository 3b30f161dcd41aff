// The calibration probes of bench.py::main as hand-written kernels for the
// H100 (sm_90a). gt4py_tpu_torch/cartesian/backend/calibration.py builds this
// file with the stencil kernels' flags (cuda_backend.NVCC_FLAGS: -O3,
// --fmad=false, no fast math), binds the launchers with ctypes and holds
// each kernel against its plain PyTorch version.
//
// They replace the TPU's three pallas_calls in bench.py::main:
//   probe_walk<M, N>  _mk_probe(m_fma, n_div).kern   (bench.py:1484, call :1494)
//   plane_walk5       _pw_kernel                     (bench.py:1410, call :1414)
//   bf16_windows<N>   _mk_bf16_probe(n_windows).kern (bench.py:1339, call :1351)
//
// Design. plane_walk5 keeps the execution shape of the port's column walks,
// the kernel class the probes calibrate: one thread per (i, j) point, blocks
// of CAL_BJ points along J by CAL_BI along I (cuda_codegen.COL_BJ, COL_BI),
// each thread walking the nk planes of its point, loads coalesced along J,
// nothing staged in shared memory. It measures what such a plain walk costs
// (the "plane-walk floor").
//
// probe_walk and bf16_windows are pointwise over the flat (K, I, J) tensor
// (bf16_windows but for its wrap-around along J) and are built to reach the
// card's own rate, so that the ceilings they give are the card's and not a
// walk's: each thread owns one 16-byte vector of every tensor (4 float32 or
// 8 bfloat16), read with one 128-bit read-only load (ld.global.nc.v4) and
// written with one 128-bit store, in blocks of CAL_THREADS; the grid covers
// the tensor, some 2,560 (P1) and 661 (P3) blocks at bench.py's sizes, every
// SM busy. A tensor whose base is not 16-byte aligned, and the last vector
// of a total that is not a multiple of the vector, are served in the same
// kernel by scalar loads and stores. P1 is bound by its bytes at bench.py's
// counts and by its FP32 and MUFU instructions at the card's own (128, 0)
// and (0, 64); P3 by its bytes (resident in the 50 MB L2 across a chain).
//
// l2_read is no TPU kernel's port but the yardstick of the probes' bound:
// the rate at which the SMs read bytes that stay in the L2, which bounds a
// probe whose bytes stay there across a chain (P1 and P3 at bench.py's
// sizes), where the device memory's rate does not.
//
// Arithmetic: --fmad=false keeps x * y + z as a rounded product and a
// rounded sum, and float division is IEEE (no fast math), so each kernel
// equals its plain version, which rounds every operation separately, to the
// bit. The bfloat16 probe computes in float32 and rounds to bfloat16 after
// every add, as torch's bfloat16 add does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CAL_BJ 32
#define CAL_BI 8
// threads a block of probe_walk and bf16_windows; the 16-byte vectors a
// bf16_windows thread owns (4: 64 bytes of loads in flight a thread, and 661
// blocks at bench.py's size, one wave at 6 blocks an SM), and the blocks an
// SM must hold, which caps its registers at 40
#define CAL_THREADS 256
#define CAL_BF16_VECTORS 4
#define CAL_BF16_MIN_BLOCKS 6
// the 16-byte vectors an l2_read thread loads a pass
#define CAL_L2_VECTORS 4
// what the launchers return on an empty grid (cuda_codegen.NOTHING_LAUNCHED),
// and for a variant that was not instantiated
#define CAL_NOTHING_LAUNCHED (-1)
#define CAL_NOT_INSTANTIATED (-2)

// A float32 load issued where it stands in the source. With plain loads the
// compiler sinks each load to its first use, behind the division before it,
// and no load is hoisted over a division's slow-path branch, so a level of
// P1 (0, 4) waited for four load latencies in a row (110.1 against 54.2 us
// on an H100, PERF.md). ld.global.nc: the inputs are read-only during the
// launch.
__device__ __forceinline__ float cal_load(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// Four float32 at a 16-byte aligned address, one 128-bit load, issued where
// it stands in the source, as cal_load.
__device__ __forceinline__ float4 cal_load4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Four float32 at a 16-byte aligned address, one 128-bit load through the
// L2 only (ld.global.cg: no SM's L1 keeps the line), issued where it stands.
__device__ __forceinline__ float4 cal_load4_l2(const float* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// P1: accs = (a, b, c, d); M times accs[s % 4] = accs[s % 4] * 1.0000001f +
// accs[(s + 1) % 4]; N times accs[s % 4] = accs[s % 4] / (accs[(s + 1) % 4] +
// 2.0f); o = accs[0] + accs[1] * accs[2] - accs[3]. 1.0000001f is
// np.float32(1.0000001), 1 + 2^-23. A thread owns the 4 points p .. p + 3 of
// the flat tensor: it issues the 16-byte loads of a, b, c and d, then runs
// the 4 points' chains interleaved (independent, so 4 times the ILP of one
// chain; each point's operations in its own order), then stores o as one
// 16-byte vector. `vec`: every pointer is 16-byte aligned.
template <int M, int N>
__global__ void __launch_bounds__(CAL_THREADS)
probe_walk(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, const float* __restrict__ d,
           float* __restrict__ o, long long total, int vec) {
  const long long p = ((long long)blockIdx.x * CAL_THREADS + threadIdx.x) * 4;
  if (p >= total) return;
  const bool whole = vec && p + 4 <= total;
  const float* in[4] = {a, b, c, d};
  float acc[4][4];  // [point][accumulator]
  if (whole) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = cal_load4(in[q] + p);
      acc[0][q] = v.x;
      acc[1][q] = v.y;
      acc[2][q] = v.z;
      acc[3][q] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[e][q] = p + e < total ? cal_load(in[q] + p + e) : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < M; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e][s % 4] = acc[e][s % 4] * 1.0000001f + acc[e][(s + 1) % 4];
#pragma unroll
  for (int s = 0; s < N; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e][s % 4] = acc[e][s % 4] / (acc[e][(s + 1) % 4] + 2.0f);
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = acc[e][0] + acc[e][1] * acc[e][2] - acc[e][3];
  if (whole) {
    *reinterpret_cast<float4*>(o + p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p + e < total) o[p + e] = r[e];
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

// Element e (0-7) of a 16-byte vector of bfloat16, and the vector of 8.
__device__ __forceinline__ __nv_bfloat16 cal_elem(const uint4& v, int e) {
  const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return __ushort_as_bfloat16((unsigned short)(w >> (16 * (e & 1))));
}

__device__ __forceinline__ unsigned cal_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// P3: x = a; N times x = x + a shifted by w + 1 along J with wrap-around
// (jnp.concatenate([a[:, :, w + 1:], a[:, :, :w + 1]], axis=2), i.e.
// torch.roll(a, -(w + 1), dims=2)); o = x. bfloat16 in and out, each add in
// float32 rounded to bfloat16. The wrapper keeps N below the row length nj.
//
// A thread owns CAL_BF16_VECTORS vectors of 8 elements of the flat tensor,
// the lanes of a warp consecutive vectors; it issues all their loads, then
// computes and stores each. The element at column j + w + 1 of a row is the
// thread's own, or the next lane's (one __shfl_down_sync a 32-bit word; the
// warp's last lane, or a lane whose next vector is past the end, loads its
// N elements beyond), or, where j + w + 1 passes the row's end, the element
// at row + (j + w + 1 - nj): one of the row's first N, loaded by a lane whose
// vector reaches the row's end (scalar loads that hit the L1 or the L2) and
// picked by a select, so that no lane of a warp branches apart. The column
// comes from one division of the vector's flat index by nj. Rows shorter
// than 8 + N elements take a path of their own, element by element.
template <int N>
__global__ void __launch_bounds__(CAL_THREADS, CAL_BF16_MIN_BLOCKS)
bf16_windows(const __nv_bfloat16* __restrict__ a, __nv_bfloat16* __restrict__ o,
             long long total, long long nj, int vec) {
  static_assert(N >= 0 && N <= 8, "a window reaches at most into the next lane's vector");
  const int lane = threadIdx.x & 31, row = (int)nj;
  const long long nvec = (total + 7) / 8;  // the last may hold fewer than 8
  const long long first = (long long)blockIdx.x * (CAL_THREADS * CAL_BF16_VECTORS) + threadIdx.x;
  uint4 raw[CAL_BF16_VECTORS];
#pragma unroll
  for (int u = 0; u < CAL_BF16_VECTORS; ++u) {
    const long long v = first + (long long)u * CAL_THREADS, p = v * 8;
    raw[u] = make_uint4(0u, 0u, 0u, 0u);
    if (v >= nvec) continue;
    if (vec && p + 8 <= total) {
      raw[u] = __ldg(reinterpret_cast<const uint4*>(a + p));
    } else {
      __nv_bfloat16 s[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = p + e < total ? __ldg(a + p + e) : __ushort_as_bfloat16(0);
      raw[u] = make_uint4(cal_pair(s[0], s[1]), cal_pair(s[2], s[3]), cal_pair(s[4], s[5]),
                          cal_pair(s[6], s[7]));
    }
  }
#pragma unroll
  for (int u = 0; u < CAL_BF16_VECTORS; ++u) {
    const long long v = first + (long long)u * CAL_THREADS, p = v * 8;
    uint4 out = raw[u];
    if constexpr (N > 0) {
      // every lane shuffles, before any leaves
      uint4 next = make_uint4(__shfl_down_sync(0xffffffffu, raw[u].x, 1),
                              __shfl_down_sync(0xffffffffu, raw[u].y, 1),
                              __shfl_down_sync(0xffffffffu, raw[u].z, 1),
                              __shfl_down_sync(0xffffffffu, raw[u].w, 1));
      if (v >= nvec) continue;
      if (lane == 31 || v + 1 >= nvec) {
        // the warp's last lane, or the last vector: its N elements beyond
        __nv_bfloat16 s[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          s[e] = e < N && p + 8 + e < total ? __ldg(a + p + 8 + e) : __ushort_as_bfloat16(0);
        next = make_uint4(cal_pair(s[0], s[1]), cal_pair(s[2], s[3]), cal_pair(s[4], s[5]),
                          cal_pair(s[6], s[7]));
      }
      // the column of element 0: a 32-bit division where the tensor allows
      const int col = total <= 0xffffffffLL ? (int)((unsigned)p % (unsigned)nj) : (int)(p % nj);
      __nv_bfloat16 res[8];
      if (row >= 8 + N) {
        // A row holds the vector's elements and their windows but where
        // they pass its end, which only the last N elements of the row do:
        // those wrap to the row's first N, loaded where the vector reaches
        // the end. No branch: the wrap is a select.
        const bool at_end = col + 7 + N >= row;
        __nv_bfloat16 head[N];
#pragma unroll
        for (int t = 0; t < N; ++t)
          head[t] = at_end ? __ldg(a + p - col + t) : __ushort_as_bfloat16(0);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          __nv_bfloat16 x = cal_elem(raw[u], e);
#pragma unroll
          for (int w = 0; w < N; ++w) {
            __nv_bfloat16 y = e + w + 1 < 8 ? cal_elem(raw[u], e + w + 1)
                                            : cal_elem(next, e + w + 1 - 8);
            const int wrapped = col + e + w + 1 - row;  // its column in the row, if it wraps
#pragma unroll
            for (int t = 0; t < N; ++t)
              if (col + e < row && wrapped == t) y = head[t];
            x = __float2bfloat16_rn(__bfloat162float(x) + __bfloat162float(y));
          }
          res[e] = x;
        }
      } else {
        // rows shorter than a vector and its windows: each element's
        // column, and a load where a window wraps
        int c = col;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          __nv_bfloat16 x = cal_elem(raw[u], e);
          // an element past the end of a partial vector reads nothing
#pragma unroll
          for (int w = 0; w < N && p + e < total; ++w) {
            __nv_bfloat16 y;
            if (c + w + 1 >= row) {
              y = __ldg(a + p + e + w + 1 - nj);
            } else if (e + w + 1 < 8) {
              y = cal_elem(raw[u], e + w + 1);
            } else {
              y = cal_elem(next, e + w + 1 - 8);
            }
            x = __float2bfloat16_rn(__bfloat162float(x) + __bfloat162float(y));
          }
          res[e] = x;
          c = c + 1 == row ? 0 : c + 1;
        }
      }
      out = make_uint4(cal_pair(res[0], res[1]), cal_pair(res[2], res[3]), cal_pair(res[4], res[5]),
                       cal_pair(res[6], res[7]));
    } else {
      if (v >= nvec) continue;
    }
    if (vec && p + 8 <= total) {
      *reinterpret_cast<uint4*>(o + p) = out;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (p + e < total) o[p + e] = cal_elem(out, e);
    }
  }
}

// The L2 yardstick: `passes` passes over n4 16-byte vectors of float32 (a
// buffer that the L2 holds), each thread CAL_L2_VECTORS vectors a round, the
// grid's threads consecutive vectors, every load through the L2 only; each
// thread keeps the largest value it read, and lane 0 of each warp writes its
// warp's largest to out (one float a warp). The largest of out is the
// largest of the buffer, in any order (torch.amax, its plain version).
__global__ void __launch_bounds__(CAL_THREADS)
l2_read(const float* __restrict__ in, long long n4, int passes, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * CAL_THREADS;
  const long long first = (long long)blockIdx.x * CAL_THREADS + threadIdx.x;
  float m = __int_as_float(0xff800000);  // -inf
  for (int r = 0; r < passes; ++r) {
    long long v = first;
    for (; v + (CAL_L2_VECTORS - 1) * stride < n4; v += CAL_L2_VECTORS * stride) {
      float4 x[CAL_L2_VECTORS];
#pragma unroll
      for (int u = 0; u < CAL_L2_VECTORS; ++u) x[u] = cal_load4_l2(in + 4 * (v + u * stride));
#pragma unroll
      for (int u = 0; u < CAL_L2_VECTORS; ++u)
        m = fmaxf(m, fmaxf(fmaxf(x[u].x, x[u].y), fmaxf(x[u].z, x[u].w)));
    }
    for (; v < n4; v += stride) {
      const float4 x = cal_load4_l2(in + 4 * v);
      m = fmaxf(m, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    }
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) out[first >> 5] = m;
}

static dim3 cal_grid(long long ni, long long nj) {
  return dim3((unsigned)((nj + CAL_BJ - 1) / CAL_BJ), (unsigned)((ni + CAL_BI - 1) / CAL_BI), 1u);
}

// Blocks of CAL_THREADS threads for `items` items of `per_thread` a thread.
static unsigned cal_blocks(long long items, long long per_thread) {
  const long long threads = (items + per_thread - 1) / per_thread;
  return (unsigned)((threads + CAL_THREADS - 1) / CAL_THREADS);
}

// Whether every pointer is 16-byte aligned: the 128-bit loads and stores.
static int cal_aligned(const void* const* ptrs, int n) {
  uintptr_t bits = 0;
  for (int q = 0; q < n; ++q) bits |= (uintptr_t)ptrs[q];
  return (bits & 15u) == 0;
}

// The instantiated (M, N) of probe_walk: bench.py's three (:1525-1527), then
// two larger ones that only the card's own reading uses.
#define CAL_PROBE_WALK_VARIANTS(X) X(0, 0) X(16, 0) X(0, 4) X(128, 0) X(0, 64)
// The instantiated N of bf16_windows: bench.py's two (:1378-1386).
#define CAL_BF16_WINDOWS_VARIANTS(X) X(0) X(1)

extern "C" int gt_probe_walk(int m, int n, const void* a, const void* b, const void* c,
                             const void* d, void* o, long long ni, long long nj,
                             long long nk, void* stream) {
  const long long total = ni * nj * nk;
  if (total <= 0) return CAL_NOTHING_LAUNCHED;
  const void* ptrs[5] = {a, b, c, d, o};
  const int vec = cal_aligned(ptrs, 5);
  const unsigned grid = cal_blocks(total, 4);
  const cudaStream_t s = (cudaStream_t)stream;
#define CAL_LAUNCH(M, N)                                                                   \
  if (m == M && n == N) {                                                                  \
    probe_walk<M, N><<<grid, CAL_THREADS, 0, s>>>((const float*)a, (const float*)b,        \
                                                 (const float*)c, (const float*)d,         \
                                                 (float*)o, total, vec);                   \
    return (int)cudaGetLastError();                                                        \
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
  const long long total = ni * nj * nk;
  if (total <= 0) return CAL_NOTHING_LAUNCHED;
  const void* ptrs[2] = {a, o};
  const int vec = cal_aligned(ptrs, 2);
  const unsigned grid = cal_blocks(total, 8 * CAL_BF16_VECTORS);
  const cudaStream_t s = (cudaStream_t)stream;
#define CAL_LAUNCH(N)                                                                      \
  if (n == N) {                                                                            \
    bf16_windows<N><<<grid, CAL_THREADS, 0, s>>>((const __nv_bfloat16*)a,                  \
                                                (__nv_bfloat16*)o, total, nj, vec);        \
    return (int)cudaGetLastError();                                                        \
  }
  CAL_BF16_WINDOWS_VARIANTS(CAL_LAUNCH)
#undef CAL_LAUNCH
  return CAL_NOT_INSTANTIATED;
}

// `blocks` blocks of CAL_THREADS; `in` 16-byte aligned, out one float a warp.
extern "C" int gt_l2_read(const void* in, long long n4, int passes, void* out, int blocks,
                          void* stream) {
  if (n4 <= 0 || blocks <= 0) return CAL_NOTHING_LAUNCHED;
  l2_read<<<blocks, CAL_THREADS, 0, (cudaStream_t)stream>>>((const float*)in, n4, passes,
                                                             (float*)out);
  return (int)cudaGetLastError();
}

// The card's own properties for the roofline (no kernel): one
// cudaDeviceGetAttribute, e.g. 36 (cudaDevAttrMemoryClockRate, kHz) and 37
// (cudaDevAttrGlobalMemoryBusWidth, bits); returns the CUDA error.
extern "C" int gt_device_attribute(int attribute, int device, int* value) {
  return (int)cudaDeviceGetAttribute(value, (cudaDeviceAttr)attribute, device);
}
