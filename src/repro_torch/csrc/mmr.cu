// Greedy MMR selection over a candidate pool, one block per query:
//
//   k times: j = argmax_i  lam*rel[i] - (1-lam)*max_sim[i]   (first index
//            on ties; taken and padded slots pinned to NEG = -1e30 AFTER
//            the blend, so lam = 0 cannot make padding finite), then
//            max_sim = max(max_sim, E . E[j]).
//
// Replaces src/repro/kernels/mmr/kernel.py::mmr_pallas (body _mmr_kernel),
// which keeps the whole (n, d) pool in VMEM (2 MB at n = 4096) and pulls
// E[j] out with a one-hot matmul.  A Hopper block has 227 KB of shared
// memory, so that layout does not fit.
//
// What bounds it on the H100: neither bytes nor operations but the latency
// of k dependent steps: each step's argmax needs the previous step's
// similarities.  The design keeps the per-slot state (rel, max_sim, taken:
// 9 bytes a slot) in shared memory and computes E . E[j] inside the kernel
// each step: one warp per pool row (eight rows in flight a warp), each
// lane a float4 of the row, so the pool rows stream with 16-byte coalesced
// loads and stay resident in L2 (n x d x 4 bytes, 1 MB at n = 2048 and
// d = 128) across the k steps; padding rows are skipped.  One block reads
// the live pool from L2 once a step, so a query is bound by one SM's L2
// bandwidth times k steps.  The blend is computed with __fmul_rn/__fsub_rn so it
// rounds like the reference's separate multiply and subtract (no FMA
// contraction that could flip a near tie).  lam is a (B,) vector, so one
// launch serves plans with different lambdas.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 8;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void argmax_step(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads) mmr_kernel(
    const float* __restrict__ emb, const float* __restrict__ rel,
    const float* __restrict__ lam, int n, int d, int k,
    int* __restrict__ out_idx, float* __restrict__ out_val) {
  extern __shared__ float smem[];
  float* s_rel = smem;
  float* s_max = smem + n;
  unsigned char* s_taken = reinterpret_cast<unsigned char*>(smem + 2 * n);
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_pick;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* e = emb + (int64_t)q * n * d;
  const float l = lam[q];
  const float one_minus = 1.f - l;
  const int d4 = d >> 2;

  for (int i = tid; i < n; i += kThreads) {
    s_rel[i] = rel[(int64_t)q * n + i];
    s_max[i] = kNeg;
    s_taken[i] = 0;
  }
  __syncthreads();

  for (int step = 0; step < k; ++step) {
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float r = s_rel[i];
      const float ms = s_max[i];
      const float pen = ms <= kNeg * 0.5f ? 0.f : ms;
      float v = __fsub_rn(__fmul_rn(l, r), __fmul_rn(one_minus, pen));
      if (s_taken[i] || r <= kNeg * 0.5f) v = kNeg;
      argmax_step(best, bi, v, i);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      argmax_step(best, bi, __shfl_down_sync(kFull, best, off),
                  __shfl_down_sync(kFull, bi, off));
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      best = red_v[lane];
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        argmax_step(best, bi, __shfl_down_sync(kFull, best, off),
                    __shfl_down_sync(kFull, bi, off));
      }
      if (lane == 0) {
        s_pick = bi;
        s_taken[bi] = 1;
        out_idx[(int64_t)q * k + step] = bi;
        out_val[(int64_t)q * k + step] = best;
      }
    }
    __syncthreads();

    // each warp keeps kRowsInFlight rows' loads in flight at once: the
    // step is bound by L2 latency, not by its few FMAs
    const float4* e4 = reinterpret_cast<const float4*>(e);
    const float4* ej = e4 + (int64_t)s_pick * d4;
    for (int r0 = warp; r0 < n; r0 += kWarps * kRowsInFlight) {
      float acc[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) acc[u] = 0.f;
      for (int c = lane; c < d4; c += 32) {
        const float4 b = ej[c];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          const int r = r0 + u * kWarps;
          if (r < n && s_rel[r] > kNeg * 0.5f) {  // padding never competes
            const float4 a = e4[(int64_t)r * d4 + c];
            acc[u] = fmaf(a.x, b.x, acc[u]);
            acc[u] = fmaf(a.y, b.y, acc[u]);
            acc[u] = fmaf(a.z, b.z, acc[u]);
            acc[u] = fmaf(a.w, b.w, acc[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[u] += __shfl_xor_sync(kFull, acc[u], off);
        }
        const int r = r0 + u * kWarps;
        if (lane == 0 && r < n) s_max[r] = fmaxf(s_max[r], acc[u]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// emb: (b, n, d) row-major f32 with d % 4 == 0 and 16-byte aligned; rel:
// (b, n) f32 (slots at or below NEG/2 are padding); lam: (b,) f32;
// out_idx (b, k) int32 and out_val (b, k) f32 receive the picks in
// selection order and their blended scores.  Needs n*9 bytes of dynamic
// shared memory.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int flexvec_mmr(const void* emb, const void* rel, const void* lam,
                           int b, int n, int d, int k, void* out_idx,
                           void* out_val, void* stream) {
  if (b <= 0 || k <= 0) return 0;
  const int smem = n * (2 * static_cast<int>(sizeof(float)) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      mmr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mmr_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const float*>(rel),
      static_cast<const float*>(lam), n, d, k, static_cast<int*>(out_idx),
      static_cast<float*>(out_val));
  return cudaGetLastError();
}
