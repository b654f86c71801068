// Modulated scoring for a batch of plans: one pass over the corpus rows.
//
//   out[n, b] = decay[n] * (M[n] . q_pre[:, b]) + M[n] . q_sup[:, b]
//
// Replaces src/repro/kernels/pem_score/kernel.py::pem_score_pallas (body
// _pem_score_kernel), the TPU kernel that streams (1024, d) corpus tiles
// through the MXU against (d, 128) query tiles.
//
// What bounds it on the H100: at B = 1 the corpus bytes (240k x 128 f32 is
// 123 MB, one read at 3.35 TB/s is 37 us); at B = 32 the 4*N*d*B f32
// operations outside the tensor cores (TF32 would miss the 1e-5 tolerance
// the reference holds).  The design reads every corpus row from device
// memory once for all B columns: a block stages a (rows x 32) corpus slice,
// loaded four elements a thread, and the matching (32 x BC) slices of
// q_pre and q_sup in shared memory; each thread keeps a 4-row (2 for B <=
// 8) x 4-column register tile of both products, so one shared-memory
// corpus value feeds eight FMAs.  Plain f32 FMA;
// bf16 corpora convert with __bfloat162float, as the TPU kernel casts its
// tile to f32.  The block masks the ragged N, B and d edges itself, so the
// caller never pads the corpus.  The output is written through (row,
// column) strides: the backend asks for the (B, N) layout the top-k kernel
// reads, and consecutive threads own consecutive rows so those stores
// coalesce.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kDepth = 32;  // depth of one staged slice of d
constexpr int kVec = 4;     // corpus elements per load (d % 4 == 0)

// Four consecutive corpus elements as f32: one 16-byte load for f32, one
// 8-byte load for bf16.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __bfloat162float(lo.x);
  v[1] = __bfloat162float(lo.y);
  v[2] = __bfloat162float(hi.x);
  v[3] = __bfloat162float(hi.y);
}

// BC: query columns per block; RPT: corpus rows per thread.  (8, 2) for
// narrow batches, (32, 4) otherwise.
template <typename T, int BC, int RPT>
__global__ void __launch_bounds__(kThreads) pem_score_kernel(
    const T* __restrict__ m, const float* __restrict__ q_pre,
    const float* __restrict__ q_sup, const float* __restrict__ decay,
    float* __restrict__ out, int n, int d, int b, int64_t so_n,
    int64_t so_b) {
  constexpr int kColGroups = BC / kColsPerThread;
  constexpr int kRowGroups = kThreads / kColGroups;
  constexpr int kTileRows = kRowGroups * RPT;
  constexpr int kLoads = kTileRows * kDepth / kVec / kThreads;
  __shared__ float ms[kTileRows][kDepth + 1];
  __shared__ __align__(16) float qp[kDepth][BC];
  __shared__ __align__(16) float qs[kDepth][BC];

  const int tid = threadIdx.x;
  const int rg = tid % kRowGroups;
  const int cg = tid / kRowGroups;
  const int64_t row0 = (int64_t)blockIdx.x * kTileRows;
  const int col0 = blockIdx.y * BC;

  float pre[RPT][kColsPerThread];
  float sup[RPT][kColsPerThread];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      pre[i][j] = 0.f;
      sup[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < d; k0 += kDepth) {
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / (kDepth / kVec);
      const int kk = e % (kDepth / kVec) * kVec;
      const int64_t gr = row0 + r;
      float v[kVec] = {0.f, 0.f, 0.f, 0.f};
      if (gr < n && k0 + kk < d) load4(m + gr * d + k0 + kk, v);
#pragma unroll
      for (int u = 0; u < kVec; ++u) ms[r][kk + u] = v[u];
    }
    for (int e = tid; e < kDepth * BC; e += kThreads) {
      const int kk = e / BC;
      const int c = e % BC;
      const int gk = k0 + kk;
      const int gc = col0 + c;
      const bool ok = gk < d && gc < b;
      qp[kk][c] = ok ? q_pre[(int64_t)gk * b + gc] : 0.f;
      qs[kk][c] = ok ? q_sup[(int64_t)gk * b + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(&qp[kk][cg * kColsPerThread]);
      const float4 s4 =
          *reinterpret_cast<const float4*>(&qs[kk][cg * kColsPerThread]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = ms[rg + i * kRowGroups][kk];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          pre[i][j] = fmaf(a, pv[j], pre[i][j]);
          sup[i][j] = fmaf(a, sv[j], sup[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t gr = row0 + rg + i * kRowGroups;
    if (gr >= n) continue;
    const float dec = decay != nullptr ? decay[gr] : 1.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int gc = col0 + cg * kColsPerThread + j;
      if (gc < b) out[gr * so_n + gc * so_b] = dec * pre[i][j] + sup[i][j];
    }
  }
}

template <typename T, int BC, int RPT>
cudaError_t launch(const void* m, const float* q_pre, const float* q_sup,
                   const float* decay, float* out, int n, int d, int b,
                   int64_t so_n, int64_t so_b, cudaStream_t stream) {
  constexpr int kTileRows = (kThreads / (BC / kColsPerThread)) * RPT;
  const dim3 grid((n + kTileRows - 1) / kTileRows, (b + BC - 1) / BC);
  pem_score_kernel<T, BC, RPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(m), q_pre, q_sup, decay, out, n, d, b, so_n,
      so_b);
  return cudaGetLastError();
}

}  // namespace

// m: (n, d) row-major f32 (m_bf16 = 0) or bf16 (m_bf16 = 1), d % 4 == 0,
// aligned to 4 elements; q_pre, q_sup:
// (d, b) row-major f32; decay: (n,) f32 or null for ones; out[r*so_n +
// c*so_b] receives the score of row r for column c.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int flexvec_pem_score(const void* m, int m_bf16, const void* q_pre,
                                 const void* q_sup, const void* decay,
                                 void* out, int n, int d, int b,
                                 long long so_n, long long so_b,
                                 void* stream) {
  if (n <= 0 || b <= 0) return 0;
  const float* qp = static_cast<const float*>(q_pre);
  const float* qs = static_cast<const float*>(q_sup);
  const float* dc = static_cast<const float*>(decay);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_bf16) {
    return b <= 8 ? launch<__nv_bfloat16, 8, 2>(m, qp, qs, dc, o, n, d, b,
                                                so_n, so_b, s)
                  : launch<__nv_bfloat16, 32, 4>(m, qp, qs, dc, o, n, d, b,
                                                 so_n, so_b, s);
  }
  return b <= 8
             ? launch<float, 8, 2>(m, qp, qs, dc, o, n, d, b, so_n, so_b, s)
             : launch<float, 32, 4>(m, qp, qs, dc, o, n, d, b, so_n, so_b,
                                    s);
}
