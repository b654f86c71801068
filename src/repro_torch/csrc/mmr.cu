// Greedy MMR selection over a candidate pool, one thread-block cluster per
// query:
//
//   k times: j = argmax_i  lam*rel[i] - (1-lam)*max_sim[i]   (first index
//            on ties; taken and padded slots pinned to NEG = -1e30 AFTER
//            the blend, so lam = 0 cannot make padding finite), then
//            max_sim = max(max_sim, E . E[j]).
//
// Replaces src/repro/kernels/mmr/kernel.py::mmr_pallas (body _mmr_kernel),
// which keeps the whole (n, d) pool in VMEM (2 MB at n = 4096) and pulls
// E[j] out with a one-hot matmul.  A Hopper block has 227 KB of shared
// memory, so that layout does not fit one SM.
//
// What bounds it on the H100: neither bytes nor operations but the latency
// of k dependent steps, each of which needs the previous step's
// similarities.  One block a query (the first port) re-read the live pool
// from L2 every step on one SM: 19 us a step.  Here a cluster of 8 CTAs on
// 8 SMs holds the pool on chip.  Slot i belongs to CTA i % 8; each CTA
// loads its live slots (rel > NEG/2; padding is never loaded) once into
// its shared memory, rows padded to d + 4 floats so that neighbouring
// threads, one row each, read neighbouring rows without bank conflicts.
// Each step then costs one cluster barrier and a pass over shared memory:
// every CTA takes the argmax over its own slots and publishes it into a
// slot double-buffered by step parity; after the barrier every CTA reduces
// the 8 candidates by the same rule (value descending, then smallest
// index), so all agree with no second barrier; each copies E[j] (d floats)
// from the owner's shared memory through distributed shared memory and
// updates max_sim over its own rows.  A CTA with no slot left offers
// (NEG, its smallest slot), which is what the reference's argmax returns
// once the pool is exhausted.  Live slots beyond what the CTA's shared
// memory holds stay in global memory and are read each step by whole
// warps, in the same kernel.  A last cluster barrier keeps every CTA
// resident until no other may read its shared memory.  The blend is
// computed with __fmul_rn/__fsub_rn so it rounds like the reference's
// separate multiply and subtract (no FMA contraction that could flip a
// near tie).  lam is a (B,) vector, so one launch serves plans with
// different lambdas.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoCluster = -1;  // returned when no cluster fits an SM group

struct Cand {
  float v;
  int slot;
  int pos;  // the owner CTA's local row
};

__device__ __forceinline__ void argmax_step(Cand& a, float v, int slot,
                                            int pos) {
  if (v > a.v || (v == a.v && slot < a.slot)) {
    a.v = v;
    a.slot = slot;
    a.pos = pos;
  }
}

__device__ __forceinline__ void argmax_shfl(Cand& a, int off, bool xor_) {
  const float v = xor_ ? __shfl_xor_sync(kFull, a.v, off)
                       : __shfl_down_sync(kFull, a.v, off);
  const int s = xor_ ? __shfl_xor_sync(kFull, a.slot, off)
                     : __shfl_down_sync(kFull, a.slot, off);
  const int p = xor_ ? __shfl_xor_sync(kFull, a.pos, off)
                     : __shfl_down_sync(kFull, a.pos, off);
  argmax_step(a, v, s, p);
}

// Floats between the starts of two pool rows in shared memory: d + 4, so
// the 8 lanes of one shared-memory wavefront, a row each, reading the same
// 16-byte column of their rows meet 8 distinct groups of 4 banks.
__host__ __device__ __forceinline__ int row_stride(int d) { return d + 4; }

__device__ __forceinline__ float blend(float l, float one_minus, float r,
                                       float ms) {
  const float pen = ms <= kNeg * 0.5f ? 0.f : ms;
  return __fsub_rn(__fmul_rn(l, r), __fmul_rn(one_minus, pen));
}

// The block's argmax; valid in thread 0 only.
__device__ __forceinline__ Cand block_argmax(Cand a, Cand* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) argmax_shfl(a, off, false);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? red[lane] : Cand{-INFINITY, INT_MAX, -1};
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) argmax_shfl(a, off, false);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads, 1) mmr_cluster_kernel(
    const float* __restrict__ emb, const float* __restrict__ rel,
    const float* __restrict__ lam, int n, int d, int k, int lmax, int cap,
    int* __restrict__ out_idx, float* __restrict__ out_val) {
  extern __shared__ __align__(16) float smem[];
  const int stride = row_stride(d);
  float* rows = smem;                          // cap x stride
  float* ej = rows + (size_t)cap * stride;     // d: the step's E[j]
  float* s_rel = ej + d;                       // lmax each:
  float* s_max = s_rel + lmax;
  int* s_slot = reinterpret_cast<int*>(s_max + lmax);
  unsigned char* s_dead = reinterpret_cast<unsigned char*>(s_slot + lmax);
  __shared__ Cand cand[2];  // this CTA's candidate, by step parity
  __shared__ Cand red[kWarps];
  __shared__ int scan[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t q = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* eq = emb + q * n * d;
  const float* rq = rel + q * n;
  const float l = lam[q];
  const float one_minus = __fsub_rn(1.f, l);
  const int d4 = d >> 2;
  const Cand none{kNeg, rank, -1};  // this CTA's smallest slot at NEG

  // deal: slots rank, rank + 8, ...; keep the live ones in slot order
  const int mine = n > rank ? (n - rank + kCluster - 1) / kCluster : 0;
  int live_n = 0;
  for (int m0 = 0; m0 < mine; m0 += kThreads) {
    const int m = m0 + tid;
    const int slot = rank + m * kCluster;
    const float r = m < mine ? rq[slot] : kNeg;
    const bool live = r > kNeg * 0.5f;
    const unsigned bal = __ballot_sync(kFull, live);
    if (lane == 0) scan[warp] = __popc(bal);
    __syncthreads();
    int before = live_n;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += scan[w];
      live_n += scan[w];
    }
    __syncthreads();
    if (live) {
      const int p = before + __popc(bal & ((1u << lane) - 1u));
      s_slot[p] = slot;
      s_rel[p] = r;
      s_max[p] = kNeg;
      s_dead[p] = 0;
    }
  }
  __syncthreads();
  const int in_smem = min(live_n, cap);
  for (int p = warp; p < in_smem; p += kWarps) {
    const float4* src =
        reinterpret_cast<const float4*>(eq + (int64_t)s_slot[p] * d);
    float4* dst = reinterpret_cast<float4*>(rows + (size_t)p * stride);
    for (int c = lane; c < d4; c += 32) dst[c] = src[c];
  }

  Cand best = none;
  for (int p = tid; p < live_n; p += kThreads) {
    argmax_step(best, blend(l, one_minus, s_rel[p], kNeg), s_slot[p], p);
  }
  best = block_argmax(best, red);

  const float4* ej4 = reinterpret_cast<const float4*>(ej);
  for (int step = 0; step < k; ++step) {
    const int par = step & 1;
    if (tid == 0) cand[par] = best;
    cluster.sync();  // publishes cand (and, at step 0, the loaded rows)
    Cand c{-INFINITY, INT_MAX, -1};
    if (lane < kCluster) c = *cluster.map_shared_rank(&cand[par], lane);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) argmax_shfl(c, off, true);
    if (rank == 0 && tid == 0) {
      out_idx[q * k + step] = c.slot;
      out_val[q * k + step] = c.v;
    }
    if (step + 1 == k) break;
    if (!(c.v > kNeg)) continue;  // exhausted everywhere: nothing changes

    const int owner = c.slot % kCluster;
    if (owner == rank && tid == 0) s_dead[c.pos] = 1;
    const float4* src =
        c.pos < cap
            ? reinterpret_cast<const float4*>(
                  cluster.map_shared_rank(rows, owner) + (size_t)c.pos * stride)
            : reinterpret_cast<const float4*>(eq + (int64_t)c.slot * d);
    for (int x = tid; x < d4; x += kThreads) {
      reinterpret_cast<float4*>(ej)[x] = src[x];
    }
    __syncthreads();

    best = none;
    for (int p = tid; p < in_smem; p += kThreads) {  // a thread a row
      if (s_dead[p]) continue;
      const float4* a =
          reinterpret_cast<const float4*>(rows + (size_t)p * stride);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 8
      for (int x = 0; x < d4; ++x) {
        const float4 u = a[x];
        const float4 w = ej4[x];
        s0 = fmaf(u.x, w.x, s0);
        s1 = fmaf(u.y, w.y, s1);
        s2 = fmaf(u.z, w.z, s2);
        s3 = fmaf(u.w, w.w, s3);
      }
      const float ms = fmaxf(s_max[p], (s0 + s1) + (s2 + s3));
      s_max[p] = ms;
      argmax_step(best, blend(l, one_minus, s_rel[p], ms), s_slot[p], p);
    }
    for (int p = in_smem + warp; p < live_n; p += kWarps) {  // a warp a row
      if (s_dead[p]) continue;
      const float4* a =
          reinterpret_cast<const float4*>(eq + (int64_t)s_slot[p] * d);
      float s = 0.f;
      for (int x = lane; x < d4; x += 32) {
        const float4 u = a[x];
        const float4 w = ej4[x];
        s = fmaf(u.x, w.x, s);
        s = fmaf(u.y, w.y, s);
        s = fmaf(u.z, w.z, s);
        s = fmaf(u.w, w.w, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(kFull, s, off);
      }
      if (lane == 0) {
        const float ms = fmaxf(s_max[p], s);
        s_max[p] = ms;
        argmax_step(best, blend(l, one_minus, s_rel[p], ms), s_slot[p], p);
      }
    }
    best = block_argmax(best, red);
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

struct Plan {
  int lmax, cap, smem;
};

// Shared-memory plan for an (n, d) pool: per-slot state for this CTA's
// share (13 bytes a slot), the step's E[j], then as many pool rows as fit.
cudaError_t plan_for(int n, int d, Plan* plan) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, mmr_cluster_kernel);
  if (err != cudaSuccess) return err;
  const long long avail = optin - static_cast<long long>(attr.sharedSizeBytes);
  const long long lmax = (n + kCluster - 1) / kCluster;
  const long long fixed = 4ll * d + 13ll * lmax + 16;
  const long long row = 4ll * row_stride(d);
  long long cap = (avail - fixed) / row;
  cap = cap < 0 ? 0 : (cap > lmax ? lmax : cap);
  const long long smem = (cap * row + fixed + 15) / 16 * 16;
  if (smem > avail) return cudaErrorInvalidConfiguration;
  plan->lmax = static_cast<int>(lmax);
  plan->cap = static_cast<int>(cap);
  plan->smem = static_cast<int>(smem);
  return cudaFuncSetAttribute(mmr_cluster_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              plan->smem);
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int b,
                    const Plan& plan, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kCluster * b);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = plan.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// The launch's shape for an (n, d) pool: cluster size, rows of a CTA's
// share held in shared memory (cap), dynamic shared memory a CTA, and
// cudaOccupancyMaxActiveClusters for it.  Returns a CUDA error.
extern "C" int flexvec_mmr_shape(int n, int d, int* cluster, int* cap,
                                 int* smem, int* max_clusters) {
  Plan plan;
  cudaError_t err = plan_for(n, d, &plan);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, 1, plan, nullptr);
  err = cudaOccupancyMaxActiveClusters(max_clusters, mmr_cluster_kernel, &cfg);
  *cluster = kCluster;
  *cap = plan.cap;
  *smem = plan.smem;
  return err;
}

// emb: (b, n, d) row-major f32 with d % 4 == 0 and 16-byte aligned; rel:
// (b, n) f32 (slots at or below NEG/2 are padding); lam: (b,) f32;
// out_idx (b, k) int32 and out_val (b, k) f32 receive the picks in
// selection order and their blended scores.  Launches b clusters of 8
// CTAs on `stream`, allocates nothing; returns a CUDA error, or -1 when
// not one cluster of that shape fits the card.
extern "C" int flexvec_mmr(const void* emb, const void* rel, const void* lam,
                           int b, int n, int d, int k, void* out_idx,
                           void* out_val, void* stream) {
  if (b <= 0 || k <= 0) return 0;
  Plan plan;
  cudaError_t err = plan_for(n, d, &plan);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, b, plan, static_cast<cudaStream_t>(stream));
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, mmr_cluster_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters == 0) return kNoCluster;
  err = cudaLaunchKernelEx(&cfg, mmr_cluster_kernel,
                           static_cast<const float*>(emb),
                           static_cast<const float*>(rel),
                           static_cast<const float*>(lam), n, d, k, plan.lmax,
                           plan.cap, static_cast<int*>(out_idx),
                           static_cast<float*>(out_val));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
