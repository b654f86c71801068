// Greedy MMR selection over a batch of candidate pools:
//
//   k times: j = argmax_i  lam*rel[i] - (1-lam)*max_sim[i]   (first index
//            on ties; taken and padded slots pinned to NEG = -1e30 AFTER
//            the blend, so lam = 0 cannot make padding finite), then
//            max_sim = max(max_sim, E . E[j]).
//
// Replaces src/repro/kernels/mmr/kernel.py::mmr_pallas (body _mmr_kernel),
// which keeps the whole (n, d) pool in VMEM (2 MB at n = 4096) and pulls
// E[j] out with a one-hot matmul.  A Hopper SM has 227 KB of shared
// memory, so that layout does not fit one SM.
//
// What bounds it on the H100: neither bytes nor operations but k dependent
// steps, each of which needs the previous step's similarities, and at a
// batch the on-chip room for the pools (64 pools of 1500 rows x 128 f32
// are 49 MB: the card's shared memory is 30 MB, its register files 34).
// So each query gets a thread-block cluster of C CTAs, one CTA an SM, and
// the wrapper (kernels/mmr/kernel.py plan) picks C from (B, n, d): the
// widest cluster up to 16 whose clusters the card keeps resident B at
// once, 2 CTAs a query at B = 64 (one wave of 128 CTAs), 16 at B = 1.
// Slot i belongs to CTA i % C, which keeps its live slots (rel > NEG/2;
// padding is never loaded) on chip: in shared memory (rows of d + 4
// floats) and, only where its share does not fit there (d <= 128), first
// one a thread in registers (384 threads; otherwise 256); any beyond are
// read from global memory each step.  A thread computes its rows' dot
// products with E[j] as one fused multiply-add chain a row in column
// order: that is how the plain version's f32 gram (cuBLAS) rounds each
// entry on the H100 at the shapes measured (d = 128; d = 256 at a 2048
// bucket, not at a pool of 1500), and there the similarities, and so the
// picks, equal the plain version's bit for bit.  A step has no cluster
// barrier (one costs 0.67-0.79 us on the H100, even alone): each warp
// takes its best candidate by shuffles and writes it into every CTA of
// the cluster by st.async, whose bytes complete a transaction count on
// the receiver's mbarrier, so no fence is needed (0.27-0.60 us an
// exchange); each CTA waits on its own mbarrier, every warp reduces the
// C x 8 or 12 candidates by the same rule (value descending, then
// smallest slot), so all agree, one warp a CTA copies E[j] from the
// winner's shared rows (written before the first cluster barrier) or
// from global memory (register and global rows), and a CTA barrier later
// every thread updates its rows.  A warp with no slot left offers (NEG,
// its CTA's smallest slot), which is what the reference's argmax returns
// once the pool is exhausted.  Candidates, mbarriers and E[j] are
// double-buffered by step parity: a CTA writes a parity's candidates
// again only after every CTA has sent the next step's, so after it has
// read them.  A last cluster barrier keeps every CTA resident until no
// other may read its shared memory.  The blend is computed with
// __fmul_rn/__fsub_rn so it rounds like the reference's separate multiply
// and subtract.  lam is a (B,) vector, so one launch serves plans with
// different lambdas.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <initializer_list>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 12;  // a CTA: 384 threads with register rows, else 256
constexpr int kMaxCluster = 16;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDead = INT_MIN;  // a taken slot's state bit
constexpr int kNoCluster = -1;  // returned when no cluster fits the card
constexpr long long kSpins = 1ll << 22;  // polls: a wait this long is a fault

struct Cand {
  float v;
  int slot;
  int tag;  // (the publishing warp's index in the cluster << 16) | row, or -1
};

__device__ __forceinline__ void argmax_step(Cand& a, float v, int slot,
                                            int tag) {
  if (v > a.v || (v == a.v && slot < a.slot)) {
    a.v = v;
    a.slot = slot;
    a.tag = tag;
  }
}

__device__ __forceinline__ void argmax_xor(Cand& a, int off) {
  const float v = __shfl_xor_sync(kFull, a.v, off);
  const int s = __shfl_xor_sync(kFull, a.slot, off);
  const int t = __shfl_xor_sync(kFull, a.tag, off);
  argmax_step(a, v, s, t);
}

__device__ __forceinline__ float blend(float l, float one_minus, float r,
                                       float ms) {
  const float pen = ms <= kNeg * 0.5f ? 0.f : ms;
  return __fsub_rn(__fmul_rn(l, r), __fmul_rn(one_minus, pen));
}

// s + u . w, one fused multiply-add a column in column order: with s = 0
// before column 0 this is the plain version's rounding (its f32 gram is
// such a chain for every entry)
__device__ __forceinline__ float chain4(float4 u, float4 w, float s) {
  s = fmaf(u.x, w.x, s);
  s = fmaf(u.y, w.y, s);
  s = fmaf(u.z, w.z, s);
  return fmaf(u.w, w.w, s);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival on CTA `rank`'s barrier, releasing this thread's writes (and
// those its warp ordered before them) to the cluster.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          remote)
      : "memory");
}

// Until the barrier's phase of this parity has completed (acquiring what
// the arrivals released); a wait past kSpins polls traps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kSpins) __trap();
  }
}

__device__ __forceinline__ unsigned mapa(const void* p, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// One word into CTA-mapped shared address `addr`, completing its size in
// bytes on the mbarrier at `bar` (both from mapa): no fence needed.
__device__ __forceinline__ void st_async(unsigned addr, int v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// The same for 16 bytes (addr 16-byte aligned).
__device__ __forceinline__ void st_async4(unsigned addr, int4 v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// This CTA's one arrival on its barrier, expecting `bytes` of st.async.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Until the barrier's phase of this parity has completed (its arrivals and
// the bytes stored into this CTA); a wait past kSpins polls traps.
__device__ __forceinline__ void mbar_wait_tx(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > kSpins) __trap();
  }
}

// Row p's new similarity: its max_sim and its candidacy.
__device__ __forceinline__ void update(float2* s_rm, const int* s_sd, int p,
                                       float sim, float l, float one_minus,
                                       Cand& best, int who) {
  const int sd = s_sd[p];
  if (sd < 0) return;  // taken
  const float2 rm = s_rm[p];
  const float ms = fmaxf(rm.y, sim);
  s_rm[p].y = ms;
  argmax_step(best, blend(l, one_minus, rm.x, ms), sd, (who << 16) | p);
}

// kD4: d / 4 at most (32 or 64).  kRegRow (d <= 128): 384 threads, and
// thread t keeps row t of its CTA's share in registers (32 float4);
// otherwise 256 threads (a barrier of 8 warps costs less than one of 12).
// Rows past those are in shared memory (rows of d + 4 floats, so a warp
// reading 32 rows at one column meets no bank twice), then in global
// memory; thread t takes rows kRegRows + t + kThreads i.
template <int kD4, bool kRegRow>
__global__ void __launch_bounds__(kRegRow ? 384 : 256, 1) mmr_kernel(
    const float* __restrict__ emb, const float* __restrict__ rel,
    const float* __restrict__ lam, int n, int d, int k, int lmax,
    int smem_rows, int* __restrict__ out_idx, float* __restrict__ out_val) {
  constexpr int kThreads = kRegRow ? 384 : 256;
  constexpr int kWarps = kThreads / 32;
  constexpr int kRegRows = kRegRow ? kThreads : 0;
  extern __shared__ __align__(16) float4 smem4[];
  const int d4 = d >> 2;
  const int stride4 = d4 + 1;
  float4* s_rows = smem4;                                     // smem_rows
  float4* s_ej = s_rows + static_cast<size_t>(smem_rows) * stride4;  // 2
  float2* s_rm = reinterpret_cast<float2*>(s_ej + 2 * d4);    // rel, ms
  int* s_sd = reinterpret_cast<int*>(s_rm + lmax);  // slot, | kDead taken
  // the cluster's candidates (v, slot, tag) and the barriers whose
  // transaction counts say they have all arrived, by step parity
  __shared__ __align__(16) int4 s_cand[2][kMaxCluster * kMaxWarps];
  __shared__ uint64_t s_bar[2];
  __shared__ int scan[kMaxWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t q = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int who = rank * kWarps + warp;  // this warp's index in the cluster
  const float4* eq = reinterpret_cast<const float4*>(emb) + q * n * d4;
  const float* rq = rel + q * n;
  const float l = lam[q];
  const float one_minus = __fsub_rn(1.f, l);
  const Cand none{kNeg, rank, -1};  // this CTA's smallest slot at NEG
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (tid == 0) {  // one arrival a phase: this CTA's expected bytes
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // deal: slots rank, rank + C, ...; keep the live ones in slot order
  const int mine = n > rank ? (n - rank + csize - 1) / csize : 0;
  int live_n = 0;
  for (int m0 = 0; m0 < mine; m0 += kThreads) {
    const int m = m0 + tid;
    const int slot = rank + m * csize;
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
      s_sd[p] = slot;
      s_rm[p] = make_float2(r, kNeg);
    }
  }
  __syncthreads();
  const int smem_end = min(live_n, kRegRows + smem_rows);

  float4 reg[kRegRow ? 32 : 1];
  if constexpr (kRegRow) {
    const float4* src =
        eq + static_cast<int64_t>(tid < live_n ? s_sd[tid] : 0) * d4;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      reg[x] = tid < live_n && x < d4 ? src[x] : zero;
    }
  }
  for (int p = kRegRows + warp; p < smem_end; p += kWarps) {  // a warp a row
    const float4* src = eq + static_cast<int64_t>(s_sd[p]) * d4;
    float4* dst = s_rows + static_cast<size_t>(p - kRegRows) * stride4;
    for (int x = lane; x < d4; x += 32) dst[x] = src[x];
  }
  cluster.sync();  // every CTA's rows are loaded, its barriers set up

  // the first pick is pure relevance
  Cand best = none;
  for (int p = tid; p < live_n; p += kThreads) {
    argmax_step(best, blend(l, one_minus, s_rm[p].x, kNeg), s_sd[p],
                (who << 16) | p);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) argmax_xor(best, off);

  for (int step = 0; step < k; ++step) {
    const int par = step & 1;
    // the warp's candidate into every CTA of the cluster by st.async,
    // counted in bytes on the receiver's barrier (no fence, no cluster
    // barrier); each CTA expects one from every warp of the cluster
    if (tid == 0) mbar_expect(&s_bar[par], csize * kWarps * 16);
    if (lane < csize) {
      st_async4(mapa(&s_cand[par][who], lane),
                make_int4(__float_as_int(best.v), best.slot, best.tag, 0),
                mapa(&s_bar[par], lane));
    }
    mbar_wait_tx(&s_bar[par], (step >> 1) & 1);
    Cand c{-INFINITY, INT_MAX, -1};
    for (int e = lane; e < csize * kWarps; e += 32) {
      const int4 o = s_cand[par][e];
      argmax_step(c, __int_as_float(o.x), o.y, o.z);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) argmax_xor(c, off);
    if (rank == 0 && tid == 0) {
      out_idx[q * k + step] = c.slot;
      out_val[q * k + step] = c.v;
    }
    if (step + 1 == k) break;
    if (!(c.v > kNeg)) continue;  // exhausted everywhere: nothing changes

    // E[j], once a CTA: from the winner's CTA's shared rows (written
    // before the first cluster barrier), else from global memory
    const int owner = (c.tag >> 16) / kWarps;
    const int pos = c.tag & 0xffff;
    float4* ej = s_ej + par * d4;
    if (warp == 0) {
      const float4* src =
          pos >= kRegRows && pos < kRegRows + smem_rows
              ? cluster.map_shared_rank(
                    s_rows + static_cast<size_t>(pos - kRegRows) * stride4,
                    owner)
              : eq + static_cast<int64_t>(c.slot) * d4;
      for (int x = lane; x < d4; x += 32) ej[x] = src[x];
    }
    if (owner == rank && (pos < kRegRows ? pos == tid
                                          : (pos - kRegRows) % kThreads == tid)) {
      s_sd[pos] |= kDead;
    }
    __syncthreads();

    best = none;
    // the register row with the first shared-memory row (two chains that
    // share E[j]'s loads), then this thread's other shared-memory rows,
    // then its global ones
    int p = kRegRows + tid;
    if constexpr (kRegRow) {
      float a0 = 0.f, a1 = 0.f;
      const float4* r1 =
          s_rows + static_cast<size_t>(p < smem_end ? tid : 0) * stride4;
      if (smem_rows > 0 && d4 == 32) {  // no predicate: loads run ahead
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const float4 w = ej[x];
          a0 = chain4(reg[x], w, a0);
          a1 = chain4(r1[x], w, a1);
        }
      } else if (smem_rows > 0) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          if (x < d4) {
            const float4 w = ej[x];
            a0 = chain4(reg[x], w, a0);
            a1 = chain4(r1[x], w, a1);
          }
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          if (x < d4) a0 = chain4(reg[x], ej[x], a0);
        }
      }
      if (tid < live_n) update(s_rm, s_sd, tid, a0, l, one_minus, best, who);
      if (p < smem_end) {
        update(s_rm, s_sd, p, a1, l, one_minus, best, who);
        p += kThreads;
      }
    }
    for (; p < smem_end; p += kThreads) {
      const float4* r = s_rows + static_cast<size_t>(p - kRegRows) * stride4;
      float a = 0.f;
      if (d4 == kD4) {  // no predicate: loads run ahead
#pragma unroll
        for (int x = 0; x < kD4; ++x) a = chain4(r[x], ej[x], a);
      } else {
#pragma unroll
        for (int x = 0; x < kD4; ++x) {
          if (x < d4) a = chain4(r[x], ej[x], a);
        }
      }
      update(s_rm, s_sd, p, a, l, one_minus, best, who);
    }
    for (; p < live_n; p += kThreads) {
      const float4* r = eq + static_cast<int64_t>(s_sd[p] & INT_MAX) * d4;
      float a = 0.f;
#pragma unroll 8
      for (int x = 0; x < d4; ++x) a = chain4(__ldg(r + x), ej[x], a);
      update(s_rm, s_sd, p, a, l, one_minus, best, who);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) argmax_xor(best, off);
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// Dynamic shared memory a CTA: its shared-memory rows, E[j] twice, then 12
// bytes of state for each of its lmax slots.
long long smem_bytes(int d, int lmax, int smem_rows) {
  const long long d4 = d / 4;
  return 16ll * ((d4 + 1) * smem_rows + 2 * d4) + 12ll * lmax;
}

using Kernel = void (*)(const float*, const float*, const float*, int, int,
                       int, int, int, int*, float*);

// The instantiation for a launch: register rows only at d <= 128.
Kernel pick(int d, int reg) {
  return reg ? mmr_kernel<32, true>
             : (d <= 128 ? mmr_kernel<32, false> : mmr_kernel<64, false>);
}

cudaError_t configure(Kernel fn, int smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// The launch for b queries over an (n, d) pool at cluster size `cluster`,
// with register rows (reg, d <= 128) or not, and `smem_rows` rows a CTA
// in shared memory: *cfg, *fn and *lmax.
cudaError_t prepare(int b, int n, int d, int cluster, int reg, int smem_rows,
                    cudaStream_t stream, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr, Kernel* fn, int* lmax) {
  if (cluster < 1 || cluster > kMaxCluster || d % 4 || d < 4 || d > 256 ||
      smem_rows < 0 || (reg && d > 128)) {
    return cudaErrorInvalidValue;
  }
  *lmax = (n + cluster - 1) / cluster;
  if (*lmax > 0xffff) return cudaErrorInvalidValue;  // the tag's 16 bits
  const long long smem = smem_bytes(d, *lmax, smem_rows);
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  *fn = pick(d, reg);
  const cudaError_t err = configure(*fn, (int)smem, cluster);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * b);
  cfg->blockDim = dim3(reg ? 384 : 256);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// One CTA an SM (its dynamic shared memory is more than half an SM's),
// `iters` exchanges: mode 0 a cluster barrier, 1 a cluster barrier and a
// read of the next CTA's shared memory, 2 an exchange on mbarriers (every
// warp stores a word into, and arrives with release semantics on the
// barrier of, every CTA, then waits on its own CTA's barrier), 3 the same
// words by st.async, each completing its bytes on the receiver's barrier.
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    cluster_sync_probe_kernel(int iters, int mode, int* __restrict__ out) {
  __shared__ int word[2][kMaxCluster * kMaxWarps];
  __shared__ uint64_t bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31;
  const int who = rank * warps + (threadIdx.x >> 5);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], mode == 3 ? 1 : csize * warps);
    mbar_init(&bar[1], mode == 3 ? 1 : csize * warps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  int acc = 0;
  for (int i = 0; i < iters; ++i) {
    const int par = i & 1;
    if (mode == 3) {
      if (threadIdx.x == 0) mbar_expect(&bar[par], csize * warps * 4);
      if (lane < csize) {
        st_async(mapa(&word[par][who], lane), i + acc, mapa(&bar[par], lane));
      }
      mbar_wait_tx(&bar[par], (i >> 1) & 1);
      acc += word[par][(who + 1) % (csize * warps)];
    } else if (mode == 2) {
      if (lane < csize) {
        *cluster.map_shared_rank(&word[par][who], lane) = i + acc;
        mbar_arrive(&bar[par], lane);
      }
      mbar_wait(&bar[par], (i >> 1) & 1);
      acc += word[par][(who + 1) % (csize * warps)];
    } else {
      if (threadIdx.x == 0) word[par][0] = i + acc;
      cluster.sync();
      if (mode == 1) {
        acc += *cluster.map_shared_rank(&word[par][0], (rank + 1) % csize);
      }
    }
  }
  cluster.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

// The card's figures the wrapper plans a launch with: the shared memory
// a CTA may opt into, and the kernels' static shared memory.
extern "C" int flexvec_mmr_limits(int* smem_optin, int* static_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *static_smem = 0;
  for (const Kernel fn : {pick(128, 1), pick(128, 0), pick(256, 0)}) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return err;
    if (static_cast<int>(a.sharedSizeBytes) > *static_smem) {
      *static_smem = static_cast<int>(a.sharedSizeBytes);
    }
  }
  return cudaSuccess;
}

// cudaOccupancyMaxActiveClusters for the launch flexvec_mmr makes with
// the same arguments (clusters of its shape resident at once).
extern "C" int flexvec_mmr_occupancy(int n, int d, int cluster, int reg,
                                     int smem_rows, int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Kernel fn = nullptr;
  int lmax = 0;
  cudaError_t err = prepare(1, n, d, cluster, reg, smem_rows, nullptr, &cfg,
                            &attr, &fn, &lmax);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      max_clusters, reinterpret_cast<const void*>(fn), &cfg);
}

// emb: (b, n, d) row-major f32 with d % 4 == 0, d <= 256 and 16-byte
// aligned; rel: (b, n) f32 (slots at or below NEG/2 are padding); lam:
// (b,) f32; out_idx (b, k) int32 and out_val (b, k) f32 receive the picks
// in selection order and their blended scores.  Launches b clusters of
// `cluster` CTAs, with a row a thread in registers if `reg` (d <= 128)
// and `smem_rows` pool rows a CTA in shared memory (the wrapper's plan),
// on `stream`, allocates nothing; returns a CUDA error, or -1 when not one
// cluster of that shape fits the card.
extern "C" int flexvec_mmr(const void* emb, const void* rel, const void* lam,
                           int b, int n, int d, int k, int cluster, int reg,
                           int smem_rows, void* out_idx, void* out_val,
                           void* stream) {
  if (b <= 0 || k <= 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Kernel fn = nullptr;
  int lmax = 0;
  cudaError_t err = prepare(b, n, d, cluster, reg, smem_rows,
                            static_cast<cudaStream_t>(stream), &cfg, &attr,
                            &fn, &lmax);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(fn), &cfg);
  if (err != cudaSuccess) return err;
  if (clusters == 0) return kNoCluster;
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const float*>(emb),
                           static_cast<const float*>(rel),
                           static_cast<const float*>(lam), n, d, k, lmax,
                           smem_rows, static_cast<int*>(out_idx),
                           static_cast<float*>(out_val));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What a step's exchange costs alone (see cluster_sync_probe_kernel):
// `clusters` clusters of `cluster` CTAs of `threads` threads (a multiple
// of 32, at most 384), one an SM, `iters` exchanges of `mode`.  out:
// clusters * cluster ints.  Returns a CUDA error.
extern "C" int flexvec_cluster_sync_probe(int cluster, int clusters,
                                          int threads, int iters, int mode,
                                          void* out, void* stream) {
  constexpr int kSmem = 120 * 1024;
  if (threads % 32 || threads < 32 || threads > 32 * kMaxWarps) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cluster_sync_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(cluster_sync_probe_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(cluster * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_sync_probe_kernel, iters, mode,
                           static_cast<int*>(out));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
