// Modulated scoring for a batch of plans on Hopper's tensor cores.
//
//   out[n, c] = f[n, c] * (M[n] . q_pre[:, c]) + M[n] . q_sup[:, c]
//   f[n, c]   = decay[n]                                  (the (N,) form)
//             = 1 / (1 + days_ago[n] / half_lives[c])      (the per-plan form)
//   days_ago[n] = f32(max((now - timestamps[n]) / 86400, 0))  (the stamped
//               form: the ages formed here from (N,) f64 unix seconds)
//
// Replaces src/repro/kernels/pem_score/kernel.py::pem_score_pallas (body
// _pem_score_kernel), the TPU kernel that streams (1024, d) corpus tiles
// through the MXU against (d, 128) query tiles.
//
// What bounds it on the H100: the bytes.  At 240k x 128 f32 and B = 32 the
// corpus (123 MB) plus the (N, B) panel (31 MB) take 46 us at 3.35 TB/s.
// The 4*N*d*B f32 operations would take 59 us on the CUDA cores, but TF32
// alone keeps ~3 digits and misses the 1e-5 tolerance, so the product runs
// as split TF32: x = hi + lo with both halves rounded to TF32 (to
// nearest), and lo*hi + hi*lo + hi*hi summed in f32, small terms first.  Three tensor-core products cost 24 us at 495 TFLOP/s, under the
// byte time.  A bf16 corpus is exact in TF32: only the query splits, two
// products.
//
// Design:
// * The instruction is wgmma.mma_async m64nNk8 tf32, A from registers, B
//   by descriptor over the query in shared memory.  mma.sync would make
//   every warp load the query fragments from shared memory for every row
//   tile, and it reaches about half of wgmma's rate: at three products
//   that would put the arithmetic near the byte time, not under it.
// * The query columns of q_pre and q_sup interleave (product column 2c is
//   q_pre[:, c], 2c+1 is q_sup[:, c]), so one product gives both sums and
//   each thread's accumulator pair holds (pre, sup) of one plan.  The
//   query is split once per block into hi and lo, K-major (TF32 wgmma
//   reads both operands K-major), 128-byte swizzled, with each 32-deep
//   block's lo rows right after its hi rows: per k-step one wgmma of
//   width 2 NW gives hi * [q_hi | q_lo] and one of width NW gives
//   lo * q_hi (NW = 8, 16, 32 or 64 by batch width; for bf16 only the
//   first).  When every chunk of 32 plans fits in shared memory it stays
//   there for the whole launch; otherwise (B > 64 at d = 128) each
//   warpgroup restages its chunk per row tile from L2.
// * The corpus streams once per launch, whatever B: a persistent grid (one
//   block per SM) walks 64-row tiles; two warpgroups take alternate tiles,
//   each owning half of a ring of 2-8 stages that it refills itself by TMA
//   (128-byte swizzled boxes, the ragged N and d edges zero-filled; the
//   rows' decay factors, ages or timestamps ride in the same stage) as
//   soon as the tile's last fragments are in registers.  One warpgroup's epilogue
//   overlaps the other's products.  For B > 32 a tile stays in shared
//   memory while its warpgroup loops over the 32-plan chunks.
// * Each thread loads its A fragment from the swizzled tile with 16-byte
//   loads and splits it in registers (a bf16 corpus only widens).  The
//   order of k inside a box is permuted, the same way for A and B, so
//   those loads are bank-conflict free: thread t of a quad reads elements
//   8t..8t+7 (16t..16t+15 for bf16) of the box.  Boxes go in pairs whose
//   fragments are all built before the pair's products start: a register
//   that a wgmma reads, written while one is in flight, makes the compiler
//   serialise every wgmma.  The steps alternate between independent
//   accumulators at narrow widths, so a product does not wait out the
//   latency of the one before.
// * The epilogue applies the decay (any form; a plan without decay has
//   half-life +inf, which gives exactly 1; a stamped row's age is formed
//   once a tile, in f64 as the host forms it) and stores from the
//   accumulator layout: into a (B, N) panel -- the transposed view the
//   top-k kernel reads -- a warp's store is four whole 32-byte sectors.
//   Staging the tile through shared memory for whole-line stores was
//   slower on the card: the round trip and its two barriers cost more
//   than the L2 saves by merging sectors.
//
// d <= 256 (flexvec's embeddings are 128-wide, a two-tower model's item
// vectors 256; the ring and the split query must fit in 227 KB: at d = 256
// in f32 a stage is 64 KB, so the ring has two stages, and past B = 16 the
// product narrows until a restaged chunk fits beside them), d % 4 == 0
// (d % 8 for bf16: TMA row strides are multiples of 16 bytes), any N and
// B >= 1.  One launch per call.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 64;          // corpus rows per tile: one wgmma M
constexpr int kConsumers = 2;      // warpgroups a block
constexpr int kThreads = 128 * kConsumers;
constexpr int kBoxBytes = kRows * 128;  // one 128-byte-wide swizzled box
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;
constexpr int kMaxDevices = 64;  // devices whose launch attribute is cached
constexpr int kMaxD = 256;       // the widest corpus row the plan takes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            int x, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps a register live (and unmoved) across the asynchronous wgmma
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int A, int K>
__device__ __forceinline__ void fence_regs(float (&r)[A][K]) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[a][i])::"memory");
}

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 gives for finite x, in two integer
// operations: the split needs two roundings a corpus element, and on the
// card the conversion instruction made a tile's product phase longer.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// 1 / (1 + days / hl), every operation correctly rounded, as the
// reference computes its f32 column, from the column's (hl, rhl): rhl is
// hl's correctly rounded reciprocal, or (1, 0) for hl = +inf, which gives
// exactly 1.  The quotient is Markstein's correction of days * rhl; the
// reciprocal one Newton step from the approximate one.  `slow` is set
// where that is not proven correctly rounded -- rhl outside the normal
// range (stored as NaN), a sum whose significand is all ones, or one
// that overflows -- and the caller recomputes those with the plain
// operations.
__device__ __forceinline__ float decay_factor(float days, float hl,
                                             float rhl, bool& slow) {
  float q = __fmul_rn(days, rhl);
  q = __fmaf_rn(__fmaf_rn(-hl, q, days), rhl, q);
  const float y = __fadd_rn(1.f, q);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  r = __fmaf_rn(__fmaf_rn(-y, r, 1.f), r, r);
  slow = (__float_as_uint(y) & 0x7FFFFFu) == 0x7FFFFFu || !(y < 1e37f);
  return r;
}

// A row's age in days at `now` from its unix timestamp, as the host forms
// it: max((now - ts) / 86400, 0) in f64, each operation correctly rounded
// (a division, not a reciprocal's product), then rounded to f32.  The max
// keeps a NaN, as np.maximum does (fmax would return the 0).
__device__ __forceinline__ float age_days(double ts, double now) {
  const double x = __ddiv_rn(__dsub_rn(now, ts), 86400.0);
  return __double2float_rn(x >= 0.0 || isnan(x) ? x : 0.0);
}

// wgmma descriptor of a K-major, 128-byte-swizzled operand: rows of 128
// bytes, 8-row groups 1024 bytes apart (LBO unused when swizzled)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D[64 x NW] += A[64 x 8] (registers) * B[8 x NW] (descriptor), TF32 in,
// f32 accumulation
template <int NW>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NW / 2],
                                           const uint32_t* a, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4],
                                               const uint32_t* a,
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                               const uint32_t* a,
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t* a,
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t* a,
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

struct Params {
  const float* q_pre;       // (d, b) row-major
  const float* q_sup;       // (d, b) row-major
  const float* half_lives;  // (b,) with days; +inf for a plan without decay
  float* out;               // out[r * so_n + c * so_b]
  long long so_n, so_b;
  double now;     // the stamped form's time, unix seconds
  int n, d, b;
  // 0: no factor, 1: decay (n,) f32, 2: days_ago (n,) f32 + half_lives,
  // 3: timestamps (n,) f64 + now + half_lives
  int rows_form;
  int nbox;       // 128-byte-wide boxes across a corpus row
  int ntiles;     // 64-row tiles
  int nchunks;    // query chunks of NW / 2 plans
  int stages;     // ring depth, a multiple of kConsumers
  int resident;   // every chunk's split query stays in shared memory
  uint32_t stage_bytes, qchunk_bytes, q_off, rows_off, hl_off, bar_off;
};

// elements of one 128-byte box row
template <typename T>
struct BoxK;
template <>
struct BoxK<float> {
  static constexpr int value = 32;
};
template <>
struct BoxK<__nv_bfloat16> {
  static constexpr int value = 64;
};

// Writes query chunk `ch` into `q`, K-major and swizzled as the B
// descriptor reads it: per 32-deep block, NW rows of hi then NW rows of
// lo (128 bytes each), so that one descriptor spans hi alone (N = NW) or
// hi and lo together (N = 2 NW).  Position kk of k-step S holds depth
// index box * kBoxK + 2 * SPB * (kk % 4) + 2 * (S % SPB) + kk / 4 (SPB =
// k-steps per box): the permutation under which a thread's A fragment is
// contiguous in the corpus tile.
template <typename T, int NW>
__device__ void stage_query(char* q, int ch, const Params& p, int tid,
                            int nthr) {
  constexpr int kBoxK = BoxK<T>::value;
  constexpr int SPB = kBoxK / 8;
  constexpr int kBatch = 32;  // loads in flight per thread
  const int depth = p.nbox * kBoxK;
  const int total = depth * NW;
  for (int e0 = tid; e0 < total; e0 += kBatch * nthr) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nthr;
      const int pc = e % NW;   // product column: 2c is q_pre, 2c+1 q_sup
      const int pos = e / NW;  // 8 * step + kk
      const int step = pos >> 3, kk = pos & 7;
      const int k = step / SPB * kBoxK + 2 * SPB * (kk & 3) +
                    2 * (step % SPB) + (kk >> 2);
      const int c = ch * (NW / 2) + (pc >> 1);
      v[u] = 0.f;
      if (e < total && c < p.b && k < p.d)
        v[u] = ((pc & 1) ? p.q_sup
                         : p.q_pre)[static_cast<long long>(k) * p.b + c];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nthr;
      if (e >= total) break;
      const int pc = e % NW, pos = e / NW, p32 = pos & 31;
      const uint32_t hi = to_tf32(v[u]);
      const uint32_t lo = to_tf32(v[u] - __uint_as_float(hi));
      const uint32_t off = (pos >> 5) * 2 * NW * 128 + pc * 128 +
                           (((p32 >> 2) ^ (pc & 7)) << 4) + (p32 & 3) * 4;
      *reinterpret_cast<uint32_t*>(q + off) = hi;
      *reinterpret_cast<uint32_t*>(q + off + NW * 128) = lo;
    }
  }
}

// Accumulators.  Per k-step an f32 corpus takes two products: lo * hi
// (N = NW) into `lo`, and hi * [hi | lo] (N = 2 NW, both terms in one
// instruction) into `hi`; a bf16 corpus takes the second only.  A wgmma
// that adds into the accumulator of the one before waits out that one's
// latency, which at these widths is several times its work, so steps
// alternate between P independent sets where registers allow; the
// epilogue sums them, small terms first.
template <typename T, int NW>
struct Acc {
  static constexpr bool kSplitA = sizeof(T) == 4;
  static constexpr int P = NW >= 64 ? 1 : NW >= 32 ? 2 : 4;
  float hi[P][NW];                       // [hi*q_hi | hi*q_lo] columns
  float lo[kSplitA ? P : 1][NW / 2];     // lo*q_hi (f32 corpus only)
};

template <typename T, int NW>
__device__ __forceinline__ void fence_acc(Acc<T, NW>& a) {
  fence_regs(a.hi);
  if constexpr (Acc<T, NW>::kSplitA) fence_regs(a.lo);
}

// This thread's A fragment of one box (32 f32 or 64 bf16 of depth) of a
// warpgroup's 64 rows: rows r0 and r0 + 8, two 16-byte loads each from the
// swizzled tile, split into TF32 hi and lo (a bf16 corpus only widens).
template <typename T>
__device__ __forceinline__ void load_fragment(uint32_t (&f)[32],
                                              const char* box, int r0, int g,
                                              int t) {
  const char* row0 = box + r0 * 128;
  const char* row1 = row0 + 8 * 128;
  const uint4 x00 = *reinterpret_cast<const uint4*>(row0 + (((2 * t) ^ g) << 4));
  const uint4 x01 =
      *reinterpret_cast<const uint4*>(row0 + (((2 * t + 1) ^ g) << 4));
  const uint4 x10 = *reinterpret_cast<const uint4*>(row1 + (((2 * t) ^ g) << 4));
  const uint4 x11 =
      *reinterpret_cast<const uint4*>(row1 + (((2 * t + 1) ^ g) << 4));
  const uint32_t w0[8] = {x00.x, x00.y, x00.z, x00.w,
                          x01.x, x01.y, x01.z, x01.w};
  const uint32_t w1[8] = {x10.x, x10.y, x10.z, x10.w,
                          x11.x, x11.y, x11.z, x11.w};
  if constexpr (sizeof(T) == 4) {
    // f32: step s takes elements 2s, 2s+1 of each row's eight; registers
    // (a0, a1, a2, a3) = (row0[2s], row1[2s], row0[2s+1], row1[2s+1]),
    // hi in f[8s .. 8s+3], lo in f[8s+4 .. 8s+7]
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float a[4] = {__uint_as_float(w0[2 * s]),
                          __uint_as_float(w1[2 * s]),
                          __uint_as_float(w0[2 * s + 1]),
                          __uint_as_float(w1[2 * s + 1])};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t hi = to_tf32(a[i]);
        f[8 * s + i] = hi;
        f[8 * s + 4 + i] = to_tf32(a[i] - __uint_as_float(hi));
      }
    }
  } else {
    // bf16: word s of a row holds elements 2s (low half) and 2s+1; a
    // bf16 widened to f32 is already exact in TF32
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      f[4 * s + 0] = w0[s] << 16;
      f[4 * s + 1] = w1[s] << 16;
      f[4 * s + 2] = w0[s] & 0xFFFF0000u;
      f[4 * s + 3] = w1[s] & 0xFFFF0000u;
    }
  }
}

// The products of box j against query q (uncommitted).
template <typename T, int NW>
__device__ __forceinline__ void box_products(Acc<T, NW>& acc,
                                             const uint32_t (&f)[32],
                                             uint32_t q, int j) {
  constexpr int P = Acc<T, NW>::P;
  constexpr uint32_t kQBlock = 2 * NW * 128;  // one 32-deep query block
  if constexpr (Acc<T, NW>::kSplitA) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t desc = smem_desc(q + j * kQBlock + s * 32);
      wgmma_tf32<NW>(acc.lo[s % P], &f[8 * s + 4], desc);  // lo * hi
      wgmma_tf32<2 * NW>(acc.hi[s % P], &f[8 * s], desc);  // hi * [hi|lo]
    }
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int step = 8 * j + s;
      const uint64_t desc =
          smem_desc(q + (step >> 2) * kQBlock + (step & 3) * 32);
      wgmma_tf32<2 * NW>(acc.hi[s % P], &f[4 * s], desc);  // m * [hi|lo]
    }
  }
}

template <typename T, int NW>
__global__ void __launch_bounds__(kThreads, 1)
    pem_score_kernel(const __grid_constant__ CUtensorMap map,
                     const __grid_constant__ CUtensorMap rows_map,
                     const Params p) {
  constexpr int kBoxK = BoxK<T>::value;
  constexpr int QC = NW / 2;
  constexpr int P = Acc<T, NW>::P;
  extern __shared__ __align__(16) char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the ring and the query
  char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + p.bar_off;  // + 8 * stage
  // a stage's rows: 64 f32 factors or ages, or 64 f64 timestamps
  const char* rows_smem = smem + p.rows_off;
  const uint32_t row_bytes = p.rows_form == 3 ? 8 : 4;
  float* hl_smem = reinterpret_cast<float*>(smem + p.hl_off);  // hl, 1/hl
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, tw = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * wl + g;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warpgroup wg takes the block's tiles wg, wg + kConsumers, ...: its
  // it-th tile lands in stage it % stages, so it owns the stages s with
  // s % kConsumers == wg and refills each itself as soon as it is read.
  // A stage holds the tile's boxes and, beside them, its rows' decay
  // factors, ages or timestamps (kRows * 8 bytes a stage whatever the
  // form).
  const CUtensorMap* corpus = &map;
  const CUtensorMap* rows_vec = &rows_map;
  auto load_tile = [&](int s, int tile) {
    mbar_expect_tx(full + 8 * s,
                   p.stage_bytes + (p.rows_form ? kRows * row_bytes : 0));
    for (int j = 0; j < p.nbox; ++j)
      tma_load_2d(base + s * p.stage_bytes + j * kBoxBytes, corpus,
                  j * kBoxK, tile * kRows, full + 8 * s);
    if (p.rows_form)
      tma_load_1d(base + p.rows_off + s * kRows * 8, rows_vec, tile * kRows,
                  full + 8 * s);
  };
  // each plan's (hl, rhl) as decay_factor takes them
  for (int c = threadIdx.x; c < p.nchunks * QC; c += kThreads) {
    const float hl = p.rows_form >= 2 && c < p.b ? p.half_lives[c] : 1.f;
    const float rhl = __frcp_rn(hl);
    const bool normal = rhl >= 1.17549435e-38f && rhl < 1e37f;
    hl_smem[2 * c] = isinf(hl) ? 1.f : hl;
    hl_smem[2 * c + 1] = isinf(hl) ? 0.f : normal ? rhl : __int_as_float(0x7fc00000);
  }
  if (p.resident) {
    for (int ch = 0; ch < p.nchunks; ++ch)
      stage_query<T, NW>(smem + p.q_off + ch * p.qchunk_bytes, ch, p,
                         threadIdx.x, kThreads);
    fence_proxy_async();
  }
  // the first tiles' loads go out after the query's: behind them, its
  // small reads would wait for megabytes of tiles
  if (tw == 0) {
    for (int it = wg; it < p.stages; it += kConsumers) {
      const int tile = blockIdx.x + it * gridDim.x;
      if (tile < p.ntiles) load_tile(it, tile);
    }
  }

  __syncthreads();

  // every thread of the warpgroup has read the stage: reload it
  auto refill = [&](int s, int tile) {
    named_sync(1 + wg, 128);
    if (tw == 0 && tile < p.ntiles) load_tile(s, tile);
  };
  int it = wg;
  for (int tile = blockIdx.x + wg * gridDim.x; tile < p.ntiles;
       tile += kConsumers * gridDim.x, it += kConsumers) {
    const int s = it % p.stages;
    const int row0 = tile * kRows;
    mbar_wait(full + 8 * s, (it / p.stages) & 1);
    const char* tl = smem + s * p.stage_bytes;
    float rowv[2] = {1.f, 1.f};  // decay factor or age of rows r0, r0 + 8
    const char* rows_stage = rows_smem + s * kRows * 8;
    if (p.rows_form == 3) {
      const double* ts = reinterpret_cast<const double*>(rows_stage);
      rowv[0] = age_days(ts[r0], p.now);
      rowv[1] = age_days(ts[r0 + 8], p.now);
    } else if (p.rows_form) {
      const float* f = reinterpret_cast<const float*>(rows_stage);
      rowv[0] = f[r0];
      rowv[1] = f[r0 + 8];
    }
    for (int ch = 0; ch < p.nchunks; ++ch) {
      const uint32_t qoff =
          p.q_off + (p.resident ? ch : wg) * p.qchunk_bytes;
      if (!p.resident) {
        // restage this warpgroup's buffer once every warp's products of
        // the chunk before are done
        named_sync(1 + wg, 128);
        stage_query<T, NW>(smem + qoff, ch, p, tw, 128);
        fence_proxy_async();
        named_sync(1 + wg, 128);
      }
      Acc<T, NW> acc;
#pragma unroll
      for (int a = 0; a < P; ++a)
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          acc.hi[a][i] = 0.f;
          if (Acc<T, NW>::kSplitA && i < QC) acc.lo[a][i] = 0.f;
        }
      fence_acc(acc);
      // Boxes go in pairs: both fragments are built before the pair's
      // products start and are not touched until they finish (a register
      // that a wgmma reads, written while any is in flight, makes the
      // compiler serialise them all).  The other warpgroup's products
      // fill the gaps.  The stage is refilled with this warpgroup's next
      // tile once the tile's last fragments are in registers.
      const int next = tile + p.stages * gridDim.x;
      for (int j = 0; j < p.nbox; j += 2) {
        uint32_t fa[32], fb[32];
        load_fragment<T>(fa, tl + j * kBoxBytes, r0, g, t);
        load_fragment<T>(fb, tl + (j + 1) * kBoxBytes, r0, g, t);
        if (ch + 1 == p.nchunks && j + 2 >= p.nbox) refill(s, next);
        fence_regs(fa);
        fence_regs(fb);
        wgmma_fence();
        box_products<T, NW>(acc, fa, base + qoff, j);
        box_products<T, NW>(acc, fb, base + qoff, j + 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(fa);
        fence_regs(fb);
        fence_acc(acc);
      }
      // acc.hi[.][i] holds hi*q_hi for i < QC and hi*q_lo at i + QC
      float sum[QC];
#pragma unroll
      for (int i = 0; i < QC; ++i) {
        float small = 0.f, big = 0.f;
#pragma unroll
        for (int a = 0; a < P; ++a) {
          if constexpr (Acc<T, NW>::kSplitA)
            small = __fadd_rn(small, acc.lo[a][i]);
          small = __fadd_rn(small, acc.hi[a][QC + i]);
          big = __fadd_rn(big, acc.hi[a][i]);
        }
        sum[i] = __fadd_rn(big, small);
      }

      // epilogue: thread holds (pre, sup) of plan 4i + t for rows r0 and
      // r0 + 8 in sum[4i .. 4i + 3].  Factors first, without branches, so
      // their latency chains overlap; the rare ones decay_factor cannot
      // round are recomputed after.
      float fac[NW / 8][2];
      uint32_t redo = 0;
#pragma unroll
      for (int i = 0; i < NW / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          fac[i][h] = rowv[h];
          if (p.rows_form >= 2) {
            const float* c = hl_smem + 2 * (ch * QC + 4 * i + t);
            bool slow;
            fac[i][h] = decay_factor(rowv[h], c[0], c[1], slow);
            redo |= static_cast<uint32_t>(slow) << (2 * i + h);
          }
        }
      while (redo) {
        const int k = __ffs(redo) - 1;
        redo &= redo - 1;
        const int c = ch * QC + 4 * (k >> 1) + t;
        const float hl = c < p.b ? p.half_lives[c] : 1.f;
        const float f =
            isinf(hl) ? 1.f
                      : __frcp_rn(__fadd_rn(1.f, __fdiv_rn(rowv[k & 1], hl)));
#pragma unroll
        for (int i = 0; i < NW / 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (k == 2 * i + h) fac[i][h] = f;
      }
      // Stored straight from the accumulator layout: a warp's store is
      // 8 consecutive rows of 4 plans, four whole 32-byte sectors of a
      // (B, N) panel, which the L2 merges into lines.
#pragma unroll
      for (int i = 0; i < NW / 8; ++i) {
        const int c = ch * QC + 4 * i + t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = row0 + r0 + 8 * h;
          if (c < p.b && gr < p.n)
            p.out[static_cast<long long>(gr) * p.so_n +
                  static_cast<long long>(c) * p.so_b] =
                __fadd_rn(__fmul_rn(fac[i][h], sum[4 * i + 2 * h]),
                          sum[4 * i + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Plan {
  int nw, nchunks, nbox, stages, resident, ntiles, grid;
  size_t smem;
  uint32_t stage_bytes, qchunk_bytes, q_off, rows_off, hl_off, bar_off;
};

// Product width by batch, ring depth and query residency by the shared
// memory budget: the split query stays resident if every chunk fits
// beside a ring of at least two stages, else each warpgroup restages its
// chunk per tile.  Where neither fits (d > 128 at B > 16: a 64-wide chunk
// of a 256-deep query is 128 KB) the product narrows to the next width,
// down to 8.  The stages are a multiple of the warpgroups, so each stage
// serves one warpgroup and a waiter is never two phases ahead of its
// barrier.
cudaError_t make_plan(int n, int d, int b, int bf16, int sms, Plan* pl) {
  if (n <= 0 || b <= 0 || d <= 0 || d > kMaxD) return cudaErrorInvalidValue;
  const int box_k = bf16 ? 64 : 32;
  // boxes go in pairs: a box wholly past d is zero-filled by TMA
  const int nbox = ((d + box_k - 1) / box_k + 1) / 2 * 2;
  const uint32_t stage = nbox * kBoxBytes;
  for (int nw = b <= 4 ? 8 : b <= 8 ? 16 : b <= 16 ? 32 : 64; nw >= 8;
       nw /= 2) {
    const uint32_t qchunk = 2 * (nbox * box_k / 32) * nw * 128;
    const int nchunks = (b + nw / 2 - 1) / (nw / 2);
    const uint32_t hl = 2 * nchunks * (nw / 2) * 4;
    // + alignment slack, the rows' factors, ages or timestamps (8 bytes a
    // row, the widest form) and one barrier per stage
    const size_t fixed = 1024 + hl + kMaxStages * (kRows * 8 + 8);
    for (int resident = 1; resident >= 0; --resident) {
      const size_t nq = resident ? nchunks : kConsumers;
      for (int s = kMaxStages; s >= kConsumers; s -= kConsumers) {
        if (fixed + s * static_cast<size_t>(stage) + nq * qchunk >
            static_cast<size_t>(kSmemLimit))
          continue;
        pl->nw = nw;
        pl->nchunks = nchunks;
        pl->nbox = nbox;
        pl->stages = s;
        pl->resident = resident;
        pl->ntiles = (n + kRows - 1) / kRows;
        pl->grid = pl->ntiles < sms ? pl->ntiles : sms;
        pl->stage_bytes = stage;
        pl->qchunk_bytes = qchunk;
        pl->q_off = s * stage;
        pl->rows_off = pl->q_off + static_cast<uint32_t>(nq) * qchunk;
        pl->hl_off = pl->rows_off + s * kRows * 8;
        pl->bar_off = pl->hl_off + hl;
        pl->smem = pl->bar_off + s * 8 + 1024;
        return cudaSuccess;
      }
    }
  }
  return cudaErrorInvalidValue;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// link against the driver
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <typename T, int NW>
cudaError_t launch(const CUtensorMap& map, const CUtensorMap& rows_map,
                   const Params& p, const Plan& pl, cudaStream_t stream) {
  // the attribute belongs to the current device: set it once on each
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    err = cudaFuncSetAttribute(
        pem_score_kernel<T, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  pem_score_kernel<T, NW>
      <<<pl.grid, kThreads, pl.smem, stream>>>(map, rows_map, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const CUtensorMap& map, const CUtensorMap& rows_map,
                         const Params& p, const Plan& pl,
                         cudaStream_t stream) {
  switch (pl.nw) {
    case 8:
      return launch<T, 8>(map, rows_map, p, pl, stream);
    case 16:
      return launch<T, 16>(map, rows_map, p, pl, stream);
    case 32:
      return launch<T, 32>(map, rows_map, p, pl, stream);
    default:
      return launch<T, 64>(map, rows_map, p, pl, stream);
  }
}

}  // namespace

// The launch's shape for (n, d, b): info receives product width, query
// chunks, boxes a row, ring stages, query residency, grid, dynamic shared
// memory bytes and row tiles.  Returns 0 or a CUDA error code.
extern "C" int flexvec_pem_score_plan(int n, int d, int b, int m_bf16,
                                      long long* info) {
  Plan pl;
  const cudaError_t err = make_plan(n, d, b, m_bf16, sm_count(), &pl);
  if (err != cudaSuccess) return err;
  const long long v[8] = {pl.nw,   pl.nchunks, pl.nbox,
                          pl.stages, pl.resident, pl.grid,
                          static_cast<long long>(pl.smem), pl.ntiles};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}

// m: (n, d) row-major f32 (m_bf16 = 0) or bf16 (m_bf16 = 1), 16-byte
// aligned, d <= 256 and d * element size a multiple of 16; q_pre, q_sup:
// (d, b) row-major f32; then either decay (n,) f32, or days (n,) f32 with
// half_lives (b,) f32, or stamps (n,) f64 unix seconds with `now` and
// half_lives, or all four null for ones (decay, days and stamps 16-byte
// aligned); out[r*so_n + c*so_b] receives the score of row r for plan c.
// One launch on `stream`; allocates nothing; returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int flexvec_pem_score(const void* m, int m_bf16, const void* q_pre,
                                 const void* q_sup, const void* decay,
                                 const void* days, const void* stamps,
                                 double now, const void* half_lives,
                                 void* out, int n, int d, int b,
                                 long long so_n, long long so_b,
                                 void* stream) {
  if (n <= 0 || b <= 0) return 0;
  Plan pl;
  cudaError_t err = make_plan(n, d, b, m_bf16, sm_count(), &pl);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const int esize = m_bf16 ? 2 : 4;
  CUtensorMap map, rows_map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(kRows)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map,
             m_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(m), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // the rows' decay factors, ages or timestamps, 64 a tile (zeros past n)
  const void* rows = decay != nullptr ? decay : days != nullptr ? days : stamps;
  memset(&rows_map, 0, sizeof(rows_map));
  if (rows != nullptr) {
    const cuuint64_t rdims[1] = {static_cast<cuuint64_t>(n)};
    const cuuint32_t rbox[1] = {static_cast<cuuint32_t>(kRows)};
    if (encode(&rows_map,
               rows == stamps ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               1,
               const_cast<void*>(rows), rdims, strides, rbox, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  Params p;
  p.q_pre = static_cast<const float*>(q_pre);
  p.q_sup = static_cast<const float*>(q_sup);
  p.half_lives = static_cast<const float*>(half_lives);
  p.out = static_cast<float*>(out);
  p.so_n = so_n;
  p.so_b = so_b;
  p.now = now;
  p.n = n;
  p.d = d;
  p.b = b;
  p.rows_form = decay != nullptr    ? 1
                : days != nullptr   ? 2
                : stamps != nullptr ? 3
                                    : 0;
  p.nbox = pl.nbox;
  p.ntiles = pl.ntiles;
  p.nchunks = pl.nchunks;
  p.stages = pl.stages;
  p.resident = pl.resident;
  p.stage_bytes = pl.stage_bytes;
  p.qchunk_bytes = pl.qchunk_bytes;
  p.q_off = pl.q_off;
  p.rows_off = pl.rows_off;
  p.hl_off = pl.hl_off;
  p.bar_off = pl.bar_off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m_bf16 ? launch_width<__nv_bfloat16>(map, rows_map, p, pl, s)
                : launch_width<float>(map, rows_map, p, pl, s);
}
