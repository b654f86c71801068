// Row-wise top-K with jax.lax.top_k's order: values descending, ties
// (-inf padding and masked rows included) to the smallest index, no index
// twice.
//
// Replaces src/repro/kernels/topk/kernel.py::topk_pallas (body
// _topk_kernel), which walks a row's 2048-column blocks in grid order and
// merges each into a running (B, K) buffer kept in VMEM across steps.
// Blocks of a Hopper grid run in no order and share nothing, so that
// sequential merge has no counterpart here.
//
// What bounds it on the H100: reading the (B, N) score panel (32 x 240k
// f32 is 31 MB, 9.3 us at 3.35 TB/s), and at B = 1 the launches' latency.
// Ordering all N keys is wasted work: only K survive.  So the design finds
// each row's K-th key first and sorts only the K survivors, in three
// phases that the host enqueues in one call with no synchronisation and
// no data-dependent host loop:
//
// 0. A panel whose rows are not contiguous (a filter batch's mask makes
//    the (B, N) panel column-major: torch.where(mask.T, ...)) would have
//    each warp's 32 keys of a row lie 4 B * B apart, and every pass move
//    a 32-byte sector for each 4-byte key.  So its first radix pass reads
//    it once in 32 x 32 tiles through shared memory, histograms each tile
//    a lane a row, and writes it row-major into the workspace, which the
//    later passes read: the same launches, one extra write of the panel.
// 1. Radix select (three launches, digits of 8, 12 and 12 bits, most
//    significant first) over the 32-bit order-flipped value (IEEE total
//    order, -0.0 below +0.0).  The grid is (chunks along N, B), so a
//    single row still spreads over the card.  A block histograms its
//    chunk's keys that match the row's prefix in shared memory (pass 0
//    in one column a lane, since real scores crowd into a few top-8-bit
//    bins; later a warp whose keys share one digit adds once, so a
//    constant or masked row does not serialise on one bin) and adds the
//    histogram, and a 64-bucket summary of it, into the row's global one
//    with atomics.  Each block of the next launch reads the summary and
//    one bucket's bins first and picks the digit that holds the K-th key
//    (no block waits for another, and no launch is spent on it).  Each
//    pass runs in about the time of one read of the panel.  Afterwards
//    each row has its K-th key v*, the count c_gt of keys above it, and
//    t = K - c_gt ties to take.
// 2. Survivors.  The last pass already knows v*'s top 20 bits, so it
//    appends every key above them to the row's survivors: a block stages
//    its own in shared memory and reserves room for them with one atomic
//    add on the row's cursor (their order there does not matter), and
//    counts, a warp at a time, the keys that share those 20 bits.  Two
//    light launches finish the rest.  The tie count: only warps whose
//    share holds a key with v*'s 20-bit prefix read it again, append its
//    keys above v* and count its ties; a row where v* is its smallest key
//    and no key above v* shares its prefix (a masked row with fewer than K
//    live keys, where v* is -inf) reads nothing, since pass 2's counts are
//    then its tie counts.  The tie write: each block with ties sums the
//    tie counts before it in (block, warp) order, which is index order,
//    and each warp writes its ties whose rank among the row's ties is
//    below t, stopping there (on such a masked row only the warps that
//    cover columns [0, K) write).  So the smallest indices win by
//    construction and exactly K keys survive, also when nearly the whole
//    row ties (a fully masked row is N ties at -inf).  The panel is read
//    three times in all, plus the shares that hold v*.
// 3. Sort (one launch, one block a row): the K survivors as 64-bit keys
//    (flipped value above, index below) with a bitonic network, in
//    registers and warp shuffles for the short strides and in shared
//    memory for the long ones, then values and indices in lax.top_k
//    order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // select and compaction blocks
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;             // loads in flight a thread
constexpr int kPasses = 3;             // digits of 8, 12 and 12 bits
constexpr int kBins = 4096;
constexpr int kStaged = 2048;          // pass 2's survivors a block stages
constexpr int kSortThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
// per-row words of the zeroed workspace: each pass's histogram and its
// summary in kCoarse buckets of equal width; the
// prefix and the count of keys above it after 0..3 digits (slot q is
// written by the first block of the launch after pass q - 1); the
// cursor of survivors above v*
constexpr int kCoarse = 64;             // buckets a histogram's summary
constexpr int kPassWords = kBins + kCoarse;
constexpr int kHist = 0;
constexpr int kPrefix = kHist + kPasses * kPassWords;
constexpr int kAbove = kPrefix + kPasses + 1;
constexpr int kCursor = kAbove + kPasses + 1;
constexpr int kRowWords = (kCursor + 2) / 2 * 2;  // even: int2 after it aligns

// ascending total-order key of a float: larger key, larger value
__device__ __forceinline__ unsigned asc_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned asc) {
  return __uint_as_float((asc & 0x80000000u) ? (asc & 0x7fffffffu) : ~asc);
}

// 64-bit sort key: ascending order is values descending, then index
__device__ __forceinline__ unsigned long long sort_key(unsigned key, int e) {
  return (static_cast<unsigned long long>(~key) << 32) |
         static_cast<unsigned>(e);
}

// Append the warp's flagged keys to a row's survivors above v*, at a
// cursor: their order there does not matter, the sort fixes it.
__device__ __forceinline__ void append(bool flag, unsigned key, int e,
                                       int* cursor,
                                       unsigned long long* out) {
  const unsigned b = __ballot_sync(kFull, flag);
  if (!b) return;
  const int lane = threadIdx.x & 31;
  int at = 0;
  if (lane == 0) at = atomicAdd(cursor, __popc(b));
  at = __shfl_sync(kFull, at, 0);
  if (flag) out[at + __popc(b & ((1u << lane) - 1u))] = sort_key(key, e);
}

struct Panel {
  const float* scores;
  long long s_b, s_n;
  int n, len;  // len = max(n, k) and n >= 1: columns n..len-1 read as -inf

  __device__ __forceinline__ const float* row_ptr(int64_t row) const {
    return scores + row * s_b;
  }
  // The load is unconditional (clamped into the row), so a thread's loads
  // issue back to back instead of one branch at a time.
  __device__ __forceinline__ unsigned key(const float* r, int e) const {
    const float v = r[min(e, n - 1) * s_n];
    return asc_key(e < n ? v : -INFINITY);
  }
};

// In warp 0: of 64 counts v (bucket 63 holds the largest keys), the
// bucket in which the count from the top first reaches `need`, and the
// count in the buckets above it, into *bucket and *over.
__device__ __forceinline__ void find64(const int* v, int need, int* bucket,
                                       int* over) {
  const int lane = threadIdx.x & 31;
  const int v0 = v[2 * lane];
  const int v1 = v[2 * lane + 1];
  int upper = v0 + v1;  // keys in buckets >= 2 lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_down_sync(kFull, upper, off);
    if (lane + off < 32) upper += t;
  }
  if (upper - v0 < need && need <= upper) {  // bucket 2 lane
    *bucket = 2 * lane;
    *over = upper - v0;
  }
  if (upper - v0 - v1 < need && need <= upper - v0) {  // bucket 2 lane + 1
    *bucket = 2 * lane + 1;
    *over = upper - v0 - v1;
  }
}

// The digit of pass Q that holds the row's K-th key: every block of the
// next launch works it out at its start from the pass's histogram (no
// block waits for the others, and no launch is spent on it), reading the
// 64-bucket summary and then the 64 bins, or 4, of one bucket.  Returns
// the prefix of Q + 1 digits and the count of keys above it, in every
// thread.  `scratch` holds 128 ints of shared memory.
template <int Q>
__device__ void narrow(const int* rw, int k, int* scratch, unsigned& prefix,
                       int& above) {
  constexpr int kFine = (Q == 0 ? 256 : kBins) / kCoarse;
  constexpr int kShiftQ = Q == 0 ? 24 : (Q == 1 ? 12 : 0);
  __shared__ int s_bucket, s_over, s_bin, s_bin_over;
  const int tid = threadIdx.x;
  const int* h = rw + kHist + Q * kPassWords;
  const unsigned pre = static_cast<unsigned>(rw[kPrefix + Q]);
  const int abv = rw[kAbove + Q];
  if (tid < kCoarse) scratch[tid] = __ldcg(&h[kBins + tid]);
  __syncthreads();
  if (tid < 32) find64(scratch, k - abv, &s_bucket, &s_over);
  __syncthreads();
  const int bucket = s_bucket;
  const int over = s_over;
  if (tid < kCoarse) {
    scratch[kCoarse + tid] =
        tid < kFine ? __ldcg(&h[bucket * kFine + tid]) : 0;
  }
  __syncthreads();
  if (tid < 32) {
    find64(scratch + kCoarse, k - abv - over, &s_bin, &s_bin_over);
  }
  __syncthreads();
  prefix = pre | (static_cast<unsigned>(bucket * kFine + s_bin) << kShiftQ);
  above = abv + over + s_bin_over;
}

// Pass PASS of the radix select over chunk blockIdx.x of row blockIdx.y.
// Pass 0 takes the top 8 bits of every key: on real scores most keys fall
// into a few bins, so each lane counts into its own column of a (256, 32)
// histogram and no two lanes of a warp ever meet on one address.  Passes 1
// and 2 take 12 bits each of the few keys that match the prefix so far.
template <int PASS>
__global__ void __launch_bounds__(kThreads) radix_pass_kernel(
    Panel p, int chunk, int chunks, int k, int* __restrict__ ws,
    int2* __restrict__ offs, unsigned long long* __restrict__ surv) {
  constexpr int kShift = PASS == 0 ? 24 : (PASS == 1 ? 12 : 0);
  constexpr unsigned kHi = PASS == 0 ? 0u : (kFull << (kShift + 12));
  constexpr int kWords = PASS == 0 ? 256 * 32 : kBins;
  constexpr int kStage = PASS == 2 ? kStaged : 1;
  __shared__ int hist[kWords];
  __shared__ unsigned long long stage[kStage];  // pass 2's survivors
  __shared__ int staged, base;
  const int64_t row = blockIdx.y;
  const float* r = p.row_ptr(row);
  int* rw = ws + row * kRowWords;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  unsigned prefix = 0;
  if (PASS > 0) {
    int above;
    narrow<PASS == 0 ? 0 : PASS - 1>(rw, k, hist, prefix, above);
    if (blockIdx.x == 0 && tid == 0) {
      rw[kPrefix + PASS] = static_cast<int>(prefix);
      rw[kAbove + PASS] = above;
    }
  }
  for (int i = tid; i < kWords; i += kThreads) hist[i] = 0;
  if (tid == 0) staged = 0;
  __syncthreads();

  const int share = chunk / kWarps;  // each warp reads a contiguous share
  const int start = blockIdx.x * chunk + (tid >> 5) * share;
  const int end = min(start + share, p.len);
  int matched = 0;  // pass 2: keys that share the 20-bit prefix
  for (int off = start; off < end; off += 32 * kUnroll) {
    unsigned key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = off + u * 32 + lane;
      key[u] = p.key(r, e);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = off + u * 32 + lane;
      if (PASS == 2) {  // above the prefix: a survivor, whatever v* is
        const bool sure = e < end && (key[u] & kHi) > prefix;
        const unsigned b = __ballot_sync(kFull, sure);
        if (b) {  // staged in shared memory, one cursor add a block
          int at = 0;
          if (lane == 0) at = atomicAdd(&staged, __popc(b));
          at = __shfl_sync(kFull, at, 0) + __popc(b & ((1u << lane) - 1u));
          if (sure && at < kStaged) stage[at] = sort_key(key[u], e);
          append(sure && at >= kStaged, key[u], e, &rw[kCursor],
                 surv + row * k);  // overflow: straight to the row
        }
      }
      if (PASS == 0) {
        if (e < end) atomicAdd(&hist[(key[u] >> 24) * 32 + lane], 1);
        continue;
      }
      const int digit = (e < end && (key[u] & kHi) == prefix)
                            ? static_cast<int>((key[u] >> kShift) & 0xfffu)
                            : -1;
      // a warp whose keys share one digit (a constant or fully masked
      // row) adds once instead of serialising 32 atomics on one bin
      if (__any_sync(kFull, digit >= 0)) {
        const int d0 = __shfl_sync(kFull, digit, 0);
        if (__all_sync(kFull, digit == d0)) {
          if (lane == 0) atomicAdd(&hist[d0], 32);
        } else if (digit >= 0) {
          atomicAdd(&hist[digit], 1);
        }
        matched += digit >= 0;
      }
    }
  }
  if (PASS == 2) {
    __syncthreads();
    const int n_staged = min(staged, kStaged);
    if (tid == 0 && n_staged) base = atomicAdd(&rw[kCursor], n_staged);
    __syncthreads();
    for (int i = tid; i < n_staged; i += kThreads) {
      surv[row * k + base + i] = stage[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      matched += __shfl_xor_sync(kFull, matched, off);
    }
    if (lane == 0) {
      offs[row * chunks * kWarps + blockIdx.x * kWarps + (tid >> 5)] =
          make_int2(matched, 0);
    }
  }
  if (PASS == 0) {  // fold the lane columns: bin tid, banks rotated
    __syncthreads();
    int sum = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) sum += hist[tid * 32 + ((j + lane) & 31)];
    __syncthreads();
    hist[tid] = sum;
  }
  __syncthreads();
  int* ghist = rw + kHist + PASS * kPassWords;
  constexpr int kFine = (PASS == 0 ? 256 : kBins) / kCoarse;
  for (int i = tid; i < kFine * kCoarse; i += kThreads) {
    if (hist[i]) atomicAdd(&ghist[i], hist[i]);
  }
  if (tid < kCoarse) {  // the summary; rotated so a warp spreads over banks
    int sum = 0;
#pragma unroll 8
    for (int j = 0; j < kFine; ++j) {
      sum += hist[tid * kFine + (j + tid) % kFine];
    }
    if (sum) atomicAdd(&ghist[kBins + tid], sum);
  }
}

// Ties and the last survivors above v*.  Only warps whose share holds a
// key with v*'s 20-bit prefix (pass 2 counted them) read their share again:
// they append its keys above v* and count its ties into their entry.
__global__ void __launch_bounds__(kThreads) tie_count_kernel(
    Panel p, int chunk, int chunks, int k, int* __restrict__ ws,
    int2* __restrict__ offs, unsigned long long* __restrict__ surv) {
  __shared__ int scratch[2 * kCoarse];
  const int64_t row = blockIdx.y;
  const float* r = p.row_ptr(row);
  int* rw = ws + row * kRowWords;
  const unsigned hi = kFull << 12;
  const int tid = threadIdx.x;
  unsigned vstar;
  int c_gt;
  narrow<2>(rw, k, scratch, vstar, c_gt);
  if (blockIdx.x == 0 && tid == 0) {
    rw[kPrefix + kPasses] = static_cast<int>(vstar);
    rw[kAbove + kPasses] = c_gt;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int entries = chunks * kWarps;
  int2* ro = offs + row * entries;
  const int entry = blockIdx.x * kWarps + warp;
  // v* the row's smallest key and none above it with its 20-bit prefix:
  // pass 2's count of the prefix in each share is that share's ties
  const int ties = __ldcg(&rw[kHist + 2 * kPassWords + (vstar & 0xfffu)]);
  if (c_gt == rw[kAbove + 2] && c_gt + ties == p.len) return;
  int eq = 0;
  if (ro[entry].x > 0) {
    const int share = chunk / kWarps;
    const int start = blockIdx.x * chunk + warp * share;
    const int end = min(start + share, p.len);
    for (int off = start; off < end; off += 32 * kUnroll) {
      unsigned key[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = off + u * 32 + lane;
        key[u] = p.key(r, e);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = off + u * 32 + lane;
        const bool in = e < end && (key[u] & hi) == (vstar & hi);
        append(in && key[u] > vstar, key[u], e, &rw[kCursor], surv + row * k);
        eq += in && key[u] == vstar;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      eq += __shfl_xor_sync(kFull, eq, off);
    }
  }
  if (lane == 0) ro[entry] = make_int2(eq, 0);
}

// Write each tie whose rank among the row's ties is below t = K - c_gt at
// c_gt + rank.  A block with ties sums the tie counts of the entries before
// its own ((block, warp) order is index order), so no launch is spent on a
// scan; then each warp walks its share in index order with ballots and
// stops once its ranks reach t.
__global__ void __launch_bounds__(kThreads) tie_write_kernel(
    Panel p, int chunk, int chunks, int k, const int* __restrict__ ws,
    const int2* __restrict__ offs, unsigned long long* __restrict__ surv) {
  __shared__ int warp_sum[kWarps];
  __shared__ int mine[kWarps];
  const int64_t row = blockIdx.y;
  const float* r = p.row_ptr(row);
  const int* rw = ws + row * kRowWords;
  const unsigned vstar = static_cast<unsigned>(rw[kPrefix + kPasses]);
  const int c_gt = rw[kAbove + kPasses];
  const int t = k - c_gt;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int2* ro = offs + row * chunks * kWarps;
  const int first = blockIdx.x * kWarps;
  if (tid < kWarps) mine[tid] = ro[first + tid].x;
  __syncthreads();
  int any = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) any |= mine[w];
  if (!any) return;
  int before = 0;  // ties in the entries before this block
  for (int i = tid; i < first; i += kThreads) before += ro[i].x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    before += __shfl_xor_sync(kFull, before, off);
  }
  if (lane == 0) warp_sum[warp] = before;
  __syncthreads();
  int at = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    at += warp_sum[w];
    if (w < warp) at += mine[w];
  }
  if (mine[warp] == 0 || at >= t) return;
  unsigned long long* out = surv + row * k + c_gt;
  const unsigned below = (1u << lane) - 1u;
  const int share = chunk / kWarps;
  const int start = blockIdx.x * chunk + warp * share;
  const int end = min(start + share, p.len);
  for (int off = start; off < end && at < t; off += 32 * kUnroll) {
    unsigned key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = off + u * 32 + lane;
      key[u] = p.key(r, e);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = off + u * 32 + lane;
      const bool tie = e < end && key[u] == vstar;
      const unsigned be = __ballot_sync(kFull, tie);
      const int rank = at + __popc(be & below);
      if (tie && rank < t) out[rank] = sort_key(key[u], e);
      at += __popc(be);
    }
  }
}

// Pass 0 over a panel whose rows are not contiguous, fused with a
// row-major copy of it: a block takes 32 rows by kCopyCols columns in
// 32 x 32 tiles through shared memory (read with consecutive threads on
// consecutive rows, coalesced where the panel is column-major; the next
// tile's loads are in flight while a tile is written out), writes
// each tile row-major into `out` and histograms its top 8 bits a lane a
// row (rows of the histogram padded so that lanes meet distinct banks),
// then adds the histograms and their summaries into the rows' global
// ones, as radix_pass_kernel<0> does.  Columns n..len-1 count as -inf.
constexpr int kCopyCols = 256;

__global__ void __launch_bounds__(kThreads) copy_pass0_kernel(
    Panel p, int rows, float* __restrict__ out, int* __restrict__ ws) {
  __shared__ float tile[32][33];
  __shared__ int hist[32][257];
  const int r0 = blockIdx.y * 32;
  const int c_begin = blockIdx.x * kCopyCols;
  const int c_end = min(c_begin + kCopyCols, p.len);
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 32 * 257; i += kThreads) (&hist[0][0])[i] = 0;
  // a thread's keys of the next tile: loaded while this tile is written
  float next[32 / kWarps];
  auto load = [&](int c0) {
#pragma unroll
    for (int u = 0; u < 32 / kWarps; ++u) {
      const int r = r0 + tx;
      const int c = c0 + ty + u * kWarps;
      next[u] = r < rows && c < p.n ? p.scores[r * p.s_b + c * p.s_n]
                                    : -INFINITY;
    }
  };
  load(c_begin);
  for (int c0 = c_begin; c0 < c_end; c0 += 32) {
    __syncthreads();  // the last tile's readers are done; hist is zeroed
#pragma unroll
    for (int u = 0; u < 32 / kWarps; ++u) tile[ty + u * kWarps][tx] = next[u];
    if (c0 + 32 < c_end) load(c0 + 32);
    __syncthreads();
    for (int j = ty; j < 32; j += kWarps) {
      const int r = r0 + j;
      const int c = c0 + tx;
      if (r < rows && c < p.n) {
        out[static_cast<int64_t>(r) * p.n + c] = tile[tx][j];
      }
      const int rr = r0 + tx;  // the histogram: lane = row
      const int cc = c0 + j;
      if (rr < rows && cc < c_end) {
        atomicAdd(&hist[tx][asc_key(tile[j][tx]) >> 24], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * 256; i += kThreads) {
    const int r = i >> 8;
    const int bin = i & 255;
    if (r0 + r < rows && hist[r][bin]) {
      atomicAdd(&ws[(r0 + r) * kRowWords + kHist + bin], hist[r][bin]);
    }
  }
  for (int i = threadIdx.x; i < 32 * kCoarse; i += kThreads) {
    const int r = i / kCoarse;
    const int b = i % kCoarse;
    const int sum = hist[r][4 * b] + hist[r][4 * b + 1] + hist[r][4 * b + 2] +
                    hist[r][4 * b + 3];
    if (r0 + r < rows && sum) {
      atomicAdd(&ws[(r0 + r) * kRowWords + kHist + kBins + b], sum);
    }
  }
}

// Compare-exchange of a bitonic stage: keep the smaller key where the
// pair sorts ascending at this end, else the larger.
__device__ __forceinline__ unsigned long long keep(unsigned long long a,
                                                   unsigned long long b,
                                                   bool smaller) {
  return (a < b) == smaller ? a : b;
}

// Sort one row's k survivors (ascending 64-bit keys = values descending,
// then index ascending) with a bitonic network and write values and
// indices.  Thread t holds positions [E t, E t + E) in registers: strides
// below E swap inside a thread, strides below 32 E go through warp
// shuffles, and only the longer strides pass through shared memory, one
// barrier each.
template <int E>
__global__ void __launch_bounds__(kSortThreads) sort_kernel(
    const unsigned long long* __restrict__ surv, int k, int sort_n,
    float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ unsigned long long sk[];
  const int64_t row = blockIdx.x;
  const int t = threadIdx.x;
  unsigned long long r[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = t * E + j;
    r[j] = i < k ? surv[row * k + i] : ~0ull;
  }
  for (int size = 2; size <= sort_n; size <<= 1) {
    int stride = size >> 1;
    if (stride >= 32 * E) {
#pragma unroll
      for (int j = 0; j < E; ++j) sk[t * E + j] = r[j];
      __syncthreads();
      for (; stride >= 32 * E; stride >>= 1) {
        for (int q = t; q < (sort_n >> 1); q += kSortThreads) {
          const int lo = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
          const int hi = lo + stride;
          const unsigned long long a = sk[lo];
          const unsigned long long c = sk[hi];
          const bool up = (lo & size) == 0;
          sk[lo] = keep(a, c, up);
          sk[hi] = keep(a, c, !up);
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < E; ++j) r[j] = sk[t * E + j];
      __syncthreads();
    }
    for (; stride >= E; stride >>= 1) {  // partner in lane t ^ (stride / E)
      const int m = stride / E;
      const bool lower = (t & m) == 0;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const unsigned long long o = __shfl_xor_sync(kFull, r[j], m);
        const bool up = ((t * E + j) & size) == 0;
        r[j] = keep(r[j], o, lower == up);
      }
    }
#pragma unroll
    for (int s = E / 2; s > 0; s >>= 1) {  // partner inside the thread
      if (s < size) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if ((j & s) == 0) {
            const bool up = ((t * E + j) & size) == 0;
            const unsigned long long a = r[j];
            const unsigned long long c = r[j + s];
            r[j] = keep(a, c, up);
            r[j + s] = keep(a, c, !up);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = t * E + j;
    if (i < k) {
      idx[row * k + i] = static_cast<int>(r[j] & 0xffffffffull);
      vals[row * k + i] = key_value(~static_cast<unsigned>(r[j] >> 32));
    }
  }
}

}  // namespace

// Bytes of workspace flexvec_topk needs for `rows` rows, `chunks` chunks a
// row and k survivors a row (the wrapper allocates it; 8-byte aligned).
extern "C" long long flexvec_topk_workspace(int rows, int chunks, int k) {
  return 4ll * rows * (kRowWords + 2ll * chunks * kWarps) +
         8ll * rows * k;
}

// Row-wise top-k of a (rows, n) f32 panel, n >= 1: element e of row r is
// scores[r*s_b + e*s_n] for e < n and -inf for n <= e < max(n, k).  Each
// row is cut into `chunks` chunks of `chunk` columns (a multiple of
// 1024); sort_n is a power of two >= k whose keys fit
// in shared memory.  vals (rows x k) f32, idx (rows x k) int32.  `copy`
// is null, or rows x n f32 that receives a row-major copy of the panel
// first (for a panel with s_n != 1).  Enqueues a memset and kPasses + 3
// launches (one more with `copy`) on `stream`, allocates nothing, returns
// the first CUDA error.
extern "C" int flexvec_topk(const void* scores, long long s_b, long long s_n,
                            int n, int rows, int k, int chunk, int chunks,
                            int sort_n, void* workspace, void* copy,
                            void* vals, void* idx, void* stream) {
  if (rows <= 0 || k <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(workspace);
  int2* offs = reinterpret_cast<int2*>(ws + (long long)rows * kRowWords);
  unsigned long long* surv = reinterpret_cast<unsigned long long*>(
      offs + (long long)rows * chunks * kWarps);
  cudaError_t err = cudaMemsetAsync(ws, 0, 4ll * rows * kRowWords, st);
  if (err != cudaSuccess) return err;
  Panel p{static_cast<const float*>(scores), s_b, s_n, n, n > k ? n : k};
  if (copy != nullptr) {  // pass 0 and the row-major copy in one launch
    copy_pass0_kernel<<<dim3((p.len + kCopyCols - 1) / kCopyCols,
                             (rows + 31) / 32),
                        kThreads, 0, st>>>(p, rows, static_cast<float*>(copy),
                                           ws);
    p = Panel{static_cast<const float*>(copy), n, 1, n, p.len};
  }
  const dim3 grid(chunks, rows);
  if (copy == nullptr) {
    radix_pass_kernel<0><<<grid, kThreads, 0, st>>>(p, chunk, chunks, k, ws,
                                                    offs, surv);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  radix_pass_kernel<1><<<grid, kThreads, 0, st>>>(p, chunk, chunks, k, ws,
                                                  offs, surv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  radix_pass_kernel<2><<<grid, kThreads, 0, st>>>(p, chunk, chunks, k, ws,
                                                  offs, surv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tie_count_kernel<<<grid, kThreads, 0, st>>>(p, chunk, chunks, k, ws, offs,
                                              surv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tie_write_kernel<<<grid, kThreads, 0, st>>>(p, chunk, chunks, k, ws, offs,
                                              surv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // E keys a thread: 2 up to 2048 keys, then sort_n / 1024
  auto sort = sort_n <= 2048 ? sort_kernel<2>
              : sort_n == 4096 ? sort_kernel<4> : sort_kernel<8>;
  const int e = sort_n <= 2048 ? 2 : sort_n / kSortThreads;
  if (sort_n > e * kSortThreads) return cudaErrorInvalidValue;
  if (e > 2) {  // above the 48 KB a launch gets without asking
    err = cudaFuncSetAttribute(
        sort, cudaFuncAttributeMaxDynamicSharedMemorySize, 8 * e * kSortThreads);
    if (err != cudaSuccess) return err;
  }
  sort<<<rows, kSortThreads, 8 * e * kSortThreads, st>>>(
      surv, k, sort_n, static_cast<float*>(vals), static_cast<int*>(idx));
  return cudaGetLastError();
}
