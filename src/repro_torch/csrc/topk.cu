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
// What bounds it on the H100: reading the (B, N) score panel once (32 x
// 240k f32 is 31 MB, 9.3 us at 3.35 TB/s); the sorting work comes on top.
// The design is a tile reduction: each block takes one tile of one row,
// packs every element into a 64-bit key (order-flipped value bits above,
// index below), sorts the tile in shared memory with a bitonic network and
// keeps its first K keys.  A tile holds at least 2K keys, so each pass
// shrinks a row at least twofold; the wrapper runs passes over the
// survivors until one tile remains, and that last pass writes values and
// indices.  A single row (B = 1, the direct SQL path) therefore spreads
// over N / tile blocks along N.  Because the index sits in the low bits,
// equal values sort by index and the tie rule holds by construction.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned long long kEmpty = ~0ull;  // sorts after every real key

__device__ __forceinline__ unsigned long long make_key(float v, int idx) {
  // IEEE total order, as XLA's top_k compares: -0.0 ranks below +0.0
  const unsigned int u = __float_as_uint(v);
  const unsigned int asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(~asc) << 32) |
         static_cast<unsigned int>(idx);
}

__global__ void __launch_bounds__(kThreads) topk_tile_kernel(
    const float* __restrict__ scores, int64_t s_b, int64_t s_n, int n,
    const unsigned long long* __restrict__ keys_in, int64_t in_stride,
    int len, int tile, int sort_n, int k,
    unsigned long long* __restrict__ keys_out, int64_t out_stride,
    float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ unsigned long long sk[];
  const int64_t row = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * tile;

  for (int i = threadIdx.x; i < sort_n; i += kThreads) {
    const int64_t e = base + i;
    unsigned long long key = kEmpty;
    if (i < tile && e < len) {
      if (keys_in != nullptr) {
        key = keys_in[row * in_stride + e];
      } else {
        const float v = e < n ? scores[row * s_b + e * s_n] : -INFINITY;
        key = make_key(v, static_cast<int>(e));
      }
    }
    sk[i] = key;
  }
  __syncthreads();

  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < (sort_n >> 1); p += kThreads) {
        const int lo = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = sk[lo];
        const unsigned long long c = sk[hi];
        const bool ascending = (lo & size) == 0;
        if ((a > c) == ascending) {
          sk[lo] = c;
          sk[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < k; i += kThreads) {
    const unsigned long long key = sk[i];
    if (keys_out != nullptr) {
      keys_out[row * out_stride + base / tile * k + i] = key;
    } else {
      const int j = static_cast<int>(key & 0xffffffffull);
      idx[row * k + i] = j;
      vals[row * k + i] =
          j < n ? scores[row * s_b + (int64_t)j * s_n] : -INFINITY;
    }
  }
}

}  // namespace

// One pass over `rows` rows.  The pass input is either the score panel
// itself (keys_in null: element e of row r is scores[r*s_b + e*s_n], for e
// < n, and -inf for n <= e < len) or the keys a previous pass kept
// (keys_in[r*in_stride + e], e < len).  Each tile of `tile` elements is
// sorted as `sort_n` keys (a power of two, >= min(tile, len)) in dynamic
// shared memory.  With keys_out set, tile t writes its first k keys to
// keys_out[r*out_stride + t*k ...]; with keys_out null there must be one
// tile, and it writes vals/idx (rows x k).  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int flexvec_topk_pass(const void* scores, long long s_b,
                                 long long s_n, int n, const void* keys_in,
                                 long long in_stride, int len, int tile,
                                 int sort_n, int k, int rows, void* keys_out,
                                 long long out_stride, void* vals, void* idx,
                                 void* stream) {
  if (rows <= 0 || len <= 0) return 0;
  const int smem = sort_n * static_cast<int>(sizeof(unsigned long long));
  cudaError_t err = cudaFuncSetAttribute(
      topk_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((len + tile - 1) / tile, rows);
  topk_tile_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), s_b, s_n, n,
      static_cast<const unsigned long long*>(keys_in), in_stride, len, tile,
      sort_n, k, static_cast<unsigned long long*>(keys_out), out_stride,
      static_cast<float*>(vals), static_cast<int*>(idx));
  return cudaGetLastError();
}
