// Fused verify + ECMP-bitmap epilogue of the fleet product, for sm_90a.
//
// Replaces the Pallas kernel openr_tpu/ops/pallas_kernels.py
// fused_epilogue_pallas (kernel body _epilogue_kernel).  For every node v,
// column p and relax group g, with u = idx[g, v]:
//
//   cand = d[u, p] + w[g, v]  if w < WBIG, (ov[g, v] == 0 or d[u, p] == 0)
//                             and d[u, p] < INF;  INF otherwise
//   bit slot[g, v] of word slot / 32 is set where d[v, p] < INF and
//   cand == d[v, p]; vmin = min(d[v, p], every cand); the verdict is
//   all(vmin == d).
//
// Two variants, one template on the element type of d:
// - int32: d in [0, INF], w >= 0 (INF = 2^30, WBIG = 2^28, so
//   du + w < 2^31);
// - uint16, the reference's uint16 distance mode (fused_epilogue_pallas
//   with d.dtype == uint16): d in [0, INF16], INF16 = 40000,
//   WBIG16 = 20000, so du + w < 2^16 as in the reference's uint16 sums.
//   Its verdict also holds the saturation guard of
//   ops/sssp.py u16_saturation_verdict: no finite d in [WBIG16, INF16).
// Both read the same [G, N] int32 tables (weights clamped to the
// variant's WBIG by the caller) and write [N, P, W] words of int32 bit
// patterns; every sum is taken in int32 registers.
//
// Bound on the H100: each input read once and each output written once is
// N*P*4 (uint16: N*P*2) bytes of d, N*P*W*4 bytes of bitmap and 16*G*N
// bytes of tables, 0.25 ms (uint16: 0.18 ms) at N = 100k, P = 1024, W = 1,
// G = 8 and 3.35 TB/s.  Per element
// and active group the inner loop is four integer operations (add, min,
// compare with d, predicated or), 0.2 ms at the card's int32 rate.  On top
// of the compulsory bytes come the gathered rows d[u, :] of the groups
// outside the halo (1.6 GB at that shape), which this design serves from
// L2.
//
// Design:
// - The columns are cut into slabs of `slab` columns, sized by the caller
//   so that N * slab * sizeof(element) bytes fill at most half the L2
//   cache.  Work items (node tile, slab) run slab-major: node tiles
//   fastest, slabs slowest,
//   so the blocks in flight share one slab and the residual (chord)
//   gathers hit in L2.  The grid is persistent: as many blocks as fit on
//   the SMs at once, each walking the items with a stride of the grid.
// - A first kernel derives each (node, group) table entry once per
//   launch into a scratch buffer: the window row or gather row, the
//   weight, the ECMP bit and its word, and the overloaded flag; an empty
//   slot (w >= WBIG) becomes a neutral read of the node's own row.
// - An item is `tile` nodes of one slab.  Its block copies the tile's
//   entries and the window of rows [v0 - halo, v0 + tile + halo) of the
//   slab, wrapping mod N, into shared memory with 16-byte cp.async, in two
//   stages: the next item's copies are in flight while this one computes.
//   Every gather row that falls in the window (the band groups of offset
//   c with c <= halo or N - c <= halo) and the node's own row are read
//   from there; other gathers go to global memory, which means L2.  The
//   branches on an entry are uniform across the threads of a node.
// - Each thread owns kCols = 8 consecutive columns of a node row: 16-byte
//   loads of d and of the gathered segments (two for int32, one for
//   uint16) and int4 streaming stores of the bitmap when P % 8 == 0 (a
//   scalar path masks the ragged edge otherwise; cp.async has no 2-byte
//   copy, so the ragged uint16 window is staged by plain loads).  The
//   groups run in unrolled chunks of kChunk whose loads are issued before
//   any is used.
// - Per element and group the loop keeps x = du + w - d (one three-input
//   add), its running minimum (the verdict holds where that stays 0), and
//   the bit where x == 0 (a compare and a predicated or).  The INF clamp
//   folds away on the domain: with w < WBIG, du = INF gives cand >= INF,
//   which never lowers min(d, cand) since d <= INF, and equals d only for
//   d = INF, whose bits are cleared once per element at the end.
// - Bitmap stores are streaming (st.global.cs), so the bitmap does not
//   push the slab out of L2.
// - The verdict is a block-wide AND followed by one atomicAnd into a device
//   int; no [N, P] vmin is written.  Nothing is padded.
//
// Measured on the H100 (PERF.md, Findings): the slab-strided stream of d
// and the bitmap, the group work and the chord gathers from L2 add up
// rather than overlap.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

// the distance domain of each element type
template <typename T>
struct Domain;
template <>
struct Domain<int> {
  static constexpr int kInf = 1 << 30;
  static constexpr int kWbig = 1 << 28;
};
template <>
struct Domain<unsigned short> {
  static constexpr int kInf = 40000;
  static constexpr int kWbig = 20000;
};

constexpr int kThreads = 256;
constexpr int kChunk = 2;  // groups whose gathers are in flight together
constexpr int kCols = 8;   // columns of one node row per thread
constexpr int kMaxWords = 8;
constexpr int kMaxSmem = 232448;
constexpr int kMinBlocks = 3;  // blocks per SM the registers must allow

enum : int { kWindow = 1, kGlobal = 2 };

// One relax group of one node, derived once per launch from the tables.
// An empty slot (w >= WBIG) becomes a neutral entry: the node's own
// window row with weight 1 and no bit, whose candidate d + 1 neither
// lowers the minimum nor equals d.
struct __align__(16) Entry {
  int src;       // window row (kWindow) or gather row u (kGlobal)
  int w;         // clamped weight, < WBIG
  unsigned bit;  // 1 << (slot % 32); 0 when slot < 0
  int meta;      // kind | overloaded << 2 | word << 3
};

struct Args {
  const void* d;
  const int* idx;
  const int* w;
  const int* ov;
  const int* slot;
  int n, p, g, slab, tile, halo;
  int wbig;  // the variant's WBIG: a weight at or above it masks the slot
  int* bitmap;
  int* verdict;
  Entry* entries;  // [n_tiles, gpad, tile]
};

__host__ __device__ inline int padded_groups(int g) {
  return (g + kChunk - 1) / kChunk * kChunk;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every group of copies but the most recent one.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// kCols consecutive elements of src widened to int: 16-byte loads when
// kVec (16-byte aligned; through the read-only path from global memory),
// else scalar loads of the first `left`, the rest 0
template <typename T, bool kVec, bool kShared = false>
__device__ __forceinline__ void load_cols(int (&out)[kCols], const T* src,
                                          int left) {
  if (kVec) {
    constexpr int kPer = 16 / sizeof(T);  // elements of one 16-byte load
#pragma unroll
    for (int m = 0; m < kCols / kPer; ++m) {
      const int4* at = reinterpret_cast<const int4*>(src + kPer * m);
      const int4 v = kShared ? *at : __ldg(at);
      const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 4) {
          out[4 * m + i] = words[i];
        } else {
          // little endian: the lower half is the earlier column
          out[8 * m + 2 * i] = words[i] & 0xFFFF;
          out[8 * m + 2 * i + 1] = (int)((unsigned)words[i] >> 16);
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) out[k] = k < left ? (int)__ldg(src + k) : 0;
  }
}

// words[word] |= bit where x == 0: for one word a compare and a
// predicated or
template <int W>
__device__ __forceinline__ void set_bit_if_zero(unsigned (&words)[W], int x,
                                                int word, unsigned bit) {
  if (W == 1) {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, 0;\n\t"
        "@p or.b32 %0, %0, %2;\n\t}"
        : "+r"(words[0])
        : "r"(x), "r"(bit));
  } else if (x == 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i == word) words[i] |= bit;
    }
  }
}

// The derived table entries of every node tile, once per launch: entry
// (tile, g, t) describes group g of node tile * T + t for a block whose
// window starts at row tile * T - halo.
__global__ void __launch_bounds__(kThreads) epilogue_entries_kernel(Args a) {
  const int gpad = padded_groups(a.g);
  const int n_tiles = (a.n + a.tile - 1) / a.tile;
  const int64_t total = (int64_t)n_tiles * gpad * a.tile;
  const int rows = a.tile + 2 * a.halo;
  for (int64_t e = blockIdx.x * (int64_t)kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int t = (int)(e % a.tile);
    const int gi = (int)(e / a.tile % gpad);
    const int v0 = (int)(e / ((int64_t)gpad * a.tile)) * a.tile;
    const int v = v0 + t;
    Entry en = {t + a.halo, 1, 0u, kWindow};
    if (gi < a.g && v < a.n) {
      const int64_t o = (int64_t)gi * a.n + v;
      const int wg = a.w[o];
      if (wg < a.wbig) {
        const int u = a.idx[o];
        const int sg = a.slot[o];
        const int r = (int)(((int64_t)u - v0 + a.halo) % a.n + a.n) % a.n;
        const bool in_win = r < rows;
        en.src = in_win ? r : u;
        en.w = wg;
        en.bit = sg >= 0 ? 1u << (sg & 31) : 0u;
        en.meta = (in_win ? kWindow : kGlobal) | (a.ov[o] != 0) << 2 |
                  (sg >= 0 ? sg >> 5 : 0) << 3;
      }
    }
    a.entries[e] = en;
  }
}

// Issue the copies of one work item (node tile `ti`, slab `c0`) into one
// stage: the tile's [gpad, tile] entries and the [rows, slab] window, in
// 16-byte chunks of kPer elements (chunks per row: 1 << chunk_shift).
template <typename T, bool kVec>
__device__ __forceinline__ void stage_item(const Args& a, Entry* tab,
                                           T* win, int ti, int c0,
                                           int gpad, int chunk_shift) {
  constexpr int kPer = 16 / sizeof(T);
  const int n = a.n, p = a.p, tile = a.tile, slab = a.slab;
  const int rows = tile + 2 * a.halo;
  const int chunks = slab / kPer;
  const int v0 = ti * tile;
  const int row0 = v0 >= a.halo ? v0 - a.halo : ((v0 - a.halo) % n + n) % n;
  const T* d = static_cast<const T*>(a.d);
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int j = e >> chunk_shift;
    const int q = e & (chunks - 1);
    const int col = c0 + kPer * q;
    if (col >= p) continue;
    // row (v0 - halo + j) mod n; a second wrap only when rows > n
    int row = row0 + j;
    if (row >= n) row -= n;
    if (row >= n) row %= n;
    const T* src = d + (int64_t)row * p + col;
    T* dst = win + j * slab + kPer * q;
    if (kVec) {
      cp_async16(dst, src);
    } else {
      for (int k = 0; k < kPer && col + k < p; ++k) {
        if constexpr (sizeof(T) == 4) {
          cp_async4(dst + k, src + k);
        } else {
          dst[k] = __ldg(src + k);
        }
      }
    }
  }
  const Entry* src = a.entries + (int64_t)ti * gpad * tile;
  for (int e = threadIdx.x; e < gpad * tile; e += kThreads) {
    cp_async16(tab + e, src + e);
  }
}

template <typename T, int W, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_epilogue_kernel(Args a) {
  constexpr int kInf = Domain<T>::kInf;
  constexpr int kWbig = Domain<T>::kWbig;
  extern __shared__ int4 smem[];
  const int n = a.n, p = a.p, slab = a.slab, tile = a.tile, halo = a.halo;
  const T* d = static_cast<const T*>(a.d);
  const int gpad = padded_groups(a.g);
  const int rows = tile + 2 * halo;
  const int n_tiles = (n + tile - 1) / tile;
  const int n_items = n_tiles * ((p + slab - 1) / slab);
  // two stages, each [gpad, tile] entries then the [rows, slab] window
  const int stage_bytes =
      gpad * tile * (int)sizeof(Entry) + rows * slab * (int)sizeof(T);
  char* stage0 = reinterpret_cast<char*>(smem);
  const int chunk_shift = __ffs(slab / (16 / (int)sizeof(T))) - 1;
  const int lanes = slab / kCols;  // threads per node row
  const int lane_shift = __ffs(lanes) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);

  // items run slab-major: the blocks in flight share one slab
  int item = blockIdx.x;
  if (item < n_items) {
    stage_item<T, kVec>(a, reinterpret_cast<Entry*>(stage0),
                        reinterpret_cast<T*>(stage0 + gpad * tile * sizeof(Entry)),
                        item % n_tiles, item / n_tiles * slab, gpad, chunk_shift);
  }
  cp_async_commit();
  bool ok = true;
  for (int s = 0; item < n_items; item += gridDim.x, s ^= 1) {
    const int v0 = item % n_tiles * tile;
    const int c0 = item / n_tiles * slab;
    const Entry* tab = reinterpret_cast<const Entry*>(stage0 + s * stage_bytes);
    const T* win = reinterpret_cast<const T*>(tab + gpad * tile);
    const int next = item + gridDim.x;
    if (next < n_items) {
      char* nst = stage0 + (s ^ 1) * stage_bytes;
      stage_item<T, kVec>(a, reinterpret_cast<Entry*>(nst),
                          reinterpret_cast<T*>(nst + gpad * tile * sizeof(Entry)),
                          next % n_tiles, next / n_tiles * slab, gpad, chunk_shift);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const int col = c0 + kCols * lane;
    const int left = p - col;
    for (int t = tid >> lane_shift; col < p && t < tile && v0 + t < n;
         t += kThreads / lanes) {
      const int v = v0 + t;
      int dv[kCols];
      load_cols<T, true, true>(dv, win + (t + halo) * slab + kCols * lane, kCols);
      // min over groups of cand - d: the verdict holds where it stays 0
      int low[kCols];
      unsigned words[kCols][W];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        low[k] = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) words[k][i] = 0u;
      }
      for (int gb = 0; gb < gpad; gb += kChunk) {
        Entry en[kChunk];
        int du[kChunk][kCols];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          en[j] = tab[(gb + j) * tile + t];
          if (en[j].meta & kWindow) {
            load_cols<T, true, true>(du[j], win + en[j].src * slab + kCols * lane, kCols);
          } else {
            load_cols<T, kVec>(du[j], d + (int64_t)en[j].src * p + col, left);
          }
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int wg = en[j].w;
          const unsigned bit = en[j].bit;
          const int word = en[j].meta >> 3;
          if (en[j].meta & 4) {
            // overloaded predecessor: only a source (du == 0) relaxes
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
              if (du[j][k] == 0) {
                const int x = wg - dv[k];
                low[k] = min(low[k], x);
                set_bit_if_zero<W>(words[k], x, word, bit);
              }
            }
          } else {
            // per element: add, min, compare and a predicated or
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
              const int x = du[j][k] + wg - dv[k];
              low[k] = min(low[k], x);
              set_bit_if_zero<W>(words[k], x, word, bit);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (dv[k] >= kInf) {
#pragma unroll
          for (int i = 0; i < W; ++i) words[k][i] = 0u;
        }
        if (kVec || k < left) {
          ok = ok && low[k] == 0;
          // uint16: a finite distance in [WBIG16, INF16) means saturation
          if constexpr (sizeof(T) == 2) {
            ok = ok && (dv[k] < kWbig || dv[k] >= kInf);
          }
        }
      }
      int* out = a.bitmap + ((int64_t)v * p + col) * W;
      if (kVec) {
        int flat[kCols * W];
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
#pragma unroll
          for (int i = 0; i < W; ++i) flat[k * W + i] = (int)words[k][i];
        }
#pragma unroll
        for (int m = 0; m < kCols * W / 4; ++m) {
          __stcs(reinterpret_cast<int4*>(out) + m,
                 make_int4(flat[4 * m], flat[4 * m + 1], flat[4 * m + 2],
                           flat[4 * m + 3]));
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          if (k < left) {
#pragma unroll
            for (int i = 0; i < W; ++i) __stcs(out + k * W + i, (int)words[k][i]);
          }
        }
      }
    }
    // the next iteration's copies overwrite this stage
    __syncthreads();
  }
  if (!__syncthreads_and(ok) && tid == 0) atomicAnd(a.verdict, 0);
}

template <typename T>
size_t smem_bytes(const Args& a) {
  const size_t stage = (size_t)padded_groups(a.g) * a.tile * sizeof(Entry) +
                       (size_t)(a.tile + 2 * a.halo) * a.slab * sizeof(T);
  return 2 * stage;
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  return (int)e;
}

template <typename T, int W, bool kVec>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = fused_epilogue_kernel<T, W, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  if ((e = (cudaError_t)sm_count(&sms)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return (int)e;
  }
  const long long n_tiles = (a.n + a.tile - 1) / a.tile;
  const long long items = n_tiles * ((a.p + a.slab - 1) / a.slab);
  const long long entries = n_tiles * padded_groups(a.g) * a.tile;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  if (entries > 0) {
    const long long blocks = (entries + kThreads - 1) / kThreads;
    epilogue_entries_kernel<<<(int)(blocks < 8L * sms ? blocks : 8L * sms),
                              kThreads, 0, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const long long slots = (long long)sms * per_sm;
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid > 0 ? grid : 1, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int dispatch(int n_words, bool vec, const Args& a, cudaStream_t stream) {
  if constexpr (W > kMaxWords) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n_words != W) return dispatch<T, W + 1>(n_words, vec, a, stream);
    return vec ? launch<T, W, true>(a, stream) : launch<T, W, false>(a, stream);
  }
}

}  // namespace

// Bytes of the scratch buffer that fused_epilogue_launch needs for the
// derived table entries of n nodes, g groups and node tile `tile`.
extern "C" long long fused_epilogue_scratch_bytes(int n, int g, int tile) {
  if (n <= 0 || tile <= 0) return 0;
  return (long long)((n + tile - 1) / tile) * padded_groups(g) * tile *
         (long long)sizeof(Entry);
}

// d [n, p] of `elem_bytes` 4 (int32) or 2 (uint16), idx/w/ov/slot [g, n]
// int32 and bitmap [n, p, n_words] int32 on the device, all contiguous,
// with idx in [0, n) and slot < 32 * n_words; *verdict must hold 1 and is
// cleared to 0 when some element is not at its fixed point (uint16: or
// saturated); `scratch` holds fused_epilogue_scratch_bytes(n, g, tile)
// bytes, 16-byte aligned.  `slab` (a power of two from 8 to 2048), `tile`
// (a power of two) and `halo` come from the caller's plan.
// Launches the entries kernel, then the epilogue.  Returns a cudaError_t
// code.
extern "C" int fused_epilogue_launch(const void* d, const void* idx,
                                     const void* w, const void* ov,
                                     const void* slot, int n, int p, int g,
                                     int n_words, int slab, int tile,
                                     int halo, int elem_bytes, void* bitmap,
                                     void* verdict, void* scratch,
                                     void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaSuccess;
  if (slab < kCols || slab > kCols * kThreads ||
      (slab & (slab - 1)) != 0 || tile < 1 || (tile & (tile - 1)) != 0 ||
      halo < 0 || g < 0 || (uintptr_t)scratch % 16 != 0 ||
      (elem_bytes != 4 && elem_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool small = elem_bytes == 2;
  const Args a = {d,
                  (const int*)idx,
                  (const int*)w,
                  (const int*)ov,
                  (const int*)slot,
                  n,
                  p,
                  g,
                  slab,
                  tile,
                  halo,
                  small ? Domain<unsigned short>::kWbig : Domain<int>::kWbig,
                  (int*)bitmap,
                  (int*)verdict,
                  (Entry*)scratch};
  const bool vec = p % kCols == 0 && (uintptr_t)d % 16 == 0 &&
                   (uintptr_t)bitmap % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return small ? dispatch<unsigned short, 1>(n_words, vec, a, s)
               : dispatch<int, 1>(n_words, vec, a, s);
}

// The L2 cache size of a device in bytes, or -1 with the error left set.
extern "C" long long fused_epilogue_l2_bytes(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrL2CacheSize, device) !=
      cudaSuccess) {
    return -1;
  }
  return bytes;
}

extern "C" const char* fused_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
