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
// Two variants, by the element type of d, each a kernel of its own:
// - int32: d in [0, INF], w >= 0 (INF = 2^30, WBIG = 2^28, so
//   du + w < 2^31);
// - uint16, the reference's uint16 distance mode (fused_epilogue_pallas
//   with d.dtype == uint16): d in [0, INF16], INF16 = 40000,
//   WBIG16 = 20000, so du + w <= 59999 < 2^16 as in the reference's
//   uint16 sums.  Its verdict also holds the saturation guard of
//   ops/sssp.py u16_saturation_verdict: no finite d in [WBIG16, INF16).
// Both read the same [G, N] int32 tables (weights clamped to the
// variant's WBIG by the caller) and write [N, P, W] words of int32 bit
// patterns.
//
// Bound on the H100: each input read once and each output written once is
// N*P*4 (uint16: N*P*2) bytes of d, N*P*W*4 bytes of bitmap and 16*G*N
// bytes of tables, 0.25 ms (uint16: 0.187 ms) at N = 100k, P = 1024,
// W = 1, G = 8 and 3.35 TB/s.  On top of the compulsory bytes come the
// gathered rows d[u, :] of the residual (chord) groups, which both
// designs serve from L2.
//
// int32 design (tiled), per element and active group four integer
// operations (add, min, compare with d, predicated or), 0.2 ms at the
// card's int32 rate:
// - The columns are cut into slabs of `slab` columns, sized by the caller
//   so that N * slab * 4 bytes fill at most half the L2 cache.  Work
//   items (node tile, slab) run slab-major: node tiles fastest, slabs
//   slowest, so the blocks in flight share one slab and the residual
//   (chord) gathers hit in L2.  The grid is persistent: as many blocks as
//   fit on the SMs at once, each walking the items with a stride of the
//   grid.
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
// - Each thread owns kCols = 8 consecutive columns of a node row: two
//   16-byte loads of d and of the gathered segments and int4 streaming
//   stores of the bitmap when P % 8 == 0 (a scalar path masks the ragged
//   edge otherwise).  The groups run in unrolled chunks of kChunk whose
//   loads are issued before any is used.
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
// Measured on the H100 (PERF.md, Findings): the slab-strided stream of d
// and the bitmap, the group work and the chord gathers add up rather than
// overlap.
//
// uint16 design (packed), two paths by the caller's plan:
// - A 32-bit register holds two adjacent columns throughout: the node's
//   row d2, each gathered row du2 and the running minimum low2.  The
//   candidate of both columns is one 32-bit add du2 + w * 0x00010001 (an
//   IMAD), carry-free on the domain (du <= INF16, w < WBIG16).  Hopper's
//   packed 16-bit min with per-half predicates (__vibmin_u16x2, one
//   VIMNMX.U16x2) keeps low2 = min(low2, cand2) and tells per column
//   whether cand <= low; the column's bit is or-ed in under that
//   predicate.  Per column pair and active group: four instructions.
// - The predicate is cand <= low, which is cand == d wherever the column
//   is at its fixed point (low stays d, every cand >= d).  A pair whose
//   minimum fell below d fails the verdict, and its bits are computed
//   again, exactly, group by group (a product that is not at its fixed
//   point, never the main path's).
// - A du of INF16 folds away as in int32 (cand >= INF16 >= d, and equals
//   d only for d = INF16, whose bits are cleared).  Overloaded
//   predecessors (only du == 0 relaxes) build cand2 per half; empty slots
//   are skipped.
// - One block per item (node tile, slab), items slab-major so the blocks
//   in flight share one slab.  No entries kernel and no window: the block
//   reads its tile's [G, tile] table entries straight from the four
//   [G, N] tables (coalesced along N) into 8-byte entries in shared
//   memory while its first rows of d are in flight; every gathered
//   segment d[u, cols] (the bands' neighbours from L1, the chords' rows
//   from L2) goes straight into registers, four groups' loads issued
//   before any is used, and the next row's d is loaded while this row's
//   bitmap is stored.  Latency is hidden by resident warps (4 blocks of
//   8 warps per SM at W = 1).
// - Each thread owns 8 columns (4 pairs, one 16-byte load per row) of a
//   node row.  Wide path (P > 64): slabs of `slab` columns (N * slab * 2
//   bytes at most half the L2), four passes of the block's threads per
//   tile.  Narrow path (P <= 64): one slab covering P, P / 8 threads
//   (rounded up to a power of two) per row, one pass; at P <= 64 the
//   whole product is at most 12.8 MB at N = 100k, inside the L2.
// - A ragged P (P % 8 != 0) loads 2-byte columns into registers, masked
//   at the edge, and stores the bitmap word by word; nothing is staged.
// - Bitmap stores are streaming; the verdict is one block-wide AND and
//   one atomicAnd per block that fails.
// Measured on the H100 (PERF.md, Findings): the stream of d and the
// bitmap alone runs at 82 % of the byte rate, and the group work and
// the chord gathers add to it rather than hide under it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;
constexpr int kMaxSmem = 232448;

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

int sm_count(int* sms) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  return (int)e;
}

// ---------------------------------------------------------------------------
// int32: the tiled design
// ---------------------------------------------------------------------------
namespace i32 {

constexpr int kInf = 1 << 30;
constexpr int kWbig = 1 << 28;
constexpr int kChunk = 2;  // groups whose gathers are in flight together
constexpr int kCols = 8;   // columns of one node row per thread
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
  const int* d;
  const int* idx;
  const int* w;
  const int* ov;
  const int* slot;
  int n, p, g, slab, tile, halo;
  int* bitmap;
  int* verdict;
  Entry* entries;  // [n_tiles, gpad, tile]
};

__host__ __device__ inline int padded_groups(int g) {
  return (g + kChunk - 1) / kChunk * kChunk;
}

// kCols consecutive elements of src: 16-byte loads when kVec (16-byte
// aligned; through the read-only path from global memory), else scalar
// loads of the first `left`, the rest 0
template <bool kVec, bool kShared = false>
__device__ __forceinline__ void load_cols(int (&out)[kCols], const int* src,
                                          int left) {
  if (kVec) {
#pragma unroll
    for (int m = 0; m < kCols / 4; ++m) {
      const int4* at = reinterpret_cast<const int4*>(src + 4 * m);
      const int4 v = kShared ? *at : __ldg(at);
      out[4 * m] = v.x;
      out[4 * m + 1] = v.y;
      out[4 * m + 2] = v.z;
      out[4 * m + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) out[k] = k < left ? __ldg(src + k) : 0;
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
      if (wg < kWbig) {
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
// 16-byte chunks of 4 elements (chunks per row: 1 << chunk_shift).
template <bool kVec>
__device__ __forceinline__ void stage_item(const Args& a, Entry* tab,
                                           int* win, int ti, int c0,
                                           int gpad, int chunk_shift) {
  const int n = a.n, p = a.p, tile = a.tile, slab = a.slab;
  const int rows = tile + 2 * a.halo;
  const int chunks = slab / 4;
  const int v0 = ti * tile;
  const int row0 = v0 >= a.halo ? v0 - a.halo : ((v0 - a.halo) % n + n) % n;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int j = e >> chunk_shift;
    const int q = e & (chunks - 1);
    const int col = c0 + 4 * q;
    if (col >= p) continue;
    // row (v0 - halo + j) mod n; a second wrap only when rows > n
    int row = row0 + j;
    if (row >= n) row -= n;
    if (row >= n) row %= n;
    const int* src = a.d + (int64_t)row * p + col;
    int* dst = win + j * slab + 4 * q;
    if (kVec) {
      cp_async16(dst, src);
    } else {
      for (int k = 0; k < 4 && col + k < p; ++k) cp_async4(dst + k, src + k);
    }
  }
  const Entry* src = a.entries + (int64_t)ti * gpad * tile;
  for (int e = threadIdx.x; e < gpad * tile; e += kThreads) {
    cp_async16(tab + e, src + e);
  }
}

template <int W, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_epilogue_kernel(Args a) {
  extern __shared__ int4 smem[];
  const int n = a.n, p = a.p, slab = a.slab, tile = a.tile, halo = a.halo;
  const int gpad = padded_groups(a.g);
  const int rows = tile + 2 * halo;
  const int n_tiles = (n + tile - 1) / tile;
  const int n_items = n_tiles * ((p + slab - 1) / slab);
  // two stages, each [gpad, tile] entries then the [rows, slab] window
  const int stage_bytes =
      gpad * tile * (int)sizeof(Entry) + rows * slab * (int)sizeof(int);
  char* stage0 = reinterpret_cast<char*>(smem);
  const int chunk_shift = __ffs(slab / 4) - 1;
  const int lanes = slab / kCols;  // threads per node row
  const int lane_shift = __ffs(lanes) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);

  // items run slab-major: the blocks in flight share one slab
  int item = blockIdx.x;
  if (item < n_items) {
    stage_item<kVec>(a, reinterpret_cast<Entry*>(stage0),
                     reinterpret_cast<int*>(stage0 + gpad * tile * sizeof(Entry)),
                     item % n_tiles, item / n_tiles * slab, gpad, chunk_shift);
  }
  cp_async_commit();
  bool ok = true;
  for (int s = 0; item < n_items; item += gridDim.x, s ^= 1) {
    const int v0 = item % n_tiles * tile;
    const int c0 = item / n_tiles * slab;
    const Entry* tab = reinterpret_cast<const Entry*>(stage0 + s * stage_bytes);
    const int* win = reinterpret_cast<const int*>(tab + gpad * tile);
    const int next = item + gridDim.x;
    if (next < n_items) {
      char* nst = stage0 + (s ^ 1) * stage_bytes;
      stage_item<kVec>(a, reinterpret_cast<Entry*>(nst),
                       reinterpret_cast<int*>(nst + gpad * tile * sizeof(Entry)),
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
      load_cols<true, true>(dv, win + (t + halo) * slab + kCols * lane, kCols);
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
            load_cols<true, true>(du[j], win + en[j].src * slab + kCols * lane, kCols);
          } else {
            load_cols<kVec>(du[j], a.d + (int64_t)en[j].src * p + col, left);
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
        if (kVec || k < left) ok = ok && low[k] == 0;
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

size_t smem_bytes(const Args& a) {
  const size_t stage = (size_t)padded_groups(a.g) * a.tile * sizeof(Entry) +
                       (size_t)(a.tile + 2 * a.halo) * a.slab * sizeof(int);
  return 2 * stage;
}

template <int W, bool kVec>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = fused_epilogue_kernel<W, kVec>;
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

template <int W>
int dispatch(int n_words, bool vec, const Args& a, cudaStream_t stream) {
  if constexpr (W > kMaxWords) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n_words != W) return dispatch<W + 1>(n_words, vec, a, stream);
    return vec ? launch<W, true>(a, stream) : launch<W, false>(a, stream);
  }
}

}  // namespace i32

// ---------------------------------------------------------------------------
// uint16: the packed design
// ---------------------------------------------------------------------------
namespace u16 {

constexpr unsigned kInf = 40000;  // INF16
constexpr int kWbig = 20000;      // WBIG16
constexpr int kCols = 8;          // columns of one node row per thread
constexpr int kPairs = kCols / 2;
static_assert(kCols == 8, "a row segment is one 16-byte load");
constexpr int kChunk = 4;         // groups whose gathers are in flight together

struct Args {
  const unsigned short* d;
  const int* idx;
  const int* w;
  const int* ov;
  const int* slot;
  int n, p, g, slab, tile;
  int* bitmap;
  int* verdict;
};

// One (node, group) table entry as the block stages it in shared memory:
// the gather row and meta = w | overloaded << 15 | (slot + 1) << 16, the
// weight clamped to WBIG16 (an empty slot)
struct __align__(8) Entry {
  int u;
  unsigned meta;
};

// kCols consecutive columns from src as kPairs packed pairs (the lower
// half the earlier column): 16-byte loads through the read-only path when
// kVec, else 2-byte loads of the first `left` columns, the rest 0
template <bool kVec>
__device__ __forceinline__ void load_pairs(unsigned (&out)[kPairs],
                                           const unsigned short* src,
                                           int left) {
  if constexpr (kVec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const unsigned lo = 2 * j < left ? (unsigned)__ldg(src + 2 * j) : 0u;
      const unsigned hi = 2 * j + 1 < left ? (unsigned)__ldg(src + 2 * j + 1) : 0u;
      out[j] = lo | hi << 16;
    }
  }
}

template <int W>
__device__ __forceinline__ void set_bit(unsigned (&words)[W], bool on,
                                        int word, unsigned bit) {
  if (W == 1) {
    // a predicated or (the compiler's own choice is a select and an or)
    asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\t"
        "@p or.b32 %0, %0, %2;\n\t}"
        : "+r"(words[0])
        : "r"((unsigned)on), "r"(bit));
  } else if (on) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i == word) words[i] |= bit;
    }
  }
}

// low2 = min(low2, cand2) per half, and the bit of each column where
// cand <= low: one packed min with predicates and two predicated ors
template <int W>
__device__ __forceinline__ void relax_pair(unsigned cand, unsigned& low,
                                           unsigned (&lo_words)[W],
                                           unsigned (&hi_words)[W], int word,
                                           unsigned bit) {
  bool hi, lo;
  low = __vibmin_u16x2(cand, low, &hi, &lo);
  set_bit<W>(lo_words, lo, word, bit);
  set_bit<W>(hi_words, hi, word, bit);
}

// The bits of node v's columns [col, col + kCols) evaluated exactly, group
// by group, as fused_epilogue_reference does: for a pair whose minimum
// fell below d (a product that is not at its fixed point).
template <int W>
__device__ __forceinline__ void exact_bits(const Args& a, int v, int col,
                                           int left,
                                           unsigned (&words)[kCols][W]) {
  const unsigned short* dv = a.d + (int64_t)v * a.p + col;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
#pragma unroll
    for (int i = 0; i < W; ++i) words[k][i] = 0u;
  }
  for (int gi = 0; gi < a.g; ++gi) {
    const int64_t o = (int64_t)gi * a.n + v;
    const int wg = __ldg(a.w + o);
    if (wg >= kWbig) continue;
    const unsigned short* du = a.d + (int64_t)__ldg(a.idx + o) * a.p + col;
    const bool overloaded = __ldg(a.ov + o) != 0;
    const int sg = __ldg(a.slot + o);
    const unsigned bit = sg >= 0 ? 1u << (sg & 31) : 0u;
    const int word = sg >= 0 ? sg >> 5 : 0;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (k < left) {
        const unsigned u = __ldg(du + k);
        const bool allow = (!overloaded || u == 0) && u < kInf;
        const unsigned cand = allow ? u + (unsigned)wg : kInf;
        set_bit<W>(words[k], cand == __ldg(dv + k), word, bit);
      }
    }
  }
}

// The entries of groups [0, g) of nodes [v0, v0 + tile) into tab[g][tile]
// (tile a power of two): coalesced reads of the four [G, N] tables.
__device__ __forceinline__ void stage_entries(const Args& a, Entry* tab,
                                              int v0, int tile_shift) {
  const int tile = 1 << tile_shift;
  for (int e = threadIdx.x; e < a.g * tile; e += kThreads) {
    const int v = v0 + (e & (tile - 1));
    Entry en = {0, (unsigned)kWbig};
    if (v < a.n) {
      const int64_t o = (int64_t)(e >> tile_shift) * a.n + v;
      const int wg = __ldg(a.w + o);
      const int u = __ldg(a.idx + o);
      const int ovg = __ldg(a.ov + o);
      const int sg = __ldg(a.slot + o);
      if (wg < kWbig) {
        en.u = u;
        en.meta = (unsigned)wg | (ovg != 0) << 15 | (unsigned)(sg + 1) << 16;
      }
    }
    tab[e] = en;
  }
}

template <int W, bool kVec>
__global__ void __launch_bounds__(kThreads, W == 1 ? 4 : 2)
    epilogue_u16_kernel(Args a) {
  extern __shared__ Entry u16_tab[];  // [g, tile]
  const int n = a.n, p = a.p;
  const int tile_shift = __ffs(a.tile) - 1;
  const int n_tiles = (n + a.tile - 1) >> tile_shift;
  // one block per item, slab-major: the blocks in flight share one slab
  const int v0 = (blockIdx.x % n_tiles) << tile_shift;
  const int lane_shift = __ffs(a.slab / kCols) - 1;  // threads per node row
  const int col =
      blockIdx.x / n_tiles * a.slab + kCols * (threadIdx.x & ((1 << lane_shift) - 1));
  const int left = p - col;
  const int step = kThreads >> lane_shift;  // node rows per pass
  int t = threadIdx.x >> lane_shift;
  // the first row's d is in flight while the block stages its entries
  unsigned dv[kPairs] = {};
  if (left > 0 && t < a.tile && v0 + t < n) {
    load_pairs<kVec>(dv, a.d + (int64_t)(v0 + t) * p + col, left);
  }
  stage_entries(a, u16_tab, v0, tile_shift);
  __syncthreads();
  bool ok = true;
  for (; left > 0 && t < a.tile && v0 + t < n; t += step) {
    const int v = v0 + t;
    unsigned low[kPairs];
    unsigned words[kCols][W];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) low[j] = dv[j];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
#pragma unroll
      for (int i = 0; i < W; ++i) words[k][i] = 0u;
    }
    for (int gb = 0; gb < a.g; gb += kChunk) {
      unsigned meta[kChunk];
      unsigned du[kChunk][kPairs];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        meta[j] = (unsigned)kWbig;
        if (gb + j < a.g) {
          const Entry en = u16_tab[((gb + j) << tile_shift) + t];
          meta[j] = en.meta;
          if ((en.meta & 0x7FFFu) < (unsigned)kWbig) {
            load_pairs<kVec>(du[j], a.d + (int64_t)en.u * p + col, left);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const unsigned wg = meta[j] & 0x7FFFu;
        if (wg >= (unsigned)kWbig) continue;  // an empty slot relaxes nothing
        const int sg = (int)(meta[j] >> 16) - 1;
        const unsigned bit = sg >= 0 ? 1u << (sg & 31) : 0u;
        const int word = sg >= 0 ? sg >> 5 : 0;
        if (meta[j] & 0x8000u) {
          // only a source (du == 0) relaxes; elsewhere INF16 lowers nothing
#pragma unroll
          for (int m = 0; m < kPairs; ++m) {
            const unsigned cand = ((du[j][m] & 0xFFFFu) == 0u ? wg : kInf) |
                                  ((du[j][m] >> 16) == 0u ? wg : kInf) << 16;
            relax_pair<W>(cand, low[m], words[2 * m], words[2 * m + 1], word, bit);
          }
        } else {
          // both columns' candidates in one add, carry-free on the domain
          const unsigned w2 = wg * 0x00010001u;
#pragma unroll
          for (int m = 0; m < kPairs; ++m) {
            relax_pair<W>(du[j][m] + w2, low[m], words[2 * m], words[2 * m + 1],
                          word, bit);
          }
        }
      }
    }
    unsigned below = 0u;
#pragma unroll
    for (int m = 0; m < kPairs; ++m) below |= low[m] ^ dv[m];
    if (below != 0u) {
      // some column is not at its fixed point: the verdict fails, and the
      // predicate cand <= low was not cand == d there
      ok = false;
      exact_bits<W>(a, v, col, left, words);
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const unsigned x = k & 1 ? dv[k / 2] >> 16 : dv[k / 2] & 0xFFFFu;
      if (x >= kInf) {
#pragma unroll
        for (int i = 0; i < W; ++i) words[k][i] = 0u;
      }
      // the saturation guard: a finite distance in [WBIG16, INF16)
      if ((kVec || k < left) && x >= (unsigned)kWbig && x < kInf) ok = false;
    }
    // the next row's d is in flight while this one's bitmap is stored
    if (t + step < a.tile && v + step < n) {
      load_pairs<kVec>(dv, a.d + (int64_t)(v + step) * p + col, left);
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
  if (!__syncthreads_and(ok) && threadIdx.x == 0) atomicAnd(a.verdict, 0);
}

template <int W, bool kVec>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.g * a.tile * sizeof(Entry);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = epilogue_u16_kernel<W, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_tiles = (a.n + a.tile - 1) / a.tile;
  const long long items = n_tiles * ((a.p + a.slab - 1) / a.slab);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(int)items, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int W>
int dispatch(int n_words, bool vec, const Args& a, cudaStream_t stream) {
  if constexpr (W > kMaxWords) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n_words != W) return dispatch<W + 1>(n_words, vec, a, stream);
    return vec ? launch<W, true>(a, stream) : launch<W, false>(a, stream);
  }
}

}  // namespace u16

}  // namespace

// Bytes of the scratch buffer that fused_epilogue_launch needs for the
// derived table entries of n nodes, g groups and node tile `tile`.
extern "C" long long fused_epilogue_scratch_bytes(int n, int g, int tile) {
  if (n <= 0 || tile <= 0) return 0;
  return (long long)((n + tile - 1) / tile) * i32::padded_groups(g) * tile *
         (long long)sizeof(i32::Entry);
}

// The int32 variant.  d [n, p] int32, idx/w/ov/slot [g, n] int32 and
// bitmap [n, p, n_words] int32 on the device, all contiguous, with idx in
// [0, n) and slot < 32 * n_words; *verdict must hold 1 and is cleared to
// 0 when some element is not at its fixed point; `scratch` holds
// fused_epilogue_scratch_bytes(n, g, tile) bytes, 16-byte aligned.
// `slab` (a power of two from 8 to 2048), `tile` (a power of two) and
// `halo` come from the caller's plan.  Launches the entries kernel, then
// the epilogue.  Returns a cudaError_t code.
extern "C" int fused_epilogue_launch(const void* d, const void* idx,
                                     const void* w, const void* ov,
                                     const void* slot, int n, int p, int g,
                                     int n_words, int slab, int tile,
                                     int halo, void* bitmap, void* verdict,
                                     void* scratch, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaSuccess;
  if (slab < i32::kCols || slab > i32::kCols * kThreads ||
      (slab & (slab - 1)) != 0 || tile < 1 || (tile & (tile - 1)) != 0 ||
      halo < 0 || g < 0 || (uintptr_t)scratch % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const i32::Args a = {(const int*)d,
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
                       (int*)bitmap,
                       (int*)verdict,
                       (i32::Entry*)scratch};
  const bool vec = p % i32::kCols == 0 && (uintptr_t)d % 16 == 0 &&
                   (uintptr_t)bitmap % 16 == 0;
  return i32::dispatch<1>(n_words, vec, a, (cudaStream_t)stream);
}

// The uint16 variant.  d [n, p] uint16 on [0, INF16], tables, bitmap and
// verdict as for fused_epilogue_launch.  The caller's plan gives `slab`
// (a power of two from 8 to 256 columns: 8 per thread) and `tile` (a
// power of two, the nodes of one block, whose entries of all g groups,
// 8 bytes each, fit the block's shared memory).  One launch; returns a
// cudaError_t code.
extern "C" int fused_epilogue_u16_launch(const void* d, const void* idx,
                                         const void* w, const void* ov,
                                         const void* slot, int n, int p,
                                         int g, int n_words, int slab,
                                         int tile, void* bitmap,
                                         void* verdict, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaSuccess;
  if (slab < u16::kCols || slab > u16::kCols * 32 || (slab & (slab - 1)) != 0 ||
      tile < 1 || (tile & (tile - 1)) != 0 || g < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const u16::Args a = {(const unsigned short*)d,
                       (const int*)idx,
                       (const int*)w,
                       (const int*)ov,
                       (const int*)slot,
                       n,
                       p,
                       g,
                       slab,
                       tile,
                       (int*)bitmap,
                       (int*)verdict};
  const bool vec = p % u16::kCols == 0 && (uintptr_t)d % 16 == 0 &&
                   (uintptr_t)bitmap % 16 == 0;
  return u16::dispatch<1>(n_words, vec, a, (cudaStream_t)stream);
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
