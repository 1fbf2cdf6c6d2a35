// Phase 3 of a blocked Floyd-Warshall round: the rank-B saturating
// min-plus update of the whole distance matrix, for sm_90a.
//
// Replaces the Pallas kernel openr_tpu/ops/pallas_kernels.py:401
// blocked_outer_pallas (kernel body _outer_kernel).  For every batch slice
// s and every (i, j) of the [Np, Np] matrix d (the [S, T, B, T, B] tile
// tensor seen as [S, Np, Np]):
//
//   d[i, j] = min(d[i, j], min over m of col[i, m] + row[m, j])
//
// where col is the [Np, B] column panel and row the [B, Np] row panel of
// tile k, and row m counts as INF when lane m of tile k is drained (an
// overloaded node relays nothing).  The wrapper writes both panels back
// into tile k before the launch and the kernel updates d in place.
//
// Arithmetic: distances are int32 storage holding values in [0, 2^30]
// (INF = 2^30), read here as uint32.  Hopper's DPX __viaddmin_u32(c, r,
// acc) = min(c + r, acc) is the whole update: c + r <= 2^31 never wraps in
// uint32 and acc <= INF, so min(acc, min(c + r, INF)) == min(acc, c + r).
// Integer min is exact and order-free, so any m order and tiling is
// bit-exact against the plain version.
//
// Bound on the H100 (3.35 TB/s) at the blocked rung's main path (one
// device, B = 16, Np = 32 864): each element of d is read once and written
// once, 2 * Np^2 * 4 = 8.64 GB per launch, 2.58 ms; the panels add 4 MB.
// The arithmetic is 2 * B integer operations per element, about 4 per
// byte, far below the card's rate, so bytes bound the kernel.  A cold
// route build launches it T = Np / B = 2054 times, about 5.3 s per closure
// at the bound.  A larger B would raise the arithmetic per byte and cut
// the launches; the tile rule (B = 16 on one device) is the reference's
// policy, kept here, and changing it is a later PR's choice.
//
// Design: a block of 256 threads owns one [64, 64] output tile of one
// slice s.  It stages the [64, B] block of the column panel and the
// [B, 64] block of the row panel in dynamic shared memory (sized from B),
// with drained rows of the row panel lifted to INF.  Each thread then
// keeps a 4 x 4 group of outputs in registers — rows ty + 16a, four
// consecutive columns read and written as one 16-byte vector, so a warp
// touches two 256-byte row segments — and runs the m loop over shared
// memory.  Each d element is read once and written once.  Masks cover a
// ragged Np (a multiple of B, not of 64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kInf = 1u << 30;
constexpr int kThreads = 256;
constexpr int kTile = 64;          // output tile edge, rows and columns
constexpr int kLanes = 16;         // threads along a tile edge
constexpr int kVec = kTile / kLanes;  // 4 outputs per thread per edge

__global__ void __launch_bounds__(kThreads) blocked_outer_kernel(
    unsigned* __restrict__ d, const unsigned* __restrict__ col,
    const unsigned* __restrict__ row, const unsigned char* __restrict__ drained,
    int np, int b) {
  extern __shared__ uint4 smem[];
  uint4* rs = smem;                                  // [b][kTile / 4]
  unsigned* cs = reinterpret_cast<unsigned*>(rs + b * (kTile / 4));
  const int cs_stride = b + 1;                       // [kTile][b + 1]

  const int64_t s = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  d += s * (int64_t)np * np;
  col += s * (int64_t)np * b;
  row += s * (int64_t)b * np;

  const int tid = threadIdx.x;
  for (int e = tid; e < b * (kTile / 4); e += kThreads) {
    const int m = e / (kTile / 4);
    const int j = j0 + 4 * (e % (kTile / 4));
    uint4 v = make_uint4(kInf, kInf, kInf, kInf);
    if (!drained[m] && j < np) {
      v = *reinterpret_cast<const uint4*>(row + (int64_t)m * np + j);
    }
    rs[e] = v;
  }
  for (int e = tid; e < kTile * b; e += kThreads) {
    const int i = e / b;
    const int m = e % b;
    cs[i * cs_stride + m] =
        i0 + i < np ? col[(int64_t)(i0 + i) * b + m] : kInf;
  }
  __syncthreads();

  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const int j = j0 + 4 * tx;
  if (j >= np) return;  // np % 4 == 0: a vector is wholly in or out
  uint4 acc[kVec];
#pragma unroll
  for (int a = 0; a < kVec; ++a) {
    const int i = i0 + ty + kLanes * a;
    acc[a] = i < np ? *reinterpret_cast<const uint4*>(d + (int64_t)i * np + j)
                    : make_uint4(kInf, kInf, kInf, kInf);
  }
  for (int m = 0; m < b; ++m) {
    const uint4 r = rs[m * (kTile / 4) + tx];
#pragma unroll
    for (int a = 0; a < kVec; ++a) {
      const unsigned c = cs[(ty + kLanes * a) * cs_stride + m];
      acc[a].x = __viaddmin_u32(c, r.x, acc[a].x);
      acc[a].y = __viaddmin_u32(c, r.y, acc[a].y);
      acc[a].z = __viaddmin_u32(c, r.z, acc[a].z);
      acc[a].w = __viaddmin_u32(c, r.w, acc[a].w);
    }
  }
#pragma unroll
  for (int a = 0; a < kVec; ++a) {
    const int i = i0 + ty + kLanes * a;
    if (i < np) *reinterpret_cast<uint4*>(d + (int64_t)i * np + j) = acc[a];
  }
}

// Dynamic shared memory of one block for tile width b, in bytes.
int smem_bytes(int b) { return b * kTile * 4 + kTile * (b + 1) * 4; }

}  // namespace

// d [s, np, np], col [s, np, b] and row [s, b, np] are int32 storage of
// values in [0, 2^30], contiguous and 16-byte aligned on the device;
// drained [b] holds the drain flags (0 or 1, one byte each) of the lanes of
// tile k.  np is a multiple of b and b a multiple of 4.  Updates d in
// place on `stream`.  Returns a cudaError_t code.
extern "C" int blocked_outer_launch(void* d, const void* col, const void* row,
                                    const void* drained, int s, int np, int b,
                                    void* stream) {
  if (s <= 0 || np <= 0) return (int)cudaSuccess;
  if (b <= 0 || b % 4 || np % b) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(b);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_outer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (np + kTile - 1) / kTile;
  if (s > 65535 || tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(tiles, tiles, s);
  blocked_outer_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (unsigned*)d, (const unsigned*)col, (const unsigned*)row,
      (const unsigned char*)drained, np, b);
  return (int)cudaGetLastError();
}

extern "C" const char* blocked_outer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
