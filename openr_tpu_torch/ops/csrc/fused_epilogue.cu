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
// Distances are int32 (INF = 2^30, WBIG = 2^28, so du + w < 2^31); the
// bitmap is [N, P, W] words of int32 bit patterns.
//
// Bound on the H100 (3.35 TB/s): each input read once and each output
// written once is N*P*4 bytes of d, N*P*W*4 bytes of bitmap and 16*G*N
// bytes of tables — 0.25 ms at N = 100k, P = 1024, W = 1, G = 8.  The
// arithmetic (about 6*G integer operations per element) is far below the
// card's rate, so the kernel is bound by bytes.  The G gathered rows
// d[u, :] come on top of that: for band groups u = v - c is a neighbouring
// row that the previous blocks have just read, which is expected to hit in
// L2; for chord groups u is random and each gathered row is a device
// memory read.
//
// Design: a block covers a few nodes (blockDim.y) and a run of columns
// (blockDim.x, a power of two from 32 to 256).  Threads take consecutive
// columns, so each gathered row segment d[u, p0:p1] is read coalesced, and
// the table entries of a node are uniform across its warps.  Each thread
// loops over the G groups with vmin and the bitmap words in registers and
// writes its words straight into the [N, P, W] layout.  The verdict is a
// block-wide AND followed by one atomicAnd into a device int; no [N, P]
// vmin is written.  Threads past the ragged edge take part only in the
// block-wide AND.  Unlike the TPU kernel, nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kWbig = 1 << 28;
constexpr int kThreads = 256;

template <int kMaxWords>
__global__ void __launch_bounds__(kThreads) fused_epilogue_kernel(
    const int* __restrict__ d, const int* __restrict__ idx,
    const int* __restrict__ w, const int* __restrict__ ov,
    const int* __restrict__ slot, int n, int p, int g, int n_words,
    int* __restrict__ bitmap, int* __restrict__ verdict) {
  const int v = blockIdx.x * blockDim.y + threadIdx.y;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  bool ok = true;
  if (v < n && col < p) {
    const int dv = d[(int64_t)v * p + col];
    const bool fin = dv < kInf;
    int vmin = dv;
    unsigned words[kMaxWords];
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) words[i] = 0u;
    for (int gi = 0; gi < g; ++gi) {
      const int64_t t = (int64_t)gi * n + v;
      const int u = __ldg(idx + t);
      const int wg = __ldg(w + t);
      const int ovg = __ldg(ov + t);
      const int sg = __ldg(slot + t);
      const int du = __ldg(d + (int64_t)u * p + col);
      const bool allow = wg < kWbig && (ovg == 0 || du == 0) && du < kInf;
      const int cand = allow ? du + wg : kInf;
      if (fin && cand == dv && sg >= 0) {
        const unsigned bit = 1u << (sg & 31);
        const int word = sg >> 5;
#pragma unroll
        for (int i = 0; i < kMaxWords; ++i) {
          if (i == word) words[i] |= bit;
        }
      }
      vmin = min(vmin, cand);
    }
    int* out = bitmap + ((int64_t)v * p + col) * n_words;
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) {
      if (i < n_words) out[i] = (int)words[i];
    }
    ok = vmin == dv;
  }
  if (!__syncthreads_and(ok) && threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAnd(verdict, 0);
  }
}

template <int kMaxWords>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const int* d,
            const int* idx, const int* w, const int* ov, const int* slot,
            int n, int p, int g, int n_words, int* bitmap, int* verdict) {
  fused_epilogue_kernel<kMaxWords><<<grid, block, 0, stream>>>(
      d, idx, w, ov, slot, n, p, g, n_words, bitmap, verdict);
}

}  // namespace

// d [n, p], idx/w/ov/slot [g, n] int32 and bitmap [n, p, n_words] int32 on
// the device, all contiguous; *verdict must hold 1 and is cleared to 0 when
// some element is not at its fixed point.  Returns a cudaError_t code.
extern "C" int fused_epilogue_launch(const void* d, const void* idx,
                                     const void* w, const void* ov,
                                     const void* slot, int n, int p, int g,
                                     int n_words, void* bitmap, void* verdict,
                                     void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaSuccess;
  int tp = 32;
  while (tp < p && tp < kThreads) tp *= 2;
  const dim3 block(tp, kThreads / tp);
  const dim3 grid((n + block.y - 1) / block.y, (p + tp - 1) / tp);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const int* args_d = (const int*)d;
  const int* args_idx = (const int*)idx;
  const int* args_w = (const int*)w;
  const int* args_ov = (const int*)ov;
  const int* args_slot = (const int*)slot;
  int* out = (int*)bitmap;
  int* ver = (int*)verdict;
  if (n_words == 1) {
    launch<1>(grid, block, s, args_d, args_idx, args_w, args_ov, args_slot,
              n, p, g, n_words, out, ver);
  } else if (n_words == 2) {
    launch<2>(grid, block, s, args_d, args_idx, args_w, args_ov, args_slot,
              n, p, g, n_words, out, ver);
  } else if (n_words <= 4) {
    launch<4>(grid, block, s, args_d, args_idx, args_w, args_ov, args_slot,
              n, p, g, n_words, out, ver);
  } else if (n_words <= 8) {
    launch<8>(grid, block, s, args_d, args_idx, args_w, args_ov, args_slot,
              n, p, g, n_words, out, ver);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fused_epilogue_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
