// rglru_scan for Hopper (sm_90a): the RG-LRU linear recurrence over time.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (`rglru_scan`, body `_scan_kernel`): h_t = a_t * h_{t-1} + b_t for
// a, b [B, S, W] f32, from h0 [B, W] (zeros when absent), giving h [B, S, W]
// f32 and h_last [B, W].  Every RG-LRU layer's prefill runs it on the gates
// that the surrounding PyTorch code computes.
//
// Bound on the card: bytes.  The work is one FMA per element against
// 12 bytes moved (read a and b, write h), so the least time is
// 4 * (3 * B*S*W + 2 * B*W) bytes over HBM bandwidth.  What actually bounds
// this design is latency: the recurrence is a chain of S dependent FMAs per
// (b, w) column, and at the serving shapes there are only B*W columns
// (16,384 at B 4, W 4096) for 132 SMs.
//
// Design: on the TPU the time axis was the sequential grid dimension and
// the carry lived in VMEM scratch between time blocks.  Here one thread owns
// one (b, w) column and walks t = 0..S-1 with the carry in a register; the
// threads of a warp take consecutive w, so every load of a[t] and b[t] and
// every store of h[t] is one coalesced 128-byte line per warp.  The loads do
// not depend on h, so they are issued kUnroll steps ahead of the FMAs that
// consume them (two register buffers: the next group is in flight while the
// current one is folded in), which overlaps memory latency with the chain.
// Ragged S and W are masked in the kernel; nothing is padded on the host.
//
// A chunked two-pass scan over S (a local scan per S-chunk in parallel, then
// a carry fix-up, the blocking the reference's _lru_scan uses at chunk 256)
// would put B*W*S/chunk threads to work instead of B*W; that redesign is
// left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // small blocks spread B*W columns over more SMs
constexpr int kUnroll = 8;     // time steps loaded ahead of the chain

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, long long S, long long W) {
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const long long base = row * S * W + w;
  const float* pa = a + base;
  const float* pb = b + base;
  float* ph = h + base;

  float carry = h0 != nullptr ? h0[row * W + w] : 0.0f;

  float na[kUnroll], nb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    na[u] = 0.0f;
    nb[u] = 0.0f;
    if (u < S) {
      na[u] = __ldg(pa + (long long)u * W);
      nb[u] = __ldg(pb + (long long)u * W);
    }
  }
  for (long long t0 = 0; t0 < S; t0 += kUnroll) {
    float ca[kUnroll], cb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
    const long long t1 = t0 + kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t1 + u < S) {
        na[u] = __ldg(pa + (t1 + u) * W);
        nb[u] = __ldg(pb + (t1 + u) * W);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        carry = fmaf(ca[u], carry, cb[u]);
        ph[(t0 + u) * W] = carry;
      }
    }
  }
  h_last[row * W + w] = carry;
}

}  // namespace

// C interface (loaded with ctypes).  a, b, h: B*S*W f32, contiguous
// [B, S, W]; h0: B*W f32 or null (zeros); h_last: B*W f32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, void* h_last, long long B,
                                 long long S, long long W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)((W + kThreads - 1) / kThreads), (unsigned)B);
  rglru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W);
  return (int)cudaGetLastError();
}
