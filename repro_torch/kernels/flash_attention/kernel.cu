// Flash attention forward and backward for Hopper (sm_90a): causal GQA
// with optional sliding window, logit softcap and q_offset, bf16 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_fwd`, body `_fwd_kernel`).  Same contract: q [B, Sq, Hq,
// hd], k and v [B, Sk, Hkv, hd]; query head h reads kv head h / (Hq / Hkv),
// no k/v is copied; online softmax with m, l and the accumulator in f32, P
// rounded to bf16 for the PV product; masked logits are -1e30 as in the
// Pallas body, so a row with every key masked averages v as it does.
//
// Bound on the card: 4 * B * Hq * hd * (causal pairs) operations at the
// bf16 tensor-core peak (989 TFLOP/s); at prefill lengths that is several
// times the bytes of q, k, v and o over HBM.  Below the products sits the
// softmax: one exp per logit on the SM's 16-a-clock MUFU, which at hd 64
// costs as many clocks as the two products together.
//
// Design.  One block owns one (batch*head, 64-row q tile) and loops over
// the k tiles it needs, with m, l and the accumulator in registers (on the
// TPU the k tiles were the sequential minor grid axis with VMEM scratch).
// 64 rows keep the grid at 72 blocks for a 512-token prompt of smollm.
//   - Products on warpgroup MMA.  One consumer warpgroup (4 warps, 16 query
//     rows each) runs S = Q K^T as wgmma m64n64k16 with Q and K read from
//     shared memory, and O += P V with P in registers as the A operand: the
//     S accumulator, converted pairwise to bf16x2, is already laid out as
//     the A fragment.  V is the shared-memory B operand with the transpose
//     bit set, so it needs no transposed copy.  hd 128 runs PV as
//     m64n128k16.
//   - Products overlap the softmax.  QK^T of tile i + 1 and PV of tile i
//     are in flight together while the ALUs and the exp unit work on the
//     softmax of tile i + 1; several blocks share an SM (3 at hd 64, 2 at
//     hd 128) and fill each other's gaps.
//   - Copies by TMA into a ring.  A producer warp (one elected thread)
//     loads Q once and the K and V tiles of 64 keys into STAGES ring slots.
//     K and V each have a full barrier the consumers wait on and an empty
//     barrier they release: K's slot as soon as QK^T has retired, V's after
//     PV, so the next K lands a whole tile earlier than V.  The tensor maps
//     span the true [B, S, H, hd] view, so a ragged tile reads TMA's zero
//     fill, never the next sequence, and the host pads nothing.  128-byte
//     swizzle (one 64-column atom; hd 128 is two boxes) lets the wgmma
//     descriptors read without bank conflicts.
//   - Masks only where needed.  Tiles wholly above the diagonal or before
//     the window are never visited; interior tiles run with no per-element
//     mask, and only the diagonal, window-edge and ragged-Sk tiles take the
//     masked variant.
//   - exp2 softmax: scale * log2(e) folds into one FFMA before ex2; the
//     softcap's tanh stays on the scaled logit, as the reference orders it.
//   - The grid issues the heavy (late) q tiles of every head first.
//   - The log-sum-exp, where the caller passes a buffer (training does;
//     serving passes null and the epilogue writes nothing more): each row's
//     m2 + log2(l), f32 [B, Hq, Sq], in the kernel's log2 domain, i.e.
//     log2(e) times the natural log-sum-exp of the (softcapped) logits.
//
// Backward (no Pallas counterpart: the reference's `_fa_bwd` in
// src/repro/kernels/flash_attention/ops.py recomputes its XLA path under
// jax.vjp).  dq, dk and dv of the same function, with P recomputed from the
// forward's log-sum-exp: P = exp2(y - lse2), D = rowsum(dO o), dS = P (dP -
// D) (times 1 - tanh^2 under softcap), dV = P^T dO, dQ = dS K scale, dK =
// dS^T Q scale.  Bound on the card: its five products, 10 * B * Hq * hd *
// (causal pairs) operations at the bf16 peak, 2.5 times the forward's.
// Two passes and no atomics, so every sum runs in one fixed order and a
// launch repeats bit for bit.  A block of either pass holds 128 resident
// rows, one 64-row half for each of two consumer warpgroups, and one
// thread of a producer warpgroup keeps a TMA ring full; every ring tile
// feeds both halves, and setmaxnreg hands the producer's registers to the
// consumers.
//   - the dq pass: one block a (batch*head, 128-row q block), Q and dO
//     resident, K and V streamed over the k tiles either half visits; S =
//     Q K^T and dP = dO V^T as one group of wgmma, then dQ += dS K with dS
//     from registers.  Its prologue computes D of its rows and writes each
//     row's (lse2, D) into scratch for the dk/dv pass;
//   - the dk/dv pass: one block a (batch*kv head, 128-key block) and a run
//     of the (query head, q tile) items that visit it, K and V resident,
//     Q, dO and the tile's 64 (lse2, D) pairs streamed, so each thread
//     reads its columns' values from shared memory.  It computes the
//     transposed products, S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
//     sit in registers as the A fragments of dV += P^T dO and dK += dS^T
//     Q, exactly as P does for the forward's P V: every product of both
//     passes is one of the forward's two wgmma shapes on the same swizzled
//     tiles.  dK and dV stay in registers over the run;
//   - the schedule (the host's, from the shape alone): where the dk/dv
//     pass would have fewer blocks than an H100 SXM has SMs, its key
//     blocks are cut into runs of at most T items, T the least that keeps
//     the grid to one wave; a cut key block's runs write f32 partials, and
//     a third short pass adds them in run order.
//   Within a block the two warpgroups run free, each waiting for its own
//   product groups: their P and dS (ALUs, exp unit) fall beside each
//   other's products without being ordered.  P and dS take a
//   specialisation per tile for the softcap and the mask, so an unmasked
//   tile without softcap pays one FFMA, one ex2 and two ops a logit.
// Every branch between an asynchronous product and its wait must look
// warp-uniform to the compiler, or ptxas serialises the products: the role
// split is broadcast from lane 0 and the barrier spin stays inside asm.
// cuTensorMapEncodeTiled lives in libcuda, which this library does not
// link: the host code gets it through the runtime's entry-point query
// (cudaGetDriverEntryPointByVersion, CUDA 12.5 and later).  Per launch the
// host encodes three tensor maps (the backward four); the shared-memory
// limit is raised once per kernel and card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <cmath>
#include <cstring>
#include <type_traits>
#include <vector>

#if CUDART_VERSION < 12050
#error "flash_attention needs CUDA 12.5+ (cudaGetDriverEntryPointByVersion)"
#endif

namespace {

constexpr int BM = 64;                    // query rows per block
constexpr int BN = 64;                    // keys per tile
constexpr int kConsumers = 128;           // the consumer warpgroup
constexpr int kThreads = kConsumers + 32; // and the producer warp
constexpr int kAtom = 64;                 // bf16 in one 128-byte swizzle row
constexpr uint32_t kBox = BN * kAtom * 2; // one 64-row x 64-column box, 8 KB
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int kMaxDevices = 64;           // cards a process may launch on

struct Params {
  CUtensorMap tq, tk, tv;       // (hd, H, S, B) views of q, k, v
  __nv_bfloat16* o;
  float* lse;                   // [B, Hq, Sq] base-2 log-sum-exp, or null
  long long o_sb, o_ss, o_sh;   // element strides (batch, seq, head)
  int Sq, Sk, Hq, G, nq_tiles;  // G = Hq / Hkv
  int causal, window, q_offset;
  float scale_log2;             // log2(e) / sqrt(hd)
  float softcap, cap_in, cap_out;  // scale / cap; cap * log2(e)
};

// shared memory: Q, then STAGES K tiles, then STAGES V tiles, each
// 64 x HD bf16 (1024-byte aligned), then the barriers: Q's full, then K's
// and V's full, then K's and V's empty, one per slot
template <int HD, int STAGES>
struct Smem {
  static constexpr uint32_t kTile = BN * HD * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kTile;
  static constexpr uint32_t kV = kK + STAGES * kTile;
  static constexpr uint32_t kBar = kV + STAGES * kTile;
  static constexpr uint32_t kBytes = kBar + (1 + 4 * STAGES) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// the spin loop stays inside the asm: a C++ loop on a per-thread flag would
// be a divergent branch to the compiler, which then serialises the
// asynchronous products around it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// ---- TMA: one 4-d box (c0 = column, c1 = head, c2 = row, c3 = batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// ---- wgmma
// shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product's fence and wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// and the registers of an A fragment, read by the product until its wait
__device__ __forceinline__ void pin(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4]) :: "memory");
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D32(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12), D4(i + 16), \
               D4(i + 20), D4(i + 24), D4(i + 28)

// S[64 x 64] (+)= Q[64 x 16] K[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 64] += P[64 x 16] (registers) V[16 x 64] (MN-major: transposed)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += P[64 x 16] (registers) V[16 x 128] (MN-major: transposed)
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, "
      "1, 1, 1;\n}\n"
      : D32(0), D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D32
#undef D4

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// One k tile of the online softmax on this thread's share of S: rows r and
// r + 8 (i = e >> 1), columns 8j + 2t + (e & 1) of element s[4j + e].  s
// holds raw logits (softcapped ones already in the log2 domain, mul = 1)
// and leaves as P = exp2(y - m); m2 is the running max of y = s * mul.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m2)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float mul, int qpos, int kpos,
                                               const Params& p) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * j + e];
      if (MASK) {
        const int qp = qpos + (e >> 1) * 8;
        const int kp = kpos + j * 8 + (e & 1);
        bool ok = kp < p.Sk;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        x = ok ? x * mul : NEG_INF;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    if (!MASK) mx[i] *= mul;
    const float m_new = fmaxf(m2[i], mx[i]);
    corr[i] = ex2(m2[i] - m_new);
    m2[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * j + e];
      const float m = m2[e >> 1];
      x = MASK ? ex2(x - m) : ex2(fmaf(x, mul, -m));
      l[e >> 1] += x;
    }
  }
}

template <int HD, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
flash_fwd_kernel(const __grid_constant__ Params p) {
  using L = Smem<HD, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms must sit on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int st) { return q_full + 8u * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8u * (1 + STAGES + st); };
  auto k_empty = [&](int st) { return q_full + 8u * (1 + 2 * STAGES + st); };
  auto v_empty = [&](int st) { return q_full + 8u * (1 + 3 * STAGES + st); };

  const int bh = blockIdx.x;
  const int qt = p.nq_tiles - 1 - (int)blockIdx.y;   // heavy tiles first
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int kvh = h / p.G;
  const int q0 = qt * BM;

  // the k tiles this q tile needs: skip tiles wholly above the causal
  // diagonal or wholly before the sliding window (Pallas's `needed`)
  const int first_q = p.q_offset + q0;
  const int last_q = p.q_offset + min(q0 + BM, p.Sq) - 1;
  int kt_begin = 0;
  int kt_end = (p.Sk + BN - 1) / BN;
  if (p.causal) kt_end = min(kt_end, last_q / BN + 1);
  if (p.window > 0) {
    const int kmin = first_q - p.window + 1;
    kt_begin = kmin > 0 ? kmin / BN : 0;
  }
  const int n = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumers);
      mbar_init(v_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, broadcast from lane 0 so the compiler sees it warp-uniform
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / kConsumers, 0);
  if (role != 0) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x == kConsumers && n > 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < HD / kAtom; ++c)
        tma_load(sQ + c * kBox, &p.tq, q_full, c * kAtom, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES;
        const uint32_t ph = ((i / STAGES) & 1) ^ 1;
        const int k0 = (kt_begin + i) * BN;
        const uint32_t dk = sK + st * L::kTile, dv = sV + st * L::kTile;
        mbar_wait(k_empty(st), ph);
        mbar_expect_tx(k_full(st), L::kTile);
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load(dk + c * kBox, &p.tk, k_full(st), c * kAtom, kvh, k0, b);
        mbar_wait(v_empty(st), ph);
        mbar_expect_tx(v_full(st), L::kTile);
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load(dv + c * kBox, &p.tv, v_full(st), c * kAtom, kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 16 query rows a warp
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + (lane >> 2);   // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);            // and columns 8j + c0, + 1

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t pa[4][4];                // P of the tile in flight, bf16x2
  float m2[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};          // partial over this thread's columns
  float corr[2];
  const float mul = p.softcap > 0.f ? 1.f : p.scale_log2;
  const int q_last = first_q + BM - 1;   // rows past Sq included

  // S = Q K^T for ring slot st: hd / 16 steps of 16 columns, each 32 bytes
  // further into the swizzle rows (hd 128: the second box from step 4)
  auto qk = [&](int st) {
    const uint32_t tk = sK + st * L::kTile;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_qk(s, desc_sw128(sQ + off, 16, 1024),
               desc_sw128(tk + off, 16, 1024), kk > 0);
    }
  };
  // O += P V for ring slot st: 16 keys (two 8-row swizzle groups, 2 KB) a
  // step; hd 128's two 64-column boxes lie kBox apart (the leading offset)
  auto pv = [&](int st) {
    const uint32_t tv = sV + st * L::kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_pv(o, pa[j], desc_sw128(tv + j * 2048, kBox, 1024));
  };
  // the online softmax of k tile i on s (its logits); sets corr
  auto softmax = [&](int i) {
    const int k_lo = (kt_begin + i) * BN;
    if (p.softcap > 0.f) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = p.cap_out * tanhf(s[e] * p.cap_in);
    }
    // only the diagonal, window-edge and ragged-Sk tiles need the mask
    const bool edge = k_lo + BN > p.Sk || (p.causal && k_lo + BN - 1 > first_q)
                      || (p.window > 0 && k_lo <= q_last - p.window);
    if (edge)
      online_softmax<true>(s, m2, l, corr, mul, first_q + r0, k_lo + c0, p);
    else
      online_softmax<false>(s, m2, l, corr, mul, first_q + r0, k_lo + c0, p);
  };
  auto rescale = [&]() {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };
  // the S accumulator's n-blocks 2j and 2j + 1 are P's A fragment for
  // keys 16j .. 16j + 15
  auto pack = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
  };

  // Tile i's PV product runs on the tensor cores while the softmax of tile
  // i + 1 runs beside it: QK^T(i + 1) and PV(i) are issued as two groups,
  // waiting for the older group releases S (and K's slot), and O is
  // rescaled only after PV(i) has retired (and V's slot with it).  The
  // first tile's product and the last tile's PV are peeled off, so no
  // branch sits between an asynchronous product and its wait.
  if (n > 0) {
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    wg_fence();
    qk(0);
    wg_commit();
    wg_wait<0>();
    pin(s);
    mbar_arrive(k_empty(0));
    softmax(0);
    pack();
    for (int i = 0; i + 1 < n; ++i) {
      const int st = i % STAGES, st1 = (i + 1) % STAGES;
      mbar_wait(k_full(st1), ((i + 1) / STAGES) & 1);
      mbar_wait(v_full(st), (i / STAGES) & 1);
      wg_fence();
      qk(st1);
      wg_commit();
      pv(st);
      wg_commit();
      wg_wait<1>();
      pin(s);
      mbar_arrive(k_empty(st1));
      softmax(i + 1);
      wg_wait<0>();
      pin(o);
      pin(pa);
      mbar_arrive(v_empty(st));
      rescale();
      pack();
    }
    const int st = (n - 1) % STAGES;
    mbar_wait(v_full(st), ((n - 1) / STAGES) & 1);
    wg_fence();
    pv(st);
    wg_commit();
    wg_wait<0>();
    pin(o);
    mbar_arrive(v_empty(st));
  }

  // finalize: o = acc / max(l, 1e-30), rows past Sq are not written; the
  // row's log-sum-exp in the log2 domain, m2 + log2(l), where asked for
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = q0 + r0 + i * 8;
    if (qrow >= p.Sq) continue;
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[(long long)bh * p.Sq + qrow] = m2[i] + log2f(fmaxf(l[i], 1e-30f));
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = p.o + b * p.o_sb + qrow * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + c0) =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
  }
}

// ---- backward
constexpr int BR = 2 * BM;                  // resident rows a block: two halves
constexpr int kBwdConsumers = 256;          // two consumer warpgroups
constexpr int kBwdThreads = kBwdConsumers + 128;  // and the producer's
// setmaxnreg moves registers between whole warpgroups within the block's
// launch allocation (384 x 168): 256 x 240 + 128 x 24 fills it exactly
constexpr int kRegsConsumer = 240;
constexpr int kRegsProducer = 24;
// The SMs the schedule plans for: an H100 SXM's.  The plan depends on the
// shape alone, so a launch's bits do not depend on the card it runs on.
constexpr int kPlanSms = 132;
constexpr int kSumRows = 32;                // rows of a block of the sum pass

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// The mask's geometry, shared by both passes and the host's schedule
struct Dims {
  int Sq, Sk, nq_tiles, nk_tiles;
  int causal, window, q_offset;

  // the 64-key tiles that 64-row q tile qt visits, [kb, ke): the forward's
  // skips
  __host__ __device__ void k_tiles(int qt, int& kb, int& ke) const {
    const int q0 = qt * BM;
    const int first_q = q_offset + q0;
    const int last_q = q_offset + imin(q0 + BM, Sq) - 1;
    kb = 0;
    ke = nk_tiles;
    if (causal) ke = imin(ke, last_q / BN + 1);
    if (window > 0) {
      const int kmin = first_q - window + 1;
      kb = kmin > 0 ? kmin / BN : 0;
    }
  }
  // the q tiles that visit any of k tiles [kt_lo, kt_hi), [qlo, qhi): a
  // contiguous run, as a q tile's k-tile range only grows with the tile
  __host__ __device__ void q_tiles(int kt_lo, int kt_hi, int& qlo,
                                   int& qhi) const {
    qlo = nq_tiles;
    qhi = 0;
    for (int qt = 0; qt < nq_tiles; ++qt) {
      int kb, ke;
      k_tiles(qt, kb, ke);
      if (kb < kt_hi && kt_lo < ke) {
        qlo = imin(qlo, qt);
        qhi = qt + 1;
      }
    }
  }
  // the k tiles the 128-row q block qb visits: the union of its halves'
  __host__ __device__ void k_tiles_of_block(int qb, int& kb, int& ke) const {
    k_tiles(2 * qb, kb, ke);
    if (2 * qb + 1 < nq_tiles) {
      int kb1, ke1;
      k_tiles(2 * qb + 1, kb1, ke1);
      kb = imin(kb, kb1);
      ke = imax(ke, ke1);
    }
  }
  // whether the (q tile at q0, k tile at k_lo) pair needs the per-element
  // mask: the forward's diagonal, window-edge and ragged-Sk tiles
  __host__ __device__ bool edge(int q0, int k_lo) const {
    const int first_q = q_offset + q0;
    return k_lo + BN > Sk || (causal && k_lo + BN - 1 > first_q)
           || (window > 0 && k_lo <= first_q + BM - 1 - window);
  }
  __device__ __forceinline__ bool visible(int qp, int kp) const {
    bool ok = kp < Sk;
    if (causal) ok = ok && kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
    return ok;
  }
};

// The dk/dv pass's schedule: its blocks walk the key blocks (128 keys) in
// key order, one block a (batch*kv head, key block), so the heavy key
// blocks of a causal mask go first.  A cut schedule (n_split > 0) gives key
// block kb the units [first[kb], first[kb + 1]), one block a part and
// (batch*kv head); a key block of several parts writes f32 partials from
// slot poff[kb] on, and the sum pass adds them in part order.  Only a grid
// of fewer blocks than kPlanSms is cut, so the table never holds more key
// blocks than that.
struct BwdSchedule {
  int units, split_parts, n_split;
  uint16_t first[kPlanSms + 1];
  uint16_t poff[kPlanSms];         // 0xFFFF: one part, written as bf16
  uint16_t split_kb[kPlanSms];     // the key blocks that are cut, in order
};

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;  // (hd, H, S, B) views of q, k, v and dO
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  const float* lse;             // [B, Hq, Sq], the forward's (log2 domain)
  float2* ld;                   // [B, Hq, Sq_pad]: (lse2, D) a query row,
                                // (+inf, 0) past Sq; written by the dq pass
  float* part;                  // dK and dV partials of split key blocks
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  Dims d;
  int Hq, Hkv, G, bhkv, nqb, Sq_pad;  // bhkv = B * Hkv
  float scale, scale_log2;      // 1 / sqrt(hd); times log2(e)
  float softcap, cap_in, cap_out;
  BwdSchedule sched;
};

// shared memory of either pass: two resident 128-row operands (A0, A1),
// each two 64-row tiles, one per warpgroup; a ring of STAGES pairs of
// 64-row tiles (R0, R1) and their 64 (lse2, D) pairs (the dk/dv pass; the
// dq pass keeps its own rows' there); the barriers: the residents' full,
// then each slot's full, then each slot's empty.  dq pass: A0 = Q, A1 =
// dO, R0 = K, R1 = V; dk/dv pass: A0 = K, A1 = V, R0 = Q, R1 = dO.
template <int HD, int STAGES>
struct BwdSmem {
  static_assert(STAGES >= 2, "the dq pass keeps two halves' rows in kLD");
  static constexpr uint32_t kTile = BM * HD * 2;
  static constexpr uint32_t kA0 = 0;
  static constexpr uint32_t kA1 = 2 * kTile;
  static constexpr uint32_t kR0 = 4 * kTile;
  static constexpr uint32_t kR1 = kR0 + STAGES * kTile;
  static constexpr uint32_t kLD = kR1 + STAGES * kTile;
  static constexpr uint32_t kBar = kLD + STAGES * BM * 8;
  static constexpr uint32_t kBytes = kBar + (1 + 2 * STAGES) * 8;
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// one bulk copy (no tensor map) of `bytes` from global to shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// P and dS of one logit, in place: s = q.k on entry, P on exit; dp = dO.v
// on entry, dS on exit.  P = exp2(y - lse2), y the logit in the forward's
// log2 domain; dS = P (dP - D), times the softcap's 1 - tanh^2 (the scale
// multiplies the finished sums once).  A masked logit (ok false, read only
// under MASK) takes the forward's -1e30, so P = 0; lse2 = +inf (a row past
// Sq) gives P = 0 too.  CAP and MASK are template flags, chosen once a
// tile: left to a run-time test, the compiler predicates the softcap's
// tanhf into every logit, which costs more than the tile's products.
template <bool CAP, bool MASK>
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2, float d,
                                     bool ok, const BwdParams& p) {
  float arg, fac = 1.f;
  if (CAP) {
    const float t = tanhf(s * p.cap_in);
    arg = fmaf(p.cap_out, t, -lse2);
    fac = 1.f - t * t;
  } else {
    arg = fmaf(s, p.scale_log2, -lse2);
  }
  if (MASK && !ok) arg = NEG_INF;
  const float pr = ex2(arg);
  s = pr;
  dp = CAP ? pr * (dp - d) * fac : pr * (dp - d);
}

// f(cap, mask) with the softcap and mask flags as compile-time constants
// (std::integral_constant), one specialisation a combination
template <typename F>
__device__ __forceinline__ void with_flags(bool cap, bool mask, F&& f) {
  using T = std::true_type;
  using N = std::false_type;
  if (cap) {
    if (mask) f(T{}, T{});
    else f(T{}, N{});
  } else {
    if (mask) f(N{}, T{});
    else f(N{}, N{});
  }
}

// the accumulator's n-blocks 2j and 2j + 1 are the A fragment of the next
// product's k-slice j (16 columns), as P is in the forward
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// acc = A B^T over hd for two 64-row tiles, both K-major in shared memory
// (the forward's Q K^T)
template <int HD>
__device__ __forceinline__ void wg_abt(float (&acc)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_qk(acc, desc_sw128(a + off, 16, 1024), desc_sw128(b + off, 16, 1024),
             kk > 0);
  }
}

// acc += A (registers, 64 x 64) T, T a 64-row tile read MN-major (the
// forward's P V)
template <int HD>
__device__ __forceinline__ void wg_at(float (&acc)[HD / 2],
                                      const uint32_t (&a)[4][4], uint32_t t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_pv(acc, a[j], desc_sw128(t + j * 2048, kBox, 1024));
}

// a row of HD / 2 accumulator pairs, times mul, to bf16 at dst (row i of
// this thread's two)
template <int HD>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&acc)[HD / 2], int i,
                                          int c0, float mul) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    *reinterpret_cast<uint32_t*>(dst + 8 * j + c0) =
        pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
}

// the same row in f32 (a partial of the dk/dv pass)
template <int HD>
__device__ __forceinline__ void store_row_f32(float* dst,
                                              const float (&acc)[HD / 2],
                                              int i, int c0) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    *reinterpret_cast<float2*>(dst + 8 * j + c0) =
        make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), v = __bfloat1622float2(b[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

__device__ __forceinline__ void regs_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegsProducer));
}

__device__ __forceinline__ void regs_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegsConsumer));
}

// The dq pass: one block owns one (batch*head, 128-row q block), Q and dO
// resident, one 64-row half a warpgroup, and walks the k tiles either half
// visits, K and V through the ring; each ring tile feeds both halves.  Its
// prologue computes D = rowsum(dO o) of its rows (read once from device
// memory) and stages (lse2, D) in shared memory and in ld for the dk/dv
// pass.  A half wholly past the last q tile loads the last tile again: its
// rows' lse2 is +inf, so it adds nothing and stores nothing.
template <int HD, int STAGES>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  using L = BwdSmem<HD, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kA0, sDO = base + L::kA1;
  const uint32_t sK = base + L::kR0, sV = base + L::kR1;
  float2* sLD = reinterpret_cast<float2*>(smem_raw + (base - raw) + L::kLD);
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int st) { return res_full + 8u * (1 + st); };
  auto empty = [&](int st) { return res_full + 8u * (1 + STAGES + st); };

  const int bh = blockIdx.x;
  const int qb = p.nqb - 1 - (int)blockIdx.y;   // heavy blocks first
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int kvh = h / p.G;
  int kt_begin, kt_end;
  p.d.k_tiles_of_block(qb, kt_begin, kt_end);
  const int n = imax(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kBwdConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, broadcast from lane 0: 0 and 1 the consumer warpgroups, 2
  // the producer
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    regs_producer();
    if (threadIdx.x == kBwdConsumers && n > 0) {
      mbar_expect_tx(res_full, 4 * L::kTile);
      for (int r = 0; r < 2; ++r) {
        const int q0 = imin(2 * qb + r, p.d.nq_tiles - 1) * BM;
        for (int c = 0; c < HD / kAtom; ++c) {
          tma_load(sQ + r * L::kTile + c * kBox, &p.tq, res_full, c * kAtom,
                   h, q0, b);
          tma_load(sDO + r * L::kTile + c * kBox, &p.tdo, res_full,
                   c * kAtom, h, q0, b);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES;
        const int k0 = (kt_begin + i) * BN;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kTile);
        for (int c = 0; c < HD / kAtom; ++c) {
          tma_load(sK + st * L::kTile + c * kBox, &p.tk, full(st), c * kAtom,
                   kvh, k0, b);
          tma_load(sV + st * L::kTile + c * kBox, &p.tv, full(st), c * kAtom,
                   kvh, k0, b);
        }
      }
    }
  } else {
    regs_consumer();
    const int w = role;                      // this warpgroup's half
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0, r0 + 8
    const int c0 = 2 * (lane & 3);           // and columns 8j + c0, + 1
    const int q0 = (2 * qb + w) * BM;
    float2* rows = sLD + w * BM;

    // (lse2, D) of the half's rows: two threads a row, half the head dim
    // each; rows past Sq take (+inf, 0)
    {
      const int row = t >> 1, half = t & 1;
      const int qrow = q0 + row;
      const bool in = qrow < p.d.Sq;
      float acc = 0.f;
      if (in) {
        const uint4* po = reinterpret_cast<const uint4*>(
            p.o + b * p.o_sb + qrow * p.o_ss + h * p.o_sh + half * (HD / 2));
        const uint4* pd = reinterpret_cast<const uint4*>(
            p.dout + b * p.do_sb + qrow * p.do_ss + h * p.do_sh
            + half * (HD / 2));
#pragma unroll
        for (int c = 0; c < HD / 16; ++c) acc += dot8(po[c], pd[c]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        const float2 v = in ? make_float2(p.lse[(long long)bh * p.d.Sq + qrow],
                                          acc)
                            : make_float2(CUDART_INF_F, 0.f);
        rows[row] = v;
        p.ld[(long long)bh * p.Sq_pad + qrow] = v;
      }
      bar_sync(1 + w, 128);
    }
    float lse2[2], dd[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 v = rows[r0 + 8 * i];
      lse2[i] = v.x;
      dd[i] = v.y;
    }

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    float s[32], dp[32];
    uint32_t pa[4][4];
    const int first_q = p.d.q_offset + q0;
    const uint32_t tQ = sQ + w * L::kTile, tDO = sDO + w * L::kTile;
    if (n > 0) mbar_wait(res_full, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const int k_lo = (kt_begin + i) * BN;
      const uint32_t tk = sK + st * L::kTile, tv = sV + st * L::kTile;
      mbar_wait(full(st), (i / STAGES) & 1);
      wg_fence();
      wg_abt<HD>(s, tQ, tk);       // S = Q K^T
      wg_abt<HD>(dp, tDO, tv);     // dP = dO V^T
      wg_commit();
      wg_wait<0>();
      pin(s);
      pin(dp);
      with_flags(p.softcap > 0.f, p.d.edge(q0, k_lo), [&](auto cap,
                                                          auto mask) {
        constexpr bool CAP = decltype(cap)::value;
        constexpr bool MASK = decltype(mask)::value;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool ok = !MASK || p.d.visible(first_q + r0 + 8 * r,
                                                 k_lo + 8 * j + c0 + (e & 1));
            p_ds<CAP, MASK>(s[4 * j + e], dp[4 * j + e], lse2[r], dd[r], ok,
                            p);
          }
        }
      });
      pack_a(pa, dp);
      wg_fence();
      wg_at<HD>(dq, pa, tk);       // dQ += dS K
      wg_commit();
      wg_wait<0>();
      pin(dq);
      pin(pa);
      mbar_arrive(empty(st));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qrow = q0 + r0 + 8 * i;
      if (qrow < p.d.Sq)
        store_row<HD>(p.dq + b * p.dq_sb + qrow * p.dq_ss + h * p.dq_sh, dq,
                      i, c0, p.scale);
    }
  }
}

// The block's key block, part and parts, and its partials' first slot (-1
// uncut), from its unit (blockIdx.x / (B Hkv)) and the schedule
__device__ __forceinline__ void dkdv_unit(const BwdSchedule& s, int nkb,
                                          int u, int& kb, int& part,
                                          int& parts, int& poff) {
  if (s.n_split == 0) {
    kb = u;
    part = 0;
    parts = 1;
    poff = -1;
    return;
  }
  int lo = 0, hi = nkb;            // first[lo] <= u < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (s.first[mid] <= u) lo = mid;
    else hi = mid;
  }
  kb = lo;
  part = u - s.first[lo];
  parts = s.first[lo + 1] - s.first[lo];
  poff = s.poff[lo] == 0xFFFF ? -1 : s.poff[lo];
}

// The dk/dv pass: one block owns one (batch*kv head, 128-key block), K and
// V resident, one 64-key half a warpgroup, and walks a run of the items
// that visit it: every (query head of the kv head, q tile) pair, head by
// head, Q, dO and the tile's (lse2, D) through the ring, each ring tile
// feeding both halves.  It works on the transposed products (S^T = K Q^T,
// dP^T = V dO^T), so its rows are keys and P^T and dS^T are the A
// fragments of dV += P^T dO and dK += dS^T Q, as P is of the forward's P V.
// dK and dV stay in registers over the run, in one fixed order.  A key
// block whose items are split over several blocks has each write its f32
// sums to its partial slot; the sum pass adds them in part order.  No
// atomics: the same bits on every launch.
template <int HD, int STAGES>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ BwdParams p) {
  using L = BwdSmem<HD, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base + L::kA0, sV = base + L::kA1;
  const uint32_t sQ = base + L::kR0, sDO = base + L::kR1;
  const uint32_t sLDu = base + L::kLD;
  const float2* sLD = reinterpret_cast<const float2*>(smem_raw + (base - raw)
                                                      + L::kLD);
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int st) { return res_full + 8u * (1 + st); };
  auto empty = [&](int st) { return res_full + 8u * (1 + STAGES + st); };

  const int bkv = blockIdx.x % p.bhkv;
  const int u = blockIdx.x / p.bhkv;
  const int b = bkv / p.Hkv;
  const int kvh = bkv % p.Hkv;
  int kb, part, parts, poff;
  dkdv_unit(p.sched, (p.d.nk_tiles + 1) / 2, u, kb, part, parts, poff);
  const int k0 = kb * BR;
  int qt_lo, qt_hi;
  p.d.q_tiles(2 * kb, imin(2 * kb + 2, p.d.nk_tiles), qt_lo, qt_hi);
  const int nqi = imax(qt_hi - qt_lo, 0);
  const int items = nqi * p.G;
  const int i_begin = part * items / parts;
  const int n = (part + 1) * items / parts - i_begin;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kBwdConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    regs_producer();
    if (threadIdx.x == kBwdConsumers && n > 0) {
      mbar_expect_tx(res_full, 4 * L::kTile);
      for (int r = 0; r < 2; ++r) {
        // a half past the last k tile loads the last tile again: its keys
        // are masked (kp >= Sk), so it adds nothing and stores nothing
        const int kr = imin(2 * kb + r, p.d.nk_tiles - 1) * BN;
        for (int c = 0; c < HD / kAtom; ++c) {
          tma_load(sK + r * L::kTile + c * kBox, &p.tk, res_full, c * kAtom,
                   kvh, kr, b);
          tma_load(sV + r * L::kTile + c * kBox, &p.tv, res_full, c * kAtom,
                   kvh, kr, b);
        }
      }
      for (int j = 0; j < n; ++j) {
        const int i = i_begin + j;
        const int st = j % STAGES;
        const int h = kvh * p.G + i / nqi;
        const int q0 = (qt_lo + i % nqi) * BM;
        mbar_wait(empty(st), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kTile + BM * 8);
        for (int c = 0; c < HD / kAtom; ++c) {
          tma_load(sQ + st * L::kTile + c * kBox, &p.tq, full(st), c * kAtom,
                   h, q0, b);
          tma_load(sDO + st * L::kTile + c * kBox, &p.tdo, full(st),
                   c * kAtom, h, q0, b);
        }
        bulk_load(sLDu + st * BM * 8,
                  p.ld + ((long long)(b * p.Hq + h) * p.Sq_pad + q0), BM * 8,
                  full(st));
      }
    }
  } else {
    regs_consumer();
    const int w = role;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's keys: r0, r0 + 8
    const int c0 = 2 * (lane & 3);           // and queries 8j + c0, + 1
    const int k_lo = k0 + w * BN;
    const uint32_t tK = sK + w * L::kTile, tV = sV + w * L::kTile;

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t pa[4][4], pb[4][4];
    if (n > 0) mbar_wait(res_full, 0);
    for (int j = 0; j < n; ++j) {
      const int i = i_begin + j;
      const int st = j % STAGES;
      const int q0 = (qt_lo + i % nqi) * BM;
      const uint32_t tq = sQ + st * L::kTile, tdo = sDO + st * L::kTile;
      mbar_wait(full(st), (j / STAGES) & 1);
      wg_fence();
      wg_abt<HD>(s, tK, tq);       // S^T = K Q^T
      wg_abt<HD>(dp, tV, tdo);     // dP^T = V dO^T
      wg_commit();
      wg_wait<0>();
      pin(s);
      pin(dp);
      const int first_q = p.d.q_offset + q0;
      const float2* ld = sLD + st * BM;
      with_flags(p.softcap > 0.f, p.d.edge(q0, k_lo), [&](auto cap,
                                                          auto mask) {
        constexpr bool CAP = decltype(cap)::value;
        constexpr bool MASK = decltype(mask)::value;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          // (lse2, D) of queries 8jj + c0 and + 1
          const float4 v = *reinterpret_cast<const float4*>(ld + 8 * jj + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * jj + c0 + (e & 1);
            const bool ok = !MASK || p.d.visible(first_q + col,
                                                 k_lo + r0 + 8 * (e >> 1));
            p_ds<CAP, MASK>(s[4 * jj + e], dp[4 * jj + e],
                            (e & 1) ? v.z : v.x, (e & 1) ? v.w : v.y, ok, p);
          }
        }
      });
      pack_a(pa, s);
      pack_a(pb, dp);
      wg_fence();
      wg_at<HD>(dv, pa, tdo);      // dV += P^T dO
      wg_at<HD>(dk, pb, tq);       // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      pin(dv);
      pin(dk);
      pin(pa);
      pin(pb);
      mbar_arrive(empty(st));
    }

    if (poff < 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kp = k_lo + r0 + 8 * i;
        if (kp >= p.d.Sk) continue;
        store_row<HD>(p.dk + b * p.dk_sb + kp * p.dk_ss + kvh * p.dk_sh, dk,
                      i, c0, p.scale);
        store_row<HD>(p.dv + b * p.dv_sb + kp * p.dv_ss + kvh * p.dv_sh, dv,
                      i, c0, 1.f);
      }
    } else {
      // slot (bkv, poff + part): dK's 128 x HD f32, then dV's
      float* slot = p.part + ((long long)bkv * p.sched.split_parts + poff
                              + part) * (2 * BR * HD);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = w * BM + r0 + 8 * i;
        store_row_f32<HD>(slot + row * HD, dk, i, c0);
        store_row_f32<HD>(slot + BR * HD + row * HD, dv, i, c0);
      }
    }
  }
}

// The sum pass: a split key block's partials added in part order, dK times
// the scale, to bf16.  One block a (split key block, 32 rows, batch*kv
// head), four columns a thread.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const __grid_constant__ BwdParams p) {
  const int s = blockIdx.x / (BR / kSumRows);
  const int rows0 = (blockIdx.x % (BR / kSumRows)) * kSumRows;
  const int bkv = blockIdx.y;
  const int b = bkv / p.Hkv;
  const int kvh = bkv % p.Hkv;
  const int kb = p.sched.split_kb[s];
  const int parts = p.sched.first[kb + 1] - p.sched.first[kb];
  const float* slots = p.part + ((long long)bkv * p.sched.split_parts
                                 + p.sched.poff[kb]) * (2 * BR * HD);
  for (int idx = threadIdx.x; idx < kSumRows * HD / 4; idx += 256) {
    const int row = rows0 + idx / (HD / 4);
    const int col = (idx % (HD / 4)) * 4;
    const int kp = kb * BR + row;
    if (kp >= p.d.Sk) continue;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    for (int q = 0; q < parts; ++q) {
      const float* src = slots + (long long)q * (2 * BR * HD) + row * HD + col;
      const float4 x = *reinterpret_cast<const float4*>(src);
      const float4 y = *reinterpret_cast<const float4*>(src + BR * HD);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    *reinterpret_cast<uint2*>(p.dk + b * p.dk_sb + kp * p.dk_ss
                              + kvh * p.dk_sh + col) =
        make_uint2(pack_bf16(a.x * p.scale, a.y * p.scale),
                   pack_bf16(a.z * p.scale, a.w * p.scale));
    *reinterpret_cast<uint2*>(p.dv + b * p.dv_sb + kp * p.dv_ss
                              + kvh * p.dv_sh + col) =
        make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
  }
}

// ---- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// cuTensorMapEncodeTiled is a driver call and needs a current context: a
// thread that has made no runtime call yet (autograd's backward thread,
// say) has none until cudaSetDevice makes the device's primary context
// current there
int bind_context() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  return (int)e;
}

// A tensor map over a [B, S, H, hd] bf16 tensor with element strides
// (sb, ss, sh) and a contiguous head dim, in 64 x 64 boxes (one head, 64
// rows, 64 columns), 128-byte swizzled; rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
             long long sb, long long ss, long long sh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H,
                        (cuuint64_t)(S > 0 ? S : 1), (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                           (cuuint64_t)sb * 2};
  // a dimension of size 1 is never stepped: give it a stride TMA accepts
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = (i == 0 ? dims[0] * 2 : strides[i - 1] * dims[i]);
  }
  cuuint32_t box[4] = {(cuuint32_t)kAtom, 1, (cuuint32_t)BN, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the kernel's dynamic shared-memory limit raised to `smem`, once per card
// (`raised` is the kernel's own flag array)
template <typename Kernel>
int raise_smem(Kernel kernel, size_t smem, std::atomic<bool>* raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  return 0;
}

template <int HD, int STAGES, int MIN_BLOCKS>
int launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const size_t smem = Smem<HD, STAGES>::kBytes + 1024;   // + alignment slack
  auto kernel = flash_fwd_kernel<HD, STAGES, MIN_BLOCKS>;
  static std::atomic<bool> raised[kMaxDevices] = {};
  const int err = raise_smem(kernel, smem, raised);
  if (err) return err;
  dim3 grid((unsigned)batch_heads, (unsigned)p.nq_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- the backward's schedule (host)

struct BwdPlan {
  Dims d;
  int B, Hq, Hkv, hd;
  int nqb, nkb, Sq_pad;
  BwdSchedule sched;
  long long ld_bytes, part_bytes;
  long long dq_blocks, dkdv_blocks, sum_blocks;
  long long dq_items, dkdv_items;
  int dq_heaviest, dkdv_heaviest, chunk;
};

// The dq pass has one block a (batch*head, q block), heaviest first.  The
// dk/dv pass has an item a (query head, q tile) that visits a key block,
// and one block a (batch*kv head, key block).  Where that grid would leave
// SMs idle (fewer blocks than kPlanSms), each key block is cut into runs of
// at most T items, T the least for which the runs still fit one wave.
void make_plan(BwdPlan& pl) {
  const Dims& d = pl.d;
  const int G = pl.Hq / pl.Hkv, bhkv = pl.B * pl.Hkv, bh = pl.B * pl.Hq;
  pl.nqb = (d.nq_tiles + 1) / 2;
  pl.nkb = (d.nk_tiles + 1) / 2;
  pl.Sq_pad = pl.nqb * BR;

  pl.dq_blocks = (long long)bh * pl.nqb;
  for (int qb = 0; qb < pl.nqb; ++qb) {
    int kb, ke;
    d.k_tiles_of_block(qb, kb, ke);
    const int n = imax(ke - kb, 0);
    pl.dq_heaviest = imax(pl.dq_heaviest, n);
    pl.dq_items += (long long)n * bh;
  }

  // items[kb]: G times the q tiles that visit key block kb, in one pass
  // over the q tiles (each visits a run of key blocks)
  std::vector<int> items(pl.nkb + 1, 0);
  for (int qt = 0; qt < d.nq_tiles; ++qt) {
    int kb, ke;
    d.k_tiles(qt, kb, ke);
    if (kb >= ke) continue;
    items[kb / 2] += G;
    items[(ke + 1) / 2] -= G;
  }
  for (int kb = 0; kb < pl.nkb; ++kb) {
    if (kb > 0) items[kb] += items[kb - 1];
    pl.dkdv_items += (long long)items[kb] * bhkv;
    pl.dkdv_heaviest = imax(pl.dkdv_heaviest, items[kb]);
  }
  BwdSchedule& s = pl.sched;
  s.units = pl.nkb;
  pl.chunk = pl.dkdv_heaviest;
  if ((long long)pl.nkb * bhkv < kPlanSms) {
    auto runs = [&](int kb, int t) { return imax(1, (items[kb] + t - 1) / t); };
    auto fits = [&](int t) {
      long long units = 0;
      for (int kb = 0; kb < pl.nkb; ++kb) units += runs(kb, t);
      return units * bhkv <= kPlanSms;
    };
    // the runs only shrink as T grows, and T = the heaviest leaves every
    // key block whole, which fits
    int lo = 1, hi = imax(pl.dkdv_heaviest, 1);
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (fits(mid)) hi = mid;
      else lo = mid + 1;
    }
    const int T = lo;
    s.units = 0;
    pl.chunk = T;
    pl.dkdv_heaviest = 0;
    for (int kb = 0; kb < pl.nkb; ++kb) {
      const int np = runs(kb, T);
      s.first[kb] = (uint16_t)s.units;
      s.units += np;
      s.poff[kb] = 0xFFFF;
      if (np > 1) {
        s.poff[kb] = (uint16_t)s.split_parts;
        s.split_parts += np;
        s.split_kb[s.n_split++] = (uint16_t)kb;
      }
      pl.dkdv_heaviest = imax(pl.dkdv_heaviest, (items[kb] + np - 1) / np);
    }
    s.first[pl.nkb] = (uint16_t)s.units;
  }
  pl.dkdv_blocks = (long long)s.units * bhkv;
  pl.sum_blocks = (long long)s.n_split * (BR / kSumRows) * bhkv;
  pl.ld_bytes = (long long)bh * pl.Sq_pad * 8;
  pl.part_bytes = (long long)bhkv * s.split_parts * 2 * BR * pl.hd * 4;
}

// the plan of a shape: a few loops over its tiles, made afresh each launch
BwdPlan plan_of(int B, int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                int window, int q_offset) {
  BwdPlan pl;
  std::memset(&pl, 0, sizeof(pl));
  pl.d.Sq = Sq;
  pl.d.Sk = Sk;
  pl.d.nq_tiles = (Sq + BM - 1) / BM;
  pl.d.nk_tiles = (Sk + BN - 1) / BN;
  pl.d.causal = causal != 0;
  pl.d.window = window;
  pl.d.q_offset = q_offset;
  pl.B = B;
  pl.Hq = Hq;
  pl.Hkv = Hkv;
  pl.hd = hd;
  make_plan(pl);
  return pl;
}

// the dq pass (which writes lse2 and D), the dk/dv pass (which reads them),
// then the sum pass where a key block is split, on one stream
template <int HD, int STAGES>
int launch_bwd(const BwdParams& p, const BwdPlan& pl, cudaStream_t stream) {
  const size_t smem = BwdSmem<HD, STAGES>::kBytes + 1024;   // + alignment
  auto dq_kernel = flash_bwd_dq_kernel<HD, STAGES>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<HD, STAGES>;
  static std::atomic<bool> raised_dq[kMaxDevices] = {};
  static std::atomic<bool> raised_dkdv[kMaxDevices] = {};
  int err = raise_smem(dq_kernel, smem, raised_dq);
  if (!err) err = raise_smem(dkdv_kernel, smem, raised_dkdv);
  if (err) return err;
  dq_kernel<<<dim3((unsigned)(pl.B * pl.Hq), (unsigned)pl.nqb), kBwdThreads,
              smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<<<(unsigned)pl.dkdv_blocks, kBwdThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || pl.sched.n_split == 0) return (int)e;
  flash_bwd_sum_kernel<HD><<<dim3((unsigned)(pl.sched.n_split
                                             * (BR / kSumRows)),
                                  (unsigned)p.bhkv), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
}  // namespace

// C interface (loaded with ctypes).  Strides are in elements; the head dim
// of every tensor is contiguous, the others are multiples of 8 elements and
// the bases 16-byte aligned (TMA's rules).  lse: null, or B*Hq*Sq f32 that
// takes each row's log-sum-exp in the log2 domain (see the header).
// Returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// head dim the kernel is not built for or a tensor map
// cuTensorMapEncodeTiled refuses.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int Sq, int Sk, int Hq, int Hkv, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  Params p;
  int err = bind_context();
  if (!err) err = make_map(&p.tq, q, B, Sq, Hq, hd, q_sb, q_ss, q_sh);
  if (!err) err = make_map(&p.tk, k, B, Sk, Hkv, hd, k_sb, k_ss, k_sh);
  if (!err) err = make_map(&p.tv, v, B, Sk, Hkv, hd, v_sb, v_ss, v_sh);
  if (err) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.G = Hq / Hkv;
  p.nq_tiles = (Sq + BM - 1) / BM;
  if (p.nq_tiles > 65535) return (int)cudaErrorInvalidValue;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  const float scale = 1.f / sqrtf((float)hd);
  p.scale_log2 = scale * LOG2E;
  p.softcap = softcap;
  p.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_out = softcap * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ring depth and blocks per SM: 3 and 3 at hd 64 (57 KB of shared
  // memory, at most 136 registers a thread); 2 and 2 at hd 128 (81 KB)
  return hd == 64 ? launch<64, 3, 3>(p, B * Hq, s)
                  : launch<128, 2, 2>(p, B * Hq, s);
}

// The backward's plan (C interface, loaded with ctypes): for a shape,
// fills out[0 .. n_out) with, in order, the scratch bytes
// flash_attention_bwd_launch needs (`dd`), the SMs the plan assumes, the dq
// pass's blocks, items and heaviest block (items), the dk/dv pass's the
// same, its chunk bound T, its split key blocks, their partial slots, the
// sum pass's blocks, and the key blocks.  Needs no card.  Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int flash_attention_bwd_plan(int B, int Sq, int Sk, int Hq,
                                        int Hkv, int hd, int causal,
                                        int window, int q_offset,
                                        long long* out, int n_out) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv
      || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const BwdPlan pl = plan_of(B, Sq, Sk, Hq, Hkv, hd, causal, window,
                             q_offset);
  const long long v[] = {pl.ld_bytes + pl.part_bytes, kPlanSms, pl.dq_blocks,
                         pl.dq_items, pl.dq_heaviest, pl.dkdv_blocks,
                         pl.dkdv_items, pl.dkdv_heaviest, pl.chunk,
                         pl.sched.n_split, pl.sched.split_parts,
                         pl.sum_blocks, pl.nkb};
  for (int i = 0; i < n_out && i < (int)(sizeof(v) / sizeof(v[0])); ++i)
    out[i] = v[i];
  return 0;
}

// The backward (C interface, loaded with ctypes).  q, k, v, o and dout as
// the forward takes them (TMA's rules for q, k, v and dout; o and dout are
// read 16 bytes at a time, so their strides are multiples of 8 elements
// too); lse: the forward's, B*Hq*Sq f32; dd: scratch of the bytes
// flash_attention_bwd_plan gives, 16-byte aligned (each query row's lse2
// and D, then the split key blocks' partials); dq, dk, dv: bf16 in q's and
// k's shapes, each written whole.  Every query row must see at least one
// key.  Launches the dq pass, the dk/dv pass and, where the plan splits a
// key block, the sum pass, on `stream`; returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue as the forward does.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dd, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    int causal, int window, float softcap, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if ((hd != 64 && hd != 128) || Sk <= 0 || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  if ((Sq + BR - 1) / BR > 65535) return (int)cudaErrorInvalidValue;
  BwdParams p;
  int err = bind_context();
  if (!err) err = make_map(&p.tq, q, B, Sq, Hq, hd, q_sb, q_ss, q_sh);
  if (!err) err = make_map(&p.tk, k, B, Sk, Hkv, hd, k_sb, k_ss, k_sh);
  if (!err) err = make_map(&p.tv, v, B, Sk, Hkv, hd, v_sb, v_ss, v_sh);
  if (!err) err = make_map(&p.tdo, dout, B, Sq, Hq, hd, do_sb, do_ss, do_sh);
  if (err) return err;
  const BwdPlan pl = plan_of(B, Sq, Sk, Hq, Hkv, hd, causal, window,
                             q_offset);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.lse = static_cast<const float*>(lse);
  p.ld = static_cast<float2*>(dd);
  p.part = reinterpret_cast<float*>(static_cast<char*>(dd) + pl.ld_bytes);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.d = pl.d;
  p.Hq = Hq; p.Hkv = Hkv; p.G = Hq / Hkv; p.bhkv = B * Hkv;
  p.nqb = pl.nqb; p.Sq_pad = pl.Sq_pad;
  p.scale = 1.f / sqrtf((float)hd);
  p.scale_log2 = p.scale * LOG2E;
  p.softcap = softcap;
  p.cap_in = softcap > 0.f ? p.scale / softcap : 0.f;
  p.cap_out = softcap * LOG2E;
  p.sched = pl.sched;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ring depth 4 at hd 64 (99 KB of shared memory), 3 at hd 128 (163 KB);
  // one block an SM, its consumers at up to 240 registers a thread
  return hd == 64 ? launch_bwd<64, 4>(p, pl, s)
                  : launch_bwd<128, 3>(p, pl, s);
}
