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
// Two launches and no atomics, so every sum runs in one fixed order and a
// launch repeats bit for bit:
//   - the dq pass: one block a (batch*head, 64-row q tile), Q and dO
//     resident, K and V streamed through the TMA ring over the k tiles the
//     forward visited; S = Q K^T and dP = dO V^T as one group of wgmma,
//     then dQ += dS K with dS from registers.  Its prologue computes D for
//     its rows into shared memory and into a [B, Hq, Sq] buffer;
//   - the dk/dv pass: one block a (batch*kv head, 64-key k tile), K and V
//     resident, walking every q tile that visits it for each of the G query
//     heads of the kv head, Q and dO streamed through the ring.  It computes
//     the transposed products, S^T = K Q^T and dP^T = V dO^T, so P^T and
//     dS^T sit in registers as the A fragments of dV += P^T dO and dK +=
//     dS^T Q, exactly as P does for the forward's P V: every product of
//     both passes is one of the forward's two wgmma shapes on the same
//     swizzled tiles.  dK and dV stay in registers over all G heads.
//   Each product group is waited for before the elementwise work (no
//   overlap of the products with the exp inside a block; blocks on one SM
//   fill each other's gaps).
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
struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;  // (hd, H, S, B) views of q, k, v and dO
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  const float* lse;             // [B, Hq, Sq], the forward's (log2 domain)
  float* dd;                    // [B, Hq, Sq]: D, written by the dq pass
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int Sq, Sk, Hq, Hkv, G, nq_tiles, nk_tiles;
  int causal, window, q_offset;
  float scale, scale_log2;      // 1 / sqrt(hd); times log2(e)
  float softcap, cap_in, cap_out;
};

// shared memory of either pass: two resident 64-row tiles (A0, A1), a ring
// of STAGES pairs (R0, R1), D of the q tile (the dq pass), the barriers:
// the residents' full, then R0's and R1's full, then their empty, a slot
// each.  dq pass: A0 = Q, A1 = dO, R0 = K, R1 = V; dk/dv pass: A0 = K,
// A1 = V, R0 = Q, R1 = dO.
template <int HD, int STAGES>
struct BwdSmem {
  static constexpr uint32_t kTile = BN * HD * 2;
  static constexpr uint32_t kA0 = 0;
  static constexpr uint32_t kA1 = kTile;
  static constexpr uint32_t kR0 = 2 * kTile;
  static constexpr uint32_t kR1 = kR0 + STAGES * kTile;
  static constexpr uint32_t kD = kR1 + STAGES * kTile;
  static constexpr uint32_t kBar = kD + BM * 4;
  static constexpr uint32_t kBytes = kBar + (1 + 4 * STAGES) * 8;
};

// the k tiles that q tile qt visits, [kb, ke): the forward's skips
__device__ __forceinline__ void k_tiles(const BwdParams& p, int qt, int& kb,
                                        int& ke) {
  const int q0 = qt * BM;
  const int first_q = p.q_offset + q0;
  const int last_q = p.q_offset + min(q0 + BM, p.Sq) - 1;
  kb = 0;
  ke = p.nk_tiles;
  if (p.causal) ke = min(ke, last_q / BN + 1);
  if (p.window > 0) {
    const int kmin = first_q - p.window + 1;
    kb = kmin > 0 ? kmin / BN : 0;
  }
}

// whether the (q tile at q0, k tile at k_lo) pair needs the per-element
// mask: the forward's diagonal, window-edge and ragged-Sk tiles
__device__ __forceinline__ bool edge_tile(const BwdParams& p, int q0,
                                          int k_lo) {
  const int first_q = p.q_offset + q0;
  return k_lo + BN > p.Sk || (p.causal && k_lo + BN - 1 > first_q)
         || (p.window > 0 && k_lo <= first_q + BM - 1 - p.window);
}

__device__ __forceinline__ bool visible(const BwdParams& p, int qp, int kp) {
  bool ok = kp < p.Sk;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// P and dS of one logit, in place: s = q.k on entry, P on exit; dp = dO.v
// on entry, dS on exit.  P = exp2(y - lse2), y the logit in the forward's
// log2 domain; dS = P (dP - D), times the softcap's 1 - tanh^2 (the scale
// multiplies the finished sums once).  A masked logit takes the forward's
// -1e30, so P = 0; lse2 = +inf (a row past Sq) gives P = 0 too.
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2, float d,
                                     bool ok, const BwdParams& p) {
  float y, fac = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(s * p.cap_in);
    y = p.cap_out * t;
    fac = 1.f - t * t;
  } else {
    y = s * p.scale_log2;
  }
  if (!ok) y = NEG_INF;
  const float pr = ex2(y - lse2);
  s = pr;
  dp = pr * (dp - d) * fac;
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

// The dq pass: one block owns one (batch*head, 64-row q tile), Q and dO
// resident, and walks the k tiles the forward visited, K and V through the
// ring.  Its prologue computes D = rowsum(dO o) of the tile (read once
// from device memory) into shared memory and into dd for the dk/dv pass.
template <int HD, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  using L = BwdSmem<HD, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kA0, sDO = base + L::kA1;
  const uint32_t sK = base + L::kR0, sV = base + L::kR1;
  float* sD = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kD);
  const uint32_t res_full = base + L::kBar;
  auto k_full = [&](int st) { return res_full + 8u * (1 + st); };
  auto v_full = [&](int st) { return res_full + 8u * (1 + STAGES + st); };
  auto k_empty = [&](int st) { return res_full + 8u * (1 + 2 * STAGES + st); };
  auto v_empty = [&](int st) { return res_full + 8u * (1 + 3 * STAGES + st); };

  const int bh = blockIdx.x;
  const int qt = p.nq_tiles - 1 - (int)blockIdx.y;   // heavy tiles first
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int kvh = h / p.G;
  const int q0 = qt * BM;
  int kt_begin, kt_end;
  k_tiles(p, qt, kt_begin, kt_end);
  const int n = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumers);
      mbar_init(v_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / kConsumers, 0);
  if (role != 0) {
    if (threadIdx.x == kConsumers && n > 0) {
      mbar_expect_tx(res_full, 2 * L::kTile);
      for (int c = 0; c < HD / kAtom; ++c) {
        tma_load(sQ + c * kBox, &p.tq, res_full, c * kAtom, h, q0, b);
        tma_load(sDO + c * kBox, &p.tdo, res_full, c * kAtom, h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES;
        const uint32_t ph = ((i / STAGES) & 1) ^ 1;
        const int k0 = (kt_begin + i) * BN;
        mbar_wait(k_empty(st), ph);
        mbar_expect_tx(k_full(st), L::kTile);
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load(sK + st * L::kTile + c * kBox, &p.tk, k_full(st),
                   c * kAtom, kvh, k0, b);
        mbar_wait(v_empty(st), ph);
        mbar_expect_tx(v_full(st), L::kTile);
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load(sV + st * L::kTile + c * kBox, &p.tv, v_full(st),
                   c * kAtom, kvh, k0, b);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + (lane >> 2);   // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);            // and columns 8j + c0, + 1

  // D of the tile: two threads a row, half the head dim each
  {
    const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int qrow = q0 + row;
    float acc = 0.f;
    if (qrow < p.Sq) {
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
      sD[row] = acc;
      if (qrow < p.Sq) p.dd[(long long)bh * p.Sq + qrow] = acc;
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
  }
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = q0 + r0 + 8 * i;
    lse2[i] = qrow < p.Sq ? p.lse[(long long)bh * p.Sq + qrow] : CUDART_INF_F;
    dd[i] = sD[r0 + 8 * i];
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4];
  const int first_q = p.q_offset + q0;
  if (n > 0) mbar_wait(res_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k_lo = (kt_begin + i) * BN;
    const uint32_t tk = sK + st * L::kTile, tv = sV + st * L::kTile;
    mbar_wait(k_full(st), ph);
    mbar_wait(v_full(st), ph);
    wg_fence();
    wg_abt<HD>(s, sQ, tk);       // S = Q K^T
    wg_abt<HD>(dp, sDO, tv);     // dP = dO V^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    mbar_arrive(v_empty(st));
    const bool edge = edge_tile(p, q0, k_lo);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = !edge || visible(p, first_q + r0 + 8 * r,
                                         k_lo + 8 * j + c0 + (e & 1));
        p_ds(s[4 * j + e], dp[4 * j + e], lse2[r], dd[r], ok, p);
      }
    }
    pack_a(pa, dp);
    wg_fence();
    wg_at<HD>(dq, pa, tk);       // dQ += dS K
    wg_commit();
    wg_wait<0>();
    pin(dq);
    pin(pa);
    mbar_arrive(k_empty(st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = q0 + r0 + 8 * i;
    if (qrow < p.Sq)
      store_row<HD>(p.dq + b * p.dq_sb + qrow * p.dq_ss + h * p.dq_sh, dq, i,
                    c0, p.scale);
  }
}

// The dk/dv pass: one block owns one (batch*kv head, 64-key k tile), K and
// V resident, and walks every q tile that visits it, for each of the G
// query heads of its kv head in turn, Q and dO through the ring.  It works
// on the transposed products (S^T = K Q^T, dP^T = V dO^T), so its rows are
// keys and P^T and dS^T are the A fragments of dV += P^T dO and dK += dS^T
// Q, as P is of the forward's P V.  dK and dV stay in registers across all
// G heads and q tiles, in one fixed order: no atomics, the same bits on
// every launch.
template <int HD, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
flash_bwd_dkdv_kernel(const __grid_constant__ BwdParams p) {
  using L = BwdSmem<HD, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base + L::kA0, sV = base + L::kA1;
  const uint32_t sQ = base + L::kR0, sDO = base + L::kR1;
  const uint32_t res_full = base + L::kBar;
  auto q_full = [&](int st) { return res_full + 8u * (1 + st); };
  auto do_full = [&](int st) { return res_full + 8u * (1 + STAGES + st); };
  auto q_empty = [&](int st) { return res_full + 8u * (1 + 2 * STAGES + st); };
  auto do_empty = [&](int st) { return res_full + 8u * (1 + 3 * STAGES + st); };

  const int b = blockIdx.x / p.Hkv;
  const int kvh = blockIdx.x % p.Hkv;
  const int kt = blockIdx.y;                 // k tile 0 (the heaviest) first
  const int k0 = kt * BN;
  // the q tiles that visit this k tile: a contiguous run, as the forward's
  // k-tile range only grows with the q tile
  int qt_lo = p.nq_tiles, qt_hi = 0;
  for (int qt = 0; qt < p.nq_tiles; ++qt) {
    int kb, ke;
    k_tiles(p, qt, kb, ke);
    if (kb <= kt && kt < ke) {
      qt_lo = min(qt_lo, qt);
      qt_hi = qt + 1;
    }
  }
  const int nqi = max(qt_hi - qt_lo, 0);
  const int items = nqi * p.G;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(q_full(st), 1);
      mbar_init(do_full(st), 1);
      mbar_init(q_empty(st), kConsumers);
      mbar_init(do_empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / kConsumers, 0);
  if (role != 0) {
    if (threadIdx.x == kConsumers && items > 0) {
      mbar_expect_tx(res_full, 2 * L::kTile);
      for (int c = 0; c < HD / kAtom; ++c) {
        tma_load(sK + c * kBox, &p.tk, res_full, c * kAtom, kvh, k0, b);
        tma_load(sV + c * kBox, &p.tv, res_full, c * kAtom, kvh, k0, b);
      }
      for (int i = 0; i < items; ++i) {
        const int st = i % STAGES;
        const uint32_t ph = ((i / STAGES) & 1) ^ 1;
        const int h = kvh * p.G + i / nqi;
        const int q0 = (qt_lo + i % nqi) * BM;
        mbar_wait(q_empty(st), ph);
        mbar_expect_tx(q_full(st), L::kTile);
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load(sQ + st * L::kTile + c * kBox, &p.tq, q_full(st),
                   c * kAtom, h, q0, b);
        mbar_wait(do_empty(st), ph);
        mbar_expect_tx(do_full(st), L::kTile);
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load(sDO + st * L::kTile + c * kBox, &p.tdo, do_full(st),
                   c * kAtom, h, q0, b);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + (lane >> 2);   // this thread's keys: r0, r0 + 8
  const int c0 = 2 * (lane & 3);            // and queries 8j + c0, + 1

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4], pb[4][4];
  if (items > 0) mbar_wait(res_full, 0);
  for (int i = 0; i < items; ++i) {
    const int st = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int h = kvh * p.G + i / nqi;
    const int q0 = (qt_lo + i % nqi) * BM;
    const long long row = (long long)(b * p.Hq + h) * p.Sq;
    // lse and D of the tile's 64 queries, lane L holding queries L and
    // L + 32; each thread takes its columns' values by shuffles below
    float lse_lo = CUDART_INF_F, lse_hi = CUDART_INF_F, d_lo = 0.f, d_hi = 0.f;
    if (q0 + lane < p.Sq) {
      lse_lo = p.lse[row + q0 + lane];
      d_lo = p.dd[row + q0 + lane];
    }
    if (q0 + 32 + lane < p.Sq) {
      lse_hi = p.lse[row + q0 + 32 + lane];
      d_hi = p.dd[row + q0 + 32 + lane];
    }
    const uint32_t tq = sQ + st * L::kTile, tdo = sDO + st * L::kTile;
    mbar_wait(q_full(st), ph);
    mbar_wait(do_full(st), ph);
    wg_fence();
    wg_abt<HD>(s, sK, tq);       // S^T = K Q^T
    wg_abt<HD>(dp, sV, tdo);     // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    const bool edge = edge_tile(p, q0, k0);
    const int first_q = p.q_offset + q0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c0 + (e & 1);
        const float l2 = __shfl_sync(0xffffffffu, j < 4 ? lse_lo : lse_hi,
                                     col & 31);
        const float d = __shfl_sync(0xffffffffu, j < 4 ? d_lo : d_hi,
                                    col & 31);
        const bool ok = !edge || visible(p, first_q + col,
                                         k0 + r0 + 8 * (e >> 1));
        p_ds(s[4 * j + e], dp[4 * j + e], l2, d, ok, p);
      }
    }
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
    mbar_arrive(q_empty(st));
    mbar_arrive(do_empty(st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + r0 + 8 * i;
    if (kp >= p.Sk) continue;
    store_row<HD>(p.dk + b * p.dk_sb + kp * p.dk_ss + kvh * p.dk_sh, dk, i,
                  c0, p.scale);
    store_row<HD>(p.dv + b * p.dv_sb + kp * p.dv_ss + kvh * p.dv_sh, dv, i,
                  c0, 1.f);
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

// the dq pass (which writes D), then the dk/dv pass (which reads it), on
// one stream
template <int HD, int STAGES, int MIN_BLOCKS>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = BwdSmem<HD, STAGES>::kBytes + 1024;
  auto dq_kernel = flash_bwd_dq_kernel<HD, STAGES, MIN_BLOCKS>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<HD, STAGES, MIN_BLOCKS>;
  static std::atomic<bool> raised_dq[kMaxDevices] = {};
  static std::atomic<bool> raised_dkdv[kMaxDevices] = {};
  int err = raise_smem(dq_kernel, smem, raised_dq);
  if (!err) err = raise_smem(dkdv_kernel, smem, raised_dkdv);
  if (err) return err;
  dq_kernel<<<dim3((unsigned)(B * p.Hq), (unsigned)p.nq_tiles), kThreads,
              smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<<<dim3((unsigned)(B * p.Hkv), (unsigned)p.nk_tiles), kThreads,
                smem, stream>>>(p);
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

// The backward (C interface, loaded with ctypes).  q, k, v, o and dout as
// the forward takes them (TMA's rules for q, k, v and dout; o and dout are
// read 16 bytes at a time, so their strides are multiples of 8 elements
// too); lse: the forward's, B*Hq*Sq f32; dd: B*Hq*Sq f32 scratch for D;
// dq, dk, dv: bf16 in q's and k's shapes, each written whole.  Every query
// row must see at least one key.  Launches the dq pass, then the dk/dv
// pass, on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue as the forward does.
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
  BwdParams p;
  int err = bind_context();
  if (!err) err = make_map(&p.tq, q, B, Sq, Hq, hd, q_sb, q_ss, q_sh);
  if (!err) err = make_map(&p.tk, k, B, Sk, Hkv, hd, k_sb, k_ss, k_sh);
  if (!err) err = make_map(&p.tv, v, B, Sk, Hkv, hd, v_sb, v_ss, v_sh);
  if (!err) err = make_map(&p.tdo, dout, B, Sq, Hq, hd, do_sb, do_ss, do_sh);
  if (err) return err;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.lse = static_cast<const float*>(lse);
  p.dd = static_cast<float*>(dd);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.G = Hq / Hkv;
  p.nq_tiles = (Sq + BM - 1) / BM;
  p.nk_tiles = (Sk + BN - 1) / BN;
  if (p.nq_tiles > 65535 || p.nk_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = 1.f / sqrtf((float)hd);
  p.scale_log2 = p.scale * LOG2E;
  p.softcap = softcap;
  p.cap_in = softcap > 0.f ? p.scale / softcap : 0.f;
  p.cap_out = softcap * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ring depth 2 for both head dims (48 KB of shared memory at hd 64, 96 KB
  // at hd 128); 2 blocks an SM at hd 64 (at most 204 registers a thread),
  // 1 at hd 128 (dK and dV alone hold 128 accumulators a thread)
  return hd == 64 ? launch_bwd<64, 2, 2>(p, B, s)
                  : launch_bwd<128, 2, 1>(p, B, s);
}
