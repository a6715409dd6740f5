// rglru_scan for Hopper (sm_90a): the RG-LRU linear recurrence over time.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (`rglru_scan`, body `_scan_kernel`): h_t = a_t * h_{t-1} + b_t for
// a, b [B, S, W] f32, from h0 [B, W] (zeros when absent), giving h [B, S, W]
// f32 and h_last [B, W] (bit-equal to h[:, S-1]).  Every RG-LRU layer's
// prefill runs it on the gates that the surrounding PyTorch code computes.
//
// Bound on the card: bytes.  One FMA per element against 12 bytes moved
// (read a and b once, write h once), so the least time is
// 4 * (3 * B*S*W + 2 * B*W) bytes over the HBM rate.  This kernel reads a
// and b from device memory once and writes h once, in one launch; no
// intermediate h goes to device memory.
//
// What held the previous design back: one thread owned one (b, w) column
// and walked all of S, loads issued 8 steps ahead in registers.  At B 4,
// W 4096 that is 16,384 threads, 16,384 * 8 steps * 2 loads * 4 B = 1 MiB
// in flight; by Little's law HBM at 3.35 TB/s and 0.6-0.8 us of latency
// needs 2-2.7 MB, so it ran at about half the rate (46 % of the bound).  At
// B 1 the grid was 64 blocks of 64 threads and 256 KiB in flight.
//
// Design: split S into chunks of kL = 64 steps so the card fills at every
// shape (2,048 blocks at B 4, S 512 and at B 1, S 2048; 512 at B 1, S 512).
//   - One block owns one (b, 64-column W tile, 64-step chunk) tile: 64
//     threads, one column each.  Blocks take their logical index from an
//     atomic ticket in chunk-major order, so every chunk to the left of a
//     block's chunk started before it (forward progress for the look-back
//     below); the grid is flat, so B has no 65,535 limit.
//   - Staging.  The chunk's a and b tiles (2 x 16 KB) land in shared memory
//     by TMA, through 3-d tensor maps over the (W, S, B) view, in kBoxes
//     boxes of kBoxS steps, each completing on its own mbarrier, so pass 1
//     starts on the first box while the rest land.  A ragged S tile reads
//     TMA's zeros, never the next sequence; ragged W is zero-filled.  Six
//     blocks share an SM (33 KB each): 192 KB of loads in flight per SM and
//     about 25 MB on the card, ten times Little's requirement, without
//     spending registers on it.  TMA needs 16-byte strides and bases: for
//     W % 4 != 0 or an unaligned base the same kernel stages with 4-byte
//     `cp.async` (zero-filling what lies outside) into the same buffers,
//     each thread arriving on the same mbarriers (`.noinc`); the launch
//     function chooses.  A warp reads a[t][32 consecutive columns]: no
//     bank conflicts.
//   - Pass 1 over shared memory composes each column's chunk aggregate,
//     (A, Bc) = (prod a_t, h at the chunk's end from 0).
//   - Decoupled look-back, per column: the chunk publishes its aggregate as
//     soon as pass 1 ends, and its inclusive carry (h at its end) once it
//     has its carry-in.  It walks left composing aggregates until it finds
//     an inclusive carry, so the waits never form a serial chain.  Chunk
//     0's carry-in is h0 (or 0).  Which words it finds depends on timing,
//     and a carry composed over k > 1 aggregates rounds otherwise than the
//     chain of inclusive carries, so h can differ in its last bits from
//     one launch to the next.  With `chained` set (the wrapper sets it
//     under torch.use_deterministic_algorithms) a chunk waits for its left
//     neighbour's inclusive carry alone: carry(c) = A(c-1) * carry(c-1) +
//     Bc(c-1), the same FMAs on every launch, for a serial chain of
//     n_chunks hops.
//   - Pass 2 runs the recurrence from the carry over the same shared-memory
//     tile, writing h over the b tile, and one thread sends it out by TMA
//     stores through a third tensor map (clipped at ragged edges); the
//     cp.async route stores h from registers instead, each warp one
//     128-byte line per step.  The thread that holds t = S - 1 also writes
//     h_last from the register that gave h there.  (Stores from registers
//     in the TMA route too were slower on the H100.)
// Reverse mode (the scan's gradient, one launch; the reference's backward
// is jax.vjp of its scan, no Pallas kernel).  With g the gradient reaching
// h and g_last that of h_last, the gradient in h_t is l_{S-1} = g_{S-1} +
// g_last, l_t = g_t + a_{t+1} l_{t+1}: the same recurrence run from S - 1
// down to 0 with step t's coefficient a_{t+1}.  The same kernel walks the
// chunks in reverse ticket order and each chunk's steps from its end: the
// a tile is staged one step later (a box at t + 1; a_S, past the end,
// reads as 0 and the last chunk puts 1 there, so g_last enters as the
// carry-in of step S - 1 with coefficient 1), and a third tile holds h one
// step earlier (h_{-1} reads as 0 and is h0 where given).  Pass 2 fuses the
// epilogue: db_t = l_t over g and da_t = l_t h_{t-1} over a in shared
// memory, out by TMA stores.  One launch reads a, g and h once and writes
// da and db once: 5 * 4 * B*S*W bytes, the function's own traffic.  Its
// three tiles (48 KB) leave four blocks an SM.
// Look-back words.  Each published value is one 64-bit word, (epoch << 32)
// | the float's bits, stored with st.relaxed.gpu and polled with
// ld.relaxed.gpu: a 64-bit access is single-copy atomic, so a word whose
// epoch is this launch's holds this launch's value, and no flag, fence or
// release/acquire pair orders it (a flag per warp behind __threadfence,
// st.release and ld.acquire was slower on the H100).
// The wrapper allocates the scratch (sized by rglru_scan_scratch_bytes)
// zeroed once per stream and passes a new epoch on every launch, so a word
// of an earlier launch never reads as ready and nothing is cleared between
// launches; the block that draws the last ticket puts the ticket counter
// back to 0 for the next launch on the stream.  A wait that lasts over
// about a second traps instead of hanging the card.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#if CUDART_VERSION < 12050
#error "rglru_scan needs CUDA 12.5+ (cudaGetDriverEntryPointByVersion)"
#endif

namespace {

constexpr int kCols = 64;            // W columns per block, one a thread
constexpr int kThreads = kCols;
constexpr int kL = 64;               // time steps per chunk
constexpr int kBoxS = 16;            // time steps per box (one mbarrier)
constexpr int kBoxes = kL / kBoxS;
constexpr uint32_t kBoxBytes = kBoxS * kCols * 4;
constexpr unsigned kSpinLimit = 1u << 25;   // polls before a wait traps

struct Params {
  // (W, S, B) views (TMA route) of a, b and h; in reverse b is g, h is
  // read, and da and db are written
  CUtensorMap ta, tb, th, tda, tdb;
  const float* a;
  const float* b;              // reverse: g
  const float* init;           // the first chunk's carry-in (h0, reverse:
                               // g_last); null: zero
  const float* h0;             // reverse: h_{-1} for da; null: zeros
  float* h;                    // reverse: read, as h_{t-1}
  float* h_last;
  float* da;                   // reverse
  float* db;                   // reverse
  unsigned* counter;           // the ticket counter
  // [B][n_chunks][n_wtiles * 64] words (epoch << 32) | value bits: the
  // aggregate's A and Bc, and h at the chunk's end
  unsigned long long* agg_a;
  unsigned long long* agg_b;
  unsigned long long* incl;
  long long S, W;
  int B, n_chunks, n_wtiles;
  unsigned n_blocks, epoch;
  int chained;                 // 1: look back at inclusive carries only
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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// ---- staging
// TMA: one 3-d box (c0 = column, c1 = step, c2 = batch row)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// TMA store of one 3-d box from shared memory (clipped at the edges)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(src)
      : "memory");
}

// 4-byte cp.async; src_bytes 0 fills the word with zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// the barrier's pending count takes one arrival when this thread's earlier
// cp.async copies have landed (the count was set for it at init)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// ---- look-back words: a value and the epoch of the launch that wrote it,
// stored and loaded as one 64-bit word (single-copy atomic), so a word is
// valid on its own and needs no flag or fence
__device__ __forceinline__ void put(unsigned long long* p, float v,
                                    unsigned epoch) {
  const unsigned long long w =
      ((unsigned long long)epoch << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n"
               :: "l"(p), "l"(w) : "memory");
}

// the word's value if this launch (`epoch`) wrote it
__device__ __forceinline__ bool get(const unsigned long long* p,
                                    unsigned epoch, float& v) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(w) : "l"(p) : "memory");
  v = __uint_as_float((unsigned)w);
  return (unsigned)(w >> 32) == epoch;
}

template <bool kTma, bool kRev>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const __grid_constant__ Params p) {
  // the tiles, 128-byte aligned: a (reverse: a one step later), b (reverse:
  // g), and in reverse h one step earlier
  extern __shared__ unsigned char dyn[];
  float* const sA = reinterpret_cast<float*>(
      dyn + ((128u - (smem_u32(dyn) & 127u)) & 127u));
  float* const sB = sA + kL * kCols;
  float* const sH = sB + kL * kCols;
  __shared__ alignas(8) uint64_t bars[kBoxes];
  __shared__ unsigned s_ticket;

  const int tid = threadIdx.x;
  if (tid == 0) {
    const unsigned t = atomicAdd(p.counter, 1u);
    if (t >= p.n_blocks) __trap();            // the counter was not reset
    if (t == p.n_blocks - 1) atomicExch(p.counter, 0u);
    s_ticket = t;
    for (int i = 0; i < kBoxes; ++i)
      mbar_init(smem_u32(&bars[i]), kTma ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // logical tile, in the scan's order of chunks: every block of the chunk
  // before c (in time forward, after it in reverse) drew its ticket before
  // any block of chunk c
  const unsigned ticket = s_ticket;
  const unsigned per_chunk = (unsigned)p.B * (unsigned)p.n_wtiles;
  const int order = (int)(ticket / per_chunk);
  const int c = kRev ? p.n_chunks - 1 - order : order;
  const int rem = (int)(ticket % per_chunk);
  const int bb = rem / p.n_wtiles;
  const int wt = rem % p.n_wtiles;
  const int t0 = c * kL;
  const long long col = (long long)wt * kCols + tid;
  const bool col_ok = col < p.W;

  if (kTma) {
    if (tid == 0) {
      for (int i = 0; i < kBoxes; ++i) {
        const uint32_t bar = smem_u32(&bars[i]);
        const int ts = t0 + i * kBoxS;
        mbar_expect_tx(bar, (kRev ? 3 : 2) * kBoxBytes);
        tma_load(smem_u32(sA + i * kBoxS * kCols), &p.ta, bar, wt * kCols,
                 kRev ? ts + 1 : ts, bb);
        tma_load(smem_u32(sB + i * kBoxS * kCols), &p.tb, bar, wt * kCols,
                 ts, bb);
        if (kRev)
          tma_load(smem_u32(sH + i * kBoxS * kCols), &p.th, bar, wt * kCols,
                   ts - 1, bb);
      }
    }
  } else {
    const long long base = (long long)bb * p.S * p.W + col;
    for (int i = 0; i < kBoxes; ++i) {
#pragma unroll 4
      for (int r = 0; r < kBoxS; ++r) {
        const int t = t0 + i * kBoxS + r;
        const int ta = kRev ? t + 1 : t;
        const bool ok = col_ok && t < p.S;
        const bool ok_a = col_ok && ta < p.S;
        const long long off = ok ? base + (long long)t * p.W : 0;
        const long long off_a = ok_a ? base + (long long)ta * p.W : 0;
        const int s = (i * kBoxS + r) * kCols + tid;
        cp_async4(smem_u32(sA + s), p.a + off_a, ok_a ? 4u : 0u);
        cp_async4(smem_u32(sB + s), p.b + off, ok ? 4u : 0u);
        if (kRev) {
          const bool ok_h = col_ok && t >= 1 && t - 1 < p.S;
          const long long off_h =
              ok_h ? base + (long long)(t - 1) * p.W : 0;
          cp_async4(smem_u32(sH + s), p.h + off_h, ok_h ? 4u : 0u);
        }
      }
      cp_async_arrive(smem_u32(&bars[i]));
    }
  }

  const bool first = kRev ? c == p.n_chunks - 1 : c == 0;
  const bool last = kRev ? c == 0 : c == p.n_chunks - 1;
  const int t_end = (int)min((long long)kL, p.S - t0);   // valid steps

  // ---- pass 1: the chunk's aggregate of this column, box by box, in the
  // scan's direction
  float A = 1.0f, Bc = 0.0f;
#pragma unroll
  for (int k = 0; k < kBoxes; ++k) {
    const int i = kRev ? kBoxes - 1 - k : k;
    mbar_wait(smem_u32(&bars[i]), 0);
    if (kRev && first) {
      // the carry (h_last's gradient) enters step S - 1 with coefficient
      // 1, where a_S lies past the end (read as 0); the steps past S carry
      // it through unchanged (their g reads as 0)
      for (int r = 0; r < kBoxS; ++r)
        if (i * kBoxS + r >= t_end - 1) sA[(i * kBoxS + r) * kCols + tid] = 1.0f;
    }
#pragma unroll
    for (int q = 0; q < kBoxS; ++q) {
      const int r = kRev ? kBoxS - 1 - q : q;
      const int s = (i * kBoxS + r) * kCols + tid;
      const float at = sA[s];
      Bc = fmaf(at, Bc, sB[s]);
      A *= at;
    }
  }

  // ---- carry-in by decoupled look-back, each thread for its column
  const long long wp = (long long)p.n_wtiles * kCols;     // padded width
  const long long step = kRev ? wp : -wp;                 // toward the start
  const long long slot = ((long long)bb * p.n_chunks + c) * wp + col;
  float carry = 0.0f;
  if (first) {
    if (p.init != nullptr && col_ok) carry = p.init[(long long)bb * p.W + col];
  } else {
    if (!last && !p.chained) {
      put(&p.agg_a[slot], A, p.epoch);
      put(&p.agg_b[slot], Bc, p.epoch);
    }
    // compose the aggregates of the chunks between j and c: the carry is
    // PA * (j's inclusive carry) + PB
    float PA = 1.0f, PB = 0.0f;
    unsigned polls = 0;
    for (long long j = slot + step;;) {
      float v, ga, gb;
      if (get(&p.incl[j], p.epoch, v)) {
        carry = fmaf(PA, v, PB);
        break;
      }
      if (!p.chained && get(&p.agg_a[j], p.epoch, ga)
          && get(&p.agg_b[j], p.epoch, gb)) {
        PB = fmaf(PA, gb, PB);
        PA *= ga;
        j += step;
        continue;
      }
      if (++polls == kSpinLimit) __trap();
      __nanosleep(32);
    }
  }
  if (!last) put(&p.incl[slot], fmaf(A, carry, Bc), p.epoch);

  if (kRev) {
    // ---- pass 2 in reverse: l_t = g_t + a_{t+1} l_{t+1} from the carry,
    // then db_t = l_t and da_t = l_t h_{t-1} (h_{-1} = h0, or 0)
    if (c == 0 && p.h0 != nullptr && col_ok)
      sH[tid] = p.h0[(long long)bb * p.W + col];
    float l = carry;
    if (kTma) {
      // db over g and da over a in shared memory, then out by TMA stores
#pragma unroll
      for (int s = kL - 1; s >= 0; --s) {
        const int e = s * kCols + tid;
        l = fmaf(sA[e], l, sB[e]);
        sA[e] = l * sH[e];
        sB[e] = l;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        for (int i = 0; i < kBoxes && i * kBoxS < t_end; ++i) {
          tma_store(&p.tdb, smem_u32(sB + i * kBoxS * kCols), wt * kCols,
                    t0 + i * kBoxS, bb);
          tma_store(&p.tda, smem_u32(sA + i * kBoxS * kCols), wt * kCols,
                    t0 + i * kBoxS, bb);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    } else {
      const long long row = (long long)bb * p.S;
#pragma unroll
      for (int s = kL - 1; s >= 0; --s) {
        const int e = s * kCols + tid;
        l = fmaf(sA[e], l, sB[e]);
        if (col_ok && s < t_end) {
          const long long at = (row + t0 + s) * p.W + col;
          p.db[at] = l;
          p.da[at] = l * sH[e];
        }
      }
    }
    return;
  }

  // ---- pass 2: the recurrence from the carry, h stored per step
  const long long row = (long long)bb * p.S;
  float hv = carry;
  if (kTma) {
    // h over b in shared memory, then out by TMA stores
#pragma unroll
    for (int s = 0; s < kL; ++s) {
      hv = fmaf(sA[s * kCols + tid], hv, sB[s * kCols + tid]);
      sB[s * kCols + tid] = hv;
      if (last && col_ok && s == t_end - 1)
        p.h_last[(long long)bb * p.W + col] = hv;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < kBoxes && i * kBoxS < t_end; ++i)
        tma_store(&p.th, smem_u32(sB + i * kBoxS * kCols), wt * kCols,
                  t0 + i * kBoxS, bb);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  } else {
#pragma unroll
    for (int s = 0; s < kL; ++s) {
      hv = fmaf(sA[s * kCols + tid], hv, sB[s * kCols + tid]);
      if (col_ok && s < t_end) {
        p.h[(row + t0 + s) * p.W + col] = hv;
        if (last && s == t_end - 1) p.h_last[(long long)bb * p.W + col] = hv;
      }
    }
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

// A tensor map over a contiguous [B, S, W] f32 tensor as the 3-d (W, S, B)
// view, in (64 columns, kBoxS steps, 1 row) boxes; what lies outside reads
// as zeros.
int make_map(CUtensorMap* map, const void* ptr, long long B, long long S,
             long long W) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[2] = {(cuuint64_t)(W * 4), (cuuint64_t)(S * W * 4)};
  cuuint32_t box[3] = {(cuuint32_t)kCols, (cuuint32_t)kBoxS, 1};
  cuuint32_t unit[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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

struct Layout {
  long long agg_a, agg_b, incl, bytes;   // byte offsets and total
};

long long round_up(long long x) { return (x + 255) / 256 * 256; }

Layout layout(long long B, long long S, long long W) {
  Layout l;
  const long long words =
      B * ((S + kL - 1) / kL) * ((W + kCols - 1) / kCols * kCols);
  l.agg_a = 256;                                   // the counter comes first
  l.agg_b = l.agg_a + round_up(words * 8);
  l.incl = l.agg_b + round_up(words * 8);
  l.bytes = l.incl + round_up(words * 8);
  return l;
}

// The scratch and grid of a launch at (B, S, W) into p; false if it cannot
// take them
bool setup(Params& p, long long B, long long S, long long W, void* scratch,
           long long scratch_bytes, unsigned epoch, int chained,
           long long& n_blocks) {
  const Layout l = layout(B, S, W);
  p.n_chunks = (int)((S + kL - 1) / kL);
  p.n_wtiles = (int)((W + kCols - 1) / kCols);
  n_blocks = (long long)p.n_chunks * B * p.n_wtiles;
  if (scratch == nullptr || scratch_bytes < l.bytes || epoch == 0
      || epoch >= (1u << 31) || n_blocks >= (1ll << 31) || S >= (1ll << 31)
      || W >= (1ll << 31) || B >= (1ll << 31))
    return false;
  char* s = static_cast<char*>(scratch);
  p.counter = reinterpret_cast<unsigned*>(s);
  p.agg_a = reinterpret_cast<unsigned long long*>(s + l.agg_a);
  p.agg_b = reinterpret_cast<unsigned long long*>(s + l.agg_b);
  p.incl = reinterpret_cast<unsigned long long*>(s + l.incl);
  p.S = S;
  p.W = W;
  p.B = (int)B;
  p.n_blocks = (unsigned)n_blocks;
  p.epoch = epoch;
  p.chained = chained != 0;
  return true;
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// the tiles' dynamic shared memory (and the slack that aligns them) in
// each mode; the reverse's 48 KB take the opt-in, once per card and kernel
constexpr size_t kSmemFwd = 2 * kL * kCols * 4 + 128;
constexpr size_t kSmemRev = 3 * kL * kCols * 4 + 128;
constexpr int kMaxDevices = 64;

template <bool kTma, bool kRev>
int launch(const Params& p, long long n_blocks, cudaStream_t st) {
  auto kernel = rglru_scan_kernel<kTma, kRev>;
  const size_t smem = kRev ? kSmemRev : kSmemFwd;
  if (kRev) {
    static std::atomic<bool> raised[kMaxDevices] = {};
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
  }
  kernel<<<(unsigned)n_blocks, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch a launch at (B, S, W) needs.  The wrapper allocates it
// zeroed once and passes it to every launch on one stream with a new epoch.
extern "C" long long rglru_scan_scratch_bytes(long long B, long long S,
                                              long long W) {
  return layout(B, S, W).bytes;
}

// C interface (loaded with ctypes).  a, b, h: B*S*W f32, contiguous
// [B, S, W]; h0: B*W f32 or null (zeros); h_last: B*W f32; scratch: at
// least rglru_scan_scratch_bytes(B, S, W) bytes, zeroed before its first
// launch and used by one stream; epoch: 1 <= epoch < 2^31, new on every
// launch with this scratch; chained: nonzero for the same bits on every
// launch (see the look-back above).  TMA moves a, b and h when W % 4 == 0
// and the three bases are 16-byte aligned; 4-byte cp.async and stores from
// registers otherwise.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// scratch, epoch or grid it cannot take.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* h, void* h_last, long long B,
                                 long long S, long long W, void* scratch,
                                 long long scratch_bytes, unsigned epoch,
                                 int chained, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  Params p = {};
  long long n_blocks;
  if (!setup(p, B, S, W, scratch, scratch_bytes, epoch, chained, n_blocks))
    return (int)cudaErrorInvalidValue;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.init = static_cast<const float*>(h0);
  p.h = static_cast<float*>(h);
  p.h_last = static_cast<float*>(h_last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(h)) {
    int err = bind_context();
    if (!err) err = make_map(&p.ta, a, B, S, W);
    if (!err) err = make_map(&p.tb, b, B, S, W);
    if (!err) err = make_map(&p.th, h, B, S, W);
    if (err) return err;
    return launch<true, false>(p, n_blocks, st);
  }
  return launch<false, false>(p, n_blocks, st);
}

// The reverse mode: the gradient of the scan that gave h from (a, b, h0),
// in one launch.  g: the gradient reaching h, B*S*W; g_last: that of
// h_last, B*W or null (zeros); h: the forward's output; h0: its h0 or null.
// With l_{S-1} = g_{S-1} + g_last and l_t = g_t + a_{t+1} l_{t+1}, writes
// db = l and da_t = l_t h_{t-1} (h_{-1} = h0, or 0), both B*S*W.  Scratch,
// epoch, chained and the return as for rglru_scan_launch; TMA moves a, g,
// h, da and db when W % 4 == 0 and the five bases are 16-byte aligned.
extern "C" int rglru_scan_bwd_launch(const void* a, const void* g,
                                     const void* g_last, const void* h,
                                     const void* h0, void* da, void* db,
                                     long long B, long long S, long long W,
                                     void* scratch, long long scratch_bytes,
                                     unsigned epoch, int chained,
                                     void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  Params p = {};
  long long n_blocks;
  if (!setup(p, B, S, W, scratch, scratch_bytes, epoch, chained, n_blocks))
    return (int)cudaErrorInvalidValue;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(g);
  p.init = static_cast<const float*>(g_last);
  p.h = const_cast<float*>(static_cast<const float*>(h));
  p.h0 = static_cast<const float*>(h0);
  p.da = static_cast<float*>(da);
  p.db = static_cast<float*>(db);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(a) && aligned16(g) && aligned16(h)
      && aligned16(da) && aligned16(db)) {
    int err = bind_context();
    if (!err) err = make_map(&p.ta, a, B, S, W);
    if (!err) err = make_map(&p.tb, g, B, S, W);
    if (!err) err = make_map(&p.th, h, B, S, W);
    if (!err) err = make_map(&p.tda, da, B, S, W);
    if (!err) err = make_map(&p.tdb, db, B, S, W);
    if (err) return err;
    return launch<true, true>(p, n_blocks, st);
  }
  return launch<false, true>(p, n_blocks, st);
}
