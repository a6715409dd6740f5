// Flash attention forward for Hopper (sm_90a): causal GQA with optional
// sliding window, logit softcap and q_offset, bf16 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_fwd`, body `_fwd_kernel`).  Same contract: q [B, Sq, Hq,
// hd], k and v [B, Sk, Hkv, hd]; query head h reads kv head h / (Hq / Hkv);
// online softmax with m, l and the accumulator in f32; masked logits are
// -1e30 as in the Pallas body, so rows agree with it tile for tile.
//
// Bound on the card: 4 * B * Hq * hd * (causal pairs) operations at the
// bf16 tensor-core peak, or bytes(q, k, v, o) over HBM bandwidth, whichever
// is larger; at prefill lengths the products dominate.
//
// Design.  On the TPU the k-tile axis was the sequential minor grid axis
// and the running (m, l, acc) lived in VMEM scratch across grid steps.  On
// Hopper blocks run in no order, so one thread block owns one (batch*head,
// 64-row q tile) and loops over the k tiles itself, keeping m, l and acc in
// registers.  Four warps each hold 16 query rows; QK^T and PV run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), the S
// accumulator is re-packed in registers as the A operand of PV (P is
// rounded to bf16 for that product; l is summed from the f32 P).  K and V
// tiles are staged in shared memory with cp.async, double buffered so the
// next tile loads while this one computes; rows are padded by 8 bf16 to
// spread shared-memory banks.  Tiles wholly above the causal diagonal or
// before the window are never visited; the ragged Sq / Sk edges are masked
// in the kernel (out-of-range rows load as zeros), with no host padding.
// Late q tiles carry the most causal work, so the grid issues them first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // keys per tile
constexpr int kWarps = 4;       // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int PAD = 8;          // bf16 of padding per shared-memory row
constexpr float NEG_INF = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_ss, q_sh;   // element strides (batch, seq, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Sk, Hq, G;            // G = Hq / Hkv
  int causal, window, q_offset, nq_tiles;
  float scale, softcap;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;   // 0 source bytes => zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [row0, row0 + BN_or_BM) of a [S, hd] head slice into shared memory;
// rows at or past `valid` are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[HD + PAD],
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int valid) {
  constexpr int kChunksPerRow = HD / 8;          // 16-byte pieces
  for (int c = threadIdx.x; c < ROWS * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const int gr = row0 + r;
    const bool ok = gr < valid;
    const __nv_bfloat16* src = ok ? base + gr * row_stride + col : base;
    cp_async16(&dst[r][col], src, ok);
  }
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo,
                                          const __nv_bfloat16* hi) {
  return (uint32_t)(*reinterpret_cast<const unsigned short*>(lo)) |
         ((uint32_t)(*reinterpret_cast<const unsigned short*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  typedef __nv_bfloat16 Row[HD + PAD];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Row* sQ = reinterpret_cast<Row*>(smem_raw);   // [BM]
  Row* sK = sQ + BM;                            // [2][BN]
  Row* sV = sK + 2 * BN;                        // [2][BN]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;        // mma row group
  const int t = lane & 3;         // thread in group

  const int qt = p.nq_tiles - 1 - (int)blockIdx.x;   // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int kvh = h / p.G;
  const int q0 = qt * BM;

  const __nv_bfloat16* qbase = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kbase = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + kvh * p.v_sh;

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

  load_tile<HD, BM>(sQ, qbase, p.q_ss, q0, p.Sq);
  if (kt_begin < kt_end) {
    load_tile<HD, BN>(sK, kbase, p.k_ss, kt_begin * BN, p.Sk);
    load_tile<HD, BN>(sV, vbase, p.v_ss, kt_begin * BN, p.Sk);
  }
  cp_async_commit();

  const int r0 = warp * 16 + g;   // this thread's rows: r0 and r0 + 8
  float o_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    o_acc[i][0] = o_acc[i][1] = o_acc[i][2] = o_acc[i][3] = 0.f;
  }
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};      // partial over this thread's columns
  uint32_t qf[HD / 16][4];

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {        // prefetch the next tile into the other stage
      load_tile<HD, BN>(sK + (st ^ 1) * BN, kbase, p.k_ss, (kt + 1) * BN, p.Sk);
      load_tile<HD, BN>(sV + (st ^ 1) * BN, vbase, p.v_ss, (kt + 1) * BN, p.Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();           // everything but the newest group landed
    __syncthreads();

    if (kt == kt_begin) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qf[kk][0] = ld32(&sQ[r0][c]);
        qf[kk][1] = ld32(&sQ[r0 + 8][c]);
        qf[kk][2] = ld32(&sQ[r0][c + 8]);
        qf[kk][3] = ld32(&sQ[r0 + 8][c + 8]);
      }
    }
    const Row* K = sK + st * BN;
    const Row* V = sV + st * BN;

    // S = Q K^T for this warp's 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const __nv_bfloat16* kr = &K[nt * 8 + g][kk * 16 + 2 * t];
        mma_16816(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, softcap, mask; row max over the tile
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const int qpos = p.q_offset + q0 + row;
        const int kpos = kt * BN + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        x = ok ? x : NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      corr[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[nt][e] - m_r[e >> 1]);
        s[nt][e] = pe;
        l_r[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      o_acc[dn][0] *= corr[0];
      o_acc[dn][1] *= corr[0];
      o_acc[dn][2] *= corr[1];
      o_acc[dn][3] *= corr[1];
    }

    // O += P V: the S accumulator tiles (2j, 2j+1) are the A fragment of
    // the j-th 16-key step
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_f32(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int k0 = j * 16 + 2 * t;
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        const int col = dn * 8 + g;
        const uint32_t b0 = pack2(&V[k0][col], &V[k0 + 1][col]);
        const uint32_t b1 = pack2(&V[k0 + 8][col], &V[k0 + 9][col]);
        mma_16816(o_acc[dn], a, b0, b1);
      }
    }
    __syncthreads();              // this stage is free for the next prefetch
  }
  cp_async_wait<0>();

  // finalize: o = acc / max(l, 1e-30), rows past Sq are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = q0 + r0 + i * 8;
    if (qrow >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* orow = p.o + b * p.o_sb + qrow * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      const uint32_t w = pack_f32(o_acc[dn][2 * i] * inv,
                                  o_acc[dn][2 * i + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) = w;
    }
  }
}

template <int HD>
int launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const size_t smem = (size_t)(BM + 4 * BN) * (HD + PAD) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)p.nq_tiles, (unsigned)batch_heads);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes).  Strides are in elements; the head dim
// of every tensor is contiguous.  Returns cudaGetLastError() (0 = launched),
// or cudaErrorInvalidValue for a head dim the kernel is not built for.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Sk, int Hq, int Hkv, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, int q_offset, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.G = Hq / Hkv;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.nq_tiles = (Sq + BM - 1) / BM;
  p.scale = 1.f / sqrtf((float)hd);
  p.softcap = softcap;
  if (B <= 0 || Sq <= 0) return 0;
  const int batch_heads = B * Hq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(p, batch_heads, s);
    case 128: return launch<128>(p, batch_heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
