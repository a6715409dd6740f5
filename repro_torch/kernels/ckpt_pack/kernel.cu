// ckpt_pack for Hopper (sm_90a): the chunk-level star-forest gather.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ckpt_pack/kernel.py
// (`ckpt_pack`, body `_pack_kernel`): out[i] = src[idx[i]] over whole
// chunks of a chunk-major array src [N, R, C], and a zero chunk where
// idx[i] < 0.  The checkpoint save packs each rank's owned chunks into one
// staging buffer with it, ahead of that rank's single device-to-host copy.
//
// Bound on the card: pure data movement, 2 * M * R * C * itemsize bytes
// (each output chunk read once and written once) over HBM bandwidth; there
// is no arithmetic to speak of.  The kernel is dtype-blind: it moves bytes.
//
// Design: on the TPU the gather lived in the scalar-prefetch index_map and
// the body was a plain copy.  Here each block loads its own idx[i] and
// copies one slice of one chunk: blockIdx.x is the output chunk, blockIdx.y
// strides over the chunk's bytes, so a large chunk is spread across many
// SMs and a small one costs a single block.  Copies use 16-byte vector
// loads and stores when both chunk bases allow it (8, 4, 2 and 1-byte words
// otherwise), with a scalar tail, so full-width bf16/f32 chunks run at the
// widest transaction the memory system takes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// bytes one block moves per pass over its share of a chunk (16 B a thread)
constexpr long long kTileBytes = kThreads * 16;

template <typename Word>
__device__ __forceinline__ void copy_words(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           long long nbytes, bool valid) {
  const long long nwords = nbytes / (long long)sizeof(Word);
  const Word* s = reinterpret_cast<const Word*>(src);
  Word* d = reinterpret_cast<Word*>(dst);
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long w = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       w < nwords; w += stride) {
    Word x;
    if (valid) {
      x = __ldg(s + w);
    } else {
      x = Word{};
    }
    d[w] = x;
  }
  // scalar tail (chunk sizes that are not a whole number of words)
  if (blockIdx.y == 0) {
    for (long long b = nwords * (long long)sizeof(Word) + threadIdx.x;
         b < nbytes; b += blockDim.x) {
      dst[b] = valid ? src[b] : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ckpt_pack_kernel(const char* __restrict__ src, const int* __restrict__ idx,
                 char* __restrict__ out, long long n_src,
                 long long chunk_bytes) {
  const long long i = blockIdx.x;
  const int j = idx[i];
  // an index past the source is treated like -1: never read out of bounds
  const bool valid = j >= 0 && (long long)j < n_src;
  const char* s = src + (valid ? (long long)j : 0LL) * chunk_bytes;
  char* d = out + i * chunk_bytes;
  const uintptr_t align = reinterpret_cast<uintptr_t>(s) |
                          reinterpret_cast<uintptr_t>(d);
  if ((align & 15) == 0) {
    copy_words<uint4>(s, d, chunk_bytes, valid);
  } else if ((align & 7) == 0) {
    copy_words<uint2>(s, d, chunk_bytes, valid);
  } else if ((align & 3) == 0) {
    copy_words<unsigned int>(s, d, chunk_bytes, valid);
  } else if ((align & 1) == 0) {
    copy_words<unsigned short>(s, d, chunk_bytes, valid);
  } else {
    copy_words<unsigned char>(s, d, chunk_bytes, valid);
  }
}

}  // namespace

// C interface (loaded with ctypes).  src: n_src chunks of chunk_bytes each;
// idx: m int32 on the device; out: m chunks.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int ckpt_pack_launch(const void* src, const void* idx, void* out,
                                long long n_src, long long m,
                                long long chunk_bytes, void* stream) {
  if (m <= 0 || chunk_bytes <= 0) return 0;
  long long tiles = (chunk_bytes + kTileBytes - 1) / kTileBytes;
  if (tiles > 65535) tiles = 65535;
  dim3 grid((unsigned)m, (unsigned)tiles);
  ckpt_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const char*>(src), static_cast<const int*>(idx),
      static_cast<char*>(out), n_src, chunk_bytes);
  return (int)cudaGetLastError();
}
