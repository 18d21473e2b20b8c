// Batch CRC-32 (IEEE, reflected poly 0xEDB88320, zlib-compatible) for Hopper.
//
// Replaces src/repro/kernels/crc32.py::crc32_pallas (body _crc32_kernel): the
// client-side §4.2 verify of every fetched object / checkpoint shard, as one
// batch.  data is (n_rows, n_words) little-endian 32-bit words, one
// zero-padded record per row; out[r] is the CRC-32 of row r's 4*n_words
// bytes.
//
// Bound on an H100: every byte is read once, so the memory floor is
// n_rows*n_words*4 bytes over 3.35 TB/s.  This design also meets a second
// floor, shared-memory table lookups: slice-by-16 costs one lookup a byte,
// and random table indices give a warp's 32 lookups ~3-4 bank wavefronts,
// so about 10 lookups a clock an SM, ~2.3 T lookups/s on 132 SMs -- a
// floor about 1.5x the memory floor (0.13 against 0.09 ms for 288 MiB).
//
// Design (the CRC is linear over GF(2), so a row is cut into pieces whose
// zero-initialised -- "raw" -- CRCs are combined by multiplying by
// x^(8*bytes after the piece) mod P, zlib's crc32_combine):
//  * A row is read as 16-byte units aligned to the tensor, so that every
//    load is a coalesced 16-byte load whatever n_words is.  The units from
//    the one holding the row's first word to the one holding its last form
//    the row's stream; words of a unit outside the row are zeroed.  Leading
//    zeros leave a raw CRC unchanged; the e <= 3 trailing zero words
//    multiply it by x^(32e), undone in pass 2 by x^(-32e) (x^(2^32-1) = 1
//    mod P).  The stream is cut into chunks of kChunkUnits units counted
//    back from its end (the first chunk is front-padded with zeros), so
//    that every chunk is whole and all rows have the same number of chunks.
//  * Pass 1 (crc32_chunks_kernel): persistent blocks of 256 threads walk
//    the (row, chunk) pairs.  A block stages its next chunk into shared
//    memory with cp.async (coalesced 16-byte copies, double-buffered,
//    pieces padded by one unit so that writing and reading them are free
//    of bank conflicts) while it CRCs the current one: each thread takes
//    the raw CRC of its contiguous 128-byte piece with slice-by-16 tables
//    in shared memory, multiplies it by x^(8*bytes after the piece), and
//    the block xors the 256 products into the chunk's raw CRC, written to
//    scratch.
//  * Pass 2 (crc32_rows_kernel): a block per row combines the row's chunk
//    CRCs the same way (Horner within a thread, a per-thread multiplier,
//    an xor across the block), undoes the trailing zeros, and adds the
//    0xFFFFFFFF initial register (0xFFFFFFFF * x^(8*row bytes)) and the
//    final xor.  No launch parameter enters a row's value.
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;
constexpr int kThreads = 256;                              // pass-1 block
constexpr int kPieceUnits = 8;                             // 128 B a thread
constexpr int kChunkUnits = kThreads * kPieceUnits;        // 32 KiB a chunk
constexpr int kPieceStride = kPieceUnits + 1;              // padded, in units
constexpr int kStageUnits = kThreads * kPieceStride;
constexpr int kSlices = 16;
constexpr int kTableWords = kSlices * 256;
// tables (from crc32.py::kernel_tables): [16][256] slice tables, then
// x^(2^k) mod P for k < 32, then x^(-32e) mod P for e < 4
constexpr int kX2nOff = kTableWords;
constexpr int kInvOff = kTableWords + 32;
constexpr int kPass1Smem = kTableWords * 4 + 2 * kStageUnits * 16;
constexpr int kCombineThreads = 128;                       // pass-2 block

// a * b mod P in zlib's reflected representation (bit 31 is x^0)
__device__ __forceinline__ uint32_t mult(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p ^= b & (0u - (a >> 31));
    a <<= 1;
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

// x^n mod P
__device__ __forceinline__ uint32_t xpow(uint64_t n, const uint32_t* x2n) {
  uint32_t p = 0x80000000u;
  for (int k = 0; n; n >>= 1, ++k)
    if (n & 1) p = mult(x2n[k & 31], p);
  return p;
}

// raw CRC state `crc` advanced over the 16 bytes of v (slice-by-16)
__device__ __forceinline__ uint32_t step16(const uint32_t* tab, uint32_t crc,
                                           uint4 v) {
  const uint32_t a = v.x ^ crc;
  return tab[15 * 256 + (a & 255)] ^ tab[14 * 256 + ((a >> 8) & 255)] ^
         tab[13 * 256 + ((a >> 16) & 255)] ^ tab[12 * 256 + (a >> 24)] ^
         tab[11 * 256 + (v.y & 255)] ^ tab[10 * 256 + ((v.y >> 8) & 255)] ^
         tab[9 * 256 + ((v.y >> 16) & 255)] ^ tab[8 * 256 + (v.y >> 24)] ^
         tab[7 * 256 + (v.z & 255)] ^ tab[6 * 256 + ((v.z >> 8) & 255)] ^
         tab[5 * 256 + ((v.z >> 16) & 255)] ^ tab[4 * 256 + (v.z >> 24)] ^
         tab[3 * 256 + (v.w & 255)] ^ tab[2 * 256 + ((v.w >> 8) & 255)] ^
         tab[1 * 256 + ((v.w >> 16) & 255)] ^ tab[(v.w >> 24)];
}

// the row's stream: words [bw, ew) of the tensor, units up to u_end
struct Row {
  int64_t bw, ew, u_end;
  __device__ Row(int64_t row, int64_t n_words)
      : bw(row * n_words), ew(row * n_words + n_words),
        u_end((row * n_words + n_words + 3) >> 2) {}
  // first unit of chunk c of n_chunks
  __device__ int64_t chunk_unit(int64_t c, int64_t n_chunks) const {
    return u_end - (n_chunks - c) * kChunkUnits;
  }
};

__global__ void __launch_bounds__(kThreads)
crc32_chunks_kernel(const uint4* __restrict__ data, int64_t n_words,
                    int64_t n_chunks, int64_t total,
                    const uint32_t* __restrict__ tables,
                    uint32_t* __restrict__ chunk_crc) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint4* stage = reinterpret_cast<uint4*>(smem + kTableWords * 4);
  __shared__ uint32_t part[kThreads / 32];
  const int t = threadIdx.x;

  // stage chunk k into buffer `buf`: copy i of thread t takes the chunk's
  // unit j = i * kThreads + t (a warp's copies are 512 contiguous bytes)
  // and puts it at its place in piece j / kPieceUnits
  auto issue = [&](int buf, int64_t k) {
    const Row row(k / n_chunks, n_words);
    const int64_t c0 = row.chunk_unit(k % n_chunks, n_chunks);
    uint4* dst = stage + buf * kStageUnits;
#pragma unroll
    for (int i = 0; i < kPieceUnits; ++i) {
      const int j = i * kThreads + t;
      const int64_t u = c0 + j;
      const bool live = 4 * u + 4 > row.bw && 4 * u < row.ew;
      hopper::cp_async16(
          dst + (j / kPieceUnits) * kPieceStride + j % kPieceUnits,
          live ? data + u : data, live ? 16u : 0u);
    }
    hopper::cp_async_commit();
  };

  int64_t k = blockIdx.x;
  if (k < total) issue(0, k);
  for (int i = t; i < kTableWords; i += kThreads) tab[i] = tables[i];
  // bytes after this thread's piece in a chunk
  const uint32_t after = xpow(8ull * 16 * kPieceUnits * (kThreads - 1 - t),
                              tables + kX2nOff);

  for (int it = 0; k < total; k += gridDim.x, ++it) {
    const int64_t next = k + gridDim.x;
    if (next < total) issue((it + 1) & 1, next);
    else hopper::cp_async_commit();  // an empty group keeps the count even
    hopper::cp_async_wait<1>();
    __syncthreads();  // chunk k is staged (and, the first time, the tables)

    const Row row(k / n_chunks, n_words);
    const int64_t u0 = row.chunk_unit(k % n_chunks, n_chunks) +
                       static_cast<int64_t>(t) * kPieceUnits;
    uint32_t crc = 0;
    if (4 * (u0 + kPieceUnits) > row.bw) {  // not wholly before the row
      const uint4* src = stage + (it & 1) * kStageUnits + t * kPieceStride;
#pragma unroll
      for (int i = 0; i < kPieceUnits; ++i) {
        uint4 v = src[i];
        const int64_t g = 4 * (u0 + i);
        if (g < row.bw || g + 4 > row.ew) {  // a unit the row only partly holds
          v.x = (g >= row.bw && g < row.ew) ? v.x : 0u;
          v.y = (g + 1 >= row.bw && g + 1 < row.ew) ? v.y : 0u;
          v.z = (g + 2 >= row.bw && g + 2 < row.ew) ? v.z : 0u;
          v.w = (g + 3 >= row.bw && g + 3 < row.ew) ? v.w : 0u;
        }
        crc = step16(tab, crc, v);
      }
      crc = mult(after, crc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) crc ^= __shfl_xor_sync(0xFFFFFFFFu, crc, o);
    if ((t & 31) == 0) part[t >> 5] = crc;
    __syncthreads();  // also: every thread is done reading buffer it & 1
    if (t == 0) {
      uint32_t x = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) x ^= part[w];
      chunk_crc[k] = x;
    }
  }
}

__global__ void __launch_bounds__(kCombineThreads)
crc32_rows_kernel(const uint32_t* __restrict__ chunk_crc, int64_t n_words,
                  int64_t n_chunks, const uint32_t* __restrict__ tables,
                  uint32_t* __restrict__ out) {
  __shared__ uint32_t part[kCombineThreads / 32];
  __shared__ uint32_t init_term;
  const int t = threadIdx.x;
  const int64_t r = blockIdx.x;
  const uint32_t* x2n = tables + kX2nOff;
  // thread t takes chunks [t*per, (t+1)*per) of the chunks front-padded
  // with zero CRCs to per*kCombineThreads
  const int64_t per = (n_chunks + kCombineThreads - 1) / kCombineThreads;
  const int64_t pad = per * kCombineThreads - n_chunks;
  const uint32_t* crcs = chunk_crc + r * n_chunks;
  const uint32_t m_chunk = xpow(8ull * 16 * kChunkUnits, x2n);
  uint32_t acc = 0;
  for (int64_t j = 0; j < per; ++j) {
    const int64_t c = t * per + j - pad;
    if (acc) acc = mult(m_chunk, acc);
    if (c >= 0) acc ^= crcs[c];
  }
  if (acc)
    acc = mult(xpow(8ull * 16 * kChunkUnits * per * (kCombineThreads - 1 - t), x2n),
               acc);
  if (t == 32)  // the initial register shifted over the row, off warp 0
    init_term = mult(xpow(8ull * 4 * n_words, x2n), 0xFFFFFFFFu);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, o);
  if ((t & 31) == 0) part[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    uint32_t raw = 0;
#pragma unroll
    for (int w = 0; w < kCombineThreads / 32; ++w) raw ^= part[w];
    const Row row(r, n_words);
    const int e = static_cast<int>(4 * row.u_end - row.ew);  // trailing zeros
    if (e) raw = mult(tables[kInvOff + e], raw);
    out[r] = raw ^ init_term ^ 0xFFFFFFFFu;
  }
}

}  // namespace

// data: (n_rows, n_words) words, 16-byte aligned; n_chunks: chunks a row
// (crc32.py::n_chunks); scratch: n_rows * n_chunks words; tables: the
// kernel_tables() words on the device.  Launches both passes on `stream`
// and returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int crc32_rows(const void* data, int64_t n_rows, int64_t n_words,
                          int64_t n_chunks, const void* tables, void* scratch,
                          void* out, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_words < 0 || reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
      n_chunks != (((n_words + 3) / 4 + 1) + kChunkUnits - 1) / kChunkUnits ||
      n_rows > INT32_MAX)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(crc32_chunks_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kPass1Smem);
  const int64_t total = n_rows * n_chunks;
  const int64_t blocks = total < 2 * sms ? total : 2 * sms;
  crc32_chunks_kernel<<<static_cast<unsigned>(blocks), kThreads, kPass1Smem,
                        st>>>(static_cast<const uint4*>(data), n_words,
                              n_chunks, total,
                              static_cast<const uint32_t*>(tables),
                              static_cast<uint32_t*>(scratch));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  crc32_rows_kernel<<<static_cast<unsigned>(n_rows), kCombineThreads, 0, st>>>(
      static_cast<const uint32_t*>(scratch), n_words, n_chunks,
      static_cast<const uint32_t*>(tables), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
