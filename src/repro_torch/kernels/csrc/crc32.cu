// Batch CRC-32 (IEEE, reflected poly 0xEDB88320, zlib-compatible) for Hopper.
//
// Replaces src/repro/kernels/crc32.py::crc32_pallas (body _crc32_kernel): the
// client-side §4.2 verify of every fetched object / checkpoint shard, as one
// batch.  data is (n_rows, n_words) little-endian 32-bit words, one
// zero-padded record per row; out[r] is the CRC-32 of row r's 4*n_words
// bytes.
//
// Bound on an H100: the kernel must read n_rows*n_words*4 bytes once, so the
// memory floor is that over 3.35 TB/s.  But each row is a dependent chain of
// 4*n_words byte steps (shared-memory table lookup -> xor -> shift), so a row
// takes at least 4*n_words times the latency of one step, and the longest row
// sets the time when rows are few.
//
// First design, simple and right: one thread per row, the 256-entry table
// built into shared memory by each block, 64-bit offsets (a KV restore batch
// is ~134 MB, a checkpoint row ~1 M words).  It knowingly leaves the loads
// uncoalesced (neighbouring threads read rows n_words*4 bytes apart) and a
// long row on one thread.  The next step is slice-by-8 tables, or rows split
// across a warp with the partial CRCs combined (crc32_combine).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPoly = 0xEDB88320u;
constexpr int kThreads = 64;

__global__ void crc32_rows_kernel(const uint32_t* __restrict__ data,
                                  int64_t n_rows, int64_t n_words,
                                  uint32_t* __restrict__ out) {
  __shared__ uint32_t table[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
    table[i] = c;
  }
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const uint32_t* p = data + row * n_words;
  uint32_t crc = 0xFFFFFFFFu;
  for (int64_t w = 0; w < n_words; ++w) {
    const uint32_t word = p[w];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      crc = table[(crc ^ (word >> (8 * b))) & 0xFFu] ^ (crc >> 8);
    }
  }
  out[row] = crc ^ 0xFFFFFFFFu;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int crc32_rows(const void* data, int64_t n_rows, int64_t n_words,
                          void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  crc32_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(data), n_rows, n_words,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
