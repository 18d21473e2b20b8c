// Flash attention forward (same-length self-attention) for Hopper.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel): q, k, v are (bh, s, hd) in bfloat16 or float32; o = softmax(
// q k^T / sqrt(hd)) v per head, causal or not, computed in one pass over KV
// tiles with the online softmax (running max m, denominator l, numerator acc)
// in float32.  Matches the reference function, not its blocking: scores are
// scaled in float32, a causally masked score is NEG_INF = -1e30 (not -inf,
// so a fully masked row stays finite), tiles wholly in the causal future
// are skipped, l is clamped at 1e-30, and o is cast to the input type
// (round to nearest even).  Any s >= 1: the tail tile's missing keys weigh 0,
// and query rows past s are not stored.
//
// Bound on an H100: q, k, v read once and o written once (4*bh*s*hd elements)
// over 3.35 TB/s, against 4*bh*s*s*hd operations (half when causal) over the
// tensor cores' 989 TFLOP/s in bf16 or the CUDA cores' 67 TFLOP/s in f32.  At
// the serve path's (64, 256, 128) bf16 the bytes bound it (about 5 us), at
// olmo_1b's context (32, 2048, 128) the operations (about 35 us).
//
// Two routes, chosen by dtype:
//
// bfloat16 -> flash_fwd_wgmma_kernel, on the tensor cores.  One warpgroup
// (128 threads) owns a 64-row query tile of one head.  The Q tile is loaded
// once; K and V tiles of 64 keys go through a 2-stage ring, each copied by
// TMA (cp.async.bulk.tensor, 3-D maps over (hd, s, bh), so rows past s are
// zero-filled) with the 128-byte swizzle (64-byte at hd = 32) that wgmma's
// shared-memory descriptors read, completing on an mbarrier; the copy of
// tile t + 2 is issued as soon as tile t is consumed, so it overlaps the
// math of tile t + 1.  S = Q K^T is wgmma m64n64k16 with both operands in
// shared memory (K row-major is the K-major B operand); the online softmax
// runs on the f32 accumulator fragments in registers, a row's max and sum
// reduced across the 4 threads that hold it, with exp2 of log2(e)-scaled
// scores; P is rounded to bf16 in registers and becomes the A operand of
// O += P V (wgmma m64n{hd}k16, V the MN-major B operand: the transpose
// bit; at hd = 256 two m64n128k16 on V's column halves, whose 128 f32
// accumulators a thread are the register budget's largest term).  Only
// the diagonal tile (causal) and the tail tile (s % 64) are masked.
// Heaviest query tiles are issued
// first; no atomics and no split across KV, so the result is deterministic.
// The TMA descriptors are encoded on the host through
// cudaGetDriverEntryPoint, so the library links only the runtime.  Not
// done yet: warp specialisation (a producer warp), persistent blocks,
// ping-pong between two consumer warpgroups, fp8, GQA.
//
// float32 -> flash_fwd_kernel, on the CUDA cores (the port's first flash
// kernel: TF32 could not meet the 2e-5 tolerance of the f32 path).  A block
// of kWarps warps owns kBlockQ = 16 query rows of one head, kRowsPerWarp
// rows a warp.  For each tile of kBlockK = 32 keys the block stages K and V
// in shared memory as float32 (K rows padded to hd + 4 floats, so that 32 lanes
// reading 32 rows with 16-byte loads hit distinct banks); lane j scores key
// j against each of its warp's rows (q is read as a shared-memory
// broadcast), the warp reduces the tile's max and sum with __shfl_xor_sync,
// and for the P.V product each lane owns hd/32 of the output dimensions and
// takes each key's probability by __shfl_sync.  Shared memory is dynamic:
// at hd = 128 8 KiB of q, 16.5 KiB of K and 16 KiB of V; at hd = 256 80.4
// KiB, past the 48 KiB static limit, raised with cudaFuncSetAttribute (two
// blocks an SM).
// Blocks are scheduled heaviest first (the last query block of each head
// first) so the causal tail of the grid is short.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// dynamic shared memory of the float32 kernel: q (kBlockQ x HD), K padded
// to HD + 4 floats a row (bank-conflict free), V (kBlockK x HD)
template <int HD>
struct F32Smem {
  static constexpr int kKStride = HD + 4;
  static constexpr int kBytes =
      (kBlockQ * HD + kBlockK * kKStride + kBlockK * HD) * static_cast<int>(sizeof(float));
};

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t bh,
                 int s, int n_qblocks, bool causal, float scale) {
  static_assert(HD % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kPer = HD / 32;     // output dimensions a lane owns
  constexpr int kKStride = F32Smem<HD>::kKStride;
  extern __shared__ __align__(16) float smem_f32[];
  auto q_s = reinterpret_cast<float (*)[HD]>(smem_f32);
  auto k_s = reinterpret_cast<float (*)[kKStride]>(smem_f32 + kBlockQ * HD);
  auto v_s = reinterpret_cast<float (*)[HD]>(smem_f32 + kBlockQ * HD + kBlockK * kKStride);

  const int64_t head = blockIdx.x % bh;
  const int qb = n_qblocks - 1 - static_cast<int>(blockIdx.x / bh);
  const int q0 = qb * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t base = head * s * HD;
  const T* qh = q + base;
  const T* kh = k + base;
  const T* vh = v + base;

  // the block's query rows, scaled, as float32 (rows past s are zero)
  for (int i = threadIdx.x * 4; i < kBlockQ * HD; i += blockDim.x * 4) {
    const int r = i / HD, d = i % HD;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < s) x = load4(qh + static_cast<int64_t>(q0 + r) * HD + d);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(&q_s[r][d]) = x;
  }

  const int row0 = q0 + warp * kRowsPerWarp;  // this warp's first query row
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPer];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[r][e] = 0.f;
  }

  // keys [0, kv_end) can be live for some row of the block
  const int q_last = min(q0 + kBlockQ, s) - 1;
  const int kv_end = causal ? q_last + 1 : s;
  for (int t0 = 0; t0 < kv_end; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int i = threadIdx.x * 4; i < kBlockK * HD; i += blockDim.x * 4) {
      const int j = i / HD, d = i % HD;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (t0 + j < s) {
        const int64_t off = static_cast<int64_t>(t0 + j) * HD + d;
        kx = load4(kh + off);
        vx = load4(vh + off);
      }
      *reinterpret_cast<float4*>(&k_s[j][d]) = kx;
      *reinterpret_cast<float4*>(&v_s[j][d]) = vx;
    }
    __syncthreads();
    // a warp with no query row, or whose rows all precede the tile, has no
    // live key in it (uniform across the warp, so no divergent shuffles)
    if (row0 >= s || (causal && t0 > row0 + kRowsPerWarp - 1)) continue;

    const int key = t0 + lane;
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&k_s[lane][d]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&q_s[warp * kRowsPerWarp + r][d]);
        sc[r] = fmaf(qq.x, kk.x, sc[r]);
        sc[r] = fmaf(qq.y, kk.y, sc[r]);
        sc[r] = fmaf(qq.z, kk.z, sc[r]);
        sc[r] = fmaf(qq.w, kk.w, sc[r]);
      }
    }
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool in_seq = key < s;
      const float x = (causal && key > row0 + r) ? kNegInf : sc[r];
      const float m_new = fmaxf(m[r], warp_max(in_seq ? x : kNegInf));
      p[r] = in_seq ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[r][e] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) vv[e] = v_s[j][lane + 32 * e];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
      }
    }
  }

  T* oh = o + base;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= s) break;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      store1(oh + static_cast<int64_t>(row) * HD + lane + 32 * e, acc[r][e] / denom);
  }
}

// ---------------------------------------------------------------- bf16
constexpr int kWgThreads = 128;  // one warpgroup
constexpr int kTileM = 64;       // query rows a block
constexpr int kTileN = 64;       // keys a tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// shared-memory geometry of a 64-row bf16 tile of width HD: column blocks
// as wide as the swizzle (128 B, or 64 B at hd = 32), each 64 rows deep
template <int HD>
struct Geom {
  static constexpr int kSwBytes = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kSwElems = kSwBytes / 2;
  static constexpr int kColBlocks = HD / kSwElems;
  static constexpr int kBlockBytes = kTileM * kSwBytes;
  static constexpr int kTileBytes = kColBlocks * kBlockBytes;
  static constexpr uint32_t kSwMode = kSwBytes == 128 ? 1 : 2;  // descriptor code
  static constexpr int kAtomBytes = 8 * kSwBytes;  // 8 rows: one swizzle atom
  // Q, then K[kStages], then V[kStages]; 1 KiB of slack for the alignment
  static constexpr int kSmem = (1 + 2 * kStages) * kTileBytes + 1024;
};

// D (64 x 64, f32) = A (64 x 16) * B (16 x 64), both from shared memory,
// both K-major; scale_d = 0 overwrites D, 1 accumulates into it
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 16, bf16 in registers) * B (16 x N) from shared
// memory, B MN-major (the transpose bit set)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// descriptor of k-slice kk (16 columns) of a K-major tile (Q as A, K as B)
template <int HD>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using G = Geom<HD>;
  const int col = kk * 16;
  const uint32_t addr = tile + (col / G::kSwElems) * G::kBlockBytes +
                        (col % G::kSwElems) * 2;
  return hopper::make_desc(addr, 16, G::kAtomBytes, G::kSwMode);
}

// descriptor of keys [16 kk, 16 kk + 16) of a V tile read MN-major: hd
// columns in blocks kBlockBytes apart (LBO), 8-key atoms kAtomBytes apart
template <int HD>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using G = Geom<HD>;
  return hopper::make_desc(tile + kk * 16 * G::kSwBytes, G::kBlockBytes,
                           G::kAtomBytes, G::kSwMode);
}

// O (64 x HD) += P (64 x 16, registers) * V's keys [16 kk, 16 kk + 16); at
// HD = 256 as two m64n128k16 on V's column halves, 2 column blocks apart,
// each into its half of the accumulator (registers 0-63: columns 0-127)
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&acc)[HD / 2], const uint32_t (&a)[4],
                                         uint32_t v_addr, int kk) {
  if constexpr (HD == 256) {
    using G = Geom<HD>;
    wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(&acc[0]), a,
                  desc_mnmajor<HD>(v_addr, kk));
    wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(&acc[64]), a,
                  desc_mnmajor<HD>(v_addr + 2 * G::kBlockBytes, kk));
  } else {
    wgmma_rs<HD>(acc, a, desc_mnmajor<HD>(v_addr, kk));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int64_t bh, int s,
                       int n_qblocks, bool causal, float scale_log2) {
  using G = Geom<HD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[kStages];
  // tiles aligned to 1 KiB, as the swizzled TMA copies and descriptors need
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* q_s = smem;
  auto k_s = [&](int st) { return smem + (1 + st) * G::kTileBytes; };
  auto v_s = [&](int st) { return smem + (1 + kStages + st) * G::kTileBytes; };

  const int tid = threadIdx.x;
  const int head = static_cast<int>(blockIdx.x % bh);
  const int qb = n_qblocks - 1 - static_cast<int>(blockIdx.x / bh);
  const int q0 = qb * kTileM;
  const int q_last = min(q0 + kTileM, s) - 1;
  const int n_tiles = causal ? q_last / kTileN + 1 : (s + kTileN - 1) / kTileN;

  auto load_kv = [&](int t) {
    const int st = t % kStages;
    hopper::mbar_arrive_expect_tx(&bar_kv[st], 2 * G::kTileBytes);
#pragma unroll
    for (int cb = 0; cb < G::kColBlocks; ++cb) {
      hopper::tma_load_3d(k_s(st) + cb * G::kBlockBytes, &tm_k, &bar_kv[st],
                          cb * G::kSwElems, t * kTileN, head);
      hopper::tma_load_3d(v_s(st) + cb * G::kBlockBytes, &tm_v, &bar_kv[st],
                          cb * G::kSwElems, t * kTileN, head);
    }
  };

  if (tid == 0) {
    hopper::mbar_init(&bar_q, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&bar_kv[st], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bar_q, G::kTileBytes);
#pragma unroll
    for (int cb = 0; cb < G::kColBlocks; ++cb)
      hopper::tma_load_3d(q_s + cb * G::kBlockBytes, &tm_q, &bar_q,
                          cb * G::kSwElems, q0, head);
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_kv(t);
  }

  // this thread's accumulator rows: r0 (registers 4j, 4j+1) and r0 + 8
  // (4j+2, 4j+3); columns 8j + 2 (lane % 4) + {0, 1}
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[kTileN / 2];
#pragma unroll
  for (int i = 0; i < kTileN / 2; ++i) sc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = hopper::smem_addr(q_s);

  hopper::mbar_wait(&bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    hopper::mbar_wait(&bar_kv[st], (t / kStages) & 1);

    // S = Q K^T
    const uint32_t k_addr = hopper::smem_addr(k_s(st));
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_m64n64k16_ss(sc, desc_kmajor<HD>(q_addr, kk),
                         desc_kmajor<HD>(k_addr, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // online softmax on the fragments (log2 units)
    const int t0 = t * kTileN;
    const bool edge = t0 + kTileN > s || (causal && t == n_tiles - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) {
      const int row = r0 + ((i & 2) ? 8 : 0);
      const int key = t0 + 8 * (i / 4) + c0 + (i & 1);
      float x = sc[i] * scale_log2;
      if (edge && (key >= s || (causal && key > row))) x = kNegInf;
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    uint32_t pa[kTileN / 16][4];
#pragma unroll
    for (int i = 0; i < kTileN / 2; i += 2) {
      const int h = (i >> 1) & 1;
      const int key = t0 + 8 * (i / 4) + c0;
      const float p0 = (edge && key >= s) ? 0.f : exp2f(sc[i] - m[h]);
      const float p1 = (edge && key + 1 >= s) ? 0.f : exp2f(sc[i + 1] - m[h]);
      l[h] += p0 + p1;
      // key block i / 4 of 8: k-slice i / 8, registers {0, 1} or {2, 3}
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V
    const uint32_t v_addr = hopper::smem_addr(v_s(st));
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) hopper::fence_regs(pa[kk]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk)
      wgmma_pv<HD>(acc, pa[kk], v_addr, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    __syncthreads();  // every wgmma reading stage st is done: refill it
    if (tid == 0 && t + kStages < n_tiles) load_kv(t + kStages);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* oh = o + static_cast<int64_t>(head) * s * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row < s)
        *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<int64_t>(row) * HD +
                                           8 * j + c0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv[h],
                                  acc[4 * j + 2 * h + 1] * inv[h]);
    }
  }
}

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 3-D map over a contiguous (bh, s, hd) bf16 tensor, box (sw_elems, 64, 1)
template <int HD>
bool make_map(CUtensorMap* map, const void* base, int64_t bh, int64_t s) {
  using G = Geom<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(s) * HD * 2};
  const cuuint32_t box[3] = {G::kSwElems, kTileM, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                G::kSwBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int64_t bh, int64_t s, bool causal, float scale,
                 cudaStream_t stream) {
  using G = Geom<HD>;
  const int64_t n_qblocks = (s + kTileM - 1) / kTileM;
  const int64_t blocks = n_qblocks * bh;
  if (s > INT32_MAX / HD || bh > INT32_MAX || blocks > INT32_MAX)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map<HD>(&tq, q, bh, s) || !make_map<HD>(&tk, k, bh, s) ||
      !make_map<HD>(&tv, v, bh, s))
    return cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  flash_fwd_wgmma_kernel<HD><<<static_cast<unsigned>(blocks), kWgThreads,
                               G::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), bh, static_cast<int>(s),
      static_cast<int>(n_qblocks), causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh,
           int64_t s, bool causal, float scale, cudaStream_t stream) {
  const int64_t n_qblocks = (s + kBlockQ - 1) / kBlockQ;
  const int64_t blocks = n_qblocks * bh;
  if (s > INT32_MAX / HD || blocks > INT32_MAX) return cudaErrorInvalidValue;
  constexpr int kSmem = F32Smem<HD>::kBytes;
  cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  flash_fwd_kernel<T, HD><<<static_cast<unsigned>(blocks), kWarps * 32, kSmem,
                            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, static_cast<int>(s),
      static_cast<int>(n_qblocks), causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32_hd(const void* q, const void* k, const void* v, void* o,
                  int64_t bh, int64_t s, int64_t hd, bool causal, float scale,
                  cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<float, 32>(q, k, v, o, bh, s, causal, scale, stream);
    case 64: return launch<float, 64>(q, k, v, o, bh, s, causal, scale, stream);
    case 128: return launch<float, 128>(q, k, v, o, bh, s, causal, scale, stream);
    case 256: return launch<float, 256>(q, k, v, o, bh, s, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

int launch_bf16_hd(const void* q, const void* k, const void* v, void* o,
                   int64_t bh, int64_t s, int64_t hd, bool causal, float scale,
                   cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_wgmma<32>(q, k, v, o, bh, s, causal, scale, stream);
    case 64: return launch_wgmma<64>(q, k, v, o, bh, s, causal, scale, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, bh, s, causal, scale, stream);
    case 256: return launch_wgmma<256>(q, k, v, o, bh, s, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, s, hd), 16-byte aligned; dtype 0 = float32
// (CUDA-core kernel), 1 = bfloat16 (wgmma kernel); hd in {32, 64, 128, 256}.
// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int64_t bh, int64_t s, int64_t hd,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_hd(q, k, v, o, bh, s, hd, causal != 0, scale, st);
  if (dtype == 1)
    return launch_bf16_hd(q, k, v, o, bh, s, hd, causal != 0, scale, st);
  return cudaErrorInvalidValue;
}
