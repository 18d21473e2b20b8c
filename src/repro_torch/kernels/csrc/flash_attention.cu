// Flash attention forward (same-length self-attention) for Hopper.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel): q, k, v are (bh, s, hd) in float32 or bfloat16; o = softmax(
// q k^T / sqrt(hd)) v per head, causal or not, computed in one pass over KV
// tiles with the online softmax (running max m, denominator l, numerator acc)
// in float32.  Matches the reference function, not its blocking: q is scaled
// in float32 before the product, a causally masked score is NEG_INF = -1e30
// (not -inf, so a fully masked row stays finite), tiles wholly in the causal
// future are skipped, l is clamped at 1e-30, and o is cast to the input type
// (round to nearest even).  Any s >= 1: the tail tile's missing keys weigh 0,
// and query rows past s are neither computed into o nor stored.
//
// Bound on an H100: q, k, v read once and o written once (4*bh*s*hd elements)
// over 3.35 TB/s, against 4*bh*s*s*hd operations (half when causal) over the
// tensor cores' 989 TFLOP/s in bf16 or the CUDA cores' 67 TFLOP/s in f32.  At
// the serve path's (64, 256, 128) bf16 the bytes bound it: about 5 us.
//
// First design, simple and right (CUDA cores, float32 throughout; wgmma/TMA
// is the redesign's work): a block of kWarps warps owns kBlockQ = 16 query
// rows of one head, kRowsPerWarp rows a warp.  For each tile of kBlockK = 32
// keys the block stages K and V in shared memory as float32 (K rows padded to
// hd + 4 floats, so that 32 lanes reading 32 rows with 16-byte loads hit
// distinct banks); lane j scores key j against each of its warp's rows (q is
// read as a shared-memory broadcast), the warp reduces the tile's max and
// sum with __shfl_xor_sync, and for the P.V product each lane owns hd/32 of
// the output dimensions and takes each key's probability by __shfl_sync.
// Shared memory at hd = 128: 8 KiB of q, 16.5 KiB of K, 16 KiB of V, under
// the 48 KiB static limit.  Blocks are scheduled heaviest first (the last query
// block of each head first) so the causal tail of the grid is short.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<unsigned*>(&lo) = raw.x;
  *reinterpret_cast<unsigned*>(&hi) = raw.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t bh,
                 int s, int n_qblocks, bool causal, float scale) {
  static_assert(HD % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kPer = HD / 32;     // output dimensions a lane owns
  constexpr int kKStride = HD + 4;  // padded K row (bank-conflict free)
  __shared__ __align__(16) float q_s[kBlockQ][HD];
  __shared__ __align__(16) float k_s[kBlockK][kKStride];
  __shared__ __align__(16) float v_s[kBlockK][HD];

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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh,
           int64_t s, bool causal, float scale, cudaStream_t stream) {
  const int64_t n_qblocks = (s + kBlockQ - 1) / kBlockQ;
  const int64_t blocks = n_qblocks * bh;
  if (s > INT32_MAX / HD || blocks > INT32_MAX) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, HD><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, static_cast<int>(s),
      static_cast<int>(n_qblocks), causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o,
                int64_t bh, int64_t s, int64_t hd, bool causal, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, bh, s, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, s, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, s, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, s, hd), 16-byte aligned; dtype 0 = float32,
// 1 = bfloat16; hd in {32, 64, 128}.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int64_t bh, int64_t s, int64_t hd,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, bh, s, hd, causal != 0, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, s, hd, causal != 0, scale, st);
  return cudaErrorInvalidValue;
}
