// MoE routing's queue positions, dispatch and combine for Hopper.
//
// They replace no Pallas kernel: the JAX package forms dispatch and combine as
// one-hot (B, n, g, E, C) tensors and einsums (src/repro/models/layers/
// moe.py), which the port rewrote as a one-hot scan, a scatter and a gather
// (models/layers/moe.py's plain versions).  Those moved each token row many
// times at every MoE layer: an int64 one-hot (B, n, g*k, E) and its cumsum
// to find each (token, slot) pair's queue position, k expanded copies of
// every token scattered into an (E*C + 1)-slot buffer through an index
// expanded to d, a permute copy, and on the way back a permute copy, a zero
// row cat'ed on and a (B, n, g, k, d) gather.  Half of granite_moe_3b's
// prefill device time went there.  These three kernels compute the same
// functions and move each row once.
//
// The groups: x (B, S, d) is B*n groups of g consecutive tokens; pair
// p = t*k + j of a group is its token t's j-th expert, topi[p] in [0, E).
// Its queue position counts the earlier pairs of the group (token-major
// order) routed to the same expert; a pair at position >= C is dropped.
//
// moe_positions_kernel: one block a group.  Each warp owns a contiguous run
// of the group's pairs; a first pass counts its pairs an expert (lanes with
// the same expert found by __match_any_sync, one add by the lowest), an
// exclusive scan over the warps gives each warp's first position at each
// expert, and a second pass over the same runs gives each pair its position
// (the scan's offset, the warp's running count and its rank among the
// lanes with its expert).  It writes pos (int64, as the plain version's),
// keep, the pair's slot e*C + pos (or -1), and the group's inverse map: for
// each of its E*C capacity slots the pair p that fills it, or -1.  Bound:
// a few KB a group; it replaces a (B, n, g*k, E) int64 one-hot, its cumsum
// and two passes over it.
//
// moe_dispatch_kernel: xe (E, B*n*C, d), the layout the experts' batched
// matmuls read.  Row r holds expert e = r / (B*n*C), group r % (B*n*C) / C,
// slot c = r % C: the row of the token whose pair fills that slot, or zeros.
// A pure copy of 16-byte vectors, neighbouring threads on neighbouring
// addresses of a row, so the result is today's zero-fill + scatter +
// permute bit for bit.  Bound: every row of xe written once and each kept
// token read (E*B*n*C + kept tokens) * d elements.
//
// moe_combine_kernel: out (B, S, d) = for each token the sum over its kept
// pairs of gate (rounded to x's dtype, as the plain version casts it) times
// the pair's row of ye (E, B*n*C, d), read in place; float32 accumulation
// in pair order (j = 0..k-1), one rounding to x's dtype.  A dropped pair
// adds nothing (the plain version's zero row).  Bound: each kept pair's row
// of ye read once, out written once, slot and gate (8 bytes a pair) read.
//
// Geometry comes from the shapes alone: positions take min(8, pairs / 32)
// warps a group; dispatch and combine give a row RT threads, the largest
// power of two <= its 16-byte vectors and <= 256 (above 32, one that divides
// them), and a 256-thread block 256 / RT rows.  No atomics: two launches
// give the same bits.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 8;
constexpr int kThreads = 256;  // a dispatch / combine block

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void moe_positions_kernel(const int64_t* __restrict__ topi,
                                     int64_t* __restrict__ pos,
                                     uint8_t* __restrict__ keep,
                                     int* __restrict__ slot, int* __restrict__ inv,
                                     int P, int E, int C, int span) {
  extern __shared__ int hist[];  // [warps][E]: counts, then running positions
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t grp = blockIdx.x;
  const int64_t* ti = topi + grp * P;
  const int slots = E * C;
  int* ginv = inv + grp * slots;
  for (int i = threadIdx.x; i < warps * E; i += blockDim.x) hist[i] = 0;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) ginv[i] = -1;
  __syncthreads();
  int* h = hist + warp * E;
  const int begin = warp * span;
  const int end = min(P, begin + span);
  for (int base = begin; base < end; base += 32) {
    const int p = base + lane;
    const int e = p < end ? static_cast<int>(ti[p]) : -1;
    const unsigned same = __match_any_sync(kFull, e);
    if (e >= 0 && lane == __ffs(same) - 1) h[e] += __popc(same);
    __syncwarp();  // the next tile's lanes read these counts
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int run = 0;
    for (int w = 0; w < warps; ++w) {
      const int n = hist[w * E + e];
      hist[w * E + e] = run;
      run += n;
    }
  }
  __syncthreads();
  for (int base = begin; base < end; base += 32) {
    const int p = base + lane;
    const int e = p < end ? static_cast<int>(ti[p]) : -1;
    const unsigned same = __match_any_sync(kFull, e);
    const int q = e >= 0 ? h[e] + __popc(same & lanemask_lt()) : 0;
    __syncwarp();
    if (e >= 0 && lane == __ffs(same) - 1) h[e] += __popc(same);
    __syncwarp();
    if (p < end) {
      const int64_t at = grp * P + p;
      const bool kept = q < C;
      pos[at] = q;
      keep[at] = kept;
      slot[at] = kept ? e * C + q : -1;
      if (kept) ginv[e * C + q] = p;  // the -1 fill above is ordered before by the barriers
    }
  }
}

// rows: E * groups * C; per_expert: groups * C; V: 16-byte vectors a row; RT:
// threads a row (a power of two, at most kThreads)
__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const uint4* __restrict__ x, const int* __restrict__ inv,
                    uint4* __restrict__ xe, int64_t rows, int64_t per_expert, int g,
                    int k, int E, int C, int V, int RT) {
  const int tx = threadIdx.x % RT;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads / RT) + threadIdx.x / RT;
  if (r >= rows) return;
  const int64_t e = r / per_expert, in_e = r % per_expert;
  const int64_t grp = in_e / C;
  const int p = inv[(grp * E + e) * C + in_e % C];
  uint4* dst = xe + r * V;
  if (p < 0) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int v = tx; v < V; v += RT) dst[v] = zero;
    return;
  }
  const uint4* src = x + (grp * g + p / k) * static_cast<int64_t>(V);
  for (int v = tx; v < V; v += RT) dst[v] = __ldg(src + v);
}

// 16 bytes of T as float32, and back with round to nearest even
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kE = 4;
  __device__ __forceinline__ static void load(const uint4& raw, float (&x)[4]) {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z);
    x[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&x)[4]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
  __device__ __forceinline__ static float round(float w) { return w; }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kE = 8;
  __device__ __forceinline__ static void load(const uint4& raw, float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&x)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return raw;
  }
  __device__ __forceinline__ static float round(float w) {
    return __bfloat162float(__float2bfloat16_rn(w));
  }
};

// tokens: groups * g; per_expert: groups * C; V: 16-byte vectors a row; RT:
// threads a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const uint4* __restrict__ ye, const int* __restrict__ slot,
                   const float* __restrict__ gates, uint4* __restrict__ out,
                   int64_t tokens, int64_t per_expert, int g, int k, int C, int V, int RT) {
  constexpr int kE = Chunk<T>::kE;
  const int tx = threadIdx.x % RT;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (kThreads / RT) + threadIdx.x / RT;
  if (t >= tokens) return;
  const int64_t grp = t / g;
  const int* st = slot + t * k;
  const float* gt = gates + t * k;
  for (int v = tx; v < V; v += RT) {
    float acc[kE];
#pragma unroll
    for (int i = 0; i < kE; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int s = st[j];
      if (s < 0) continue;
      const float w = Chunk<T>::round(gt[j]);
      const int64_t row = (s / C) * per_expert + grp * C + s % C;
      float y[kE];
      Chunk<T>::load(__ldg(ye + row * V + v), y);
#pragma unroll
      for (int i = 0; i < kE; ++i) acc[i] = fmaf(w, y[i], acc[i]);
    }
    out[t * V + v] = Chunk<T>::pack(acc);
  }
}

// threads a row: the largest power of two <= min(V, kThreads), halved while
// above a warp until it divides V (each thread an equal share of the row)
int row_threads(int64_t V) {
  int rt = 1;
  while (rt * 2 <= V && rt * 2 <= kThreads) rt *= 2;
  while (rt > 32 && V % rt) rt /= 2;
  return rt;
}

}  // namespace

// topi: contiguous int64 (groups, g, k), experts in [0, E); pos int64, keep
// bool (one byte), slot int32: (groups, g, k); inv int32 (groups, E * C).
// 1 <= E <= 1024, C >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int moe_positions(const void* topi, void* pos, void* keep, void* slot, void* inv,
                             int64_t groups, int64_t g, int64_t k, int64_t E, int64_t C,
                             void* stream) {
  if (groups <= 0 || g <= 0) return 0;
  const int64_t P = g * k;
  if (k <= 0 || E <= 0 || E > 1024 || C <= 0 || P > INT32_MAX || E * C > INT32_MAX ||
      groups > INT32_MAX)
    return cudaErrorInvalidValue;
  const int64_t tiles = (P + 31) / 32;
  const int warps = static_cast<int>(tiles < kMaxWarps ? tiles : kMaxWarps);
  const int span = static_cast<int>((tiles + warps - 1) / warps * 32);
  const size_t smem = sizeof(int) * warps * E;
  moe_positions_kernel<<<static_cast<unsigned>(groups), warps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(topi), static_cast<int64_t*>(pos),
      static_cast<uint8_t*>(keep), static_cast<int*>(slot), static_cast<int*>(inv),
      static_cast<int>(P), static_cast<int>(E), static_cast<int>(C), span);
  return static_cast<int>(cudaGetLastError());
}

// x: contiguous (groups * g, row_bytes); inv: int32 (groups, E * C) from
// moe_positions; xe: (E, groups * C, row_bytes); row_bytes a multiple of 16,
// x and xe 16-byte aligned.
extern "C" int moe_dispatch(const void* x, const void* inv, void* xe, int64_t groups,
                            int64_t g, int64_t k, int64_t E, int64_t C, int64_t row_bytes,
                            void* stream) {
  const int64_t rows = E * groups * C;
  if (rows <= 0 || row_bytes <= 0) return 0;
  if (g <= 0 || k <= 0 || row_bytes % 16 || g > INT32_MAX || C > INT32_MAX ||
      k > INT32_MAX || E > INT32_MAX)
    return cudaErrorInvalidValue;
  const int64_t V = row_bytes / 16;
  const int rt = row_threads(V);
  const int64_t blocks = (rows + kThreads / rt - 1) / (kThreads / rt);
  if (V > INT32_MAX || blocks > INT32_MAX) return cudaErrorInvalidValue;
  moe_dispatch_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(inv), static_cast<uint4*>(xe),
      rows, groups * C, static_cast<int>(g), static_cast<int>(k), static_cast<int>(E),
      static_cast<int>(C), static_cast<int>(V), rt);
  return static_cast<int>(cudaGetLastError());
}

// ye: contiguous (E, groups * C, d); slot int32 and gates float32: (groups,
// g, k); out (groups * g, d); dtype 0 = float32, 1 = bfloat16; d * size a
// multiple of 16, ye and out 16-byte aligned.
extern "C" int moe_combine(const void* ye, const void* slot, const void* gates, void* out,
                           int64_t groups, int64_t g, int64_t k, int64_t C, int64_t d,
                           int dtype, void* stream) {
  const int64_t tokens = groups * g;
  if (tokens <= 0 || d <= 0) return 0;
  const int64_t size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (size == 0 || k <= 0 || C <= 0 || d * size % 16 || g > INT32_MAX || C > INT32_MAX ||
      k > INT32_MAX)
    return cudaErrorInvalidValue;
  const int64_t V = d * size / 16;
  const int rt = row_threads(V);
  const int64_t blocks = (tokens + kThreads / rt - 1) / (kThreads / rt);
  if (V > INT32_MAX || blocks > INT32_MAX) return cudaErrorInvalidValue;
  const auto launch = dtype == 0 ? moe_combine_kernel<float> : moe_combine_kernel<__nv_bfloat16>;
  launch<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ye), static_cast<const int*>(slot),
      static_cast<const float*>(gates), static_cast<uint4*>(out), tokens, groups * C,
      static_cast<int>(g), static_cast<int>(k), static_cast<int>(C), static_cast<int>(V), rt);
  return static_cast<int>(cudaGetLastError());
}
