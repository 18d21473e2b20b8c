// Single-token attention against a KV cache (a decode step) for Hopper.
//
// Replaces no Pallas kernel: the JAX package's decode attention is plain jnp
// (src/repro/models/layers/attention.py::decode_attention).  It was added
// because that plain version, ported as float32 casts of the whole cache,
// two einsums and a masked softmax, took 65 % of olmo_1b.chat's decode
// device time.  It computes models/layers/attention.py::decode_attention:
// q (b, 1, h, hd) against caches (b, c, kv, hd), kv = h / g; slot j of a row
// is valid when kv_pos[j] >= 0, kv_pos[j] <= pos and, with a window,
// kv_pos[j] > pos - window; o = softmax(q k^T * scale) v over the valid
// slots, in float32 (q taken to float32 and scaled, every product and sum in
// float32, the online softmax's running max m, denominator l and numerator
// acc), cast to q's type (round to nearest even) at the end.  A masked slot
// weighs exp(-1e30 - m) = 0 in the plain version, so its K and V are never
// read.  A row with no valid slot is a uniform softmax over every slot there
// (each score -1e30): the mean of V, which the kernel computes then.  pos is
// read from device memory, so a step needs no host sync.
//
// Bound on an H100: K and V of the valid slots read once (2*b*c*kv*hd
// elements), 4*b*c*h*hd operations: about one operation a byte at g = 1, far
// below the ridge (~295 a byte in bf16), so bytes alone bound it.  At
// olmo_1b.chat's (32, 640, 16, 128) bf16 that is 168 MB, 50 us at 3.35 TB/s.
//
// Design: CUDA cores (the products are GEMVs).  A block of 4 warps owns one
// (batch row, KV head) pair, or a contiguous range of its slots when the
// pairs are too few to fill the card (`splits`, a function of the shapes
// chosen by the wrapper).  K and V tiles of 4 KiB each stream through a
// 4-stage cp.async ring in shared memory, 16-byte copies with neighbouring
// threads on neighbouring addresses of a slot's row, three stages in flight
// while one is consumed; an invalid slot's copy reads nothing and zero-fills
// (src size 0).  The slot positions of the next tile are loaded one tile
// ahead, so validity is known when its copies are issued.  A row of the tile
// is consumed by a group of kL lanes, each holding 16 bytes (8 bf16 or 4
// f32) of it: the g query heads sharing the KV head each form a partial dot
// product, reduced across the group with shuffles, and update the group's
// own (m, l, acc) for its dimensions.  At the end the row groups of a warp,
// then the warps, then (split) the splits are merged in a fixed order: no
// atomics, so two launches give the same bits.  Splits write (m, l, acc) to
// a float32 workspace that a second launch merges.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kTileBytes = 4096;  // of K (and as much of V) a stage
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// 16 bytes of T as float32
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kE = 4;
  __device__ __forceinline__ static void load(const void* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kE = 8;
  __device__ __forceinline__ static void load(const void* p, float (&x)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// how a row of HD elements of T is spread over lanes, and the tile geometry
template <typename T, int HD, int GM>
struct Geom {
  static constexpr int kE = Chunk<T>::kE;        // elements a 16-byte chunk
  static constexpr int kChunks = HD / kE;        // chunks a row
  static constexpr int kL = kChunks < 32 ? kChunks : 32;  // lanes a row
  static constexpr int kP = kChunks / kL;        // chunks a lane
  static constexpr int kPE = kP * kE;            // elements a lane
  static constexpr int kR = 32 / kL;             // rows a warp takes at once
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  static constexpr int kTile = kTileBytes / kRowBytes;  // slots a tile
  static constexpr int kIter = kTile / (kWarps * kR);   // row steps a tile
  static constexpr int kIssue = kTile * kChunks / kThreads;  // copies a thread
  static constexpr int kRing = kStages * 2 * kTileBytes;
  // the warps' (m, l, acc) for the block's merge, over the ring
  static constexpr int kMerge = kWarps * GM * (HD + 2) * static_cast<int>(sizeof(float));
  static constexpr int kSmem = kRing > kMerge ? kRing : kMerge;
  static_assert(kChunks % kL == 0 && 32 % kL == 0, "a row's lanes");
  static_assert(kIter >= 1 && kTile % (kWarps * kR) == 0, "a tile's rows");
  static_assert(kIssue >= 1 && kTile * kChunks % kThreads == 0, "a tile's copies");
};

// the mean of V over every slot of (b, kvh) at dimension d: a row with no
// valid slot (the plain version's uniform softmax over -1e30 scores)
template <typename T>
__device__ float mean_v(const T* v, int64_t b, int kvh, int d, int C, int KV, int HD) {
  float s = 0.f;
  for (int c = 0; c < C; ++c)
    s += to_float(v[((b * C + c) * KV + kvh) * static_cast<int64_t>(HD) + d]);
  return s / static_cast<float>(C);
}

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kv_pos,
                   const int* __restrict__ pos_ptr, T* __restrict__ o,
                   float* __restrict__ ws_ml, float* __restrict__ ws_acc, int C,
                   int KV, int G, int splits, int chunk, int window, float scale) {
  using Gm = Geom<T, HD, GM>;
  constexpr int kE = Gm::kE, kL = Gm::kL, kP = Gm::kP, kPE = Gm::kPE, kR = Gm::kR;
  constexpr int kTile = Gm::kTile, kChunks = Gm::kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int valid_s[kStages][kTile];

  const int pair = blockIdx.x / splits;  // b * KV + kvh
  const int split = blockIdx.x % splits;
  const int64_t b = pair / KV;
  const int kvh = pair % KV;
  const int c_begin = split * chunk;
  const int c_end = min(C, c_begin + chunk);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kTile - 1) / kTile : 0;
  const int64_t row_stride = static_cast<int64_t>(KV) * HD;  // elements a slot
  const T* kb = k + (b * C * KV + kvh) * HD;
  const T* vb = v + (b * C * KV + kvh) * HD;
  const int p = *pos_ptr;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / kL, li = lane % kL;

  // this lane's query dimensions (chunks li + kL * j), scaled, as float32;
  // heads past G (GM rounds G up) are zero and never stored
  float qf[GM][kPE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      float x[kE];
      if (g < G) {
        Chunk<T>::load(q + (static_cast<int64_t>(pair) * G + g) * HD + (li + kL * j) * kE, x);
      } else {
#pragma unroll
        for (int e = 0; e < kE; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) qf[g][j * kE + e] = x[e] * scale;
    }
  }

  // slot positions of the next tile to issue, loaded one tile ahead
  int kp[Gm::kIssue];
  auto fetch = [&](int t) {
#pragma unroll
    for (int j = 0; j < Gm::kIssue; ++j) {
      const int c = c_begin + t * kTile + (tid + j * kThreads) / kChunks;
      kp[j] = (t < n_tiles && c < c_end) ? __ldg(kv_pos + c) : -1;
    }
  };
  auto issue = [&](int t) {
    const int st = t % kStages;
    unsigned char* ks = smem + st * 2 * kTileBytes;
    unsigned char* vs = ks + kTileBytes;
#pragma unroll
    for (int j = 0; j < Gm::kIssue; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kChunks, ch = i % kChunks;
      const int x = kp[j];
      const bool ok = x >= 0 && x <= p &&
                      (window <= 0 || static_cast<int64_t>(x) > static_cast<int64_t>(p) - window);
      const int64_t off = (ok ? static_cast<int64_t>(c_begin + t * kTile + r) * row_stride : 0) +
                          ch * kE;
      hopper::cp_async16(ks + r * Gm::kRowBytes + ch * 16, kb + off, ok ? 16 : 0);
      hopper::cp_async16(vs + r * Gm::kRowBytes + ch * 16, vb + off, ok ? 16 : 0);
      if (ch == 0) valid_s[st][r] = ok;
    }
    fetch(t + 1);
  };

  float m[GM], l[GM], acc[GM][kPE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kPE; ++e) acc[g][e] = 0.f;
  }

  fetch(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s);
    hopper::cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; tile t - 1 is consumed
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    hopper::cp_async_commit();
    const int st = t % kStages;
    const unsigned char* ks = smem + st * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;
#pragma unroll
    for (int it = 0; it < Gm::kIter; ++it) {
      const int r = (it * kWarps + warp) * kR + rg;
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        float kf[kE];
        Chunk<T>::load(ks + r * Gm::kRowBytes + (li + kL * j) * 16, kf);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < kE; ++e) s[g] = fmaf(qf[g][j * kE + e], kf[e], s[g]);
      }
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int off = kL / 2; off > 0; off >>= 1) s[g] += __shfl_xor_sync(kFull, s[g], off);
      if (valid_s[st][r]) {
        float vf[kPE];
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          float x[kE];
          Chunk<T>::load(vs + r * Gm::kRowBytes + (li + kL * j) * 16, x);
#pragma unroll
          for (int e = 0; e < kE; ++e) vf[j * kE + e] = x[e];
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = expf(m[g] - m_new);
          const float pr = expf(s[g] - m_new);
          l[g] = fmaf(l[g], alpha, pr);
#pragma unroll
          for (int e = 0; e < kPE; ++e) acc[g][e] = fmaf(acc[g][e], alpha, pr * vf[e]);
          m[g] = m_new;
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge area lies over it

  // merge the warp's row groups (lanes kL, 2 kL, ... apart)
#pragma unroll
  for (int off = kL; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float m2 = __shfl_xor_sync(kFull, m[g], off);
      const float l2 = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], m2);
      const float a1 = expf(m[g] - mx), a2 = expf(m2 - mx);
      l[g] = l[g] * a1 + l2 * a2;
#pragma unroll
      for (int e = 0; e < kPE; ++e) {
        const float acc2 = __shfl_xor_sync(kFull, acc[g][e], off);
        acc[g][e] = acc[g][e] * a1 + acc2 * a2;
      }
      m[g] = mx;
    }
  }
  float* m_s = reinterpret_cast<float*>(smem);  // [kWarps][GM]
  float* l_s = m_s + kWarps * GM;               // [kWarps][GM]
  float* acc_s = l_s + kWarps * GM;             // [kWarps][GM][HD]
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (li == 0) {
        m_s[warp * GM + g] = m[g];
        l_s[warp * GM + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < kP; ++j)
#pragma unroll
        for (int e = 0; e < kE; ++e)
          acc_s[(warp * GM + g) * HD + (li + kL * j) * kE + e] = acc[g][j * kE + e];
    }
  }
  __syncthreads();

  // merge the warps, in order, for each (head, dimension) of the pair
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * GM + g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(m_s[w * GM + g] - mx);
      lt += l_s[w * GM + g] * a;
      at += acc_s[(w * GM + g) * HD + d] * a;
    }
    const int64_t row = static_cast<int64_t>(pair) * G + g;  // (b, head) of q and o
    if (splits == 1) {
      store(o + row * HD + d, lt > 0.f ? at / lt : mean_v(v, b, kvh, d, C, KV, HD));
    } else {
      const int64_t part = (static_cast<int64_t>(pair) * splits + split) * G + g;
      if (d == 0) {
        ws_ml[2 * part] = mx;
        ws_ml[2 * part + 1] = lt;
      }
      ws_acc[part * HD + d] = at;
    }
  }
}

// the splits of (pair, head g) merged in order: a block a (pair, g), a
// thread a dimension
template <typename T>
__global__ void decode_attn_merge(const float* __restrict__ ws_ml,
                                  const float* __restrict__ ws_acc,
                                  const T* __restrict__ v, T* __restrict__ o, int C,
                                  int KV, int G, int HD, int splits) {
  const int64_t row = blockIdx.x;  // pair * G + g
  const int pair = static_cast<int>(row / G), g = static_cast<int>(row % G);
  const int d = threadIdx.x;
  const int64_t first = static_cast<int64_t>(pair) * splits * G + g;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ws_ml[2 * (first + s * G)]);
  float lt = 0.f, at = 0.f;
  for (int s = 0; s < splits; ++s) {
    const int64_t part = first + s * G;
    const float a = expf(ws_ml[2 * part] - mx);
    lt += ws_ml[2 * part + 1] * a;
    at += ws_acc[part * HD + d] * a;
  }
  store(o + row * HD + d, lt > 0.f ? at / lt : mean_v(v, pair / KV, pair % KV, d, C, KV, HD));
}

struct Args {
  const void *q, *k, *v, *kv_pos, *pos;
  void *o, *ws;
  int64_t b, c, kv, g, hd;
  int splits, window;
  float scale;
};

template <typename T, int HD, int GM>
int launch(const Args& a, cudaStream_t stream) {
  using Gm = Geom<T, HD, GM>;
  const int64_t pairs = a.b * a.kv;
  const int64_t blocks = pairs * a.splits;
  const int64_t chunk = (a.c + a.splits - 1) / a.splits;
  if (blocks > INT32_MAX || a.c > INT32_MAX || a.kv > INT32_MAX) return cudaErrorInvalidValue;
  const int64_t parts = blocks * a.g;
  float* ws_ml = static_cast<float*>(a.ws);
  float* ws_acc = ws_ml + 2 * parts;
  decode_attn_kernel<T, HD, GM><<<static_cast<unsigned>(blocks), kThreads, Gm::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.kv_pos), static_cast<const int*>(a.pos), static_cast<T*>(a.o),
      ws_ml, ws_acc, static_cast<int>(a.c), static_cast<int>(a.kv), static_cast<int>(a.g),
      a.splits, static_cast<int>(chunk), a.window, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  decode_attn_merge<T><<<static_cast<unsigned>(pairs * a.g), HD, 0, stream>>>(
      ws_ml, ws_acc, static_cast<const T*>(a.v), static_cast<T*>(a.o), static_cast<int>(a.c),
      static_cast<int>(a.kv), static_cast<int>(a.g), HD, a.splits);
  return static_cast<int>(cudaGetLastError());
}

// GM: the group size rounded up to 1, 2, 4 or 8
template <typename T, int HD>
int launch_g(const Args& a, cudaStream_t stream) {
  if (a.g == 1) return launch<T, HD, 1>(a, stream);
  if (a.g == 2) return launch<T, HD, 2>(a, stream);
  if (a.g <= 4) return launch<T, HD, 4>(a, stream);
  if (a.g <= 8) return launch<T, HD, 8>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_hd(const Args& a, cudaStream_t stream) {
  switch (a.hd) {
    case 32: return launch_g<T, 32>(a, stream);
    case 64: return launch_g<T, 64>(a, stream);
    case 128: return launch_g<T, 128>(a, stream);
    case 256: return launch_g<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: contiguous (b, 1, kv * g, hd); k, v: contiguous (b, c, kv, hd), all
// of one dtype (0 = float32, 1 = bfloat16) and 16-byte aligned; kv_pos: (c,)
// int32; pos: one int32, both on the device; ws: float32 scratch of
// b * kv * splits * g * (hd + 2) elements when splits > 1; window 0 = none;
// hd in {32, 64, 128, 256}, 1 <= g <= 8, 1 <= splits <= c.  Launches on
// `stream` (a second, merging launch when splits > 1) and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_pos, const void* pos, void* o,
                                    void* ws, int64_t b, int64_t c, int64_t kv,
                                    int64_t g, int64_t hd, int dtype, int splits,
                                    int window, float scale, void* stream) {
  if (b <= 0 || kv <= 0) return 0;
  if (c <= 0 || g <= 0 || splits <= 0 || splits > c || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, kv_pos, pos, o, ws, b, c, kv, g, hd, splits, window, scale};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}
