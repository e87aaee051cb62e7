// Decode (one-token) attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention.py, body `_decode_kernel`): the same
// function on the same inputs -- q (B,H,D) against k/v cache (B,S,K,D),
// per-row cache_len (B,), positions pos < cache_len[b] (and, with a window,
// pos > cache_len[b]-1-window), optional tanh softcap, fp32 online softmax,
// output in q's dtype.
//
// Bound on the H100: bytes.  Each live cache row is read once (K and V) and
// used for `group` dot products, about 2*group FLOP per byte of bf16 cache,
// far below the ~295 FLOP/byte where the tensor cores would be the limit.
// So the kernel's work is to keep HBM busy, in one launch:
//   * grid (splits, K, B) with a thread-block cluster of (splits, 1, 1):
//     the `splits` CTAs of one (b, kv head) form one cluster.  The host
//     picks splits (1, 2, 4 or 8) from B*K alone, never from cache_len, so
//     the call does not synchronise the stream;
//   * each CTA cuts row b's live range [max(0, L - window), L) itself, from
//     cache_len[b] on the device, into `splits` equal parts of whole 16-row
//     tiles (`row_part`; `decode_attention.row_parts` is its Python
//     mirror): the work follows the longest live slot, not S, and no
//     CTA of a live row idles while a sibling walks the rest;
//   * K and V tiles go through a four-stage cp.async ring in shared memory
//     (zero-filled past the part's end), read in place through the
//     (B,S,K,D) strides: three tiles are in flight while one is used.  A
//     tile is 32 rows; 16 at group 8 and 8 at group 16 (registers), and at
//     most 16 where a stage of K and V would pass 16 KB (fp32 at D = 128),
//     so the ring stays within 64 KB and three CTAs fit on an SM;
//   * the group's q rows sit in registers, scaled, fp32 (loaded while the
//     first tiles are in flight); each of the 4 warps takes every fourth
//     key row of a tile, its lanes split D (D/32 contiguous elements each,
//     one vector read: 16 bytes at D = 128 fp32), and one multi-value
//     shuffle reduction (`warp_allreduce`, ~2 shuffles per score instead of
//     5) gives the warp all its rows' scores; each warp keeps its own
//     online softmax (m, l, acc) in fp32 registers sized by the group's
//     bucket (1, 2, 4, 8, 16), not by 16, with the fast exp (__expf: its
//     error is far inside the fp32 bar for the weights that matter);
//   * the combine runs in the CTA, then in the cluster: the warps' partials
//     merge in shared memory into the CTA's (m, l, acc); after
//     cluster.sync() every CTA merges a slice of the (G x D) output from
//     the `splits` CTAs' partials through distributed shared memory (all
//     remote loads independent) and writes it in q's dtype; a second
//     cluster.sync() keeps each CTA's shared memory alive for its peers.
//     No scratch in device memory, no second kernel.
// All math is fp32 for every dtype mix (bf16/fp32 q x bf16/fp32 cache).

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;  // threads per CTA
constexpr int NW = NT / 32;
constexpr int STAGES = 4;  // tiles in the ring
constexpr int GRAIN = 16;  // the split of a row's live range is in whole 16-row tiles
constexpr int GMAX = 16;   // largest supported group (H / K)

// Rows of a tile each warp takes: 8, fewer where the warp's RPW x group
// scores would pass 32 registers or a tile of K and V would pass 16 KB
// (fp32 at D = 128), so four stages stay within 64 KB.
template <typename TKV, int D, int GB>
__host__ __device__ constexpr int rows_per_warp() {
  int r = GB >= 16 ? 2 : GB >= 8 ? 4 : 8;
  while (r > 2 && 2 * NW * r * D * sizeof(TKV) > 16384) r /= 2;
  return r;
}

// Sum each of the R values of every lane over the warp, leaving all R sums
// in every lane: a reduce-scatter (each halving step sends half the values
// still held), plain butterflies once one value is left, then the matching
// all-gather.  About 2R shuffles instead of the 5R of R butterflies.
template <int R>
__device__ __forceinline__ void warp_allreduce(float (&v)[R]) {
  const int lane = threadIdx.x & 31;
  int c = R;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (c > 1) {
      const bool up = lane & o;  // this lane keeps the upper half
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        if (i < c / 2) {
          const float send = up ? v[i] : v[i + c / 2];
          const float keep = up ? v[i + c / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      c /= 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
#pragma unroll
  for (int o = 1; o <= 16; o <<= 1) {
    if ((16 / o) * 2 <= R) {  // offset o was one of the log2(R) halving steps
      const bool up = lane & o;
#pragma unroll
      for (int i = R / 2 - 1; i >= 0; --i) {
        if (i < c) {
          const float other = __shfl_xor_sync(0xffffffffu, v[i], o);
          const float mine = v[i];
          v[i] = up ? other : mine;
          v[i + c] = up ? mine : other;
        }
      }
      c *= 2;
    }
  }
}

// Rows [start, end) of the live range [lo, L) that part `split` of `splits`
// takes: equal counts of whole GRAIN-row tiles, the last part ragged.
__device__ __forceinline__ void row_part(int L, int lo, int split, int splits, int& start,
                                         int& end) {
  const int n_tiles = (L - lo + GRAIN - 1) / GRAIN;
  const int per = (n_tiles + splits - 1) / splits;
  start = min(L, lo + split * per * GRAIN);
  end = min(L, start + per * GRAIN);
}

template <typename TKV, int D, int GB>
constexpr size_t smem_bytes() {
  const size_t ring = STAGES * 2 * NW * rows_per_warp<TKV, D, GB>() * D * sizeof(TKV);
  const size_t part = sizeof(float) * (NW + 1) * GB * (D + 2);
  return ring > part ? ring : part;
}

template <typename TKV, int D, int GB>
__global__ void __launch_bounds__(NT)
decode_kernel(const void* __restrict__ qv, int q_bf16, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ clen,
              void* __restrict__ outv, int S, int H, int KH, int G, long long sqb,
              long long sqh, long long skb, long long sks, long long skh, long long svb,
              long long svs, long long svh, float scale, float cap, int window) {
  constexpr int E = D / 32;                          // elements per lane
  constexpr int RPW = rows_per_warp<TKV, D, GB>();
  constexpr int TILE = NW * RPW;                     // rows per tile
  constexpr int CPR = D * sizeof(TKV) / 16;          // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* ring = reinterpret_cast<TKV*>(smem_raw);      // STAGES x {K, V} x TILE x D
  // after the loop: the warps' partials (m, l, acc), then the CTA's
  float* wm = reinterpret_cast<float*>(smem_raw);    // NW x GB
  float* wl = wm + NW * GB;                          // NW x GB
  float* wacc = wl + NW * GB;                        // NW x GB x D
  float* cm = wacc + NW * GB * D;                    // GB
  float* cl = cm + GB;                               // GB
  float* cacc = cl + GB;                             // GB x D

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L = min(clen[b], S);
  const int lo = window > 0 ? max(0, L - window) : 0;
  int start, end;
  row_part(L, lo, split, splits, start, end);
  const int nt = (end - start + TILE - 1) / TILE;

  const TKV* kb = k + b * skb + kh * skh;
  const TKV* vb = v + b * svb + kh * svh;
  auto load = [&](int j) {  // tile j into stage j % STAGES; rows past `end` zero-filled
    TKV* st = ring + (j % STAGES) * 2 * TILE * D;
    const int r0 = start + j * TILE;
    for (int c = threadIdx.x; c < 2 * TILE * CPR; c += NT) {
      const int which = c / (TILE * CPR), r = (c / CPR) % TILE, ch = c % CPR;
      const bool ok = r0 + r < end;
      const long long row = ok ? r0 + r : 0;
      const TKV* src = which ? vb + row * svs : kb + row * sks;
      tc::cp_async16(reinterpret_cast<char*>(st + (which * TILE + r) * D) + ch * 16,
                     reinterpret_cast<const char*>(src) + ch * 16, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nt) load(j);
    tc::cp_async_commit();
  }

  // the group's q rows, scaled, this lane's D/32 elements (while the first
  // tiles are on their way)
  float qr[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const long long off = b * sqb + (long long)(kh * G + min(g, G - 1)) * sqh + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(qv)[off + e])
                             : static_cast<const float*>(qv)[off + e];
      qr[g][e] = g < G ? x * scale : 0.f;
    }
  }

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = rt::NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int j = 0; j < nt; ++j) {
    tc::cp_async_wait<STAGES - 2>();  // tile j has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; tile j-1's readers are done
    if (j + STAGES - 1 < nt) load(j + STAGES - 1);  // into the stage tile j-1 used
    tc::cp_async_commit();
    const TKV* kt = ring + (j % STAGES) * 2 * TILE * D;
    const TKV* vt = kt + TILE * D;
    const int n = min(TILE, end - start - j * TILE);

    // scores of this warp's rows warp, warp + NW, ... (zero-filled past
    // the end, masked to NEG below)
    float s[RPW * GB];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float kx[E];
      rt::load_vec<TKV, E>(kt + (warp + NW * i) * D + lane * E, kx);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) a += qr[g][e] * kx[e];
        s[i * GB + g] = a;
      }
    }
    warp_allreduce<RPW * GB>(s);
    // online softmax over the warp's rows, then acc += p v
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float sc = warp + NW * i < n ? rt::softcap(s[i * GB + g], cap) : rt::NEG;
        s[i * GB + g] = sc;
        mx = fmaxf(mx, sc);
      }
      const float corr = __expf(m[g] - mx);
      m[g] = mx;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pv = warp + NW * i < n ? __expf(s[i * GB + g] - mx) : 0.f;
        s[i * GB + g] = pv;
        sum += pv;
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float vx[E];
      rt::load_vec<TKV, E>(vt + (warp + NW * i) * D + lane * E, vx);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += s[i * GB + g] * vx[e];
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds the partials

#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      wm[warp * GB + g] = m[g];
      wl[warp * GB + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) wacc[(warp * GB + g) * D + lane * E + e] = acc[g][e];
  }
  __syncthreads();
  // the CTA's partial: its warps' merged
  for (int idx = threadIdx.x; idx < GB * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float M = rt::NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * GB + g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = __expf(wm[w * GB + g] - M);
      a += wacc[(w * GB + g) * D + d] * c;
      ls += wl[w * GB + g] * c;
    }
    cacc[idx] = a;
    if (d == 0) {
      cm[g] = M;
      cl[g] = ls;
    }
  }
  cluster.sync();  // every CTA's partial is written

  // this CTA's slice of the (G x D) output, merged from the cluster's
  // partials through distributed shared memory (all loads independent)
  const int per = (G * D + splits - 1) / splits;
  const int o_end = min(G * D, (split + 1) * per);
  for (int idx = split * per + threadIdx.x; idx < o_end; idx += NT) {
    const int g = idx / D;
    float pm[8], pl[8], pa[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < splits) {
        pm[r] = *cluster.map_shared_rank(cm + g, r);
        pl[r] = *cluster.map_shared_rank(cl + g, r);
        pa[r] = *cluster.map_shared_rank(cacc + idx, r);
      }
    }
    float M = rt::NEG;
#pragma unroll
    for (int r = 0; r < 8; ++r) M = r < splits ? fmaxf(M, pm[r]) : M;
    float Lsum = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < splits) {
        const float c = __expf(pm[r] - M);
        Lsum += pl[r] * c;
        a += pa[r] * c;
      }
    }
    const float o = a / fmaxf(Lsum, 1e-30f);
    const long long oi = ((long long)b * H + kh * G + g) * D + idx % D;
    if (q_bf16) {
      rt::store(static_cast<__nv_bfloat16*>(outv) + oi, o);
    } else {
      rt::store(static_cast<float*>(outv) + oi, o);
    }
  }
  cluster.sync();  // peers are done reading this CTA's shared memory
}

template <typename TKV, int D, int GB>
int launch(const void* q, int q_bf16, const void* k, const void* v, const int* clen,
           void* out, int B, int S, int H, int KH, long long sqb, long long sqh,
           long long skb, long long sks, long long skh, long long svb, long long svs,
           long long svh, float scale, float cap, int window, int splits,
           cudaStream_t stream) {
  auto kernel = decode_kernel<TKV, D, GB>;
  const size_t smem = smem_bytes<TKV, D, GB>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KH, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, q_bf16, static_cast<const TKV*>(k),
                           static_cast<const TKV*>(v), clen, out, S, H, KH, H / KH, sqb,
                           sqh, skb, sks, skh, svb, svs, svh, scale, cap, window);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, int D, typename... A>
int launch_g(int G, A... args) {
  if (G <= 1) return launch<TKV, D, 1>(args...);
  if (G <= 2) return launch<TKV, D, 2>(args...);
  if (G <= 4) return launch<TKV, D, 4>(args...);
  if (G <= 8) return launch<TKV, D, 8>(args...);
  return launch<TKV, D, 16>(args...);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or -1 for an
// argument the kernel does not take (the Python wrapper checks first).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* clen, void* out, int B,
    int S, int H, int KH, int D, long long sqb, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs, long long svh,
    int q_dtype, int kv_dtype, float scale, float cap, int window, int splits,
    void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > GMAX) return -1;
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return -1;
  if (q_dtype != rt::F32 && q_dtype != rt::BF16) return -1;
  const int q_bf16 = q_dtype == rt::BF16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_ARGS H / KH, q, q_bf16, k, v, clen, out, B, S, H, KH, sqb, sqh, skb, sks, \
                skh, svb, svs, svh, scale, cap, window, splits, st
#define RT_D(TKV)                                      \
  switch (D) {                                         \
    case 32: return launch_g<TKV, 32>(RT_ARGS);        \
    case 64: return launch_g<TKV, 64>(RT_ARGS);        \
    case 128: return launch_g<TKV, 128>(RT_ARGS);      \
    default: return -1;                                \
  }
  if (kv_dtype == rt::F32) {
    RT_D(float)
  } else if (kv_dtype == rt::BF16) {
    RT_D(__nv_bfloat16)
  }
#undef RT_D
#undef RT_ARGS
  return -1;
}
