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
// The design therefore spends its effort on moving the cache once:
//   * the cache is read in its own (B,S,K,D) layout through strides (the
//     Pallas wrapper's transpose to (B,K,S,D) copies the whole cache);
//   * every positions loop is bounded by [max(0, len-window), len): dead
//     rows are never read, and any S is taken (no padding, no S % block);
//   * one CTA per (b, kv head, S-split) holds the group's query rows in
//     shared memory, so each cache row is fetched once for all `group`
//     heads that read it; the S-split (flash-decoding) fills the 132 SMs
//     when B*K is small (max_batch 4 x 8 kv heads = 32 pairs);
//   * a second small kernel combines the splits' (m, l, acc).
// Tiles are 32 rows, loaded with 16-byte vector loads and widened to fp32
// in shared memory; the dots are scalar FMAs.  wgmma, TMA and a pipelined
// ring of tiles are left for a later change.

#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per CTA
constexpr int TILE = 32;  // cache rows per tile
constexpr int GMAX = 16;  // largest supported group (H / K)

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ clen,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int S, int KH, int G, long long sqb, long long sqh,
                    long long skb, long long sks, long long skh, long long svb,
                    long long svs, long long svh, float scale, float cap,
                    int window, int splits, int chunk) {
  constexpr int P = D + 1;  // padded pitch: conflict-free column reads
  constexpr int OWN = (GMAX * D + NT - 1) / NT;
  __shared__ float qs[GMAX * D];
  __shared__ float ks[TILE * P];
  __shared__ float vs[TILE * P];
  __shared__ float ps[GMAX * TILE];
  __shared__ float ms[GMAX], ls[GMAX], cs[GMAX];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int L = min(clen[b], S);
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int start = max(split * chunk, lo);
  const int end = min(split * chunk + chunk, L);

  const TQ* qb = q + b * sqb + (long long)kh * G * sqh;
  for (int c = tid; c < G * D; c += NT) {
    qs[c] = rt::to_float(qb[(c / D) * sqh + (c % D)]) * scale;
  }
  if (tid < GMAX) {
    ms[tid] = rt::NEG;
    ls[tid] = 0.f;
  }
  float acc[OWN];
#pragma unroll
  for (int i = 0; i < OWN; ++i) acc[i] = 0.f;

  const TKV* kb = k + b * skb + kh * skh;
  const TKV* vb = v + b * svb + kh * svh;
  for (int t0 = start; t0 < end; t0 += TILE) {
    const int n = min(TILE, end - t0);
    __syncthreads();  // previous tile's readers are done (and qs is ready)
    rt::load_rows<TKV, D, TILE, NT>(ks, P, kb + t0 * sks, sks, 0, n, 1.f);
    rt::load_rows<TKV, D, TILE, NT>(vs, P, vb + t0 * svs, svs, 0, n, 1.f);
    __syncthreads();
    // scores: a warp holds one query row g against the tile's 32 rows
    for (int c = tid; c < G * TILE; c += NT) {
      const int g = c / TILE, t = c % TILE;
      float s = rt::NEG;
      if (t < n) {
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a += qs[g * D + d] * ks[t * P + d];
        s = rt::softcap(a, cap);
      }
      ps[c] = s;
    }
    __syncthreads();
    // online-softmax update, one warp per query row
    for (int g = warp; g < G; g += NT / 32) {
      const bool ok = lane < n;
      const float s = ps[g * TILE + lane];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, rt::warp_max(ok ? s : rt::NEG));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float sum = rt::warp_sum(p);
      ps[g * TILE + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g][d] = acc*corr + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int idx = tid + i * NT;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        float a = acc[i] * cs[g];
        for (int t = 0; t < n; ++t) a += ps[g * TILE + t] * vs[t * P + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();
  const long long base = ((long long)(b * KH + kh) * splits + split) * G;
#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D) part_acc[base * D + idx] = acc[i];
  }
  if (tid < G) {
    part_ml[2 * (base + tid)] = ms[tid];
    part_ml[2 * (base + tid) + 1] = ls[tid];
  }
}

// One CTA per (h, b), D threads: merge the splits' partial softmax states.
template <typename TQ>
__global__ void decode_combine_kernel(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc,
                                      TQ* __restrict__ out, int H, int KH, int G,
                                      int D, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kh = h / G, g = h % G;
  const long long base = (long long)(b * KH + kh) * splits * G + g;
  float M = rt::NEG;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part_ml[2 * (base + s * G)]);
  float L = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long i = base + (long long)s * G;
    const float w = expf(part_ml[2 * i] - M);
    L += part_ml[2 * i + 1] * w;
    a += part_acc[i * D + d] * w;
  }
  rt::store(out + ((long long)b * H + h) * D + d, a / fmaxf(L, 1e-30f));
}

template <typename TQ, typename TKV, int D>
void launch(const void* q, const void* k, const void* v, const int* clen, void* out,
            float* part_ml, float* part_acc, int B, int S, int H, int KH,
            long long sqb, long long sqh, long long skb, long long sks,
            long long skh, long long svb, long long svs, long long svh,
            float scale, float cap, int window, int splits, int chunk,
            cudaStream_t stream) {
  const int G = H / KH;
  decode_split_kernel<TQ, TKV, D><<<dim3(splits, KH, B), NT, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), clen, part_ml, part_acc, S, KH, G, sqb, sqh,
      skb, sks, skh, svb, svs, svh, scale, cap, window, splits, chunk);
  decode_combine_kernel<TQ><<<dim3(H, B), D, 0, stream>>>(
      part_ml, part_acc, static_cast<TQ*>(out), H, KH, G, D, splits);
}

}  // namespace

// Returns cudaGetLastError() after the launches, or -1 for an argument the
// kernel does not take (the Python wrapper checks first).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* clen, void* out,
    float* part_ml, float* part_acc, int B, int S, int H, int KH, int D,
    long long sqb, long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, int q_dtype, int kv_dtype,
    float scale, float cap, int window, int splits, int chunk, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > GMAX) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_ARGS q, k, v, clen, out, part_ml, part_acc, B, S, H, KH, sqb, sqh, skb, \
                sks, skh, svb, svs, svh, scale, cap, window, splits, chunk, st
#define RT_D(TQ, TKV)                                   \
  switch (D) {                                          \
    case 32: launch<TQ, TKV, 32>(RT_ARGS); break;       \
    case 64: launch<TQ, TKV, 64>(RT_ARGS); break;       \
    case 128: launch<TQ, TKV, 128>(RT_ARGS); break;     \
    default: return -1;                                 \
  }
  using bf16 = __nv_bfloat16;
  if (q_dtype == rt::F32 && kv_dtype == rt::F32) {
    RT_D(float, float)
  } else if (q_dtype == rt::F32 && kv_dtype == rt::BF16) {
    RT_D(float, bf16)
  } else if (q_dtype == rt::BF16 && kv_dtype == rt::F32) {
    RT_D(bf16, float)
  } else if (q_dtype == rt::BF16 && kv_dtype == rt::BF16) {
    RT_D(bf16, bf16)
  } else {
    return -1;
  }
#undef RT_D
#undef RT_ARGS
  return static_cast<int>(cudaGetLastError());
}
