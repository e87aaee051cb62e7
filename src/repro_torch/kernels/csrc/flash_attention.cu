// Flash attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`): the same
// function on the same inputs -- q (B,Sq,H,D) against k/v (B,Sk,K,D), GQA
// with kv head h // group, causal or full masking, sliding window, tanh
// softcap, q_offset, fp32 (m, l, acc) online softmax, output divided by
// max(l, 1e-30), in q's dtype.
//
// Bound on the H100: at the serving prefill shapes (a prompt group of a few
// hundred tokens, D = 128) the work is about 4*Sq*Sk_live*D*H FLOP against
// (q + k + v + out) bytes, well above the ridge, so the bound is the
// tensor-core rate.  This first kernel does its dots with fp32 scalar FMAs
// out of shared memory, so it runs far from that bound; wgmma on bf16
// operands is the later step.  What the design already does:
//   * q/k/v are read in their (B,S,H,D) layouts through strides (the Pallas
//     wrapper transposes all three to (B,H,S,D));
//   * causal and window masks are loop bounds over k blocks, so dead tiles
//     cost nothing, and only the diagonal tiles evaluate a mask;
//   * ragged Sq/Sk tails are masked in the tile, not asserted (the serving
//     prefill pads prompts to a multiple of 16, not of the block);
//   * one CTA per (q block of 64, head, batch); 256 threads each own a 4x4
//     block of scores and a 4 x D/16 block of the output, so every value
//     read from shared memory feeds 2-4 FMAs.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int BQ = 64;
constexpr int BK = 64;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KH, long long sqb, long long sqs, long long sqh,
                 long long skb, long long sks, long long skh, long long svb,
                 long long svs, long long svh, float scale, float cap,
                 int causal, int window, int q_offset) {
  constexpr int P = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;         // BQ x P, pre-scaled q
  float* ks = qs + BQ * P;  // BK x P
  float* vs = ks + BK * P;  // BK x P
  float* ps = vs + BK * P;  // BQ x PP probabilities

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qb * BQ;
  const int nq = min(BQ, Sq - q0);

  rt::load_rows<T, D, BQ, NT>(qs, P, q + b * sqb + h * sqh + q0 * sqs, sqs, 0, nq, scale);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // live k range of this q block: loop bounds, not masks
  const int qlo = q0 + q_offset, qhi = q0 + nq - 1 + q_offset;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;
  int kstart = window > 0 ? max(0, qlo - window + 1) : 0;
  kstart = (kstart / BK) * BK;

  const T* kb = k + b * skb + kh * skh;
  const T* vb = v + b * svb + kh * svh;
  for (int k0 = kstart; k0 < kend; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    __syncthreads();  // previous tile's readers are done
    rt::load_rows<T, D, BK, NT>(ks, P, kb + k0 * sks, sks, 0, nk, 1.f);
    rt::load_rows<T, D, BK, NT>(vs, P, vb + k0 * svs, svs, 0, nk, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

    // mask, softcap, online softmax; a row's 64 scores live on 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + q_offset;
      bool ok[4];
      float mx = rt::NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Sk && (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
        s[i][j] = ok[j] ? rt::softcap(s[i][j], cap) : rt::NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - mn) : 0.f;
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < nk; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* orow = o + (((long long)b * Sq + q0 + r) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) rt::store(orow + tx + 16 * j, acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int KH, long long sqb, long long sqs, long long sqh,
           long long skb, long long sks, long long skh, long long svb,
           long long svs, long long svh, float scale, float cap, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KH, sqb, sqs, sqh, skb, sks, skh, svb, svs,
      svh, scale, cap, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Output o is (B,Sq,H,D) contiguous.  Returns cudaGetLastError() after the
// launch, or -1 for an argument the kernel does not take (the Python
// wrapper checks first).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
    int H, int KH, int D, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, int dtype, float scale, float cap, int causal, int window,
    int q_offset, void* stream) {
  if (KH <= 0 || H % KH != 0 || Sq <= 0 || Sk <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_ARGS q, k, v, o, B, Sq, Sk, H, KH, sqb, sqs, sqh, skb, sks, skh, svb, \
                svs, svh, scale, cap, causal, window, q_offset, st
#define RT_D(T)                                          \
  switch (D) {                                           \
    case 32: return launch<T, 32>(RT_ARGS);              \
    case 64: return launch<T, 64>(RT_ARGS);              \
    case 128: return launch<T, 128>(RT_ARGS);            \
    default: return -1;                                  \
  }
  if (dtype == rt::F32) {
    RT_D(float)
  } else if (dtype == rt::BF16) {
    RT_D(__nv_bfloat16)
  }
#undef RT_D
#undef RT_ARGS
  return -1;
}
