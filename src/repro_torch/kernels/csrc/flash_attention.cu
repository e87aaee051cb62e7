// Flash attention forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`): the same
// function on the same inputs -- q (B,Sq,H,D) against k/v (B,Sk,K,D), GQA
// with kv head h // group, causal or full masking, sliding window, tanh
// softcap, q_offset, fp32 (m, l, acc) online softmax, output divided by
// max(l, 1e-30), in q's dtype.
//
// Bound on the H100: at the serving prefill shapes (one prompt of ~300
// tokens, H = 32, D = 128 or 64) the work is 4*D*H*(causal pairs) FLOP,
// about 0.8 GFLOP (under 1 us at the bf16 tensor peak), against ~6 MB of
// q, k, v and out (~2 us at 3.35 TB/s): bytes bound it, and at 160 CTAs
// the wave count and the latency of each key tile decide the time.
//
// Two kernels, chosen by dtype:
//   * bf16 (the serving path): FlashAttention-2 on mma.sync tensor cores.
//     One CTA of 4 warps per (q block of 64, head, batch), longest causal
//     span first; each warp owns 16 query rows.  Q is loaded once into
//     registers as ldmatrix A-fragments (unscaled: bf16 q is exact, and the
//     scale goes on S in fp32, then the softcap, then the mask, as in the
//     Pallas kernel).  K/V tiles of 64 keys go through a two-stage cp.async
//     ring (tile j+1 is in flight while tile j is computed; the ragged tail
//     is zero-filled by the copy).  S = Q K^T is a bf16 MMA with fp32
//     accumulation; K rows are the B operand as they lie.  The online
//     softmax keeps (m, l) per row, with shuffles across the 4 lanes that
//     share a row; only tiles that cross the diagonal, the window edge or
//     Sk evaluate a mask.  O += P V: P stays in registers and is split into
//     bf16 hi + lo fragments (two MMAs into one fp32 accumulator), because
//     one bf16 rounding of P puts the bf16 output at the edge of the
//     comparison bar; V goes through ldmatrix.trans.  mma.sync, not wgmma
//     with TMA: at these shapes bytes and waves bound the time, not the
//     last factor of MMA rate, and mma.sync keeps P in registers without a
//     warpgroup layout.  Shared memory at D = 128: 87 KB (Q staging + 2
//     stages of K and V, rows padded by 16 bytes so ldmatrix is free of
//     bank conflicts);
//   * fp32 (the card-vs-CPU consistency phases and the fp32 tests): the
//     first kernel of this port, unchanged -- fp32 scalar FMAs out of
//     shared memory, so its output meets the 2e-5 fp32 bar, which TF32 or
//     bf16 tensor-core products would miss.
// Both read q/k/v in their (B,S,H,D) layouts through strides (the Pallas
// wrapper transposes all three to (B,H,S,D)), take causal and window masks
// as loop bounds over key blocks, and mask ragged Sq/Sk tails in the tile.

#include "common.cuh"
#include "mma.cuh"

namespace scalar {

// fp32: one CTA per (q block of 64, head, batch); 256 threads each own a
// 4x4 block of scores and a 4 x D/16 block of the output.
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

}  // namespace scalar

namespace fa2 {

using tc::bf16;

constexpr int NT = 128;  // 4 warps, each owns 16 query rows
constexpr int BQ = 64;
constexpr int BK = 64;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (BQ + 2 * 2 * BK) * (D + tc::PAD);  // Q, 2 stages of K and V
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Sk,
                 int H, int KH, long long sqb, long long sqs, long long sqh,
                 long long skb, long long sks, long long skh, long long svb,
                 long long svs, long long svh, float scale, float cap,
                 int causal, int window, int q_offset) {
  constexpr int P = D + tc::PAD;  // shared-memory row pitch
  constexpr int KD = D / 16;      // k16 steps of Q K^T
  constexpr int NB = BK / 8;      // n8 blocks of S
  constexpr int ND = D / 8;       // n8 blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x P
  bf16* ks = qs + BQ * P;                        // 2 stages of BK x P
  bf16* vs = ks + 2 * BK * P;                    // 2 stages of BK x P

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal span first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qb * BQ;
  const int nq = min(BQ, Sq - q0);

  // live key range of this q block: loop bounds, not masks
  const int qlo = q0 + q_offset, qhi = q0 + nq - 1 + q_offset;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;
  int kstart = window > 0 ? max(0, qlo - window + 1) : 0;
  kstart = (kstart / BK) * BK;
  const int ntiles = kend > kstart ? (kend - kstart + BK - 1) / BK : 0;

  const bf16* kb = k + b * skb + kh * skh;
  const bf16* vb = v + b * svb + kh * svh;
  auto load_kv = [&](int j) {  // tile j into stage j & 1; rows past Sk zero-filled
    const int k0 = kstart + j * BK, st = j & 1;
    for (int c = threadIdx.x; c < BK * D / 8; c += NT) {
      const int r = c / (D / 8), d = (c % (D / 8)) * 8;
      const bool ok = k0 + r < Sk;
      const long long kr = ok ? (long long)(k0 + r) : 0;
      tc::cp_async16(ks + st * BK * P + r * P + d, kb + kr * sks + d, ok);
      tc::cp_async16(vs + st * BK * P + r * P + d, vb + kr * svs + d, ok);
    }
  };
  tc::load_tile<BQ, D, NT>(qs, q + b * sqb + h * sqh + q0 * sqs, sqs, nq);
  if (ntiles > 0) load_kv(0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();  // Q and the first K/V tile have landed
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) tc::ldsm_a(qa[kk], qs, P, warp * 16, kk * 16);

  // this thread's rows: g and g + 8 of the warp's 16; positions with q_offset
  const int qp0 = qlo + warp * 16 + g;
  float m[2] = {rt::NEG, rt::NEG}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    tc::cp_async_wait<0>();  // tile j has landed
    __syncthreads();         // ... for every thread; tile j-1's readers are done
    if (j + 1 < ntiles) load_kv(j + 1);  // into the stage tile j-1 used
    tc::cp_async_commit();
    const bf16* kt = ks + (j & 1) * BK * P;
    const bf16* vt = vs + (j & 1) * BK * P;
    const int k0 = kstart + j * BK;

    // S = Q K^T (16 rows x 64 keys per warp), fp32
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t bk[4];
        tc::ldsm_b_nmajor(bk, kt, P, np * 16, kk * 16);
        tc::mma(s[2 * np], qa[kk], bk[0], bk[1]);
        tc::mma(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // scale, softcap, mask (the Pallas order); uniform branches, so tiles
    // without a cap or a mask pay for neither
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    if (cap > 0.f) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = cap * tanhf(s[n][e] / cap);
    }
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > qlo) ||
        (window > 0 && k0 <= qlo + BQ - 1 - window)) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n * 8 + 2 * t4 + (e & 1), qp = qp0 + 8 * (e >> 1);
          const bool ok = kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          s[n][e] = ok ? s[n][e] : rt::NEG;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[n][e] == rt::NEG ? 0.f : __expf(s[n][e] - m[r]);
        s[n][e] = p;
        l[r] += p;  // this lane's share of the row sum; the quad adds at the end
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V, P as bf16 hi + lo register fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        tc::ldsm_b_kmajor(bv, vt, P, kk * 16, dp * 16);
        tc::mma(acc[2 * dp], ph, bv[0], bv[1]);
        tc::mma(acc[2 * dp + 1], ph, bv[2], bv[3]);
        tc::mma(acc[2 * dp], pl, bv[0], bv[1]);
        tc::mma(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy outlives the CTA

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < Sq) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      bf16* orow = o + (((long long)b * Sq + row) * H + h) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int KH, long long sqb, long long sqs, long long sqh,
           long long skb, long long sks, long long skh, long long svb,
           long long svs, long long svh, float scale, float cap, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_mma_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Sk, H, KH, sqb, sqs, sqh, skb, sks, skh, svb, svs,
      svh, scale, cap, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa2

// Output o is (B,Sq,H,D) contiguous.  fp32 goes to the scalar kernel, bf16
// to the tensor-core kernel.  Returns cudaGetLastError() after the launch,
// or -1 for an argument no kernel takes (the Python wrapper checks first).
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
  if (dtype == rt::F32) {
    switch (D) {
      case 32: return scalar::launch<float, 32>(RT_ARGS);
      case 64: return scalar::launch<float, 64>(RT_ARGS);
      case 128: return scalar::launch<float, 128>(RT_ARGS);
      default: return -1;
    }
  }
  if (dtype == rt::BF16) {
    switch (D) {
      case 32: return fa2::launch<32>(RT_ARGS);
      case 64: return fa2::launch<64>(RT_ARGS);
      case 128: return fa2::launch<128>(RT_ARGS);
      default: return -1;
    }
  }
#undef RT_ARGS
  return -1;
}
