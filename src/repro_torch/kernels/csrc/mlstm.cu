// Stabilized parallel mLSTM (the xLSTM matrix-memory cell), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `mlstm_pallas` (src/repro/kernels/
// mlstm_kernel.py, body `_mlstm_kernel`).  Per (b, h), with F the cumsum of
// log sigmoid(f) (computed by the wrapper, as the Pallas wrapper does) and
// D_ts = (F_t - F_s) + i_s for s <= t:
//   m_t   = max_{s<=t} D_ts
//   w_ts  = (q_t . k_s / sqrt(d)) exp(D_ts - m_t)          (signed)
//   out_t = sum_s w_ts v_s / max(|sum_s w_ts|, exp(-m_t))
// q, k, v are bf16 or fp32 (all one type), F and i fp32 (B,S,H)
// contiguous, out (B,S,H,D) contiguous in q's type; all math fp32.
//
// Bound on the H100: at the serving prefill of xlstm-1.3b (B=1, S<=300,
// H=4, D=1024, bf16) the function reads q, k, v and writes out, about 10 MB
// (~3 us at 3.35 TB/s), against ~0.74 GFLOP of causal products (under 1 us
// at the bf16 tensor peak): bytes bound it.  This first kernel multiplies
// with fp32 scalar FMAs out of shared memory (no tensor cores), so it runs
// far above that bound.  What the design does:
//   * head dim 1024: a (64 x 1024) fp32 accumulator (256 KB) fits neither a
//     CTA's 227 KB of shared memory nor its registers, so the value dim is
//     split across CTAs: grid (query block of 64, value slice of DV = 128
//     (64 where D is not a multiple of 128), b*h).  Each CTA recomputes
//     q.k over the full D from 64-wide chunks in shared memory and keeps
//     only its (64 x DV) accumulator in registers and its own copy of the
//     row sums l; at B=1, S=300, D=1024 that is 5 x 8 x 4 = 160 CTAs;
//   * the stabilizer does not depend on q.k, so a first sweep finds each
//     row's exact m_t, term by term in the plain version's operand order
//     ((F_t - F_s) + i_s), and the second pass accumulates with no online
//     rescaling (the Pallas kernel's running max and correction factors);
//   * exp is taken only where s <= t (the Pallas code exps the whole tile
//     and masks after); key blocks wholly above the diagonal are skipped;
//   * S is the exact prompt length: the ragged tail of q, k, v is
//     zero-filled on load and masked, no padded copy is made;
//   * q, k, v are read through strides (the last dim contiguous); query
//     blocks are scheduled longest causal span first.
// Shared memory at DV = 128: about 84 KB (the q and k chunks, the weight
// tile, the v tile, four per-row vectors), set with cudaFuncSetAttribute.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int BQ = 64;      // query rows per CTA
constexpr int BK = 64;      // key rows per step
constexpr int DC = 64;      // width of the q.k contraction chunk
constexpr int KP = DC + 1;  // q/k chunk row pitch: rows fall in distinct banks
constexpr int WP = BK + 1;  // weight tile row pitch

template <int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * KP + BK * KP + BQ * WP + BK * DV + 2 * BK + 2 * BQ);
}

template <typename T, int DV>
__global__ void __launch_bounds__(NT)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ Fc,
             const float* __restrict__ ig, T* __restrict__ out, int S, int H,
             int D, long long sqb, long long sqs, long long sqh, long long skb,
             long long sks, long long skh, long long svb, long long svs,
             long long svh, float scale) {
  constexpr int JV = DV / 16;  // value columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x KP: q rows, one D chunk
  float* ks = qs + BQ * KP;    // BK x KP: k rows, one D chunk
  float* ws = ks + BK * KP;    // BQ x WP: the masked weights w_ts
  float* vs = ws + BQ * WP;    // BK x DV: v rows, this CTA's value slice
  float* fk = vs + BK * DV;    // BK: F at the key rows
  float* ik = fk + BK;         // BK: i at the key rows
  float* fq = ik + BK;         // BQ: F at the query rows
  float* mq = fq + BQ;         // BQ: m_t

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal span first
  const int q0 = qb * BQ;
  const int nq = min(BQ, S - q0);  // live query rows
  const int dv0 = blockIdx.y * DV;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const float* Fb = Fc + (long long)b * S * H + h;  // F[b, s, h] = Fb[s * H]
  const float* ib = ig + (long long)b * S * H + h;

  // sweep 1: the exact stabilizer of each live row, one warp per row
  for (int r = warp; r < BQ; r += NT / 32) {
    const int t = q0 + r;
    float ft = 0.f, mx = rt::NEG;
    if (t < S) {
      ft = Fb[(long long)t * H];
      for (int s = lane; s <= t; s += 32) {
        mx = fmaxf(mx, __fadd_rn(__fsub_rn(ft, Fb[(long long)s * H]), ib[(long long)s * H]));
      }
    }
    mx = rt::warp_max(mx);
    if (lane == 0) {
      fq[r] = ft;
      mq[r] = mx;
    }
  }

  // pass 2: rows r = ty + 16 i (i < 4); scores at key columns c = tx + 16 j
  // (j < 4); values at columns dv0 + tx + 16 jv (jv < JV)
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][JV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JV; ++j) acc[i][j] = 0.f;

  const T* qbase = q + b * sqb + h * sqh + (long long)q0 * sqs;
  const int kb_end = (q0 + nq - 1) / BK;  // the last key block any live row sees
  for (int kb = 0; kb <= kb_end; ++kb) {
    const int s0 = kb * BK;
    const int nk = min(BK, S - s0);
    const T* kbase = k + b * skb + h * skh + (long long)s0 * sks;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // readers of qs/ks (at d0 = 0 also of ws/vs/fk/ik) are done
      rt::load_rows<T, DC, BQ, NT>(qs, KP, qbase + d0, sqs, 0, nq, 1.f);
      rt::load_rows<T, DC, BK, NT>(ks, KP, kbase + d0, sks, 0, nk, 1.f);
      if (d0 == 0) {
        rt::load_rows<T, DV, BK, NT>(vs, DV, v + b * svb + h * svh + (long long)s0 * svs + dv0,
                                     svs, 0, nk, 1.f);
        for (int c = tid; c < BK; c += NT) {
          fk[c] = c < nk ? Fb[(long long)(s0 + c) * H] : 0.f;
          ik[c] = c < nk ? ib[(long long)(s0 + c) * H] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * KP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
    }

    // masked weights, and their row sums into l (the 16 threads of a row
    // are one half-warp: lanes 0-15 hold row ty, lanes 16-31 row ty + 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, t = q0 + r;
      const float ft = fq[r], mt = mq[r];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float w = 0.f;
        if (t < S && s0 + c <= t) {
          const float e = expf(__fsub_rn(__fadd_rn(__fsub_rn(ft, fk[c]), ik[c]), mt));
          w = __fmul_rn(__fmul_rn(sc[i][j], scale), e);
        }
        ws[r * WP + c] = w;
        rs += w;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] += rs;
    }
    __syncthreads();

    // acc += w v over the key columns any live row of this block sees
    const int c_end = min(nk, q0 + nq - s0);
    for (int c = 0; c < c_end; ++c) {
      float vv[JV];
#pragma unroll
      for (int j = 0; j < JV; ++j) vv[j] = vs[c * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = ws[(ty + 16 * i) * WP + c];
#pragma unroll
        for (int j = 0; j < JV; ++j) acc[i][j] = fmaf(w, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t < S) {
      const float den = fmaxf(fabsf(l[i]), expf(-mq[r]));
      T* o = out + (((long long)b * S + t) * H + h) * D + dv0;
#pragma unroll
      for (int j = 0; j < JV; ++j) rt::store(o + tx + 16 * j, acc[i][j] / den);
    }
  }
}

template <typename T, int DV>
int launch(const void* q, const void* k, const void* v, const void* Fc,
           const void* ig, void* out, int B, int S, int H, int D, long long sqb,
           long long sqs, long long sqh, long long skb, long long sks,
           long long skh, long long svb, long long svs, long long svh,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DV>();
  cudaError_t err = cudaFuncSetAttribute(mlstm_kernel<T, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, D / DV, B * H);
  mlstm_kernel<T, DV><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(Fc), static_cast<const float*>(ig), static_cast<T*>(out),
      S, H, D, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out is (B,S,H,D) contiguous in q's type; F and i (B,S,H) fp32
// contiguous.  Returns cudaGetLastError() after the launch, or -1 for an
// argument the kernel does not take (the Python wrapper checks first).
extern "C" int mlstm_launch(
    const void* q, const void* k, const void* v, const void* Fc, const void* ig,
    void* out, int B, int S, int H, int D, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % DC != 0 || B * H > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_ARGS q, k, v, Fc, ig, out, B, S, H, D, sqb, sqs, sqh, skb, sks, skh, \
                svb, svs, svh, scale, st
  const bool wide = D % 128 == 0;
  if (dtype == rt::F32) return wide ? launch<float, 128>(RT_ARGS) : launch<float, 64>(RT_ARGS);
  if (dtype == rt::BF16) {
    return wide ? launch<__nv_bfloat16, 128>(RT_ARGS) : launch<__nv_bfloat16, 64>(RT_ARGS);
  }
#undef RT_ARGS
  return -1;
}
