// Mamba2 SSD (state-space dual) chunked scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_pallas` (src/repro/kernels/mamba2_ssd.py,
// body `_ssd_kernel`) and, on the serving path, the chunked scan that
// `ops.ssd_scan(return_state=True)` runs instead of it.  Per (b, h) and per
// chunk of c rows, with a = A dt and a_cum its inclusive cumsum:
//   y_t  = sum_{s<=t} (C_t . B_s) exp(a_cum_t - a_cum_s) dt_s x_s   (intra)
//        + exp(a_cum_t) C_t h^T                                      (inter)
//        + D x_t
//   h   <- exp(a_tot) h + sum_s exp(a_tot - a_cum_s) dt_s x_s B_s^T
// from h = 0; the final h (fp32, (B,H,P,N)) is written when asked for.
// x, B, C are bf16 or fp32 (all one type), dt/A/D fp32, y in x's type, all
// math fp32.
//
// Bound on the H100: at the serving prefill (B=1, S<=300, H=64, P=N=64) the
// function reads x, B, C, dt and writes y and the state, about 6 MB, against
// ~1.2 GFLOP of causal-half products: the byte bound (~2 us) is the larger,
// but a CTA per (b, h) gives only 64 CTAs on 132 SMs, and this first kernel
// multiplies with fp32 scalar FMAs out of shared memory (no tensor cores),
// so it runs far above that bound.  What the design does:
//   * one CTA per (b, h) walks the chunks in order with the (P x N) state in
//     shared memory, as the Pallas grid's sequential third axis does; no
//     second state-passing pass;
//   * x, B, C are read through strides (in the model they are views of the
//     conv output, row stride conv_dim), never copied; head h reads group
//     h / (H/G);
//   * the ragged last chunk (S is the exact prompt length) is zero-filled on
//     load with dt = 0: identity steps, so the final state is unchanged and
//     no padded copy is made;
//   * exp is taken only where s <= t (the Pallas code exps the whole tile and
//     masks after, which in CUDA could give inf * 0 = NaN); score tiles above
//     the diagonal are never formed, and the intra-chunk sum skips them;
//   * a_cum is a sequential fp32 sum, one multiply then one add per row, as
//     torch.cumsum along a non-innermost dim computes it, so exp(seg) agrees
//     bit for bit with the plain version's;
//   * 256 threads each own a block of 8x8 scores / 8x4 outputs / 4x4 state
//     entries, so each shared-memory read feeds several FMAs.
// Shared memory, chunk tile 128, P = N = 64: about 187 KB (x, B, C, the
// masked score tile, the state, four per-row vectors), set with
// cudaFuncSetAttribute; one CTA per SM.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int L = 128;      // rows of the chunk tile: the largest chunk taken
constexpr int PS = L + 16;  // score row pitch: rows t and t+1 fall 16 banks apart

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (L * P + 2 * L * (N + 1) + L * PS + P * (N + 1) + 4 * L);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dskip,
           T* __restrict__ y, float* __restrict__ state_out, int S, int H,
           int G, int chunk, long long sxb, long long sxs, long long sxh,
           long long sdb, long long sds, long long sdh, long long sbb,
           long long sbs, long long sbg, long long scb, long long scs,
           long long scg) {
  static_assert(P == 64 && N == 64, "the thread blocks below assume P = N = 64");
  constexpr int PB = N + 1;  // B, C and state rows are also read down a column
  extern __shared__ float smem[];
  float* xs = smem;          // L x P
  float* bs = xs + L * P;    // L x PB
  float* cs = bs + L * PB;   // L x PB
  float* ss = cs + L * PB;   // L x PS: (C_t . B_s) exp(a_cum_t - a_cum_s) dt_s, s <= t
  float* hs = ss + L * PS;   // P x PB: the carried state
  float* dts = hs + P * PB;  // L: dt
  float* acs = dts + L;      // L: a_cum
  float* eas = acs + L;      // L: exp(a_cum)
  float* ws = eas + L;       // L: exp(a_tot - a_cum) dt

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float a_h = A[h];
  const float d_h = Dskip != nullptr ? Dskip[h] : 0.f;
  const T* xb = x + b * sxb + h * sxh;
  const T* bb = Bm + b * sbb + g * sbg;
  const T* cb = Cm + b * scb + g * scg;
  const float* db = dt + b * sdb + h * sdh;
  T* yb = y + ((long long)b * S * H + h) * P;  // y is (B,S,H,P) contiguous

  for (int i = tid; i < P * PB; i += NT) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int nv = min(chunk, S - c0);  // live rows of this chunk
    __syncthreads();  // the previous chunk's readers of xs/bs/ws are done
    rt::load_rows<T, P, L, NT>(xs, P, xb + c0 * sxs, sxs, 0, nv, 1.f);
    rt::load_rows<T, N, L, NT>(bs, PB, bb + c0 * sbs, sbs, 0, nv, 1.f);
    rt::load_rows<T, N, L, NT>(cs, PB, cb + c0 * scs, scs, 0, nv, 1.f);
    for (int t = tid; t < L; t += NT) dts[t] = t < nv ? db[(c0 + t) * sds] : 0.f;
    __syncthreads();

    if (tid == 0) {  // sequential inclusive cumsum; padded rows add 0
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run = __fadd_rn(run, __fmul_rn(a_h, dts[t]));
        acs[t] = run;
      }
    }
    __syncthreads();
    const float a_tot = acs[L - 1];
    for (int t = tid; t < L; t += NT) {
      eas[t] = expf(acs[t]);
      ws[t] = t < nv ? __fmul_rn(expf(a_tot - acs[t]), dts[t]) : 0.f;
    }

    // masked scores: rows t = ty + 16 i, cols s = tx + 16 j; block (i, j) is
    // formed only for j <= i (the rest of the tile lies above the diagonal)
    {
      float sc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = cs[(ty + 16 * i) * PB + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[(tx + 16 * j) * PB + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) sc[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        const float at = acs[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          float v = 0.f;
          if (j < i || (j == i && tx <= ty)) {
            v = __fmul_rn(__fmul_rn(sc[i][j], expf(at - acs[s])), dts[s]);
          }
          ss[t * PS + s] = v;
        }
      }
    }
    __syncthreads();

    // y rows t = ty + 16 i (i < 8), cols p = tx + 16 j (j < 4)
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      // inter: exp(a_cum_t) C_t . h_p
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[8], hv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = cs[(ty + 16 * i) * PB + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hs[(tx + 16 * j) * PB + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float e = eas[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // intra: rows of block i hold t in [16 i, 16 i + 16), so the 32-wide
      // block k of s is needed only by i >= 2k
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s_end = min(32 * k + 32, nv);
        for (int s = 32 * k; s < s_end; ++s) {
          float xv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xs[s * P + tx + 16 * j];
#pragma unroll
          for (int i = 2 * k; i < 8; ++i) {
            const float sv = ss[(ty + 16 * i) * PS + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += sv * xv[j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        if (t < nv) {
          T* yr = yb + (long long)(c0 + t) * H * P;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            rt::store(yr + p, acc[i][j] + d_h * xs[t * P + p]);
          }
        }
      }
    }
    __syncthreads();  // every reader of hs is done

    // state: h_pn <- exp(a_tot) h_pn + sum_s ws_s x_sp B_sn,
    // p = ty + 16 i, n = tx + 16 j (i, j < 4)
    {
      float u[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
      for (int s = 0; s < nv; ++s) {
        const float w = ws[s];
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[s * P + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[s * PB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) u[i][j] += xv[i] * bv[j];
      }
      const float dec = expf(a_tot);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = hs + (ty + 16 * i) * PB + tx + 16 * j;
          *hp = *hp * dec + u[i][j];
        }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + ((long long)b * H + h) * P * N;
    for (int i = tid; i < P * N; i += NT) so[i] = hs[(i / N) * PB + i % N];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* state, int B, int S,
           int H, int G, int chunk, long long sxb, long long sxs, long long sxh,
           long long sdb, long long sds, long long sdh, long long sbb,
           long long sbs, long long sbg, long long scb, long long scs,
           long long scg, cudaStream_t stream) {
  const size_t smem = smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  ssd_kernel<T, P, N><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D), static_cast<T*>(y),
      static_cast<float*>(state), S, H, G, chunk, sxb, sxs, sxh, sdb, sds, sdh,
      sbb, sbs, sbg, scb, scs, scg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y is (B,S,H,P) contiguous in x's type; state (B,H,P,N) fp32 contiguous, or
// null for none; D may be null.  Returns cudaGetLastError() after the
// launch, or -1 for an argument the kernel does not take (the Python
// wrapper checks first).
extern "C" int ssd_launch(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* D, void* y, void* state, int B, int S, int H, int G, int P,
    int N, int chunk, long long sxb, long long sxs, long long sxh, long long sdb,
    long long sds, long long sdh, long long sbb, long long sbs, long long sbg,
    long long scb, long long scs, long long scg, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || chunk < 1 || chunk > L) return -1;
  if (P != 64 || N != 64) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_ARGS x, dt, A, Bm, Cm, D, y, state, B, S, H, G, chunk, sxb, sxs, sxh, \
                sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg, st
  if (dtype == rt::F32) return launch<float, 64, 64>(RT_ARGS);
  if (dtype == rt::BF16) return launch<__nv_bfloat16, 64, 64>(RT_ARGS);
#undef RT_ARGS
  return -1;
}
