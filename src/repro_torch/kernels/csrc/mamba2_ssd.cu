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
// x, B, C are bf16 or fp32 (all one type), dt/A/D fp32, y in x's type;
// every sum is accumulated in fp32 (the bf16 route's products on the
// tensor cores, with fp32 operands split as below).
//
// Bound on the H100: at the serving prefill (B=1, S<=300, H=64, P=N=64) the
// function reads x, B, C, dt and writes y and the state, about 6 MB, against
// ~0.5 GFLOP of causal-half products: bytes bound it (~2 us), provided the
// products run on the tensor cores and the grid fills the 132 SMs.
//
// Two routes, chosen by dtype:
//   * bf16 (the serving path): the state-passing form of the Mamba2 paper,
//     chunk-parallel (namespace `chunked`).  Per chunk: its state
//     contribution dS_c = x^T (w o B); the state passed across chunks
//     (h_c = exp(a_tot_c) h_{c-1} + dS_c); then y: the masked, decayed
//     C B^T scores times x, plus exp(a_cum) C h_{c-1}^T, plus D x.  One CTA
//     of 4 warps per (chunk, head, row): 192 CTAs at 1 x 300, H = 64 (the
//     scalar kernel has 64).  Up to 8 chunks (every serving prefill) it is
//     one launch: the chunks of one (b, h) form a thread-block cluster,
//     each keeps its dS in shared memory, and chunk c runs the recurrence
//     over its peers' dS through distributed shared memory; above 8 chunks
//     three launches pass dS through fp32 scratch.  Every product is an
//     mma.sync m16n8k16 with fp32 accumulation: C B^T and C h^T take C
//     (bf16, exact) as A, x^T (w o B) takes x through ldmatrix.trans; the
//     fp32 operand of the other three (the scores, w o B, h) is split into
//     bf16 hi + lo and runs two MMAs into one accumulator (mma.cuh
//     `split_a`/`split2`), since one bf16 rounding of any of them misses a
//     comparison bar (tests/test_torch_kernels.py pins it).  C B^T is
//     formed only over the causal 16 x 16 blocks; warp w takes the row
//     blocks w and 7 - w, so the four warps do equal work.  x, B, C are
//     loaded by cp.async with zero-fill for the ragged last chunk; a_cum is
//     thread 0's sequential sum, as in the scalar kernel; the decays use
//     the fast exp (__expf), the state recurrence expf;
//   * fp32 (the card-vs-CPU consistency phases and the fp32 tests): the
//     first kernel of this port, unchanged, so its output meets the 2e-5
//     fp32 bar -- fp32 scalar FMAs out of shared memory, one CTA per (b, h)
//     walking the chunks in order with the (P x N) state in shared memory,
//     as the Pallas grid's sequential third axis does.
// Both routes:
//   * read x, B, C through strides (in the model they are views of the
//     conv output, row stride conv_dim), never copied; head h reads group
//     h / (H/G);
//   * zero-fill the ragged last chunk (S is the exact prompt length) on
//     load with dt = 0: identity steps, so the final state is unchanged and
//     no padded copy is made;
//   * take exp only where s <= t (the Pallas code exps the whole tile and
//     masks after, which in CUDA could give inf * 0 = NaN); score tiles
//     above the diagonal are never formed;
//   * compute a_cum as a sequential fp32 sum, one multiply then one add per
//     row, as torch.cumsum along a non-innermost dim computes it, so
//     exp(seg) agrees bit for bit with the plain version's.
// The scalar kernel: 256 threads each own a block of 8x8 scores / 8x4
// outputs / 4x4 state entries; shared memory, chunk tile 128: about 187 KB
// (x, B, C, the masked score tile, the state, four per-row vectors), one
// CTA per SM.

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

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

// The bf16 route: the state-passing form of the chunked scan, chunk-parallel,
// on mma.sync tensor cores.  Per chunk c of (b, h), three steps:
//   1. `chunk_state`: the chunk's state contribution dS_c = x^T (w o B),
//      w_s = exp(a_tot - a_cum_s) dt_s, and a_tot;
//   2. state passing: h_c = exp(a_tot_c) h_{c-1} + dS_c in chunk order,
//      elementwise over P*N, from h = 0;
//   3. y = (masked, decayed C B^T) x (`tile_intra`, no state needed) +
//      diag(exp(a_cum)) C h_{c-1}^T + D x (`tile_finish`), in bf16.
// Up to CLUSTER_MAX chunks (S <= 1024 at chunk 128: every serving prefill)
// one launch does all three: ssd_cluster_kernel, grid (chunks, H, B) with a
// thread-block cluster of (chunks, 1, 1), keeps each dS_c in its CTA's
// shared memory, and the CTA of chunk c runs the recurrence over its
// peers' dS through distributed shared memory.  Above that, three kernels:
// ssd_state_kernel writes dS to scratch, ssd_pass_kernel passes the state
// (writing each chunk's entering state over its dS slot, the final state
// to `state`), ssd_out_kernel forms y.
namespace chunked {

using tc::bf16;

constexpr int NT = 128;           // 4 warps
constexpr int L = 128;            // rows of the chunk tile: the largest chunk taken
constexpr int P = 64, N = 64;     // head dim, state dim
constexpr int PX = 64 + tc::PAD;  // shared-memory row pitch of every bf16 tile
constexpr int PASS_NT = 256;      // ssd_pass_kernel: one float4 of the state per thread
constexpr int PASS_CTAS = P * N / 4 / PASS_NT;
constexpr int CLUSTER_MAX = 8;    // the portable cluster size
constexpr int HV = P * N / 2 / NT;  // float2 of a (P x N) state per thread
static_assert(NT == L, "one dt row per thread");

constexpr size_t TILE_B = sizeof(bf16) * L * PX;  // one bf16 tile of the chunk's rows
constexpr size_t VEC_B = sizeof(float) * 3 * L;   // dt, a_cum, w
// state: x, B, w o B hi and lo; out: x, B, C, and h hi and lo (P rows
// each, one tile together); cluster: all of those (h over w o B) and dS
constexpr size_t state_smem() { return 4 * TILE_B + VEC_B; }
constexpr size_t out_smem() { return 4 * TILE_B + VEC_B; }
constexpr size_t cluster_smem() { return 5 * TILE_B + VEC_B + sizeof(float) * (P * N + 4); }

struct Smem {
  bf16 *xs, *bs, *cs;  // L x PX: x rows (s, p), B rows (s, n), C rows (t, n)
  bf16 *wh, *wl;       // L x PX: w o B, bf16 hi and lo
  bf16 *hh, *hl;       // P x PX: the entering state (p, n), bf16 hi and lo
  float *dts, *acs, *ws;  // L each: dt, a_cum, w
};

__device__ __forceinline__ Smem carve(unsigned char* raw, bool with_c, bool h_over_w) {
  Smem sm;
  bf16* t = reinterpret_cast<bf16*>(raw);
  sm.xs = t;
  sm.bs = t + L * PX;
  sm.cs = with_c ? t + 2 * L * PX : nullptr;
  bf16* next = t + (with_c ? 3 : 2) * L * PX;
  sm.wh = next;
  sm.wl = next + L * PX;
  sm.hh = h_over_w ? sm.wh : next;
  sm.hl = h_over_w ? sm.wl : next + P * PX;
  // the vectors follow the last tile in use: w o B, or h where w o B is not
  const bool w_used = h_over_w || !with_c;
  sm.dts = reinterpret_cast<float*>(next + (w_used ? 2 : 1) * L * PX);
  sm.acs = sm.dts + L;
  sm.ws = sm.acs + L;
  return sm;
}

// dt of this thread's row of the chunk (0 past nv: identity steps); loaded
// early, stored by `chunk_cumsum`
__device__ __forceinline__ float load_dt(const float* db, long long sds, int c0, int nv) {
  return threadIdx.x < nv ? db[(c0 + threadIdx.x) * sds] : 0.f;
}

// thread 0's sequential inclusive cumsum of A dt over the chunk's rows, the
// scalar kernel's and torch's order; then every thread's w.  Ends in a
// barrier.
__device__ __forceinline__ void chunk_cumsum(const Smem& sm, float dt_row, float a_h, int nv) {
  sm.dts[threadIdx.x] = dt_row;
  __syncthreads();
  if (threadIdx.x == 0) {  // 16 rows at a time through registers: one add chain
    float run = 0.f;
#pragma unroll 1
    for (int t0 = 0; t0 < L; t0 += 16) {
      float a[16];
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        const float4 d = *reinterpret_cast<const float4*>(sm.dts + t0 + i);
        a[i] = d.x; a[i + 1] = d.y; a[i + 2] = d.z; a[i + 3] = d.w;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        run = __fadd_rn(run, __fmul_rn(a_h, a[i]));
        a[i] = run;
      }
#pragma unroll
      for (int i = 0; i < 16; i += 4) {
        *reinterpret_cast<float4*>(sm.acs + t0 + i) = make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
      }
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  sm.ws[t] = t < nv ? __expf(sm.acs[L - 1] - sm.acs[t]) * sm.dts[t] : 0.f;
}

// dS = x^T (w o B) over the chunk's live rows, w o B as bf16 hi + lo; warp
// w forms rows p = 16 w .. 16 w + 15, written (fp32, row pitch N) to `out`,
// global or shared.  Needs the x and B tiles landed and w in place.
__device__ __forceinline__ void chunk_state(const Smem& sm, int nv, float* out) {
  __syncthreads();  // w and the tiles are visible to every thread
  for (int i = threadIdx.x; i < L * N / 2; i += NT) {
    const int t = i / (N / 2), n = 2 * (i % (N / 2));
    const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sm.bs + t * PX + n));
    uint32_t hi, lo;
    tc::split2(bv.x * sm.ws[t], bv.y * sm.ws[t], hi, lo);
    *reinterpret_cast<uint32_t*>(sm.wh + t * PX + n) = hi;
    *reinterpret_cast<uint32_t*>(sm.wl + t * PX + n) = lo;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[N / 8][4];
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  const int ksteps = (nv + 15) / 16;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[4];
    tc::ldsm_a_kmajor(a, sm.xs, PX, kk * 16, warp * 16);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      tc::ldsm_b_kmajor(bf, sm.wh, PX, kk * 16, np * 16);
      tc::mma(acc[2 * np], a, bf[0], bf[1]);
      tc::mma(acc[2 * np + 1], a, bf[2], bf[3]);
      tc::ldsm_b_kmajor(bf, sm.wl, PX, kk * 16, np * 16);
      tc::mma(acc[2 * np], a, bf[0], bf[1]);
      tc::mma(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
  const int r = warp * 16 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb) {
    *reinterpret_cast<float2*>(out + r * N + nb * 8 + col) = make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(out + (r + 8) * N + nb * 8 + col) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
}

// One step of the state recurrence, h <- exp(a_tot) h + dS, over this
// thread's HV float2 of the state (element f = threadIdx.x + i NT)
__device__ __forceinline__ void pass_step(float2 (&hv)[HV], float dec, const float* d_state) {
  const float2* d = reinterpret_cast<const float2*>(d_state);
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const float2 v = d[threadIdx.x + i * NT];
    hv[i].x = __fadd_rn(__fmul_rn(hv[i].x, dec), v.x);
    hv[i].y = __fadd_rn(__fmul_rn(hv[i].y, dec), v.y);
  }
}

// The entering state as bf16 hi + lo tiles (p rows, n columns)
__device__ __forceinline__ void store_state_split(const Smem& sm, const float2 (&hv)[HV]) {
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const int f = threadIdx.x + i * NT, p = f / (N / 2), n = 2 * (f % (N / 2));
    uint32_t hi, lo;
    tc::split2(hv[i].x, hv[i].y, hi, lo);
    *reinterpret_cast<uint32_t*>(sm.hh + p * PX + n) = hi;
    *reinterpret_cast<uint32_t*>(sm.hl + p * PX + n) = lo;
  }
}

// One warp's 16-row tile i of y: C's A-fragments (kept for C h^T) and the
// fp32 accumulator.
struct TileY {
  uint32_t ca[N / 16][4];
  float y[P / 8][4];
};

// The part of tile i of y that needs no entering state: the masked,
// decayed C B^T scores times x, the scores as bf16 hi + lo.
__device__ __forceinline__ void tile_intra(const Smem& sm, int i, TileY& ty) {
  const int lane = threadIdx.x % 32, gq = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) tc::ldsm_a(ty.ca[kk], sm.cs, PX, 16 * i, 16 * kk);
  // scores C B^T over the column blocks j <= i
  float s[L / 8][4];
#pragma unroll
  for (int nb = 0; nb < L / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int np = 0; np < L / 16; ++np) {
    if (np <= i) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t bf[4];
        tc::ldsm_b_nmajor(bf, sm.bs, PX, 16 * np, 16 * kk);
        tc::mma(s[2 * np], ty.ca[kk], bf[0], bf[1]);
        tc::mma(s[2 * np + 1], ty.ca[kk], bf[2], bf[3]);
      }
    }
  }
  // (C_t . B_s) exp(a_cum_t - a_cum_s) dt_s where s <= t, else 0
  const int t0 = 16 * i + gq;
  const float at0 = sm.acs[t0], at1 = sm.acs[t0 + 8];
#pragma unroll
  for (int nb = 0; nb < L / 8; ++nb) {
    if (nb < 2 * (i + 1)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * (e >> 1), sc = 8 * nb + 2 * t4 + (e & 1);
        const float at = e < 2 ? at0 : at1;
        s[nb][e] = sc <= t ? s[nb][e] * __expf(at - sm.acs[sc]) * sm.dts[sc] : 0.f;
      }
    }
  }
#pragma unroll
  for (int nb = 0; nb < P / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) ty.y[nb][e] = 0.f;
#pragma unroll
  for (int j = 0; j < L / 16; ++j) {
    if (j <= i) {
      uint32_t sh[4], sl[4];
      tc::split_a(s[2 * j], s[2 * j + 1], sh, sl);
#pragma unroll
      for (int dp = 0; dp < P / 16; ++dp) {
        uint32_t bf[4];
        tc::ldsm_b_kmajor(bf, sm.xs, PX, 16 * j, 16 * dp);
        tc::mma(ty.y[2 * dp], sh, bf[0], bf[1]);
        tc::mma(ty.y[2 * dp + 1], sh, bf[2], bf[3]);
        tc::mma(ty.y[2 * dp], sl, bf[0], bf[1]);
        tc::mma(ty.y[2 * dp + 1], sl, bf[2], bf[3]);
      }
    }
  }
}

// The rest of tile i: + exp(a_cum_t) C_t h^T (with `has_h`; h as bf16 hi +
// lo) + D x, written in bf16 to yb (row t at yb + t * H * P) for t < nv.
__device__ __forceinline__ void tile_finish(const Smem& sm, int i, TileY& ty, bool has_h,
                                            float d_h, bf16* yb, int H, int nv) {
  const int lane = threadIdx.x % 32, gq = lane / 4, t4 = lane % 4;
  const int t0 = 16 * i + gq;
  if (has_h) {
    float z[P / 8][4];
#pragma unroll
    for (int nb = 0; nb < P / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < P / 16; ++dp) {
        uint32_t bf[4];
        tc::ldsm_b_nmajor(bf, sm.hh, PX, 16 * dp, 16 * kk);
        tc::mma(z[2 * dp], ty.ca[kk], bf[0], bf[1]);
        tc::mma(z[2 * dp + 1], ty.ca[kk], bf[2], bf[3]);
        tc::ldsm_b_nmajor(bf, sm.hl, PX, 16 * dp, 16 * kk);
        tc::mma(z[2 * dp], ty.ca[kk], bf[0], bf[1]);
        tc::mma(z[2 * dp + 1], ty.ca[kk], bf[2], bf[3]);
      }
    }
    const float ea0 = __expf(sm.acs[t0]), ea1 = __expf(sm.acs[t0 + 8]);
#pragma unroll
    for (int nb = 0; nb < P / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) ty.y[nb][e] += (e < 2 ? ea0 : ea1) * z[nb][e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + 8 * r;
    if (t < nv) {
      bf16* yr = yb + (long long)t * H * P;
#pragma unroll
      for (int nb = 0; nb < P / 8; ++nb) {
        const int p = 8 * nb + 2 * t4;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sm.xs + t * PX + p));
        *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(
            ty.y[nb][2 * r] + d_h * xv.x, ty.y[nb][2 * r + 1] + d_h * xv.y);
      }
    }
  }
}

// Warp w takes the 16-row tiles w and 7 - w: tile i has i + 1 causal column
// blocks, so each warp does 9.
__device__ __forceinline__ int warp_tile(int half) {
  const int warp = threadIdx.x / 32;
  return half ? L / 16 - 1 - warp : warp;
}

// The kernels' shared arguments: pointers and strides of one call.
struct Args {
  const bf16 *x, *Bm, *Cm;
  const float *dt, *A, *D;
  bf16* y;
  float* state;  // (B, H, P, N) or null
  float *dS, *atot;  // scratch of the three-kernel path
  int S, H, G, chunk, nc;
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

// Issue the chunk's x and B (and C) tile copies; return its live rows.
__device__ __forceinline__ int load_chunk(const Smem& sm, const Args& a, int b, int h, int c) {
  const int g = h / (a.H / a.G);
  const int c0 = c * a.chunk, nv = min(a.chunk, a.S - c0);
  tc::load_tile<L, P, NT>(sm.xs, a.x + b * a.sxb + c0 * a.sxs + h * a.sxh, a.sxs, nv);
  tc::load_tile<L, N, NT>(sm.bs, a.Bm + b * a.sbb + c0 * a.sbs + g * a.sbg, a.sbs, nv);
  if (sm.cs != nullptr) {
    tc::load_tile<L, N, NT>(sm.cs, a.Cm + b * a.scb + c0 * a.scs + g * a.scg, a.scs, nv);
  }
  tc::cp_async_commit();
  return nv;
}

__device__ __forceinline__ bf16* y_rows(const Args& a, int b, int h, int c) {
  return a.y + (((long long)b * a.S + (long long)c * a.chunk) * a.H + h) * P;  // (B,S,H,P)
}

__global__ void __launch_bounds__(NT) ssd_cluster_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, true, true);
  float* dss = sm.ws + L;      // P x N: this chunk's dS
  float* a_tot_s = dss + P * N;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank()), h = blockIdx.y, b = blockIdx.z;
  const int nv = load_chunk(sm, a, b, h, c);
  const float a_h = a.A[h];
  const float d_h = a.D != nullptr ? a.D[h] : 0.f;
  chunk_cumsum(sm, load_dt(a.dt + b * a.sdb + h * a.sdh, a.sds, c * a.chunk, nv), a_h, nv);
  const float a_tot = sm.acs[L - 1];
  tc::cp_async_wait<0>();
  chunk_state(sm, nv, dss);
  if (threadIdx.x == 0) *a_tot_s = a_tot;
  // arrive now, wait after the part of y that needs no entering state
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  TileY ty[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (16 * warp_tile(half) < nv) tile_intra(sm, warp_tile(half), ty[half]);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  // every chunk's dS and a_tot are in place: the entering state from the
  // earlier chunks' dS (the pass kernel's recurrence), and from the last
  // chunk the final state
  const bool last = a.state != nullptr && c == a.nc - 1;
  if (c > 0 || last) {
    float2 hv[HV];
#pragma unroll
    for (int i = 0; i < HV; ++i) hv[i] = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX - 1; ++r) {  // unrolled: the peers' loads go out together
      if (r < c) {
        pass_step(hv, expf(*cluster.map_shared_rank(a_tot_s, r)), cluster.map_shared_rank(dss, r));
      }
    }
    if (c > 0) store_state_split(sm, hv);  // over w o B, which chunk_state is done with
    if (last) {
      pass_step(hv, expf(a_tot), dss);
      float2* so = reinterpret_cast<float2*>(a.state + ((long long)b * a.H + h) * P * N);
#pragma unroll
      for (int i = 0; i < HV; ++i) so[threadIdx.x + i * NT] = hv[i];
    }
  }
  __syncthreads();
  bf16* yb = y_rows(a, b, h, c);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = warp_tile(half);
    if (16 * i < nv) tile_finish(sm, i, ty[half], c > 0, d_h, yb, a.H, nv);
  }
  cluster.sync();  // the peers are done reading this CTA's dS
}

__global__ void __launch_bounds__(NT) ssd_state_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, false, false);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nv = load_chunk(sm, a, b, h, c);
  chunk_cumsum(sm, load_dt(a.dt + b * a.sdb + h * a.sdh, a.sds, c * a.chunk, nv), a.A[h], nv);
  tc::cp_async_wait<0>();
  const long long slot = ((long long)b * a.nc + c) * a.H + h;
  chunk_state(sm, nv, a.dS + slot * P * N);
  if (threadIdx.x == 0) a.atot[slot] = sm.acs[L - 1];
}

// grid (PASS_CTAS, B*H): the recurrence over the chunks whose dS exists
// (all, with a final state; else all but the last), each chunk's entering
// state over its dS slot, then the final state (or the last chunk's
// entering state)
__global__ void __launch_bounds__(PASS_NT) ssd_pass_kernel(Args a) {
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int i = blockIdx.x * PASS_NT + threadIdx.x;  // float4 index in the (P x N) state
  const int n1 = a.state != nullptr ? a.nc : a.nc - 1;
  constexpr int AHEAD = 4;  // chunks whose dS is loaded before the chain uses it
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n1; c0 += AHEAD) {
    float4 d[AHEAD];
    float dec[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k < n1) {
        const long long slot = ((long long)b * a.nc + c0 + k) * a.H + h;
        d[k] = reinterpret_cast<const float4*>(a.dS + slot * P * N)[i];
        dec[k] = expf(a.atot[slot]);
      }
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int c = c0 + k;
      if (c < n1) {
        if (c > 0) {  // the state entering chunk c, over its dS
          reinterpret_cast<float4*>(a.dS + (((long long)b * a.nc + c) * a.H + h) * P * N)[i] = hc;
        }
        hc.x = __fadd_rn(__fmul_rn(hc.x, dec[k]), d[k].x);
        hc.y = __fadd_rn(__fmul_rn(hc.y, dec[k]), d[k].y);
        hc.z = __fadd_rn(__fmul_rn(hc.z, dec[k]), d[k].z);
        hc.w = __fadd_rn(__fmul_rn(hc.w, dec[k]), d[k].w);
      }
    }
  }
  float* dst = a.state != nullptr ? a.state + ((long long)b * a.H + h) * P * N
                                  : a.dS + (((long long)b * a.nc + n1) * a.H + h) * P * N;
  reinterpret_cast<float4*>(dst)[i] = hc;
}

__global__ void __launch_bounds__(NT) ssd_out_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, true, false);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nv = load_chunk(sm, a, b, h, c);
  const float a_h = a.A[h];
  const float d_h = a.D != nullptr ? a.D[h] : 0.f;
  const float dt_row = load_dt(a.dt + b * a.sdb + h * a.sdh, a.sds, c * a.chunk, nv);
  float2 hv[HV];
  if (c > 0) {  // chunk 0 starts from the zero state
    const float2* src = reinterpret_cast<const float2*>(
        a.dS + (((long long)b * a.nc + c) * a.H + h) * P * N);
#pragma unroll
    for (int i = 0; i < HV; ++i) hv[i] = src[threadIdx.x + i * NT];
  }
  chunk_cumsum(sm, dt_row, a_h, nv);
  if (c > 0) store_state_split(sm, hv);
  tc::cp_async_wait<0>();
  __syncthreads();
  bf16* yb = y_rows(a, b, h, c);
  for (int half = 0; half < 2; ++half) {
    const int i = warp_tile(half);
    if (16 * i >= nv) continue;
    TileY ty;
    tile_intra(sm, i, ty);
    tile_finish(sm, i, ty, c > 0, d_h, yb, a.H, nv);
  }
}

int launch(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err;
  if (a.nc <= CLUSTER_MAX) {
    err = cudaFuncSetAttribute(ssd_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cluster_smem()));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.nc, a.H, B);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = cluster_smem();
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, ssd_cluster_kernel, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.dS == nullptr || a.atot == nullptr) return -1;
  const int n1 = a.state != nullptr ? a.nc : a.nc - 1;  // chunks whose dS is needed
  err = cudaFuncSetAttribute(ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(state_smem()));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<<<dim3(n1, a.H, B), NT, state_smem(), stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<<<dim3(PASS_CTAS, B * a.H), PASS_NT, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(out_smem()));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_out_kernel<<<dim3(a.nc, a.H, B), NT, out_smem(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked

// y is (B,S,H,P) contiguous in x's type; state (B,H,P,N) fp32 contiguous, or
// null for none; D may be null.  fp32 runs the scalar kernel (dS and atot
// unused, may be null); bf16 the chunk-parallel route, which needs dS
// (B, chunks, H, P, N) and atot (B, chunks, H) fp32 scratch when S holds
// more than CLUSTER_MAX chunks.  Returns the CUDA error of the launches (0 on
// success), or -1 for an argument the kernels do not take (the Python
// wrapper checks first).
extern "C" int ssd_launch(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* D, void* y, void* state, void* dS, void* atot, int B, int S, int H, int G,
    int P, int N, int chunk, long long sxb, long long sxs, long long sxh, long long sdb,
    long long sds, long long sdh, long long sbb, long long sbs, long long sbg,
    long long scb, long long scs, long long scg, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || chunk < 1 || chunk > L) return -1;
  if (P != 64 || N != 64) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::F32) {
    return launch<float, 64, 64>(x, dt, A, Bm, Cm, D, y, state, B, S, H, G, chunk, sxb, sxs,
                                 sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg, st);
  }
  if (dtype == rt::BF16) {
    using chunked::bf16;
    chunked::Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(Bm),
                    static_cast<const bf16*>(Cm), static_cast<const float*>(dt),
                    static_cast<const float*>(A), static_cast<const float*>(D),
                    static_cast<bf16*>(y), static_cast<float*>(state),
                    static_cast<float*>(dS), static_cast<float*>(atot),
                    S, H, G, chunk, (S + chunk - 1) / chunk,
                    sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg};
    return chunked::launch(a, B, st);
  }
  return -1;
}
