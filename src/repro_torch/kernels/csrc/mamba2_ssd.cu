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
// Widths: the head dim P and state dim N are padded up to the mma tile (a
// multiple of 16) in shared memory: x, B and C load zero in the padding
// columns, which then add nothing to any product, and y and the final
// state are stored for the real columns only.  One template instance per
// padded pair (`with_tiles`): (64, 64) zamba2-1.2b; (16, 16) the reduced
// configs, and (16, 8) and (8, 4) padded to it; (32, 16); (64, 128)
// Mamba2's published state width.  Rows are read in 16-byte pieces where
// the pointer, the strides and the width allow it (`rows16`), else element
// by element (N = 4 in bf16 is 8 bytes a row).
// The scalar kernel: 256 threads each own a block of 8x8 scores, 8x(P/16)
// outputs and (P/16)x(N/16) state entries; B and C are staged 64 columns
// at a time (two stages at N = 128), each stage adding its columns to the
// scores and the inter term and then updating its columns of the state,
// so every sum over n runs in order and the shared memory (chunk tile 128)
// is at most about 203 KB (N = 128; 187 KB at 64): x, one stage of B and
// C, the masked score tile, the state, four per-row vectors; one CTA per SM.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int L = 128;      // rows of the chunk tile: the largest chunk taken
constexpr int PS = L + 16;  // score row pitch: rows t and t+1 fall 16 banks apart

// The widths of the kernels' tiles: P and N padded up to a multiple of 16.
// B and C are staged in slices of at most 64 columns (two for N = 128), so
// the scalar kernel's tiles fit a block's shared memory at every width.
template <int N>
__host__ __device__ constexpr int stage_n() { return N > 64 ? 64 : N; }

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (L * P + 2 * L * (stage_n<N>() + 1) + L * PS + P * (N + 1) + 4 * L);
}

// True when a tensor's rows can be read in 16-byte pieces: the base pointer
// and every row stride 16-byte aligned, and `ncols` a whole number of them.
bool rows16(const void* p, long long s0, long long s1, long long s2, int ncols, int es) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s0 * es) % 16 == 0 &&
         (s1 * es) % 16 == 0 && (s2 * es) % 16 == 0 && (ncols * es) % 16 == 0;
}

// Rows [0, ROWS) x columns [0, D) of a tile into shared memory as fp32 (row
// pitch `pitch`); row i starts at base + i * row_stride.  Rows at or past
// nv and columns at or past ncols are zero-filled (the ragged last chunk;
// the padding of P or N up to the tile).  `vec`: 16-byte loads (`rows16`),
// else element by element.
template <typename T, int D, int ROWS, int NTH>
__device__ __forceinline__ void load_cols(float* sm, int pitch, const T* base,
                                          long long row_stride, int nv, int ncols, bool vec) {
  if (vec) {
    constexpr int V = rt::Vec<T>::N;
    constexpr int CPR = D / V;
    for (int c = threadIdx.x; c < ROWS * CPR; c += NTH) {
      const int i = c / CPR, d0 = (c % CPR) * V;
      float v[V];
      if (i < nv && d0 < ncols) {
        rt::Vec<T>::load(base + (long long)i * row_stride + d0, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sm[i * pitch + d0 + j] = v[j];
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += NTH) {
      const int i = e / D, d = e % D;
      float v = 0.f;
      if (i < nv && d < ncols) rt::load_vec<T, 1>(base + (long long)i * row_stride + d, &v);
      sm[i * pitch + d] = v;
    }
  }
}

// Real widths and whether each of x, B and C can be read in 16-byte pieces.
struct Widths {
  int P, N;
  bool vx, vb, vc;
};

// P, N: the padded tile widths (multiples of 16; P <= 64, N <= 128).
template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dskip,
           T* __restrict__ y, float* __restrict__ state_out, int S, int H,
           int G, int chunk, Widths wd, long long sxb, long long sxs, long long sxh,
           long long sdb, long long sds, long long sdh, long long sbb,
           long long sbs, long long sbg, long long scb, long long scs,
           long long scg) {
  static_assert(P % 16 == 0 && N % 16 == 0 && P <= 64 && N <= 128, "tile widths");
  constexpr int NH = stage_n<N>();  // columns of B and C staged at a time
  constexpr int NS = N / NH;         // stages per chunk
  constexpr int PB = NH + 1;         // B and C rows are also read down a column
  constexpr int HB = N + 1;          // state row pitch
  constexpr int PJ = P / 16;         // y columns / state rows per thread
  constexpr int NJ = NH / 16;        // state columns per thread and stage
  extern __shared__ float smem[];
  float* xs = smem;          // L x P
  float* bs = xs + L * P;    // L x PB: one stage of B
  float* cs = bs + L * PB;   // L x PB: one stage of C
  float* ss = cs + L * PB;   // L x PS: (C_t . B_s) exp(a_cum_t - a_cum_s) dt_s, s <= t
  float* hs = ss + L * PS;   // P x HB: the carried state
  float* dts = hs + P * HB;  // L: dt
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
  T* yb = y + ((long long)b * S * H + h) * wd.P;  // y is (B,S,H,P) contiguous

  for (int i = tid; i < P * HB; i += NT) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int nv = min(chunk, S - c0);  // live rows of this chunk
    __syncthreads();  // the previous chunk's readers of xs/ws are done
    load_cols<T, P, L, NT>(xs, P, xb + c0 * sxs, sxs, nv, wd.P, wd.vx);
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

    // per stage of B and C columns: the scores C B^T (rows t = ty + 16 i,
    // cols s = tx + 16 j; block (i, j) only for j <= i, the rest lies above
    // the diagonal), the inter term exp(a_cum_t) C_t . h_p (rows t, cols
    // p = tx + 16 j) from the entering state, then that stage's columns
    // of the state; each sum runs over n in order, whatever the stages
    float sc[8][8], acc[8][PJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) sc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
    }
#pragma unroll 1
    for (int st = 0; st < NS; ++st) {
      const int n0 = st * NH;
      if (st > 0) __syncthreads();  // the last stage's readers of bs/cs are done
      load_cols<T, NH, L, NT>(bs, PB, bb + c0 * sbs + n0, sbs, nv, wd.N - n0, wd.vb);
      load_cols<T, NH, L, NT>(cs, PB, cb + c0 * scs + n0, scs, nv, wd.N - n0, wd.vc);
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < NH; ++n) {
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
#pragma unroll 4
      for (int n = 0; n < NH; ++n) {
        float cv[8], hv[PJ];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = cs[(ty + 16 * i) * PB + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = hs[(tx + 16 * j) * HB + n0 + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += cv[i] * hv[j];
      }
      __syncthreads();  // every reader of this stage's state columns is done

      // h_pn <- exp(a_tot) h_pn + sum_s ws_s x_sp B_sn over this stage's
      // columns, p = ty + 16 i, n = n0 + tx + 16 j
      {
        float u[PJ][NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) u[i][j] = 0.f;
        for (int s = 0; s < nv; ++s) {
          const float w = ws[s];
          float xv[PJ], bv[NJ];
#pragma unroll
          for (int i = 0; i < PJ; ++i) xv[i] = xs[s * P + ty + 16 * i] * w;
#pragma unroll
          for (int j = 0; j < NJ; ++j) bv[j] = bs[s * PB + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < PJ; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) u[i][j] += xv[i] * bv[j];
        }
        const float dec = expf(a_tot);
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float* hp = hs + (ty + 16 * i) * HB + n0 + tx + 16 * j;
            *hp = *hp * dec + u[i][j];
          }
      }
    }

    // the masked scores to shared memory
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
    __syncthreads();

    // y rows t = ty + 16 i (i < 8), cols p = tx + 16 j (j < PJ)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = eas[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
    }
    // intra: rows of block i hold t in [16 i, 16 i + 16), so the 32-wide
    // block k of s is needed only by i >= 2k
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s_end = min(32 * k + 32, nv);
      for (int s = 32 * k; s < s_end; ++s) {
        float xv[PJ];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = xs[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 2 * k; i < 8; ++i) {
          const float sv = ss[(ty + 16 * i) * PS + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += sv * xv[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      if (t < nv) {
        T* yr = yb + (long long)(c0 + t) * H * wd.P;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + 16 * j;
          if (p < wd.P) rt::store(yr + p, acc[i][j] + d_h * xs[t * P + p]);
        }
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + ((long long)b * H + h) * wd.P * wd.N;
    for (int i = tid; i < wd.P * wd.N; i += NT) so[i] = hs[(i / wd.N) * HB + i % wd.N];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, void* y, void* state, int B, int S,
           int H, int G, int chunk, Widths wd, long long sxb, long long sxs, long long sxh,
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
      static_cast<float*>(state), S, H, G, chunk, wd, sxb, sxs, sxh, sdb, sds, sdh,
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
// Every template's P and N are the tile widths, the real widths padded up
// to a multiple of 16 (the mma tile): the padding columns of x, B and C are
// zero-filled on load, so they add nothing to any product, and y and the
// final state are stored for the real columns only.  The state scratch
// (dS) has the padded (P x N) layout.
namespace chunked {

using tc::bf16;

constexpr int NT = 128;           // 4 warps
constexpr int L = 128;            // rows of the chunk tile: the largest chunk taken
constexpr int CLUSTER_MAX = 8;    // the portable cluster size
static_assert(NT == L, "one dt row per thread");

template <int P, int N>
struct Dims {
  static_assert(P % 16 == 0 && N % 16 == 0 && P <= L, "tile widths");
  static constexpr int PXP = P + tc::PAD;  // shared-memory row pitch of the x tile
  static constexpr int PXN = N + tc::PAD;  // ... of the B, C, w o B and h tiles
  static constexpr int HV = P * N / 2 / NT;  // float2 of a (P x N) state per thread
  static constexpr int PASS_NT = P * N / 4 < 256 ? P * N / 4 : 256;  // one float4 per thread
  static constexpr int PASS_CTAS = P * N / 4 / PASS_NT;
  static constexpr size_t X_B = sizeof(bf16) * L * PXP;  // the x tile
  static constexpr size_t T_B = sizeof(bf16) * L * PXN;  // one L-row tile of N columns
  static constexpr size_t H_B = sizeof(bf16) * P * PXN;  // one P-row tile (h hi or lo)
  static constexpr size_t VEC_B = sizeof(float) * 3 * L;  // dt, a_cum, w
  // state: x, B, w o B hi and lo; out: x, B, C, and h hi and lo; cluster:
  // x, B, C, w o B hi and lo (h over them), and dS
  static constexpr size_t state_smem = X_B + 3 * T_B + VEC_B;
  static constexpr size_t out_smem = X_B + 2 * T_B + 2 * H_B + VEC_B;
  static constexpr size_t cluster_smem = X_B + 4 * T_B + VEC_B + sizeof(float) * (P * N + 4);
};

struct Smem {
  bf16 *xs, *bs, *cs;  // L rows each: x rows (s, p), B rows (s, n), C rows (t, n)
  bf16 *wh, *wl;       // L rows: w o B, bf16 hi and lo
  bf16 *hh, *hl;       // P rows: the entering state (p, n), bf16 hi and lo
  float *dts, *acs, *ws;  // L each: dt, a_cum, w
};

template <int P, int N>
__device__ __forceinline__ Smem carve(unsigned char* raw, bool with_c, bool h_over_w) {
  using D = Dims<P, N>;
  Smem sm;
  bf16* t = reinterpret_cast<bf16*>(raw);
  sm.xs = t;
  sm.bs = t + L * D::PXP;
  sm.cs = with_c ? sm.bs + L * D::PXN : nullptr;
  bf16* next = sm.bs + (with_c ? 2 : 1) * L * D::PXN;
  sm.wh = next;
  sm.wl = next + L * D::PXN;
  sm.hh = h_over_w ? sm.wh : next;
  sm.hl = h_over_w ? sm.wl : next + P * D::PXN;
  // the vectors follow the last tiles in use: w o B, or h where w o B is not
  const bool w_used = h_over_w || !with_c;
  sm.dts = reinterpret_cast<float*>(next + (w_used ? 2 * L : 2 * P) * D::PXN);
  sm.acs = sm.dts + L;
  sm.ws = sm.acs + L;
  return sm;
}

// Rows [0, nvalid) x columns [0, ncols) of a bf16 tile of COLS columns
// (pitch COLS + PAD) into shared memory; the other rows and columns up to
// (L, COLS) zero-filled.  `vec`: 16-byte cp.async (`rows16`), else element
// by element (finished by the caller's next barrier).
template <int COLS>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* src, long long row_stride,
                                          int nvalid, int ncols, bool vec) {
  constexpr int PXC = COLS + tc::PAD;
  if (vec) {
    constexpr int CPR = COLS / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < L * CPR; c += NT) {
      const int i = c / CPR, j = (c % CPR) * 8;
      const bool ok = i < nvalid && j < ncols;
      tc::cp_async16(sm + i * PXC + j, src + (ok ? (long long)i * row_stride + j : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < L * COLS; e += NT) {
      const int i = e / COLS, j = e % COLS;
      bf16 v = __float2bfloat16(0.f);
      if (i < nvalid && j < ncols) v = src[(long long)i * row_stride + j];
      sm[i * PXC + j] = v;
    }
  }
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
// w forms the 16-row blocks p = 16 m .. 16 m + 15 for m = w, w + 4, ...,
// written (fp32, row pitch N) to `out`, global or shared.  Needs the x and
// B tiles landed and w in place.
template <int P, int N>
__device__ __forceinline__ void chunk_state(const Smem& sm, int nv, float* out) {
  constexpr int PXN = Dims<P, N>::PXN, PXP = Dims<P, N>::PXP;
  __syncthreads();  // w and the tiles are visible to every thread
  for (int i = threadIdx.x; i < L * N / 2; i += NT) {
    const int t = i / (N / 2), n = 2 * (i % (N / 2));
    const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sm.bs + t * PXN + n));
    uint32_t hi, lo;
    tc::split2(bv.x * sm.ws[t], bv.y * sm.ws[t], hi, lo);
    *reinterpret_cast<uint32_t*>(sm.wh + t * PXN + n) = hi;
    *reinterpret_cast<uint32_t*>(sm.wl + t * PXN + n) = lo;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ksteps = (nv + 15) / 16;
  for (int m = warp; m < P / 16; m += NT / 32) {
    float acc[N / 8][4];
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t a[4];
      tc::ldsm_a_kmajor(a, sm.xs, PXP, kk * 16, m * 16);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bf[4];
        tc::ldsm_b_kmajor(bf, sm.wh, PXN, kk * 16, np * 16);
        tc::mma(acc[2 * np], a, bf[0], bf[1]);
        tc::mma(acc[2 * np + 1], a, bf[2], bf[3]);
        tc::ldsm_b_kmajor(bf, sm.wl, PXN, kk * 16, np * 16);
        tc::mma(acc[2 * np], a, bf[0], bf[1]);
        tc::mma(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    const int r = m * 16 + lane / 4, col = 2 * (lane % 4);
#pragma unroll
    for (int nb = 0; nb < N / 8; ++nb) {
      *reinterpret_cast<float2*>(out + r * N + nb * 8 + col) = make_float2(acc[nb][0], acc[nb][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * N + nb * 8 + col) =
          make_float2(acc[nb][2], acc[nb][3]);
    }
  }
}

// One step of the state recurrence, h <- exp(a_tot) h + dS, over this
// thread's HV float2 of the state (element f = threadIdx.x + i NT)
template <int HV>
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
template <int P, int N>
__device__ __forceinline__ void store_state_split(const Smem& sm,
                                                  const float2 (&hv)[Dims<P, N>::HV]) {
  constexpr int PXN = Dims<P, N>::PXN;
#pragma unroll
  for (int i = 0; i < Dims<P, N>::HV; ++i) {
    const int f = threadIdx.x + i * NT, p = f / (N / 2), n = 2 * (f % (N / 2));
    uint32_t hi, lo;
    tc::split2(hv[i].x, hv[i].y, hi, lo);
    *reinterpret_cast<uint32_t*>(sm.hh + p * PXN + n) = hi;
    *reinterpret_cast<uint32_t*>(sm.hl + p * PXN + n) = lo;
  }
}

// E consecutive elements from element e of a padded (P x N) state to the
// final state (Pr x Nr, fp32, contiguous), the padding dropped.
template <int P, int N, int E>
__device__ __forceinline__ void store_final(float* so, const float* v, int e, int Pr, int Nr) {
  if (Pr == P && Nr == N) {
    if constexpr (E == 4) {
      *reinterpret_cast<float4*>(so + e) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<float2*>(so + e) = make_float2(v[0], v[1]);
    }
    return;
  }
  const int p = e / N, n = e % N;
  if (p >= Pr) return;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (n + k < Nr) so[p * Nr + n + k] = v[k];
  }
}

// One warp's 16-row tile i of y: C's A-fragments (kept for C h^T while N
// is at most 64, else loaded again) and the fp32 accumulator.
template <int P, int N>
struct TileY {
  uint32_t ca[N / 16][4];
  float y[P / 8][4];
};

// The part of tile i of y that needs no entering state: the masked,
// decayed C B^T scores times x, the scores as bf16 hi + lo.
template <int P, int N>
__device__ __forceinline__ void tile_intra(const Smem& sm, int i, TileY<P, N>& ty) {
  constexpr int PXN = Dims<P, N>::PXN, PXP = Dims<P, N>::PXP;
  const int lane = threadIdx.x % 32, gq = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) tc::ldsm_a(ty.ca[kk], sm.cs, PXN, 16 * i, 16 * kk);
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
        tc::ldsm_b_nmajor(bf, sm.bs, PXN, 16 * np, 16 * kk);
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
        tc::ldsm_b_kmajor(bf, sm.xs, PXP, 16 * j, 16 * dp);
        tc::mma(ty.y[2 * dp], sh, bf[0], bf[1]);
        tc::mma(ty.y[2 * dp + 1], sh, bf[2], bf[3]);
        tc::mma(ty.y[2 * dp], sl, bf[0], bf[1]);
        tc::mma(ty.y[2 * dp + 1], sl, bf[2], bf[3]);
      }
    }
  }
}

// The rest of tile i: + exp(a_cum_t) C_t h^T (with `has_h`; h as bf16 hi +
// lo) + D x, written in bf16 to yb (row t at yb + t * H * Pr, columns p <
// Pr) for t < nv.
template <int P, int N>
__device__ __forceinline__ void tile_finish(const Smem& sm, int i, TileY<P, N>& ty, bool has_h,
                                            float d_h, bf16* yb, int H, int nv, int Pr) {
  constexpr int PXN = Dims<P, N>::PXN, PXP = Dims<P, N>::PXP;
  const int lane = threadIdx.x % 32, gq = lane / 4, t4 = lane % 4;
  const int t0 = 16 * i + gq;
  if (has_h) {
    if constexpr (N > 64) {  // not kept across the cluster barrier: registers
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) tc::ldsm_a(ty.ca[kk], sm.cs, PXN, 16 * i, 16 * kk);
    }
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
        tc::ldsm_b_nmajor(bf, sm.hh, PXN, 16 * dp, 16 * kk);
        tc::mma(z[2 * dp], ty.ca[kk], bf[0], bf[1]);
        tc::mma(z[2 * dp + 1], ty.ca[kk], bf[2], bf[3]);
        tc::ldsm_b_nmajor(bf, sm.hl, PXN, 16 * dp, 16 * kk);
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
      bf16* yr = yb + (long long)t * H * Pr;
#pragma unroll
      for (int nb = 0; nb < P / 8; ++nb) {
        const int p = 8 * nb + 2 * t4;
        if (P == Pr || p < Pr) {  // Pr is even: the pair is whole or out
          const float2 xv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sm.xs + t * PXP + p));
          *reinterpret_cast<__nv_bfloat162*>(yr + p) = __floats2bfloat162_rn(
              ty.y[nb][2 * r] + d_h * xv.x, ty.y[nb][2 * r + 1] + d_h * xv.y);
        }
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
  float* state;  // (B, H, Pr, Nr) or null
  float *dS, *atot;  // scratch of the three-kernel path; dS padded (P x N)
  int S, H, G, chunk, nc;
  Widths wd;  // the real P and N, 16-byte loads of x, B, C
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

// Issue the chunk's x and B (and C) tile copies; return its live rows.
template <int P, int N>
__device__ __forceinline__ int load_chunk(const Smem& sm, const Args& a, int b, int h, int c) {
  const int g = h / (a.H / a.G);
  const int c0 = c * a.chunk, nv = min(a.chunk, a.S - c0);
  load_tile<P>(sm.xs, a.x + b * a.sxb + c0 * a.sxs + h * a.sxh, a.sxs, nv, a.wd.P, a.wd.vx);
  load_tile<N>(sm.bs, a.Bm + b * a.sbb + c0 * a.sbs + g * a.sbg, a.sbs, nv, a.wd.N, a.wd.vb);
  if (sm.cs != nullptr) {
    load_tile<N>(sm.cs, a.Cm + b * a.scb + c0 * a.scs + g * a.scg, a.scs, nv, a.wd.N, a.wd.vc);
  }
  tc::cp_async_commit();
  return nv;
}

__device__ __forceinline__ bf16* y_rows(const Args& a, int b, int h, int c) {
  return a.y + (((long long)b * a.S + (long long)c * a.chunk) * a.H + h) * a.wd.P;  // (B,S,H,P)
}

template <int P, int N>
__global__ void __launch_bounds__(NT) ssd_cluster_kernel(Args a) {
  using D = Dims<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve<P, N>(smem_raw, true, true);
  float* dss = sm.ws + L;      // P x N: this chunk's dS
  float* a_tot_s = dss + P * N;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank()), h = blockIdx.y, b = blockIdx.z;
  const int nv = load_chunk<P, N>(sm, a, b, h, c);
  const float a_h = a.A[h];
  const float d_h = a.D != nullptr ? a.D[h] : 0.f;
  chunk_cumsum(sm, load_dt(a.dt + b * a.sdb + h * a.sdh, a.sds, c * a.chunk, nv), a_h, nv);
  const float a_tot = sm.acs[L - 1];
  tc::cp_async_wait<0>();
  chunk_state<P, N>(sm, nv, dss);
  if (threadIdx.x == 0) *a_tot_s = a_tot;
  // arrive now, wait after the part of y that needs no entering state
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  TileY<P, N> ty[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (16 * warp_tile(half) < nv) tile_intra<P, N>(sm, warp_tile(half), ty[half]);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  // every chunk's dS and a_tot are in place: the entering state from the
  // earlier chunks' dS (the pass kernel's recurrence), and from the last
  // chunk the final state
  const bool last = a.state != nullptr && c == a.nc - 1;
  if (c > 0 || last) {
    float2 hv[D::HV];
#pragma unroll
    for (int i = 0; i < D::HV; ++i) hv[i] = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX - 1; ++r) {  // unrolled: the peers' loads go out together
      if (r < c) {
        pass_step(hv, expf(*cluster.map_shared_rank(a_tot_s, r)), cluster.map_shared_rank(dss, r));
      }
    }
    if (c > 0) store_state_split<P, N>(sm, hv);  // over w o B, which chunk_state is done with
    if (last) {
      pass_step(hv, expf(a_tot), dss);
      float* so = a.state + ((long long)b * a.H + h) * a.wd.P * a.wd.N;
#pragma unroll
      for (int i = 0; i < D::HV; ++i) {
        const float v[2] = {hv[i].x, hv[i].y};
        store_final<P, N, 2>(so, v, 2 * (threadIdx.x + i * NT), a.wd.P, a.wd.N);
      }
    }
  }
  __syncthreads();
  bf16* yb = y_rows(a, b, h, c);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = warp_tile(half);
    if (16 * i < nv) tile_finish<P, N>(sm, i, ty[half], c > 0, d_h, yb, a.H, nv, a.wd.P);
  }
  cluster.sync();  // the peers are done reading this CTA's dS
}

template <int P, int N>
__global__ void __launch_bounds__(NT) ssd_state_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve<P, N>(smem_raw, false, false);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nv = load_chunk<P, N>(sm, a, b, h, c);
  chunk_cumsum(sm, load_dt(a.dt + b * a.sdb + h * a.sdh, a.sds, c * a.chunk, nv), a.A[h], nv);
  tc::cp_async_wait<0>();
  const long long slot = ((long long)b * a.nc + c) * a.H + h;
  chunk_state<P, N>(sm, nv, a.dS + slot * P * N);
  if (threadIdx.x == 0) a.atot[slot] = sm.acs[L - 1];
}

// grid (PASS_CTAS, B*H): the recurrence over the chunks whose dS exists
// (all, with a final state; else all but the last), each chunk's entering
// state over its dS slot, then the final state (or the last chunk's
// entering state)
template <int P, int N>
__global__ void __launch_bounds__(Dims<P, N>::PASS_NT) ssd_pass_kernel(Args a) {
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int i = blockIdx.x * Dims<P, N>::PASS_NT + threadIdx.x;  // float4 index in the (P x N) state
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
  if (a.state != nullptr) {
    const float v[4] = {hc.x, hc.y, hc.z, hc.w};
    store_final<P, N, 4>(a.state + ((long long)b * a.H + h) * a.wd.P * a.wd.N, v, 4 * i,
                         a.wd.P, a.wd.N);
  } else {
    reinterpret_cast<float4*>(a.dS + (((long long)b * a.nc + n1) * a.H + h) * P * N)[i] = hc;
  }
}

template <int P, int N>
__global__ void __launch_bounds__(NT) ssd_out_kernel(Args a) {
  using D = Dims<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve<P, N>(smem_raw, true, false);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nv = load_chunk<P, N>(sm, a, b, h, c);
  const float a_h = a.A[h];
  const float d_h = a.D != nullptr ? a.D[h] : 0.f;
  const float dt_row = load_dt(a.dt + b * a.sdb + h * a.sdh, a.sds, c * a.chunk, nv);
  float2 hv[D::HV];
  if (c > 0) {  // chunk 0 starts from the zero state
    const float2* src = reinterpret_cast<const float2*>(
        a.dS + (((long long)b * a.nc + c) * a.H + h) * P * N);
#pragma unroll
    for (int i = 0; i < D::HV; ++i) hv[i] = src[threadIdx.x + i * NT];
  }
  chunk_cumsum(sm, dt_row, a_h, nv);
  if (c > 0) store_state_split<P, N>(sm, hv);
  tc::cp_async_wait<0>();
  __syncthreads();
  bf16* yb = y_rows(a, b, h, c);
  for (int half = 0; half < 2; ++half) {
    const int i = warp_tile(half);
    if (16 * i >= nv) continue;
    TileY<P, N> ty;
    tile_intra<P, N>(sm, i, ty);
    tile_finish<P, N>(sm, i, ty, c > 0, d_h, yb, a.H, nv, a.wd.P);
  }
}

template <int P, int N>
int launch(const Args& a, int B, cudaStream_t stream) {
  using D = Dims<P, N>;
  cudaError_t err;
  if (a.nc <= CLUSTER_MAX) {
    err = cudaFuncSetAttribute(ssd_cluster_kernel<P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(D::cluster_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.nc, a.H, B);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = D::cluster_smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, ssd_cluster_kernel<P, N>, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.dS == nullptr || a.atot == nullptr) return -1;
  const int n1 = a.state != nullptr ? a.nc : a.nc - 1;  // chunks whose dS is needed
  err = cudaFuncSetAttribute(ssd_state_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(D::state_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<P, N><<<dim3(n1, a.H, B), NT, D::state_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<P, N><<<dim3(D::PASS_CTAS, B * a.H), D::PASS_NT, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_out_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(D::out_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_out_kernel<P, N><<<dim3(a.nc, a.H, B), NT, D::out_smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked

namespace {

// Run `fn` with the tile widths (P and N padded up to a multiple of 16) as
// template arguments; -1 for a pair no instance covers.
template <typename F>
int with_tiles(int P, int N, F&& fn) {
  const int pp = (P + 15) / 16 * 16, nn = (N + 15) / 16 * 16;
  if (pp == 64 && nn == 64) return fn(std::integral_constant<int, 64>{}, std::integral_constant<int, 64>{});
  if (pp == 16 && nn == 16) return fn(std::integral_constant<int, 16>{}, std::integral_constant<int, 16>{});
  if (pp == 32 && nn == 16) return fn(std::integral_constant<int, 32>{}, std::integral_constant<int, 16>{});
  if (pp == 64 && nn == 128) return fn(std::integral_constant<int, 64>{}, std::integral_constant<int, 128>{});
  return -1;
}

}  // namespace

// y is (B,S,H,P) contiguous in x's type; state (B,H,P,N) fp32 contiguous, or
// null for none; D may be null.  fp32 runs the scalar kernel (dS and atot
// unused, may be null); bf16 the chunk-parallel route, which needs dS
// (B, chunks, H, P16, N16) and atot (B, chunks, H) fp32 scratch when S holds
// more than CLUSTER_MAX chunks (P16, N16: P and N padded up to a multiple of
// 16).  (P, N) must pad to one of the instances of `with_tiles`; P even.
// Returns the CUDA error of the launches (0 on success), or -1 for an
// argument the kernels do not take (the Python wrapper checks first).
extern "C" int ssd_launch(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* D, void* y, void* state, void* dS, void* atot, int B, int S, int H, int G,
    int P, int N, int chunk, long long sxb, long long sxs, long long sxh, long long sdb,
    long long sds, long long sdh, long long sbb, long long sbs, long long sbg,
    long long scb, long long scs, long long scg, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || chunk < 1 || chunk > L) return -1;
  if (P < 2 || P % 2 || N < 1 || (dtype != rt::F32 && dtype != rt::BF16)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int es = dtype == rt::F32 ? 4 : 2;
  const Widths wd{P, N, rows16(x, sxb, sxs, sxh, P, es), rows16(Bm, sbb, sbs, sbg, N, es),
                  rows16(Cm, scb, scs, scg, N, es)};
  if (dtype == rt::F32) {
    return with_tiles(P, N, [&](auto pp, auto nn) {
      return launch<float, decltype(pp)::value, decltype(nn)::value>(
          x, dt, A, Bm, Cm, D, y, state, B, S, H, G, chunk, wd, sxb, sxs, sxh, sdb, sds, sdh,
          sbb, sbs, sbg, scb, scs, scg, st);
    });
  }
  using chunked::bf16;
  const chunked::Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(Bm),
                        static_cast<const bf16*>(Cm), static_cast<const float*>(dt),
                        static_cast<const float*>(A), static_cast<const float*>(D),
                        static_cast<bf16*>(y), static_cast<float*>(state),
                        static_cast<float*>(dS), static_cast<float*>(atot),
                        S, H, G, chunk, (S + chunk - 1) / chunk, wd,
                        sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg};
  return with_tiles(P, N, [&](auto pp, auto nn) {
    return chunked::launch<decltype(pp)::value, decltype(nn)::value>(a, B, st);
  });
}
