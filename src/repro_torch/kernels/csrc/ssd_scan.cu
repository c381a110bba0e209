// ssd_scan for Hopper (sm_90a): the Mamba2 SSD chunked scan with a scalar
// decay per head, carrying an (N x P) float32 state across chunks.
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (function at line 75, its pl.pallas_call at line 99, body `_ssd_kernel`
// at line 28).  It computes what that kernel computes, chunk by chunk (t, j
// index the L steps of a chunk):
//
//   a        = -exp(a_log[h]),  cum_t = sum_{i<=t} dt_i a
//   scores   = (C_t . B_j) e^{cum_t - cum_j} dt_j,       j <= t
//   y_t      = sum_j scores[t,j] x_j + e^{cum_t} C_t . S
//   S       <- e^{cum_L} S + sum_j (B_j e^{cum_L - cum_j} dt_j) x_j^T
//
// The decay is a scalar per head, so every exponent here is <= 0 and the
// chunk length is bounded only by shared memory.  The prefix sums cum are
// taken in float64: at zamba2's chunk of 128 with A down to -16, cum
// reaches about -1400, where one float32 ulp (1.2e-4) of cum_t - cum_j
// would already be the whole tolerance of the scores e^{cum_t - cum_j}.
//
// Layout: x and y (B, S, H, P), dt (B, S, H), B and C (B, S, H, N), all
// float32 and addressed through element strides with the last dimension
// contiguous.  With one B/C group the model hands in B and C expanded over
// the heads with a head stride of 0, so the group's values are read in
// place rather than repeated.  a_log is (H,); s0 and s_out are (B, H, P, N)
// contiguous, the API's layout (the state is (N, P) inside, as in the TPU
// kernel).  s0 may be null (zero state).
//
// Grid: one block of 256 threads per (b, h), looping over the S / L chunks
// in order.  The state stays in shared memory; each chunk's x, B, C and dt
// are staged in shared memory.  Warp 0 scans the log decay; the (L x L)
// scores are built 32 rows at a time (a 32 x L tile, so the chunk of 128
// zamba2 uses fits beside the staged tiles in ~130 KB of the 227 KB a
// block may opt into), and every product runs as float32 FMAs on the CUDA
// cores.  L is a runtime argument (pick_chunk gives 1 for a prime prompt
// length), so no shape needs padding.
//
// What bounds it on this card: operations.  Per chunk and (b, h) it reads
// L (P + 2N + 1) floats and writes L P, against about L^2 N + L^2 P +
// 4 L N P FLOP: 32 FLOP per byte at L = 128 and P = N = 64 (more with B
// and C shared by every head), above the H100's ~20 FLOP/byte balance for
// float32 outside the tensor cores.  This design is far from that limit:
// one block per SM (its shared memory), only B * H blocks (64 for zamba2
// at B = 1), and no load overlapping any math.  wgmma for the three
// products, several blocks per sequence with a second pass for the carried
// state, and pipelined tile loads are the later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;          // score rows built at a time
constexpr size_t kMaxSmem = 232448;  // what one block may opt into on H100

// the float tiles of the dynamic shared memory for P, N and chunk L
__host__ __device__ constexpr size_t float_tiles(int P, int N, int L) {
  return (size_t)N * P            // state S[n][p]
         + (size_t)L * P          // x
         + (size_t)L * (N + 1)    // B (padded rows: no bank conflicts)
         + (size_t)L * N          // C
         + (size_t)kRows * (L + 1)  // one block of score rows
         + 2 * (size_t)L + 1;     // dt, state weights, e^{cum_L}
}

// the whole of it, in floats: the tiles rounded up to an even count, then
// the L float64 prefix sums
__host__ __device__ constexpr size_t smem_floats(int P, int N, int L) {
  return (float_tiles(P, N, L) + 1) / 2 * 2 + 2 * (size_t)L;
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ s0, float* __restrict__ y,
                    float* __restrict__ s_out, int S, int H, int P, int N,
                    int L, int64_t x_sb, int64_t x_ss, int64_t x_sh,
                    int64_t d_sb, int64_t d_ss, int64_t d_sh, int64_t b_sb,
                    int64_t b_ss, int64_t b_sh, int64_t c_sb, int64_t c_ss,
                    int64_t c_sh, int64_t y_sb, int64_t y_ss, int64_t y_sh) {
  extern __shared__ double smem_d[];   // 8-byte aligned
  float* smem = reinterpret_cast<float*>(smem_d);
  const int Nb = N + 1, Lr = L + 1;
  float* st = smem;              // N x P
  float* xs = st + N * P;        // L x P
  float* bs = xs + L * P;        // L x Nb
  float* cs = bs + L * Nb;       // L x N
  float* sc = cs + L * N;        // kRows x Lr
  float* dts = sc + kRows * Lr;  // L
  float* wj = dts + L;           // L   e^{cum_L - cum_j} dt_j
  float* decay = wj + L;         // 1   e^{cum_L}
  double* cum = smem_d + (float_tiles(P, N, L) + 1) / 2;   // L doubles

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int64_t state_off = (int64_t)bh * P * N;
  for (int i = tid; i < N * P; i += kThreads) {
    const int p = i / N, n = i % N;   // API layout (P, N)
    st[n * P + p] = s0 != nullptr ? s0[state_off + i] : 0.f;
  }
  const float a = -expf(a_log[h]);

  const float* xb = x + b * x_sb + h * x_sh;
  const float* db = dt + b * d_sb + h * d_sh;
  const float* bb = bm + b * b_sb + h * b_sh;
  const float* cb = cm + b * c_sb + h * c_sh;
  float* yb = y + b * y_sb + h * y_sh;

  for (int t0 = 0; t0 < S; t0 += L) {
    // stage the chunk (the previous chunk's last reads ended at a sync)
    for (int i = tid; i < L * P; i += kThreads) {
      const int64_t s = t0 + i / P;
      xs[i] = xb[s * x_ss + i % P];
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const int64_t s = t0 + t;
      bs[t * Nb + n] = bb[s * b_ss + n];
      cs[i] = cb[s * c_ss + n];
    }
    for (int t = tid; t < L; t += kThreads) dts[t] = db[(int64_t)(t0 + t) * d_ss];
    __syncthreads();

    // float64 prefix sum of the log decay dt * a over the chunk, in warp
    // 0: each lane sums a run of consecutive steps, then the runs are
    // scanned
    if (tid < 32) {
      const int per = (L + 31) / 32;
      const int lo = min(L, tid * per), hi = min(L, lo + per);
      double run = 0.0;
      for (int t = lo; t < hi; ++t) {
        run += (double)(dts[t] * a);
        cum[t] = run;
      }
      double incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      const double before = incl - run;
      const double total = __shfl_sync(0xffffffffu, incl, 31);
      for (int t = lo; t < hi; ++t) {
        cum[t] += before;
        wj[t] = expf((float)(total - cum[t])) * dts[t];
      }
      if (tid == 0) decay[0] = expf((float)total);
    }
    __syncthreads();

    for (int r0 = 0; r0 < L; r0 += kRows) {
      const int rows = min(kRows, L - r0);
      // scores[t][j] = (C_t . B_j) e^{cum_t - cum_j} dt_j for j <= t
      for (int i = tid; i < rows * L; i += kThreads) {
        const int tt = i / L, j = i % L, t = r0 + tt;
        float v = 0.f;
        if (j <= t) {
          const float* ct = cs + t * N;
          const float* bj = bs + j * Nb;
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot = fmaf(ct[n], bj[n], dot);
          v = dot * expf((float)(cum[t] - cum[j])) * dts[j];
        }
        sc[tt * Lr + j] = v;
      }
      __syncthreads();
      // y_t = sum_{j<=t} scores[t][j] x_j + e^{cum_t} C_t . S
      for (int i = tid; i < rows * P; i += kThreads) {
        const int tt = i / P, p = i % P, t = r0 + tt;
        float acc = 0.f;
        for (int j = 0; j <= t; ++j)
          acc = fmaf(sc[tt * Lr + j], xs[j * P + p], acc);
        const float* ct = cs + t * N;
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(ct[n], st[n * P + p], inter);
        yb[(int64_t)(t0 + t) * y_ss + p] =
            fmaf(expf((float)cum[t]), inter, acc);
      }
      __syncthreads();   // the score tile is rewritten by the next rows
    }

    // S <- e^{cum_L} S + sum_t (B_t wj_t) x_t^T
    const float dl = decay[0];
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P, p = i % P;
      float acc = st[i] * dl;
      for (int t = 0; t < L; ++t)
        acc = fmaf(bs[t * Nb + n] * wj[t], xs[t * P + p], acc);
      st[i] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < N * P; i += kThreads) {
    const int p = i / N, n = i % N;
    s_out[state_off + i] = st[n * P + p];
  }
}

}  // namespace

// Strides are in elements, ordered x (batch, seq, head), dt, B, C, y.
// a_log is (H,); s0 / s_out are (B, H, P, N) contiguous; s0 may be null.
// Needs S % L == 0 and the shared memory of (P, N, L) within what a block
// may opt into (232,448 bytes).  Returns the cudaError_t of the launch.
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* a_log, const void* b_in,
    const void* c_in, const void* s0, void* y, void* s_out, int B, int S,
    int H, int P, int N, int L, int64_t x_sb, int64_t x_ss, int64_t x_sh,
    int64_t d_sb, int64_t d_ss, int64_t d_sh, int64_t b_sb, int64_t b_ss,
    int64_t b_sh, int64_t c_sb, int64_t c_ss, int64_t c_sh, int64_t y_sb,
    int64_t y_ss, int64_t y_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 ||
      S % L != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(P, N, L);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // raised once, to the most a block may have, at the first launch that
  // needs more than the default 48 KB (never inside a graph capture that
  // replays launches made before it)
  static bool smem_raised = false;
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    smem_raised = true;
  }
  ssd_scan_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(b_in),
      static_cast<const float*>(c_in), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), S, H, P, N, L,
      x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh,
      y_sb, y_ss, y_sh);
  return (int)cudaGetLastError();
}
