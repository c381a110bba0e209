// ssd_scan for Hopper (sm_90a): the Mamba2 SSD chunked scan with a scalar
// decay per head, carrying an (N x P) float32 state across chunks, with
// its three chunk products on the tensor cores.
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
// contiguous; x, B and C rows 16-byte aligned.  With one B/C group the
// model hands in B and C expanded over the heads with a head stride of 0,
// so the group's values are read in place rather than repeated.  a_log is
// (H,); s0 and s_out are (B, H, P, N) contiguous, the API's layout (the
// state is (N, P) inside, as in the TPU kernel).  s0 may be null (zero
// state).  P is a multiple of 16 and N of 8.
//
// What bounds it on this card: operations.  Per chunk and head it reads
// L (P + 2N + 1) floats and writes L P, against about L^2 N + L^2 P +
// 4 L N P FLOP: 32 FLOP per byte at L = 128 and P = N = 64 (more with B
// and C shared by every head), near the balance of float32-accurate
// tensor-core products (3 x TF32 at 165 TFLOP/s against 3.35 TB/s is ~49
// FLOP/byte).
//
// Design:
//   * Value-tiled blocks.  Column p of y and of the state depends only on
//     column p of x, so a block owns one (b, h) and a tile of PT value
//     columns, and runs that sequence's chunks in order with its (N x PT)
//     state tile in shared memory: no second pass, no state traffic
//     between blocks.  Each block recomputes the chunk's shared part (the
//     scores C B^T and the prefix sums).  The host picks PT from the shape
//     (`ssd_plan` in ssd_scan.py) so the grid has a block per two SMs where
//     the shape has that many; the tiles of one (b, h) are adjacent in
//     launch order, so their shared B/C/dt reads meet in L2.
//   * Tensor cores: all three products (C B^T, then scores x and C S for y,
//     and (B w)^T x for the state) run on mma.sync m16n8k8 as 3 x TF32
//     (mma_common.cuh), which keeps float32 accuracy where one TF32
//     product misses the 3e-4 tolerance by 300x.  Each of the 8 warps owns
//     some 16-row tiles of the chunk (all the block's value columns, or a
//     part of them where row tiles are fewer than warps), dealt so the
//     two warps of each SM sub-partition share the triangular work
//     evenly, and streams the scores four 8-column tiles at a time: the
//     C B^T
//     accumulator is scaled by e^{cum_t - cum_j} dt_j and masked to
//     j <= t < L in registers and fed, as it lies, to the scores . x
//     product, which reads its k index t as column 2t and t + 4 as 2t + 1.
//     Shared-memory row strides (x: PT + 4, B/C: N + 4, state: PT + 8) make
//     every fragment load conflict-free.
//   * Chunk c + 1's x, B, C (16-byte cp.async.cg) and dt (4-byte, its seq
//     stride is H) are staged in a second buffer while chunk c computes;
//     the tiles' rows past L are zeroed once and never loaded, so no shape
//     needs padding (pick_chunk gives L = 1 for a prime prompt length).
//   * Every instantiation's shared-memory limit is raised on the first
//     call of the C entry point, whatever its shape, so a CUDA graph
//     captured later never meets one that was not set up.
//
// What it leaves for later: wgmma and TMA, and splitting each staged tile
// into TF32 hi/lo once per block instead of once per use.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::FragA;
using repro::FragB;
using repro::mma_3xtf32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 232448;  // what one block may opt into on H100

__host__ __device__ constexpr int round16(int l) { return (l + 15) / 16 * 16; }

// floats of one stage buffer: x, B, C, dt
__host__ __device__ constexpr size_t stage_floats(int pt, int n, int lr) {
  return (size_t)lr * (pt + 4) + 2 * (size_t)lr * (n + 4) + lr;
}

// bytes of dynamic shared memory: the float64 prefix sums first, then two
// stage buffers, the state tile, e^{cum_t}, the state weights and e^{cum_L}
__host__ __device__ constexpr size_t smem_bytes(int pt, int n, int l) {
  return 8 * (size_t)round16(l) +
         4 * (2 * stage_floats(pt, n, round16(l)) + (size_t)n * (pt + 8) +
              2 * (size_t)round16(l) + 1);
}

// Warp w's place in a round of 8 work units: units 0-3 go to warps 0-3
// and units 4-7 to warps 7-4, so the two warps of each SM sub-partition
// (w and w + 4) take a heavy and a light unit; odd rounds run backwards.
__device__ __forceinline__ int unit_slot(int warp, int round) {
  const int slot = warp < 4 ? warp : 11 - warp;
  return (round & 1) ? kWarps - 1 - slot : slot;
}

template <int PT>
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
  constexpr int XS = PT + 4, SS = PT + 8, NT = PT / 8;
  constexpr int XP = PT / 4;   // 16-byte pieces of an x row
  // score n-tiles built together (independent mma chains): 8 where the
  // registers allow, 4 in the narrow tiles that run two blocks per SM
  constexpr int kGroup = PT >= 64 ? 8 : 4;
  const int BS = N + 4, NP = N / 4;
  const int LR = round16(L);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cumd = reinterpret_cast<double*>(smem_raw);  // LR
  float* stage0 = reinterpret_cast<float*>(cumd + LR);
  const size_t stage = stage_floats(PT, N, LR);
  float* st = stage0 + 2 * stage;  // N x SS   state S[n][p]
  float* ecum = st + N * SS;       // LR       e^{cum_t}
  float* wj = ecum + LR;           // LR       e^{cum_L - cum_t} dt_t
  float* dec = wj + LR;            // 1        e^{cum_L}

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_pt = P / PT;
  const int pt = blockIdx.x % n_pt;
  const int bh = blockIdx.x / n_pt;
  const int b = bh / H, h = bh % H;
  const int p0 = pt * PT;

  const float* xb = x + b * x_sb + h * x_sh + p0;
  const float* db = dt + b * d_sb + h * d_sh;
  const float* bb = bm + b * b_sb + h * b_sh;
  const float* cb = cm + b * c_sb + h * c_sh;
  float* yb = y + b * y_sb + h * y_sh + p0;

  // this thread's first (row, 16-byte piece) of the B/C tiles and the step
  // to its next one, so the loads need no division per piece
  const int bc_r0 = tid / NP, bc_c0 = tid % NP;
  const int bc_dr = kThreads / NP, bc_dc = kThreads % NP;

  // rows past L stay zero in both buffers: no chunk writes them
  for (int buf = 0; buf < 2; ++buf) {
    float* xs = stage0 + buf * stage;
    float* bs = xs + LR * XS;
    float* cs = bs + LR * BS;
    float* dts = cs + LR * BS;
    for (int i = tid; i < (LR - L) * (XS + 2 * BS + 1); i += kThreads) {
      const int row = L + i % (LR - L), col = i / (LR - L);
      if (col < XS)
        xs[row * XS + col] = 0.f;
      else if (col < XS + BS)
        bs[row * BS + col - XS] = 0.f;
      else if (col < XS + 2 * BS)
        cs[row * BS + col - XS - BS] = 0.f;
      else
        dts[row] = 0.f;
    }
  }

  auto load_chunk = [&](int buf, int t0) {
    float* xs = stage0 + buf * stage;
    float* bs = xs + LR * XS;
    float* cs = bs + LR * BS;
    float* dts = cs + LR * BS;
    for (int i = tid; i < L * XP; i += kThreads) {
      const int r = i / XP, c = (i % XP) * 4;
      cp_async16(xs + r * XS + c, xb + (int64_t)(t0 + r) * x_ss + c, 16);
    }
    for (int r = bc_r0, c = bc_c0; r < L; r += bc_dr, c += bc_dc) {
      if (c >= NP) c -= NP, ++r;
      if (r >= L) break;
      const int64_t s = t0 + r;
      cp_async16(bs + r * BS + 4 * c, bb + s * b_ss + 4 * c, 16);
      cp_async16(cs + r * BS + 4 * c, cb + s * c_ss + 4 * c, 16);
    }
    for (int r = tid; r < L; r += kThreads)
      cp_async4(dts + r, db + (int64_t)(t0 + r) * d_ss, 4);
  };

  const int n_chunks = S / L;
  load_chunk(0, 0);
  cp_async_commit();

  // the state tile, (P, N) at the API -> [n][p] inside
  for (int i = tid; i < PT * N; i += kThreads) {
    const int p = i / N, n = i % N;
    const int64_t off = ((int64_t)(b * H + h) * P + p0 + p) * N + n;
    st[n * SS + p] = s0 != nullptr ? s0[off] : 0.f;
  }
  const float a_h = -expf(a_log[h]);

  // y work: (16-row tile, value part) units, row tiles longest first; the
  // value columns are cut in two only where row tiles are at most half the
  // warps and each part keeps >= 2 n-tiles (a part recomputes its row
  // tile's scores)
  const int RT = LR / 16;
  const int y_parts = (NT >= 4 && 2 * RT <= kWarps) ? 2 : 1;
  const int y_nt = NT / y_parts;
  // state work: (16 state rows, value part) units
  const int MT = (N + 15) / 16;
  const int u_parts = min(NT, max(1, kWarps / MT));
  const int u_nt = NT / u_parts;

  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // chunk c - 1 is done with its buffer and the state
    if (c + 1 < n_chunks) {
      load_chunk((c + 1) & 1, (c + 1) * L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c visible to every warp
    const float* xs = stage0 + (c & 1) * stage;
    const float* bs = xs + LR * XS;
    const float* cs = bs + LR * BS;
    const float* dts = cs + LR * BS;

    // float64 prefix sums of the log decay dt * a, on warp 0: each lane
    // sums a run of consecutive steps, then the runs are scanned.  Rows
    // past L get finite values and zero weights.
    if (warp == 0) {
      const float* dh = dts;
      double* cum = cumd;
      const int per = (L + 31) / 32;
      const int lo = min(L, lane * per), hi = min(L, lo + per);
      double run = 0.0;
      for (int t = lo; t < hi; ++t) {
        run += (double)(dh[t] * a_h);
        cum[t] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const double before = incl - run;
      const double total = __shfl_sync(0xffffffffu, incl, 31);
      for (int t = lo; t < hi; ++t) {
        cum[t] += before;
        ecum[t] = expf((float)cum[t]);
        wj[t] = expf((float)(total - cum[t])) * dh[t];
      }
      for (int t = L + lane; t < LR; t += 32) {
        cum[t] = total;
        ecum[t] = 0.f;
        wj[t] = 0.f;
      }
      if (lane == 0) *dec = expf((float)total);
    }
    __syncthreads();

    // y.  Products alternate between two accumulator sets (two chains)
    const int t_base = c * L;
    for (int round = 0; round * kWarps < RT * y_parts; ++round) {
      const int unit = round * kWarps + unit_slot(warp, round);
      if (unit >= RT * y_parts) continue;
      const int r0 = 16 * (RT - 1 - unit / y_parts);
      const int nt0 = (unit % y_parts) * y_nt;
      const int tr0 = r0 + g, tr1 = tr0 + 8;
      const float* c0 = cs + tr0 * BS + t4;
      const float* c1 = cs + tr1 * BS + t4;
      float acc[2][NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][n][e] = acc[1][n][e] = 0.f;

      // inter-chunk part: C_t . S, then scaled by e^{cum_t}
      auto inter_step = [&](int kk, float (&out)[NT][4]) {
        FragA a;
        a.set(c0[8 * kk], c1[8 * kk], c0[8 * kk + 4], c1[8 * kk + 4]);
        const float* sk = st + (8 * kk + t4) * SS + g + 8 * nt0;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n >= y_nt) break;
          FragB f;
          f.set(sk[8 * n], sk[4 * SS + 8 * n]);
          mma_3xtf32(out[n], a, f);
        }
      };
#pragma unroll 4
      for (int kk = 0; kk < N / 8; kk += 2) {
        inter_step(kk, acc[0]);
        if (kk + 1 < N / 8) inter_step(kk + 1, acc[1]);
      }
      {
        const float e0 = ecum[tr0], e1 = ecum[tr1];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][n][e] = (acc[0][n][e] + acc[1][n][e]) * (e < 2 ? e0 : e1);
            acc[1][n][e] = 0.f;
          }
      }
      const double cr0 = cumd[tr0], cr1 = cumd[tr1];

      // intra-chunk part: columns j < min(r0 + 16, L) can have j <= t < L
      const int njt = (min(r0 + 16, L) + 7) / 8;
      for (int jg = 0; jg < njt; jg += kGroup) {
        float sc[kGroup][4];
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jj][e] = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < N / 8; ++kk) {
          FragA a;
          a.set(c0[8 * kk], c1[8 * kk], c0[8 * kk + 4], c1[8 * kk + 4]);
#pragma unroll
          for (int jj = 0; jj < kGroup; ++jj) {
            if (jg + jj < njt) {
              const float* bj = bs + (8 * (jg + jj) + g) * BS + 8 * kk + t4;
              FragB f;
              f.set(bj[0], bj[4]);
              mma_3xtf32(sc[jj], a, f);
            }
          }
        }
        const float* xh = xs + g + 8 * nt0;
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          if (jg + jj >= njt) continue;
          // this lane's score columns: j0 (c0, c2) and j0 + 1 (c1, c3)
          const int j0 = 8 * (jg + jj) + 2 * t4;
          const double2 cj = *reinterpret_cast<const double2*>(cumd + j0);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j0);
          const float s00 = (j0 <= tr0 && tr0 < L)
              ? sc[jj][0] * expf((float)(cr0 - cj.x)) * dj.x : 0.f;
          const float s01 = (j0 + 1 <= tr0 && tr0 < L)
              ? sc[jj][1] * expf((float)(cr0 - cj.y)) * dj.y : 0.f;
          const float s10 = (j0 <= tr1 && tr1 < L)
              ? sc[jj][2] * expf((float)(cr1 - cj.x)) * dj.x : 0.f;
          const float s11 = (j0 + 1 <= tr1 && tr1 < L)
              ? sc[jj][3] * expf((float)(cr1 - cj.y)) * dj.y : 0.f;
          // A column t4 <-> score column j0, t4 + 4 <-> j0 + 1
          FragA a;
          a.set(s00, s10, s01, s11);
          const float* xj = xh + j0 * XS;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (n >= y_nt) break;
            FragB f;
            f.set(xj[8 * n], xj[XS + 8 * n]);
            mma_3xtf32(acc[jj & 1][n], a, f);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = i ? tr1 : tr0;
        if (t >= L) continue;
        float* yr = yb + (int64_t)(t_base + t) * y_ss + 8 * nt0 + 2 * t4;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n >= y_nt) break;
          *reinterpret_cast<float2*>(yr + 8 * n) = make_float2(
              acc[0][n][2 * i] + acc[1][n][2 * i],
              acc[0][n][2 * i + 1] + acc[1][n][2 * i + 1]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S <- e^{cum_L} S + (B w)^T x over (16 state rows, value part) units;
    // the k index t4 reads step 2 t4, t4 + 4 reads 2 t4 + 1
    for (int unit = warp; unit < MT * u_parts; unit += kWarps) {
      const int mt = unit / u_parts;
      const int nt0 = (unit % u_parts) * u_nt;
      const int n0 = 16 * mt + g, n1 = n0 + 8;
      const bool ok1 = n1 < N;
      float* sh = st + 2 * t4 + 8 * nt0;
      const float dl = *dec;
      float acc[2][NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][n][e] = acc[1][n][e] = 0.f;
        if (n >= u_nt) continue;
        const float2 v0 =
            *reinterpret_cast<const float2*>(sh + n0 * SS + 8 * n);
        const float2 v1 = ok1 ? *reinterpret_cast<const float2*>(
                                    sh + n1 * SS + 8 * n)
                              : make_float2(0.f, 0.f);
        acc[0][n][0] = v0.x * dl;
        acc[0][n][1] = v0.y * dl;
        acc[0][n][2] = v1.x * dl;
        acc[0][n][3] = v1.y * dl;
      }
      const float* wh = wj;
      const float* xh = xs + g + 8 * nt0;
      auto state_step = [&](int kk, float (&out)[NT][4]) {
        const int ta = 8 * kk + 2 * t4, tb = ta + 1;
        const float wa = wh[ta], wb = wh[tb];
        const float* ba = bs + ta * BS;
        const float* bt = bs + tb * BS;
        FragA a;
        a.set(ba[n0] * wa, ok1 ? ba[n1] * wa : 0.f, bt[n0] * wb,
              ok1 ? bt[n1] * wb : 0.f);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n >= u_nt) break;
          FragB f;
          f.set(xh[ta * XS + 8 * n], xh[tb * XS + 8 * n]);
          mma_3xtf32(out[n], a, f);
        }
      };
      const int kend = (L + 7) / 8;
#pragma unroll 4
      for (int kk = 0; kk < kend; kk += 2) {
        state_step(kk, acc[0]);
        if (kk + 1 < kend) state_step(kk + 1, acc[1]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= u_nt) break;
        *reinterpret_cast<float2*>(sh + n0 * SS + 8 * n) = make_float2(
            acc[0][n][0] + acc[1][n][0], acc[0][n][1] + acc[1][n][1]);
        if (ok1)
          *reinterpret_cast<float2*>(sh + n1 * SS + 8 * n) = make_float2(
              acc[0][n][2] + acc[1][n][2], acc[0][n][3] + acc[1][n][3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < PT * N; i += kThreads) {
    const int p = i / N, n = i % N;
    const int64_t off = ((int64_t)(b * H + h) * P + p0 + p) * N + n;
    s_out[off] = st[n * SS + p];
  }
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          const float*, const float*, const float*, float*,
                          float*, int, int, int, int, int, int64_t, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t,
                          int64_t, int64_t, int64_t, int64_t, int64_t,
                          int64_t, int64_t, int64_t);

// the instantiated value tiles
struct Variant {
  int pt;
  KernelFn fn;
};
const Variant kVariants[] = {{16, ssd_scan_kernel<16>},
                             {32, ssd_scan_kernel<32>},
                             {64, ssd_scan_kernel<64>}};

// Raise the shared-memory limit of every instantiation at once.
cudaError_t raise_all() {
  for (const Variant& var : kVariants) {
    const cudaError_t e = cudaFuncSetAttribute(
        var.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Strides are in elements, ordered x (batch, seq, head), dt, B, C, y.
// a_log is (H,); s0 / s_out are (B, H, P, N) contiguous; s0 may be null.
// p_tile (16, 32, 64) is a block's share of the value columns (ssd_plan
// in ssd_scan.py).  Needs S % L == 0, P % p_tile == 0, N % 8 == 0 and the
// shared memory of (p_tile, N, L) within what a block may opt into
// (232,448 bytes).  Returns the cudaError_t of the launch.
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* a_log, const void* b_in,
    const void* c_in, const void* s0, void* y, void* s_out, int B, int S,
    int H, int P, int N, int L, int p_tile,
    int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t d_sb, int64_t d_ss,
    int64_t d_sh, int64_t b_sb, int64_t b_ss, int64_t b_sh, int64_t c_sb,
    int64_t c_ss, int64_t c_sh, int64_t y_sb, int64_t y_ss, int64_t y_sh,
    void* stream) {
  // first call, whatever its shape: every instantiation's limit, outside
  // any graph capture that later replays a launch of another shape
  static const cudaError_t smem_ready = raise_all();
  if (smem_ready != cudaSuccess) return (int)smem_ready;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 ||
      S % L != 0 || N % 8 != 0 || p_tile <= 0 || P % p_tile != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p_tile, N, L);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  for (const Variant& var : kVariants) {
    if (var.pt != p_tile) continue;
    const int blocks = B * H * (P / p_tile);
    var.fn<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a_log), static_cast<const float*>(b_in),
        static_cast<const float*>(c_in), static_cast<const float*>(s0),
        static_cast<float*>(y), static_cast<float*>(s_out), S, H, P, N, L,
        x_sb, x_ss, x_sh, d_sb, d_ss, d_sh, b_sb, b_ss, b_sh, c_sb, c_ss,
        c_sh, y_sb, y_ss, y_sh);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
