// ssd_scan for Hopper (sm_90a): the Mamba2 SSD chunked scan with a scalar
// decay per head, carrying a (P x N) float32 state across chunks, with
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
// (H,); s0 and s_out are (B, H, P, N) contiguous, the API's layout.  s0
// may be null (zero state).  P is a multiple of 16 and N of 8 (the wgmma
// kernel: P = N = 64, with 16-byte strides, as TMA needs).
//
// What bounds it on this card: operations.  Per chunk and head it reads
// L (P + 2N + 1) floats and writes L P, against about L^2 N + L^2 P +
// 4 L N P FLOP: 32 FLOP per byte at L = 128 and P = N = 64 (more with B
// and C shared by every head), near the balance of float32-accurate
// tensor-core products (3 x TF32 at 165 TFLOP/s against 3.35 TB/s is ~49
// FLOP/byte).
//
// Two kernels compute the same function; the wrapper's plan
// (kernels/ssd_scan.py, ssd_path, a pure function of the shape) takes the
// warp-specialised wgmma kernel wherever it has the head (P = N = 64,
// zamba2's), else the mma.sync kernel.  Neither falls back to the other:
// a kernel that fails to build or launch raises.
//
// The wgmma kernel (ssd_scan_ws_kernel), one block per (b, h):
//   * Blocks of 64 steps, the last one ragged, whatever the caller's chunk:
//     the scan is linear with a scalar decay, so any blocking composes
//     exactly (zamba2's chunk of 128 runs as two blocks, a prime prompt's
//     chunk of 1 as blocks of 64).  Rows past S arrive zero-filled by TMA
//     and carry zero weight.
//   * Three warpgroups.  A producer (one warp works; the group hands its
//     registers to the math warpgroup by setmaxnreg: 256 a math thread,
//     where 240 left it 0.09 ms slower at B=8 S=2048) keeps two ring slots
//     of x, B, C (TMA through 4-D tensor maps, 128-byte swizzled; B/C
//     given with head stride 0 map one group for every head) and dt (the
//     warp's own loads: its seq stride is H floats, no 16-byte box) in
//     flight.  A transform warpgroup turns a landed slot, once for the
//     block, into x^T hi / lo (steps contiguous, each 8 in the order the
//     score accumulator hands them over) and B hi / lo (hi in place: hi +
//     lo is B again, exactly), and takes the float64 prefix sums of dt a
//     (every warp scans all 64 steps by shuffles, the same sums in the
//     same order, and writes its 16), a block ahead of the math warpgroup,
//     which runs the products and owns the state.
//   * All products are wgmma m64n64k8 TF32, each as lo.hi + hi.lo + hi.hi:
//     C S and C B^T with C split in registers (the rs form) and S (kept as
//     hi / lo tiles [p][n], the API's layout) or B from shared memory,
//     issued together; the scores scaled by e^{cum_t - cum_j} dt_j and
//     masked in registers, split and fed as the A operand of scores . x
//     (y accumulates on e^{cum_t} C S); the state update (B w)^T x with
//     (B w)^T built from B's hi + lo in registers and its accumulator
//     seeded with e^{cum_L} S, issued while scores . x runs.  Exponentials
//     are ex2 of one float64 difference of cum log2(e) rounded to float32.
//   * Shared memory per (block of steps, value tile) at P = N = 64, the
//     whole head: two slots of [x, then x^T hi | B, then B hi | C | x^T lo
//     | B lo] (80 KB each), the state's hi / lo (32 KB), dt and the prefix
//     sums: 197 KB, one block per SM.  C and every A operand are split in
//     registers, every B operand once per block in shared memory.  A
//     128-step block (two math warpgroups) needs 96 KB of raw x, B and C a
//     slot before any split: no ring of two fits beside the split tiles.
//   * Every k step of every product runs: a step past the block's last
//     live row holds zeros.  A data-dependent exit from a wgmma sequence
//     made ptxas serialise every wgmma of the kernel (its C7520 note), as
//     did a register cap of 168 (C7511) until the producer warpgroup gave
//     its registers away.  The math warpgroup still spills ~300 bytes.
//   * Tried and lost on the card (uncommitted probes, so no figures): one
//     warpgroup doing the splits, the prefix sums and the three products in
//     turn; C, B and S all as shared-memory operands (the ss form, more
//     shared-memory bytes per product than the rs form).
//
// The mma.sync kernel (ssd_scan_kernel, any P multiple of 16 and N of 8):
//   * Value-tiled blocks.  Column p of y and of the state depends only on
//     column p of x, so a block owns one (b, h) and a tile of PT value
//     columns, and runs that sequence's chunks in order with its (N x PT)
//     state tile in shared memory (the state is (N, P) there): no second
//     pass, no state traffic between blocks.  Each block recomputes the
//     chunk's shared part (the scores C B^T and the prefix sums).  The
//     host picks PT from the shape (`ssd_plan` in ssd_scan.py) so the grid
//     has a block per two SMs where the shape has that many; the tiles of
//     one (b, h) are adjacent in launch order, so their shared B/C/dt
//     reads meet in L2.
//   * Tensor cores: all three products (C B^T, then scores x and C S for y,
//     and (B w)^T x for the state) run on mma.sync m16n8k8 as 3 x TF32
//     (mma_common.cuh), which keeps float32 accuracy where one TF32
//     product misses the 3e-4 tolerance by 300x.  Each of the 8 warps owns
//     some 16-row tiles of the chunk (all the block's value columns, or a
//     part of them where row tiles are fewer than warps), dealt so the
//     two warps of each SM sub-partition share the triangular work
//     evenly, and streams the scores four 8-column tiles at a time: the
//     C B^T accumulator is scaled by e^{cum_t - cum_j} dt_j and masked to
//     j <= t < L in registers and fed, as it lies, to the scores . x
//     product, which reads its k index t as column 2t and t + 4 as 2t + 1.
//     Shared-memory row strides (x: PT + 4, B/C: N + 4, state: PT + 8) make
//     every fragment load conflict-free.
//   * Chunk c + 1's x, B, C (16-byte cp.async.cg) and dt (4-byte, its seq
//     stride is H) are staged in a second buffer while chunk c computes;
//     the tiles' rows past L are zeroed once and never loaded, so no shape
//     needs padding (pick_chunk gives L = 1 for a prime prompt length).
//
// Every instantiation's shared-memory limit is raised on the first call
// of either C entry point, whatever its shape, so a CUDA graph captured
// later never meets one that was not set up.
//
// What it leaves for later: two (b, h) per block sharing zamba2's one B/C
// group (C B^T is the same for every head; heads sharing an mma.sync
// block were slower); a third ring slot (the split tiles fill shared
// memory).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

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


// ------------------------------------------------ warp-specialised kernel --
// The wgmma kernel's geometry: zamba2's head (P = N = 64), 64 steps a
// block of the sequence (the math warpgroup's rows), and two ring slots,
// each 1024-byte aligned:
//   [x: raw, then x^T hi | B: raw, then B hi | C raw | x^T lo | B lo]
// (64 x 64 float32 tiles, 128-byte swizzled: TMA writes x, B, C so and the
// transform warpgroup writes the rest so), then the state's hi / lo tiles
// ([p][n]), then each slot's dt and prefix sums, then the mbarriers.
namespace ws {
constexpr int P = 64, N = 64;
constexpr int KL = 64;                  // steps per block of the sequence
constexpr int STAGES = 2;
constexpr int TILE = 64 * 64 * 4;       // one 64 x 64 float32 tile
constexpr int kX = 0, kB = TILE, kC = 2 * TILE, kXtl = 3 * TILE,
              kBlo = 4 * TILE;          // offsets in a slot
constexpr int SLOT = 5 * TILE;
constexpr int kSt = STAGES * SLOT;      // state hi [p][n]
constexpr int kStl = kSt + TILE;        // state lo
constexpr int kSmall = kStl + TILE;     // per slot: dt, cum, e^cum, w
constexpr int DT = 0, CUM = KL * 4, ECUM = CUM + KL * 8, WGT = ECUM + KL * 4;
constexpr int SMALL = WGT + KL * 4;
constexpr int kBar = kSmall + STAGES * SMALL;
constexpr int kSmem = kBar + 3 * STAGES * 8 + 1024;  // + alignment
// the math warpgroup (warps 0-3), the transform warpgroup (4-7), the
// producer warpgroup (8-11: one warp works, the group gives its registers
// to the math warpgroup)
constexpr int kThreads = 3 * 128;
// registers a thread of the producer and the math warpgroups holds after
// setmaxnreg (the transform warpgroup keeps the launch's 168): what the
// producer hands back covers what the math warpgroup takes.  Raising the
// transform warpgroup too (to 216, the producer at 40) deadlocked on the
// card: the increase waits for registers the pool never has.
constexpr int kProducerRegs = 24, kMathRegs = 256;
static_assert(kSmem <= 232448, "over the 227 KB of a block");

// byte offset of element (row r, column c) of a 64 x 64 tile stored as two
// 128-byte swizzled column blocks of 32 floats
__device__ __forceinline__ uint32_t at(int r, int c) {
  return (uint32_t)((c >> 5) * 8192) + repro::sm90::swz128(r, (c & 31) >> 2) +
         (uint32_t)((c & 3) * 4);
}
}  // namespace ws

constexpr double kLog2e = 1.4426950408889634;

// 2^x by the MUFU unit (2 ulp; below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ld_f(const unsigned char* tile, uint32_t off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// state hi / lo tiles [p][n] from the math warpgroup's accumulator of
// S^T[n][p]
__device__ __forceinline__ void put_state(unsigned char* base, const float* sa,
                                          int warp, int g, int q) {
  using repro::split_tf32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off =
          ws::at(8 * j + 2 * q + (e & 1), 16 * warp + g + 8 * (e >> 1));
      uint32_t hi, lo;
      split_tf32(sa[4 * j + e], hi, lo);
      *reinterpret_cast<uint32_t*>(base + ws::kSt + off) = hi;
      *reinterpret_cast<uint32_t*>(base + ws::kStl + off) = lo;
    }
}

// The transform warpgroup's work on a filled slot: x -> x^T hi (in place)
// and lo, B -> hi (in place) and lo, and the float64 prefix sums of dt a.
__device__ __forceinline__ void transform_slot(unsigned char* slot,
                                               unsigned char* small, float a_h,
                                               int tw) {
  namespace hw = repro::sm90;
  using namespace ws;
  using repro::split_tf32;
  const int warp = tw / 32, lane = tw % 32;
  // x^T: p rows of t, each 8 steps of a row in the order the score
  // accumulator hands them over (steps 0, 2, 4, 6 at positions 0-3, 1, 3,
  // 5, 7 at 4-7).  A thread takes one p of four 8-step groups; a warp's
  // lanes take consecutive p.  Every thread reads its part of x before
  // any thread writes x^T over it.
  float xv[4][8];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tw + 128 * u, p = i % 64, kg = i / 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[u][j] = ld_f(slot + kX, at(8 * kg + j, p));
  }
  hw::named_sync(2, 128);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = tw + 128 * u, p = i % 64, kg = i / 64;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 hi, lo;
      split_tf32(xv[u][half], hi.x, lo.x);
      split_tf32(xv[u][half + 2], hi.y, lo.y);
      split_tf32(xv[u][half + 4], hi.z, lo.z);
      split_tf32(xv[u][half + 6], hi.w, lo.w);
      const uint32_t off = (kg / 4) * 8192 + hw::swz128(p, 2 * (kg % 4) + half);
      *reinterpret_cast<uint4*>(slot + kX + off) = hi;
      *reinterpret_cast<uint4*>(slot + kXtl + off) = lo;
    }
  }
  // B: hi in place (hi + lo is B again, exactly), lo beside it
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = tw + 128 * u;
    const uint4 v = reinterpret_cast<const uint4*>(slot + kB)[i];
    uint4 hi, lo;
    split_tf32(__uint_as_float(v.x), hi.x, lo.x);
    split_tf32(__uint_as_float(v.y), hi.y, lo.y);
    split_tf32(__uint_as_float(v.z), hi.z, lo.z);
    split_tf32(__uint_as_float(v.w), hi.w, lo.w);
    reinterpret_cast<uint4*>(slot + kB)[i] = hi;
    reinterpret_cast<uint4*>(slot + kBlo)[i] = lo;
  }
  // float64 prefix sums of dt * a: every warp scans all 64 steps (a lane
  // two steps, then a shuffle scan), the same sums in the same order, so
  // no warp waits for another; warp w writes steps 16w .. 16w + 15.  Kept
  // as cum log2(e), so each exponential is one float64 difference rounded
  // once to float32 and one ex2.
  const float* dts = reinterpret_cast<const float*>(small + DT);
  double* cum = reinterpret_cast<double*>(small + CUM);
  float* ecum = reinterpret_cast<float*>(small + ECUM);
  float* wgt = reinterpret_cast<float*>(small + WGT);
  const float2 dd = reinterpret_cast<const float2*>(dts)[lane];
  const double v0 = (double)(dd.x * a_h), v1 = (double)(dd.y * a_h);
  double incl = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double c0 = (excl + v0) * kLog2e, c1 = (excl + v0 + v1) * kLog2e;
  const double total = __shfl_sync(0xffffffffu, c1, 31);
  if (lane / 8 == warp) {
    cum[2 * lane] = c0;
    cum[2 * lane + 1] = c1;
    ecum[2 * lane] = ex2((float)c0);
    ecum[2 * lane + 1] = ex2((float)c1);
    wgt[2 * lane] = ex2((float)(total - c0)) * dd.x;
    wgt[2 * lane + 1] = ex2((float)(total - c1)) * dd.y;
  }
  hw::fence_async_smem();  // x^T and B hi / lo, for the math's wgmma
}

__global__ void __launch_bounds__(ws::kThreads, 1)
    ssd_scan_ws_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap bmap,
                       const __grid_constant__ CUtensorMap cmap, int x_order,
                       int b_order, int c_order, int b_head, int c_head,
                       const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       const float* __restrict__ s0, float* __restrict__ y,
                       float* __restrict__ s_out, int S, int H, int64_t d_sb,
                       int64_t d_ss, int64_t d_sh, int64_t y_sb, int64_t y_ss,
                       int64_t y_sh) {
  namespace hw = repro::sm90;
  using repro::split_tf32;
  using namespace ws;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kBar);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nblk = (S + KL - 1) / KL;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1 + 32);  // the TMA bytes + the warp's dt
      hw::mbar_init(&ready[s], 128);    // every transform thread
      hw::mbar_init(&empty[s], 4);      // one arrival per math warp
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: warp 8's lane 0 issues the TMA loads, its lanes the dt
    hw::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 288) return;
    const int lane = threadIdx.x - 256;
    if (lane == 0) {
      hw::tma_prefetch_map(&xmap);
      hw::tma_prefetch_map(&bmap);
      hw::tma_prefetch_map(&cmap);
    }
    const float* db = dt + b * d_sb + h * d_sh;
    for (int c = 0; c < nblk; ++c) {
      const int st = c % STAGES, t0 = c * KL;
      hw::mbar_wait(&empty[st], ((c / STAGES) & 1) ^ 1);
      unsigned char* slot = base + st * SLOT;
      if (lane == 0) {
        hw::mbar_expect_tx(&full[st], 3 * TILE);
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {
          hw::tma_load_rows(slot + kX + cb * 8192, &xmap, &full[st], x_order,
                            32 * cb, t0, h, b);
          hw::tma_load_rows(slot + kB + cb * 8192, &bmap, &full[st], b_order,
                            32 * cb, t0, h * b_head, b);
          hw::tma_load_rows(slot + kC + cb * 8192, &cmap, &full[st], c_order,
                            32 * cb, t0, h * c_head, b);
        }
      }
      // dt's seq stride is H floats: no 16-byte box holds one head, so
      // the warp loads it; steps past S are 0 (no decay, no weight)
      float* dts = reinterpret_cast<float*>(base + kSmall + st * SMALL + DT);
      for (int i = lane; i < KL; i += 32)
        dts[i] = t0 + i < S ? db[(int64_t)(t0 + i) * d_ss] : 0.f;
      hw::mbar_arrive(&full[st]);
    }
    return;
  }

  const float a_h = -expf(a_log[h]);
  if (threadIdx.x >= 128) {
    // ---- transform warpgroup: one slot ahead of the math ----
    const int tw = threadIdx.x - 128;
    for (int c = 0; c < nblk; ++c) {
      const int st = c % STAGES;
      hw::mbar_wait(&full[st], (c / STAGES) & 1);
      transform_slot(base + st * SLOT, base + kSmall + st * SMALL, a_h, tw);
      hw::mbar_arrive(&ready[st]);
    }
    return;
  }

  // ---- the math warpgroup: 64 steps of a block ----
  hw::setmaxnreg_inc<kMathRegs>();
  const int tw = threadIdx.x, warp = tw / 32, lane = tw % 32;
  const int g = lane >> 2, q = lane & 3;
  const int ra = 16 * warp + g, rb = ra + 8;  // this thread's rows (t or n)
  // the state lives in its hi / lo tiles between blocks; a thread's part
  // of it in wgmma's accumulator layout is S^T[n][p] at (n = ra or rb by
  // e >> 1, p = 8j + 2q + (e & 1)) for element 4j + e
  const int64_t state_off = (int64_t)(b * H + h) * P * N;
  {
    float s_init[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_init[4 * j + e] =
            s0 != nullptr ? s0[state_off + (8 * j + 2 * q + (e & 1)) * N +
                               (e < 2 ? ra : rb)]
                          : 0.f;
    put_state(base, s_init, warp, g, q);
  }
  const uint32_t sth = hw::smem_u32(base + kSt);
  const uint32_t stl = hw::smem_u32(base + kStl);
  float* yb = y + b * y_sb + h * y_sh;

  for (int c = 0; c < nblk; ++c) {
    const int st = c % STAGES, t0 = c * KL, live = min(KL, S - t0);
    // the state tiles written by every math thread, for this block's C S
    hw::fence_async_smem();
    hw::named_sync(1, 128);
    hw::mbar_wait(&ready[st], (c / STAGES) & 1);
    unsigned char* slot = base + st * SLOT;
    const unsigned char* small = base + kSmall + st * SMALL;
    const float* dts = reinterpret_cast<const float*>(small + DT);
    const double* cum = reinterpret_cast<const double*>(small + CUM);
    const float* ecum = reinterpret_cast<const float*>(small + ECUM);
    const float* wgt = reinterpret_cast<const float*>(small + WGT);
    const uint32_t xt = hw::smem_u32(slot + kX);
    const uint32_t xtl = hw::smem_u32(slot + kXtl);
    const uint32_t bhi = hw::smem_u32(slot + kB);
    const uint32_t blo = hw::smem_u32(slot + kBlo);

    // C as the A operand of C S and C B^T, split in registers: k step kk
    // holds (ra, 8kk + q), (rb, 8kk + q), (ra, 8kk + q + 4), (rb, ...)
    uint32_t ch[8][4], cl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split_tf32(ld_f(slot + kC, at(ra, 8 * kk + q)), ch[kk][0], cl[kk][0]);
      split_tf32(ld_f(slot + kC, at(rb, 8 * kk + q)), ch[kk][1], cl[kk][1]);
      split_tf32(ld_f(slot + kC, at(ra, 8 * kk + q + 4)), ch[kk][2], cl[kk][2]);
      split_tf32(ld_f(slot + kC, at(rb, 8 * kk + q + 4)), ch[kk][3], cl[kk][3]);
    }
    // C S (the inter-block part) and C B^T, issued together
    float yo[32], sc[32];
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      hw::Wgmma<64, false>::rs(yo, cl[kk], hw::desc_kmajor(sth + off), kk > 0);
      hw::Wgmma<64, false>::rs(yo, ch[kk], hw::desc_kmajor(stl + off), 1);
      hw::Wgmma<64, false>::rs(yo, ch[kk], hw::desc_kmajor(sth + off), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      hw::Wgmma<64, false>::rs(sc, cl[kk], hw::desc_kmajor(bhi + off), kk > 0);
      hw::Wgmma<64, false>::rs(sc, ch[kk], hw::desc_kmajor(blo + off), 1);
      hw::Wgmma<64, false>::rs(sc, ch[kk], hw::desc_kmajor(bhi + off), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs<32>(yo);
    hw::fence_regs<32>(sc);
    {  // y starts as e^{cum_t} C_t S
      const float ea = ecum[ra], eb = ecum[rb];
#pragma unroll
      for (int i = 0; i < 32; ++i) yo[i] *= (i & 2) ? eb : ea;
    }

    // scores -> weights e^{cum_t - cum_j} dt_j on j <= t < live, split for
    // the A operand of scores . x: column q <-> step 8kk + 2q, q + 4 <->
    // 8kk + 2q + 1 (x^T's order).  Every product runs all 8 k steps: a
    // step past `live` holds zeros (a data-dependent exit from a wgmma
    // sequence makes ptxas serialise every wgmma of the kernel).
    const double cra = cum[ra], crb = cum[rb];
    uint32_t sh[8][4], sl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int j0 = 8 * kk + 2 * q;
      const double2 cj = *reinterpret_cast<const double2*>(cum + j0);
      const float2 dj = *reinterpret_cast<const float2*>(dts + j0);
      const float w00 = (j0 <= ra && ra < live)
          ? sc[4 * kk] * ex2((float)(cra - cj.x)) * dj.x : 0.f;
      const float w01 = (j0 + 1 <= ra && ra < live)
          ? sc[4 * kk + 1] * ex2((float)(cra - cj.y)) * dj.y : 0.f;
      const float w10 = (j0 <= rb && rb < live)
          ? sc[4 * kk + 2] * ex2((float)(crb - cj.x)) * dj.x : 0.f;
      const float w11 = (j0 + 1 <= rb && rb < live)
          ? sc[4 * kk + 3] * ex2((float)(crb - cj.y)) * dj.y : 0.f;
      split_tf32(w00, sh[kk][0], sl[kk][0]);
      split_tf32(w10, sh[kk][1], sl[kk][1]);
      split_tf32(w01, sh[kk][2], sl[kk][2]);
      split_tf32(w11, sh[kk][3], sl[kk][3]);
    }
    // y += scores . x, issued and left running
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      hw::Wgmma<64, false>::rs(yo, sl[kk], hw::desc_kmajor(xt + off), 1);
      hw::Wgmma<64, false>::rs(yo, sh[kk], hw::desc_kmajor(xtl + off), 1);
      hw::Wgmma<64, false>::rs(yo, sh[kk], hw::desc_kmajor(xt + off), 1);
    }
    hw::wgmma_commit();

    // meanwhile: S^T <- e^{cum_L} S^T + (B w)^T x, the accumulator seeded
    // from the state tiles, the A operand (B w)^T from B's hi + lo, rows n,
    // k steps t in x^T's order
    const float dl = ex2((float)cum[KL - 1]);
    float su[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = at(8 * j + 2 * q + (e & 1), e < 2 ? ra : rb);
        su[4 * j + e] =
            (ld_f(base + kSt, off) + ld_f(base + kStl, off)) * dl;
      }
    uint32_t bh[8][4], bl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int ta = 8 * kk + 2 * q, tb = ta + 1;
      const float wa = wgt[ta], wb = wgt[tb];
      auto bv = [&](int t, int n) {
        const uint32_t off = at(t, n);
        return ld_f(slot + kB, off) + ld_f(slot + kBlo, off);
      };
      split_tf32(bv(ta, ra) * wa, bh[kk][0], bl[kk][0]);
      split_tf32(bv(ta, rb) * wa, bh[kk][1], bl[kk][1]);
      split_tf32(bv(tb, ra) * wb, bh[kk][2], bl[kk][2]);
      split_tf32(bv(tb, rb) * wb, bh[kk][3], bl[kk][3]);
    }
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      hw::Wgmma<64, false>::rs(su, bl[kk], hw::desc_kmajor(xt + off), 1);
      hw::Wgmma<64, false>::rs(su, bh[kk], hw::desc_kmajor(xtl + off), 1);
      hw::Wgmma<64, false>::rs(su, bh[kk], hw::desc_kmajor(xt + off), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs<32>(yo);
    hw::fence_regs<32>(su);
    if (lane == 0) hw::mbar_arrive(&empty[st]);  // the slot is read

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = i ? rb : ra;
      if (t >= live) continue;
      float* yr = yb + (int64_t)(t0 + t) * y_ss + 2 * q;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(yr + 8 * j) =
            make_float2(yo[4 * j + 2 * i], yo[4 * j + 2 * i + 1]);
    }
    if (c + 1 < nblk) {
      // every thread is past its reads of the old state tiles: the
      // product above was issued by the whole warpgroup after them
      put_state(base, su, warp, g, q);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_out[state_off + (8 * j + 2 * q + (e & 1)) * N +
                (e < 2 ? ra : rb)] = su[4 * j + e];
    }
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
  return cudaFuncSetAttribute(ssd_scan_ws_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              ws::kSmem);
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

// The warp-specialised wgmma kernel (P = N = 64 only; blocks of 64 steps,
// the last one ragged, whatever the caller's chunk): the arguments of
// repro_ssd_scan without L and p_tile.  x, B and C are read through tensor
// maps (16-byte aligned base and strides; a head stride of 0 reads one
// group for every head).  Returns the cudaError_t of the launch.
extern "C" int repro_ssd_scan_ws(
    const void* x, const void* dt, const void* a_log, const void* b_in,
    const void* c_in, const void* s0, void* y, void* s_out, int B, int S,
    int H, int P, int N, int64_t x_sb, int64_t x_ss, int64_t x_sh,
    int64_t d_sb, int64_t d_ss, int64_t d_sh, int64_t b_sb, int64_t b_ss,
    int64_t b_sh, int64_t c_sb, int64_t c_ss, int64_t c_sh, int64_t y_sb,
    int64_t y_ss, int64_t y_sh, void* stream) {
  static const cudaError_t smem_ready = raise_all();
  if (smem_ready != cudaSuccess) return (int)smem_ready;
  if (B <= 0 || S <= 0 || H <= 0 || P != ws::P || N != ws::N)
    return (int)cudaErrorInvalidValue;
  namespace hw = repro::sm90;
  CUtensorMap xmap, bmap, cmap;
  int x_order, b_order, c_order;
  cudaError_t e = hw::f32_rows_map(&xmap, x, P, S, H, B, x_sb, x_ss, x_sh, 32,
                                   ws::KL, true, &x_order);
  if (e == cudaSuccess)
    e = hw::f32_rows_map(&bmap, b_in, N, S, H, B, b_sb, b_ss, b_sh, 32,
                         ws::KL, true, &b_order);
  if (e == cudaSuccess)
    e = hw::f32_rows_map(&cmap, c_in, N, S, H, B, c_sb, c_ss, c_sh, 32,
                         ws::KL, true, &c_order);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_ws_kernel<<<B * H, ws::kThreads, ws::kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      xmap, bmap, cmap, x_order, b_order, c_order, b_sh != 0, c_sh != 0,
      static_cast<const float*>(dt), static_cast<const float*>(a_log),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_out), S, H, d_sb, d_ss, d_sh, y_sb, y_ss, y_sh);
  return (int)cudaGetLastError();
}
