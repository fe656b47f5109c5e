// The independent patch objective of the tiled solver and its gradient, on
// Hopper (sm_90a): one launch evaluates every patch's loss and its gradient
// with respect to theta = (vx, vy, px, py).
//
// Replaces no TPU kernel.  The JAX package's per-patch objective
// (event_based_bos_tpu/solver/patch.py::_patch_objective) is plain JAX,
// vmapped over the patches and left to XLA.  Its PyTorch counterpart,
// vmapped, with its autograd backward, ran ~530 small kernels a step of
// the independent solve, each sweeping a [n, 4, 4] operand for a handful
// of operations; this kernel was added for that bottleneck.
//
// Per 4 x 4 patch, with its windows m (the normalized measurement), gx and
// gy (the frame's gradients):
//
//   gs(r, c)  = g sampled bilinearly at (r - px, c - py), zero outside the
//               window: sample_bilinear's floor and its four taps, in order
//   pred      = vx * gxs + vy * gys
//   pn        = pred / (|pred|_F + 1e-4), |pred|_F = 0 with a zero
//               subgradient where pred is exactly 0 (every patch's start)
//   diff_norm = max_c sum_r |pn - m|, |x| with derivative +1 at 0, the
//               gradient of tied columns split evenly (as amax's)
//   flow_norm_pxy  = |(px, py)|, with a zero subgradient at the origin
//   loss = w_diff * diff_norm + w_pxy * flow_norm_pxy
//
// and the gradient is autodiff's of the same, derived by hand.  The cost's
// image_gradient term is left out: it sums weighted differences of the
// patch's constant flow, each v - v, so its value and its gradient are 0.
// (Only a frame without events, whose inverse-event weights are 0 / 0,
// makes it NaN in the vmapped objective, whose solve then fails.)  The spec,
// in plain PyTorch, is ops/patch_cuda.py::patch_objective_plain.  float32
// throughout, with IEEE division and square root (no fast math).  The
// backward multiplies by IEEE-rounded reciprocals (__frcp_rn) where
// autodiff divides (by the normalization, by the tie count, by the norms):
// one rounding more than a division, and a tenth of its instructions.
//
// Bound: bytes.  A patch reads three windows of 64 B and theta's 16 B,
// and writes its loss (4 B) and its gradient (16 B): 228 B.  At
// patch_eklt's grid of 229,401 patches that is 52.3 MB a call, 15.6 us at
// 3.35 TB/s.  Its 1,876 float32 flops a patch, as the 4 lanes below run
// them (an FFMA counted twice), take 6.4 us at 67 TFLOP/s.  What holds it
// above the bytes is instruction issue: ~1,000 instructions a lane in its
// SASS, 4 lanes a patch.
//
// Design: 4 lanes a patch, one a row of 4 pixels held in registers, 8
// patches a warp.  A lane reads its row of each window as one 16-byte
// word, so a warp's read of one of the three [n, 4, 4] arrays the cut makes
// is 512 contiguous bytes.  The shift's two tap rows come from the lanes
// that hold them (16 shuffles a lane, inside the patch's 4 lanes); each
// column's taps are picked from those rows by a select chain on the tap's
// column index.  The floor of r - px can differ from row to row by
// rounding, and that of c - py from column to column, so every pixel takes
// its own taps.  The column sums, the prediction's norm and the four
// gradient sums (one transposing butterfly, three shuffles) are shuffles
// across the 4 lanes.  On an H100, in a version that still read the
// inverse-event weights for the image_gradient term, this ran 1.36 times
// faster than 16 lanes a patch, one a pixel (a shuffle for every tap and a
// 16-lane reduction for every sum: 2.2 times the instructions a patch),
// and 2.4 times faster than one thread a patch with the windows staged in
// shared memory (~235 registers a thread, 8 warps an SM).

#include <cuda_runtime.h>

namespace {

constexpr int kSide = 4;                // lanes a patch, one a row
constexpr int kPixels = kSide * kSide;
constexpr int kParams = 4;              // vx, vy, px, py
constexpr int kThreads = 128;           // 32 patches a block
constexpr float kNormEps = 1e-4f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float across(float v, int mask) {
  return __shfl_xor_sync(kAll, v, mask, kSide);
}

// the sum over a patch's 4 lanes; every lane ends with the same bits
__device__ __forceinline__ float patch_sum(float v) {
  v += across(v, 2);
  v += across(v, 1);
  return v;
}

// max that keeps a NaN, as amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float abs_jax(float x) {
  return x >= 0.0f ? x : -x;
}

// v[j] for a column index j known by its three tests
__device__ __forceinline__ float pick(const float (&v)[kSide], bool is0,
                                      bool is1, bool is2) {
  return is0 ? v[0] : is1 ? v[1] : is2 ? v[2] : v[3];
}

__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         int at, float (&row)[kSide]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src + at));
  row[0] = v.x;
  row[1] = v.y;
  row[2] = v.z;
  row[3] = v.w;
}

__global__ void __launch_bounds__(kThreads)
patch_objective_kernel(const float* __restrict__ theta,
                       const float* __restrict__ measured,
                       const float* __restrict__ gx,
                       const float* __restrict__ gy, int n,
                       float w_diff, float w_pxy,
                       float* __restrict__ loss, float* __restrict__ grad) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool live = t / kSide < n;
  // a lane past the last patch reads that patch and writes nothing: every
  // lane of a warp takes part in its shuffles
  const int p = live ? t / kSide : n - 1;
  const int r = t % kSide;
  const int at = p * kPixels + r * kSide;

  const float4 th = __ldg(reinterpret_cast<const float4*>(theta) + p);
  const float vx = th.x, vy = th.y, px = th.z, py = th.w;
  float gx_row[kSide], gy_row[kSide], m[kSide];
  load_row(gx, at, gx_row);
  load_row(gy, at, gy_row);
  load_row(measured, at, m);

  // -- the shift: this lane's row r sampled at r - px ----------------------
  const float rows = (float)r - px;
  const float r0 = floorf(rows);
  const float dr = rows - r0;
  const float wr[2] = {1.0f - dr, dr};
  bool rin[2];
  float tap_x[2][kSide], tap_y[2][kSide];  // the two tap rows
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float rr = r0 + (float)a;
    rin[a] = rr >= 0.0f && rr < (float)kSide;
    const int src = (int)fminf(fmaxf(rr, 0.0f), kSide - 1.0f);
#pragma unroll
    for (int j = 0; j < kSide; ++j) {
      tap_x[a][j] = __shfl_sync(kAll, gx_row[j], src, kSide);
      tap_y[a][j] = __shfl_sync(kAll, gy_row[j], src, kSide);
    }
  }
  // each column c sampled at c - py.  Tap k = a + 2b is (r0 + a, c0 + b),
  // in sample_bilinear's order; its value is 0 outside the window
  float gxs[kSide], gys[kSide], wc[kSide][2];
  float tx[kSide][4], ty[kSide][4];
  bool in_tap[kSide][4];
#pragma unroll
  for (int c = 0; c < kSide; ++c) {
    const float cols = (float)c - py;
    const float c0 = floorf(cols);
    const float dc = cols - c0;
    wc[c][0] = 1.0f - dc;
    wc[c][1] = dc;
    gxs[c] = 0.0f;
    gys[c] = 0.0f;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float cc = c0 + (float)b;
      const bool cin = cc >= 0.0f && cc < (float)kSide;
      const int j = (int)fminf(fmaxf(cc, 0.0f), kSide - 1.0f);
      const bool is0 = j == 0, is1 = j == 1, is2 = j == 2;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int k = a + 2 * b;
        const bool inside = rin[a] && cin;
        const float sx = pick(tap_x[a], is0, is1, is2);
        const float sy = pick(tap_y[a], is0, is1, is2);
        in_tap[c][k] = inside;
        tx[c][k] = inside ? sx : 0.0f;
        ty[c][k] = inside ? sy : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float wt = wr[k & 1] * wc[c][k >> 1];
      gxs[c] += in_tap[c][k] ? tx[c][k] * wt : 0.0f;
      gys[c] += in_tap[c][k] ? ty[c][k] * wt : 0.0f;
    }
  }

  // -- the prediction, normalized, against the measurement ----------------
  float pred[kSide], pn[kSide], d[kSide];
  float sq = 0.0f;
#pragma unroll
  for (int c = 0; c < kSide; ++c) {
    pred[c] = vx * gxs[c] + vy * gys[c];
    sq += pred[c] * pred[c];
  }
  sq = patch_sum(sq);
  const bool flat = sq == 0.0f;
  const float norm = flat ? 0.0f : sqrtf(sq);
  const float denom = norm + kNormEps;
  float column[kSide];
#pragma unroll
  for (int c = 0; c < kSide; ++c) {
    pn[c] = pred[c] / denom;
    d[c] = pn[c] - m[c];
    column[c] = patch_sum(abs_jax(d[c]));
  }

  // -- diff_norm: the largest column sum (every lane holds all four) ------
  float largest = column[0];
#pragma unroll
  for (int c = 1; c < kSide; ++c) largest = nan_max(largest, column[c]);
  float tied = 0.0f;
#pragma unroll
  for (int c = 0; c < kSide; ++c) tied += column[c] == largest ? 1.0f : 0.0f;
  const float g_top = w_diff * __frcp_rn(tied);

  // -- back through the normalization -------------------------------------
  // d pn / d denom = -pn / denom, summed; d denom / d pred = pred / norm
  const float inv_denom = __frcp_rn(denom);
  float g_pn[kSide], g_denom = 0.0f;
#pragma unroll
  for (int c = 0; c < kSide; ++c) {
    const float g_column = column[c] == largest ? g_top : 0.0f;
    g_pn[c] = d[c] >= 0.0f ? g_column : -g_column;
    g_denom += g_pn[c] * (pn[c] * inv_denom);
  }
  g_denom = -patch_sum(g_denom);
  const float g_sq = flat ? 0.0f : g_denom * __frcp_rn(2.0f * norm);

  // -- back through the prediction and the shift -------------------------
  // q: this lane's parts of d/dvx, d/dvy, d/dpx, d/dpy
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < kSide; ++c) {
    const float g_pred =
        g_pn[c] * inv_denom + (g_sq * pred[c] + g_sq * pred[c]);
    q[0] += g_pred * gxs[c];
    q[1] += g_pred * gys[c];
    const float cx = g_pred * vx, cy = g_pred * vy;  // onto gxs, gys
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int a = k & 1, b = k >> 1;
      const float g_w = cx * tx[c][k] + cy * ty[c][k];
      q[2] -= g_w * (a ? wc[c][b] : -wc[c][b]);   // rows = r - px
      q[3] -= g_w * (b ? wr[a] : -wr[a]);         // cols = c - py
    }
  }

  // -- the four gradient sums: lane j ends with the sum of q[j] -----------
  const bool hi2 = r & 2, hi1 = r & 1;
  const float pair0 = (hi2 ? q[2] : q[0]) + across(hi2 ? q[0] : q[2], 2);
  const float pair1 = (hi2 ? q[3] : q[1]) + across(hi2 ? q[1] : q[3], 2);
  const float mine = (hi1 ? pair1 : pair0) + across(hi1 ? pair0 : pair1, 1);

  // -- flow_norm_pxy -------------------------------------------------------
  const float psq = px * px + py * py;
  const bool origin = psq == 0.0f;
  const float shift_norm = origin ? 0.0f : sqrtf(psq);
  const float g_shift = origin ? 0.0f : w_pxy * __frcp_rn(shift_norm);

  if (!live) return;
  grad[kParams * p + r] = r == 2   ? mine + g_shift * px
                          : r == 3 ? mine + g_shift * py
                                   : mine;
  if (r == 0) {
    loss[p] = w_diff * largest + w_pxy * shift_norm;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// theta is [n, 4] and measured, gx, gy are [n, 4, 4], all contiguous
// float32 on 16 bytes; loss is [n] and grad [n, 4].  More than 2^31 / 16
// patches, or an input off 16 bytes, returns cudaErrorInvalidValue.
extern "C" int ebt_patch_objective(const float* theta, const float* measured,
                                   const float* gx, const float* gy,
                                   long long n, float w_diff, float w_pxy,
                                   float* loss, float* grad, void* stream) {
  if (n <= 0) return 0;
  if (n * kPixels + kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {(const void*)theta, (const void*)measured,
                          (const void*)gx, (const void*)gy})
    if (reinterpret_cast<unsigned long long>(ptr) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  const long long blocks = (n * kSide + kThreads - 1) / kThreads;
  patch_objective_kernel<<<(unsigned)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      theta, measured, gx, gy, (int)n, w_diff, w_pxy, loss, grad);
  return (int)cudaGetLastError();
}
