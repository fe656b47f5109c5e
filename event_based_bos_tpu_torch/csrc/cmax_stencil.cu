// Time-binned CMax stencil, forward and backward, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/cmax_pallas.py: _fwd_kernel (launched by _run_fwd) and _bwd_kernel
// (launched by _run_bwd), the two halves of binned_warp_accumulate.  With
// per-bin histograms H_b ([B, h, w], zero outside the array given), a flow
// [2, h, w] and per-bin time offsets dt_b, let u_b = -dt_b * flow[0](x) and
// v_b = -dt_b * flow[1](x).  Then
//
//   forward:  out(x) = sum_b sum_{orow,ocol in [-R,R]}
//                        hat(u_b+orow) * hat(v_b+ocol) * H_b(x+o)
//   backward: du(x)  = sum_b sum_o (-dt_b) * dhat(u_b+orow) * hat(v_b+ocol)
//                        * g(x) * H_b(x+o)                     (dv alike)
//
//   hat(a)  = max(0, 1 - |a|)
//   dhat(a) = |a| < 1 ? -sign(a) : 0,  sign(0) = 0
//
// dhat is the Pallas kernel's rule, not autodiff's: at a kink (a = 0 or
// |a| = 1) it gives 0.  The solve starts from flow exactly 0, where every
// tap sits on a kink, so this rule makes the first gradient of the
// contrast term exactly 0.  copysignf(1, 0) is +1, so sign is written out.
//
// Design.  The TPU kernel DMAs a row tile of all B histograms with an
// 8-row halo into VMEM and shifts columns with pltpu.roll; both exist for
// VMEM and lane alignment and are not carried over.  Here one thread owns
// one output pixel and loops over the bins and the (2R+1)^2 taps, R being a
// template parameter so that the taps unroll.  Histograms come through the
// read-only cache; a tap's neighbours are the neighbouring threads' own
// taps, so the 25-fold reuse at R = 2 is served by L1.  dts is a small
// device array read uniformly by every thread.  There are no atomics: a
// pixel's du and dv depend only on that pixel's flow and cotangent, so the
// result repeats bit for bit.  No shared memory is used yet.
//
// What bounds it on an H100 (convention: HBM bytes with each input read
// once and each output written once, L2 flushed before the call, at
// 3.35 TB/s; against the f32 operations the function needs, an FMA counted
// as two, at 67 TFLOP/s).  hat(a + o) and dhat(a + o) are nonzero only
// where |a + o| < 1, so a pixel and bin need at most 2 x 2 of the
// (2R+1)^2 taps (1 x 1 on an integer shift).  With n_u, n_v <= 2 such
// offsets per axis, the forward needs 2 + 4(n_u + n_v) + 3 n_u n_v
// operations per pixel and bin (the two shifts; add, abs, sub, max per hat
// weight; a weight product and an FMA per tap) and the backward
// 2 + 7(n_u + n_v) + 9 n_u n_v (dhat adds a compare, a sign and a select
// per offset; a tap is g*h, then four operations each for du and dv).  At
// the CMax cell's box, B = 16 and 720 x 644 = 463,680 px, R = 2, and a
// flow whose shifts are not integers (n_u = n_v = 2):
//   forward:  (B+3)*4*463,680 = 35.2 MB, 10.5 us;
//             30 ops * 16 * 463,680 = 0.22 GFLOP, 3.3 us: bound by bytes.
//   backward: (B+5)*4*463,680 = 38.9 MB, 11.6 us;
//             66 ops * 16 * 463,680 = 0.49 GFLOP, 7.3 us: bound by bytes.
// This kernel evaluates all (2R+1)^2 taps (117 and 297 operations per
// pixel and bin at R = 2), most of them zero; that is work above the
// bound, not part of it.  The 29.7 MB of histograms fit the 50 MB L2, so
// within the Adam loop the forward and backward of one step mostly find
// them there.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float hat(float a) {
  return fmaxf(0.0f, 1.0f - fabsf(a));
}

__device__ __forceinline__ float dhat(float a) {
  const float sign = a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : 0.0f);
  return fabsf(a) < 1.0f ? -sign : 0.0f;
}

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

template <int R>
__global__ void __launch_bounds__(kBlockX * kBlockY)
cmax_fwd_kernel(const float* __restrict__ hists,
                const float* __restrict__ flow,
                const float* __restrict__ dts, int n_bins, int h, int w,
                float* __restrict__ out) {
  constexpr int K = 2 * R + 1;
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;
  const long long hw = (long long)h * w;
  const long long p = (long long)r * w + c;
  const float u0 = __ldg(flow + p);
  const float v0 = __ldg(flow + hw + p);
  float acc = 0.0f;
  for (int b = 0; b < n_bins; ++b) {
    const float dt = __ldg(dts + b);
    const float u = -dt * u0;
    const float v = -dt * v0;
    float wc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) wc[j] = hat(v + (float)(j - R));
    const float* hb = hists + b * hw;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int rr = r + i - R;
      if (rr < 0 || rr >= h) continue;  // zero taps add nothing
      const float wr = hat(u + (float)(i - R));
      const float* row = hb + (long long)rr * w;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int cc = c + j - R;
        const float hv = (cc >= 0 && cc < w) ? __ldg(row + cc) : 0.0f;
        acc += wr * wc[j] * hv;
      }
    }
  }
  out[p] = acc;
}

template <int R>
__global__ void __launch_bounds__(kBlockX * kBlockY)
cmax_bwd_kernel(const float* __restrict__ hists,
                const float* __restrict__ flow,
                const float* __restrict__ g, const float* __restrict__ dts,
                int n_bins, int h, int w, float* __restrict__ du_out,
                float* __restrict__ dv_out) {
  constexpr int K = 2 * R + 1;
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;
  const long long hw = (long long)h * w;
  const long long p = (long long)r * w + c;
  const float u0 = __ldg(flow + p);
  const float v0 = __ldg(flow + hw + p);
  const float gp = __ldg(g + p);
  float du = 0.0f;
  float dv = 0.0f;
  for (int b = 0; b < n_bins; ++b) {
    const float dt = __ldg(dts + b);
    const float ndt = -dt;
    const float u = ndt * u0;
    const float v = ndt * v0;
    float wc[K];
    float dwc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float av = v + (float)(j - R);
      wc[j] = hat(av);
      dwc[j] = dhat(av);
    }
    const float* hb = hists + b * hw;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int rr = r + i - R;
      if (rr < 0 || rr >= h) continue;
      const float au = u + (float)(i - R);
      const float wr = hat(au);
      const float dwr = dhat(au);
      const float* row = hb + (long long)rr * w;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int cc = c + j - R;
        const float hv = (cc >= 0 && cc < w) ? __ldg(row + cc) : 0.0f;
        const float gh = gp * hv;
        du += ndt * dwr * wc[j] * gh;
        dv += ndt * wr * dwc[j] * gh;
      }
    }
  }
  du_out[p] = du;
  dv_out[p] = dv;
}

dim3 grid_of(int h, int w) {
  return dim3((unsigned)((w + kBlockX - 1) / kBlockX),
              (unsigned)((h + kBlockY - 1) / kBlockY));
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError()
// (0 = launched); a radius outside 1..4 returns cudaErrorInvalidValue.
extern "C" int ebt_cmax_stencil_fwd(const float* hists, const float* flow,
                                    const float* dts, int n_bins, int h,
                                    int w, int radius, float* out,
                                    void* stream) {
  if (n_bins <= 0 || h <= 0 || w <= 0) return 0;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid = grid_of(h, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: cmax_fwd_kernel<1><<<grid, block, 0, s>>>(hists, flow, dts, n_bins, h, w, out); break;
    case 2: cmax_fwd_kernel<2><<<grid, block, 0, s>>>(hists, flow, dts, n_bins, h, w, out); break;
    case 3: cmax_fwd_kernel<3><<<grid, block, 0, s>>>(hists, flow, dts, n_bins, h, w, out); break;
    case 4: cmax_fwd_kernel<4><<<grid, block, 0, s>>>(hists, flow, dts, n_bins, h, w, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ebt_cmax_stencil_bwd(const float* hists, const float* flow,
                                    const float* g, const float* dts,
                                    int n_bins, int h, int w, int radius,
                                    float* du, float* dv, void* stream) {
  if (n_bins <= 0 || h <= 0 || w <= 0) return 0;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid = grid_of(h, w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: cmax_bwd_kernel<1><<<grid, block, 0, s>>>(hists, flow, g, dts, n_bins, h, w, du, dv); break;
    case 2: cmax_bwd_kernel<2><<<grid, block, 0, s>>>(hists, flow, g, dts, n_bins, h, w, du, dv); break;
    case 3: cmax_bwd_kernel<3><<<grid, block, 0, s>>>(hists, flow, g, dts, n_bins, h, w, du, dv); break;
    case 4: cmax_bwd_kernel<4><<<grid, block, 0, s>>>(hists, flow, g, dts, n_bins, h, w, du, dv); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
