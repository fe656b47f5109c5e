// Bilinear ("hat") event vote on Hopper (sm_90a): the one-thread-per-event,
// global-atomic design that event_based_bos_tpu_torch/csrc/hat_vote.cu had
// before its per-tile redesign.  Kept, unchanged but for this paragraph, as
// the baseline that `tools/stencil_ab.py --kernel vote` and chip_smoke.py
// build into a library of their own and time in turns against the current
// kernel; the package never loads it.
//
// Replaces the Pallas TPU kernel ops/iwe_pallas.py::hat_vote_image of the
// JAX package.  It computes
//
//     img[h, w] = sum_e v_e * hat(x_e - h) * hat(y_e - w),
//     hat(d) = max(0, 1 - |d|),
//
// over an [H, W] float32 image that the caller zeroes.  Corners outside the
// image are dropped; v_e == 0 disables an event (the Python wrapper folds
// the validity mask and the polarity sign into v, and parks invalid slots
// at coordinates -2).
//
// The TPU kernel rewrote the scatter as an [H, E] x [E, W] matmul of hat
// factors because the TPU has a matrix unit and no fast random-access
// add.  Hopper has fast f32 atomics in L2, so this kernel writes what the
// function is: one thread per event (grid-stride), floor of the
// coordinates, the four corner weights, and one atomicAdd per corner that
// has nonzero weight and lies inside the image.
//
// What bounds it on an H100: at the main path's size (2^19 events, a
// 720 x 1280 image) the kernel reads x, y and v (12 B/event, 6.3 MB; the
// signed-vote wrapper's inputs x, y, p and valid are 13 B/event) and the
// image is 3.7 MB, about 3 us of HBM time at 3.35 TB/s.  The work is up to
// 2.1 M f32 atomics (1 per event for the integer sensor coordinates of the
// per-frame cache, whose other three corner weights are exactly 0 and are
// skipped).  The image fits the 50 MB L2, so the atomics resolve in L2,
// and the atomic throughput on hot pixels, not HBM bytes, is what this
// simple design leaves on the table.  Privatising spatial tiles in shared
// memory or pre-binning the events are later options.
//
// Numerics: with integer coordinates every weight is exactly 0 or 1 and
// the sums of +-1 in f32 are exact in any order below 2^24, so the result
// is bit-exact against the torch scatter whatever order the atomics land
// in.  Fractional coordinates agree to f32 rounding of the summation order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void hat_vote_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ v,
                                long long n, int h, int w,
                                float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float val = v[i];
    if (val == 0.0f) continue;
    const float xi = x[i];
    const float yi = y[i];
    const float fx = floorf(xi);
    const float fy = floorf(yi);
    // rows fx and fx+1 must meet [0, h-1]; written so that NaN is skipped
    if (!(fx >= -1.0f && fx <= (float)(h - 1) && fy >= -1.0f &&
          fy <= (float)(w - 1)))
      continue;
    const float dx = xi - fx;
    const float dy = yi - fy;
    const int r0 = (int)fx;
    const int c0 = (int)fy;
    const float wr[2] = {1.0f - dx, dx};
    const float wc[2] = {1.0f - dy, dy};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = r0 + a;
      if (r < 0 || r >= h) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int c = c0 + b;
        if (c < 0 || c >= w) continue;
        const float wgt = wr[a] * wc[b];
        if (wgt == 0.0f) continue;
        atomicAdd(out + (long long)r * w + c, wgt * val);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int ebt_hat_vote(const float* x, const float* y, const float* v,
                            long long n, int h, int w, float* out,
                            void* stream) {
  if (n > 0 && h > 0 && w > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    // grid-stride: a few waves of 132 SMs x 8 blocks cover any n
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    hat_vote_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, y, v, n, h, w,
                                                            out);
  }
  return (int)cudaGetLastError();
}
