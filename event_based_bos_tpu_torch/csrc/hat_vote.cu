// Bilinear ("hat") event vote on Hopper (sm_90a), read straight from the
// event record, over P planes of an output box, in one call.
//
// Replaces the Pallas TPU kernel ops/iwe_pallas.py::hat_vote_image of the
// JAX package, and serves the two other per-frame callers of the same
// function there: the polarity pair and the time-binned CMax histograms
// (solver/cmax.py::binned_histograms, an XLA scatter in the JAX package).
// Over P planes of an output box of h x w pixels it computes
//
//     out[q, r, c] = sum over events e of plane q of
//                    val_e * hat(x_e + off_x - (r + org_r))
//                          * hat(y_e + off_y - (c + org_c)),
//     hat(d) = max(0, 1 - |d|),   val_e = [valid_e] * sign_e * scale * w_e,
//
// reading the event record itself: x, y (f32), an optional validity mask,
// an optional polarity p (its sign multiplies the vote, or it picks plane 0
// for p > 0 and plane 1 for p <= 0), optional per-event weights, an
// optional int32 plane index.  The corners are floor(x + off) and the one
// after it, exactly as a caller that shifted x by the padding in f32 would
// get them; with `nudge` they are floor(x + off + 1e-6) as the scatter's
// (and dx = x + off - floor(...)).  The integer origin comes off the
// integer corner, so voting into a box equals voting the whole frame and
// cropping.  The output is [P, h, pitch] f32 (pitch >= w), the columns
// from w on 0.  Corners outside the box, and events that are invalid, have
// a zero value or a plane outside [0, P), are dropped.
//
// Design: a memset of the output, then one thread per event (grid-stride)
// that issues all of its loads of the record first, forms the event's
// value, the floor of its coordinates and the four corner weights, and
// adds each nonzero in-box corner vote with one f32 atomicAdd (a RED in
// L2; the output was just written by the memset, so its lines are in L2).
// No temporary is made from the event record and nothing is launched
// besides.
//
// What bounds it on an H100: at the main path's size (2^19 events, a 720 x
// 1280 image) the signed vote reads 13 B/event (x, y, p, valid) and writes
// 3.7 MB, 10.5 MB or ~3.1 us of HBM time at 3.35 TB/s; the CMax histograms
// write 16 planes of the 720 x 644 box (29.7 MB, ~10.9 us).  At that size
// there are 0.57 votes a pixel, so the atomics rarely meet: a per-tile
// design that bins the votes in shared memory first (count, place and
// accumulate launches, tools/hat_vote_tiled.cu) measured 2.4x slower for
// the signed vote, and slower on 2^19 events in one 32 x 32 window too
// (PERF.md, tools/stencil_ab.py --kernel vote).  The time left above the
// bound is the memset, the launch ramp and the random-address atomics.
//
// Numerics: each corner's value is (wr * wc) * val as the plain version
// forms it.  With integer coordinates every weight is 0 or +-val, and sums
// of +-1 in f32 are exact in any order below 2^24, so the result is
// bit-exact against the plain version whatever order the atomics land in.
// Fractional coordinates agree to f32 rounding of the summation order,
// which the atomics make differ from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct VoteArgs {
  const float* __restrict__ x;
  const float* __restrict__ y;
  const unsigned char* __restrict__ valid;  // nullable
  const float* __restrict__ p;              // nullable
  const float* __restrict__ weight;         // nullable
  const int* __restrict__ plane;            // nullable
  long long n;
  float scale, off_x, off_y;
  float lo_r, hi_r, lo_c, hi_c;  // floor(x') whose corners can meet the box
  int org_r, org_c;
  int p_mode;  // 0: p unused; 1: vote times sign(p); 2: plane p <= 0
  int nudge;
  int n_planes, h, w, pitch;
};

__global__ void hat_vote_kernel(VoteArgs a, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    // every load issued before any branch on a loaded value
    const float xr = a.x[i];
    const float yr = a.y[i];
    const bool ok = a.valid == nullptr || a.valid[i];
    const float pi = a.p_mode != 0 ? a.p[i] : 1.0f;
    const float wi = a.weight != nullptr ? a.weight[i] : 1.0f;
    const int qi = a.plane != nullptr ? a.plane[i] : 0;
    if (!ok) continue;
    float v = a.scale;
    int q = 0;
    if (a.p_mode == 1) {
      if (!(pi > 0.0f)) v = -v;
    } else if (a.p_mode == 2) {
      if (pi > 0.0f) {
        q = 0;
      } else if (pi <= 0.0f) {
        q = 1;
      } else {
        continue;  // NaN: in neither plane
      }
    }
    if (a.weight != nullptr) v *= wi;
    if (a.plane != nullptr) q = qi;
    if (v == 0.0f || q < 0 || q >= a.n_planes) continue;
    const float xi = xr + a.off_x;
    const float yi = yr + a.off_y;
    const float fx = floorf(a.nudge ? xi + 1e-6f : xi);
    const float fy = floorf(a.nudge ? yi + 1e-6f : yi);
    // written so that NaN is dropped; keeps the int casts defined
    if (!(fx >= a.lo_r && fx <= a.hi_r && fy >= a.lo_c && fy <= a.hi_c))
      continue;
    const float dx = xi - fx;
    const float dy = yi - fy;
    const int r0 = (int)fx - a.org_r;
    const int c0 = (int)fy - a.org_c;
    const float wr[2] = {1.0f - dx, dx};
    const float wc[2] = {1.0f - dy, dy};
    float* base = out + (long long)q * a.h * a.pitch;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = r0 + u;
        const int c = c0 + s;
        const float wgt = wr[u] * wc[s];
        if (r < 0 || r >= a.h || c < 0 || c >= a.w || wgt == 0.0f) continue;
        atomicAdd(base + (long long)r * a.pitch + c, wgt * v);
      }
    }
  }
}

}  // namespace

// Vote into out [n_planes, h, pitch] on `stream` (the output is zeroed
// first).  Returns 0 when the memset and the launch were accepted, a
// cudaError_t, or -1 for arguments it does not take.
extern "C" int ebt_vote(const float* x, const float* y,
                        const unsigned char* valid, const float* p,
                        int p_mode, const float* weight, float scale,
                        const int* plane, int n_planes, long long n,
                        float off_x, float off_y, int org_r, int org_c,
                        int nudge, int h, int w, int pitch, float* out,
                        void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || pitch < w || n_planes <= 0 ||
      p_mode < 0 || p_mode > 2 || (p_mode != 0 && p == nullptr) ||
      (p_mode == 2 && n_planes < 2))
    return -1;
  VoteArgs a;
  a.x = x;
  a.y = y;
  a.valid = valid;
  a.p = p;
  a.weight = weight;
  a.plane = plane;
  a.n = n;
  a.scale = scale;
  a.off_x = off_x;
  a.off_y = off_y;
  a.lo_r = (float)(org_r - 1);
  a.hi_r = (float)(org_r + h - 1);
  a.lo_c = (float)(org_c - 1);
  a.hi_c = (float)(org_c + w - 1);
  a.org_r = org_r;
  a.org_c = org_c;
  a.p_mode = p_mode;
  a.nudge = nudge;
  a.n_planes = n_planes;
  a.h = h;
  a.w = w;
  a.pitch = pitch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * (size_t)n_planes * h * pitch, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    // grid-stride: a few waves of 132 SMs x 8 blocks cover any n
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    hat_vote_kernel<<<(unsigned)blocks, threads, 0, s>>>(a, out);
  }
  return (int)cudaGetLastError();
}
