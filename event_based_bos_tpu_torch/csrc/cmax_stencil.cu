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
// The taps.  hat(s + o) is nonzero only where |s + o| < 1, so per axis only
// the offsets p = floor(-s) and p + 1 can carry weight (p + 1 has weight
// exactly 0 on an integer shift).  The kernel takes p = clamp(floor(-s),
// -R, R - 1), so that both offsets lie in [-R, R], and weighs each by the
// same formula as the full tap sum, hat(s + o) with s + o rounded as there.
// Where floor(-s) falls outside [-R, R - 1] (|s| > R - 1), the clamped pair
// holds the one offset inside [-R, R] that can carry weight and a second
// whose hat is 0, and beyond |s| >= R + 1 both hats are 0: the truncation
// at R comes out of the formula, and no read leaves the R-pixel halo.
// Rounding is monotone, so every offset outside the pair has |s + o| >= 1
// after rounding too, and the nonzero products are exactly those of the
// (2R+1)^2 loop, added in its order (bins outer, then orow, then ocol).
// The shift and each s + o are rounded on their own, as the plain version
// and the TPU kernel round them.  floor comes from one add rounded down
// against 1.5 * 2^23 (full rate) instead of a conversion (quarter rate).
//
// Design.  The TPU kernel DMAs a row tile of all B histograms with an
// 8-row halo into VMEM and shifts columns with pltpu.roll; both exist for
// VMEM and lane alignment.  Here a block of 256 threads owns a 64 x 16
// tile of output pixels; thread (warp, lane) owns rows warp and warp + 8,
// columns lane and lane + 32, so a warp's reads of a tap fall on 32
// neighbouring words (no bank conflicts where the flow is smooth).  The
// flow (and g) are read once into registers, each a coalesced 128-byte
// row per warp.  The histograms go through shared memory: bin b's window,
// R rows above and below the tile and 4 columns left and right (16 bytes,
// >= R), is staged with cp.async in 16-byte pieces (L1 bypassed) into a
// ring of three stages, two bins ahead of the bin being computed, with one
// barrier per bin.  The pieces need histogram rows that start on 16 bytes:
// the wrapper hands the kernel a pitched buffer (row stride a multiple of
// 4 floats), made once per solve.  A piece above, below or left of the
// array is zero-filled (source size 0), one that straddles column w is
// read in part and zero-filled beyond it, so one route serves every width
// and no tap is bounds-checked.  Each tap's shared-memory address is two
// multiply-adds from the magic-number floor and an immediate.  One
// template, <R, kBackward>, covers both directions at R = 1..4.  There are
// no atomics: a pixel's du and dv depend only on that pixel's flow and
// cotangent, so the result repeats bit for bit.
//
// What bounds it on an H100 (convention: HBM bytes with each input read
// once and each output written once, L2 flushed before the call, at
// 3.35 TB/s; against the f32 operations the function needs, an FMA counted
// as two, at 67 TFLOP/s).  With n_u, n_v <= 2 offsets per axis where the
// hat is nonzero, the forward needs 2 + 4(n_u + n_v) + 3 n_u n_v
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
// What holds the kernels above that is instruction issue, not bytes.  The
// halo makes each histogram word be read (64+8)(16+2R)/(64*16) = 1.41
// times at R = 2 (the re-reads hit L2); staging alone, with no taps, takes
// about 17 us at the cell with L2 flushed by reads.  The loop issues
// about 186 instructions per bin and thread forward (4 pixels: the pair
// selection, the address, four shared-memory loads, four products) and
// 355 backward (two dhat per axis and the bit-exact tap products), at an
// IPC near 0.7 with the 8 warps a scheduler gets from 4 blocks an SM; the
// cell's 463,680 pixels allow no more warps at 56 registers.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kTileW = 64;     // output columns per block
constexpr int kTileH = 16;     // output rows per block
constexpr int kThreads = 256;  // 8 warps; each thread owns 4 pixels
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;
constexpr int kStages = 3;     // histogram windows in the ring
constexpr int kHaloW = 4;      // window columns left and right: 16 bytes
constexpr int kMaxRadius = 4;

static_assert(kTileW == 64 && kTileH == 2 * kWarps && kPix == 4,
              "pixel k of a thread is (warp + 8 (k/2), lane + 32 (k%2))");
static_assert(kHaloW >= kMaxRadius && kTileW % 4 == 0,
              "the window's columns come in aligned 16-byte pieces");

// Bin b's window in shared memory: the tile, R rows above and below and
// kHaloW >= R columns left and right, copied in 16-byte pieces.
template <int R>
struct Window {
  static_assert(R >= 1 && R <= kMaxRadius, "the halo holds R <= 4");
  static constexpr int kPitch = kTileW + 2 * kHaloW;
  static constexpr int kRows = kTileH + 2 * R;
  static constexpr int kWords = kPitch * kRows;
  static constexpr int kPieces = kWords / 4;
  static constexpr int kCopies = (kPieces + kThreads - 1) / kThreads;
};

// max(0, 1 - |a|): 1 - |a| <= 1, so saturating to [0, 1] is the max, in
// one add (and NaN gives 0, as fmaxf(0, NaN) does)
__device__ __forceinline__ float hat(float a) {
  return __saturatef(1.0f - fabsf(a));
}

// -sign(a) for |a| < 1, else 0 (+0 at a = 0): two masked compares
__device__ __forceinline__ float dhat(float a) {
  const bool inside = fabsf(a) < 1.0f;
  return (inside && a < 0.0f ? 1.0f : 0.0f) -
         (inside && a > 0.0f ? 1.0f : 0.0f);
}

// 1.5 * 2^23: for |x| <= 2^22, x + kMagic rounded down is kMagic + floor(x)
// exactly, and its bit pattern is kMagicBits + floor(x).
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// The two taps of one axis for the shift s = -dt * f: returns
// kMagicBits + p with p = clamp(floor(-s), -R, R - 1) and sets a0 = s + p,
// a1 = s + (p + 1).  s and each sum are rounded on their own (no fused
// multiply-add), as the TPU kernel's tap loop and the plain version round
// them.
template <int R>
__device__ __forceinline__ int tap_pair(float ndt, float f, float& a0,
                                        float& a1) {
  const float s = __fmul_rn(ndt, f);
  const float x = fminf(fmaxf(-s, (float)-R), (float)(R - 1));
  const float t = __fadd_rd(x, kMagic);
  a0 = __fadd_rn(s, t - kMagic);
  a1 = __fadd_rn(s, t - (kMagic - 1.0f));
  return __float_as_int(t);
}

__device__ __forceinline__ void copy_piece(unsigned dst, const float* src,
                                           int nbytes) {
  // reads nbytes (0, 4, 8, 12 or 16) and zero-fills the rest of the piece
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(nbytes) : "memory");
}

// a word of shared memory at addr + kOffset (volatile: it stays after the
// barrier that makes the window visible)
template <int kOffset>
__device__ __forceinline__ float load_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];"
               : "=f"(v) : "r"(addr), "n"(kOffset));
  return v;
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// hists is [B, h, pitch] (pitch % 4 == 0, 16-byte aligned; the columns
// from w on are not read).  kBackward false: out0 = out (g, out1 unused).
// True: out0 = du, out1 = dv.
template <int R, bool kBackward>
__global__ void __launch_bounds__(kThreads, 4)
cmax_stencil_kernel(const float* __restrict__ hists,
                    const float* __restrict__ flow,
                    const float* __restrict__ g,
                    const float* __restrict__ dts, int n_bins, int h, int w,
                    int pitch, float* __restrict__ out0,
                    float* __restrict__ out1) {
  using Win = Window<R>;
  __shared__ __align__(16) float ring[kStages * Win::kWords];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.y * kTileH;
  const int c0 = blockIdx.x * kTileW;
  const long long hw = (long long)h * w;

  // This thread's 16-byte pieces of a window: the source in bin 0's plane
  // and the bytes to read, 0 above, below and left of the array (pieces
  // start at multiples of 4 columns, so none straddles column 0) and fewer
  // than 16 where the piece straddles column w.
  const float* src[Win::kCopies];
  int nbytes[Win::kCopies];
#pragma unroll
  for (int k = 0; k < Win::kCopies; ++k) {
    const int i = tid + k * kThreads;
    const int gr = r0 - R + i / (Win::kPitch / 4);
    const int gc = c0 - kHaloW + 4 * (i % (Win::kPitch / 4));
    const int words = gr >= 0 && gr < h && gc >= 0 ? min(w - gc, 4) : 0;
    nbytes[k] = 4 * max(words, 0);
    src[k] = hists + (nbytes[k] ? gr * pitch + gc : 0);
  }
  const long long plane_words = (long long)h * pitch;
  const unsigned ring_addr = (unsigned)__cvta_generic_to_shared(ring);
  constexpr unsigned kStageBytes = 4u * Win::kWords;
  // copies this thread's pieces of the bin that src points at into a stage,
  // and moves src on to the next bin
  auto stage_next_bin = [&](unsigned stage_offset) {
#pragma unroll
    for (int k = 0; k < Win::kCopies; ++k) {
      if (k + 1 < Win::kCopies || tid + k * kThreads < Win::kPieces)
        copy_piece(ring_addr + stage_offset + 16u * (tid + k * kThreads),
                   src[k], nbytes[k]);
      src[k] += plane_words;
    }
  };

  // Issue the first bins' copies, then read this thread's pixels (a pixel
  // past the array's edge computes on zeros and is not stored).
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_bins) stage_next_bin(s * kStageBytes);
    copy_commit();
  }
  float u0[kPix], v0[kPix], gp[kPix], acc0[kPix], acc1[kPix];
  bool live[kPix];
  int pix[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int r = r0 + warp + kWarps * (k >> 1);
    const int c = c0 + lane + 32 * (k & 1);
    live[k] = r < h && c < w;
    pix[k] = live[k] ? r * w + c : 0;
    u0[k] = live[k] ? __ldg(flow + pix[k]) : 0.0f;
    v0[k] = live[k] ? __ldg(flow + hw + pix[k]) : 0.0f;
    gp[k] = kBackward && live[k] ? __ldg(g + pix[k]) : 0.0f;
    acc0[k] = 0.0f;
    acc1[k] = 0.0f;
  }
  // Tap (pr, pc) of pixel k in the window at ring + offset lies at byte
  // offset + own + kPixelBytes(k) + 4 (kPitch pr + pc).  pr and pc come as
  // kMagicBits + p: the magic is taken out of the base once per bin, so
  // each tap's address is two multiply-adds and a small immediate.
  const unsigned own = ring_addr + 4u * ((warp + R) * Win::kPitch + lane +
                                         kHaloW);
  constexpr unsigned kUnmagic = 4u * (Win::kPitch + 1) * kMagicBits;

  unsigned read_offset = 0;  // bytes from the ring to bin b's window
  float ndt_next = -__ldg(dts);
  for (int b = 0; b < n_bins; ++b) {
    copy_wait<kStages - 2>();  // this thread's pieces of bin b have landed
    __syncthreads();           // everyone's have; bin b - 1 is done with
    if (b + kStages - 1 < n_bins)  // into the stage bin b - 1 used
      stage_next_bin(read_offset ? read_offset - kStageBytes
                                 : (kStages - 1) * kStageBytes);
    copy_commit();

    const float ndt = ndt_next;
    ndt_next = -__ldg(dts + min(b + 1, n_bins - 1));
    const unsigned base = own + read_offset - kUnmagic;
    auto pixel = [&](auto kc) {
      constexpr int k = decltype(kc)::value;
      float au0, au1, av0, av1;
      const unsigned mr = tap_pair<R>(ndt, u0[k], au0, au1);
      const unsigned mc = tap_pair<R>(ndt, v0[k], av0, av1);
      const unsigned q = base + 4u * (Win::kPitch * mr + mc);
      constexpr int kPixel = 4 * (kWarps * (k >> 1) * Win::kPitch
                                  + 32 * (k & 1));
      const float h00 = load_shared<kPixel>(q);
      const float h01 = load_shared<kPixel + 4>(q);
      const float h10 = load_shared<kPixel + 4 * Win::kPitch>(q);
      const float h11 = load_shared<kPixel + 4 * Win::kPitch + 4>(q);
      const float wr0 = hat(au0), wr1 = hat(au1);
      const float wc0 = hat(av0), wc1 = hat(av1);
      if constexpr (!kBackward) {
        acc0[k] += wr0 * wc0 * h00;
        acc0[k] += wr0 * wc1 * h01;
        acc0[k] += wr1 * wc0 * h10;
        acc0[k] += wr1 * wc1 * h11;
      } else {
        const float dwr0 = dhat(au0), dwr1 = dhat(au1);
        const float dwc0 = dhat(av0), dwc1 = dhat(av1);
        const float g0 = gp[k];
        float gh = g0 * h00;
        acc0[k] += ndt * dwr0 * wc0 * gh;
        acc1[k] += ndt * wr0 * dwc0 * gh;
        gh = g0 * h01;
        acc0[k] += ndt * dwr0 * wc1 * gh;
        acc1[k] += ndt * wr0 * dwc1 * gh;
        gh = g0 * h10;
        acc0[k] += ndt * dwr1 * wc0 * gh;
        acc1[k] += ndt * wr1 * dwc0 * gh;
        gh = g0 * h11;
        acc0[k] += ndt * dwr1 * wc1 * gh;
        acc1[k] += ndt * wr1 * dwc1 * gh;
      }
    };
    pixel(std::integral_constant<int, 0>{});
    pixel(std::integral_constant<int, 1>{});
    pixel(std::integral_constant<int, 2>{});
    pixel(std::integral_constant<int, 3>{});
    read_offset = read_offset + kStageBytes == kStages * kStageBytes
                      ? 0 : read_offset + kStageBytes;
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (!live[k]) continue;
    out0[pix[k]] = acc0[k];
    if constexpr (kBackward) out1[pix[k]] = acc1[k];
  }
}

// A block's 3 windows (14-21 KB) let 4 blocks share an SM, and the cell's
// 495 blocks then fit the 132 SMs in one wave, if the SM gives shared
// memory the larger part of its L1; ask for that once per instantiation.
template <int R, bool kBackward>
void launch_radius(dim3 grid, cudaStream_t s, const float* hists,
                   const float* flow, const float* g, const float* dts,
                   int n_bins, int h, int w, int pitch, float* out0,
                   float* out1) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      cmax_stencil_kernel<R, kBackward>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  (void)carveout;  // a refusal is left for cudaGetLastError to report
  cmax_stencil_kernel<R, kBackward><<<grid, kThreads, 0, s>>>(
      hists, flow, g, dts, n_bins, h, w, pitch, out0, out1);
}

template <bool kBackward>
int launch(const float* hists, const float* flow, const float* g,
           const float* dts, int n_bins, int h, int w, int pitch,
           int radius, float* out0, float* out1, void* stream) {
  if (n_bins <= 0 || h <= 0 || w <= 0) return 0;
  if (pitch < w || pitch % 4 != 0 ||
      reinterpret_cast<unsigned long long>(hists) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: launch_radius<1, kBackward>(grid, s, hists, flow, g, dts, n_bins, h, w, pitch, out0, out1); break;
    case 2: launch_radius<2, kBackward>(grid, s, hists, flow, g, dts, n_bins, h, w, pitch, out0, out1); break;
    case 3: launch_radius<3, kBackward>(grid, s, hists, flow, g, dts, n_bins, h, w, pitch, out0, out1); break;
    case 4: launch_radius<4, kBackward>(grid, s, hists, flow, g, dts, n_bins, h, w, pitch, out0, out1); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points launch on `stream` and return cudaGetLastError()
// (0 = launched).  hists is [n_bins, h, pitch] with its rows on 16 bytes
// (pitch a multiple of 4, >= w); a radius outside 1..4 or another layout
// returns cudaErrorInvalidValue.
extern "C" int ebt_cmax_stencil_fwd(const float* hists, const float* flow,
                                    const float* dts, int n_bins, int h,
                                    int w, int pitch, int radius, float* out,
                                    void* stream) {
  return launch<false>(hists, flow, nullptr, dts, n_bins, h, w, pitch,
                       radius, out, nullptr, stream);
}

extern "C" int ebt_cmax_stencil_bwd(const float* hists, const float* flow,
                                    const float* g, const float* dts,
                                    int n_bins, int h, int w, int pitch,
                                    int radius, float* du, float* dv,
                                    void* stream) {
  return launch<true>(hists, flow, g, dts, n_bins, h, w, pitch, radius, du,
                      dv, stream);
}
