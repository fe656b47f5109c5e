// The event vote of event_based_bos_tpu_torch/csrc/hat_vote.cu as a
// per-tile design: the votes binned by (plane, tile) and accumulated in
// shared memory.  It was weighed against the one-launch design with global
// atomics that the package ships, and measured slower at the main path's
// size (PERF.md); kept as the variant that `tools/stencil_ab.py --kernel
// vote` builds into a library of its own and times in turns against the
// package's kernel.  Entry point `ebt_vote_tiled`: the package's arguments
// plus the tile shape, the chunk and two scratch buffers; the package
// never loads it.
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
// cropping.  The output is [P, h, pitch] f32 (pitch >= w); every element
// is written, the columns from w on with 0.  Corners outside the box, and
// events that are invalid, have a zero value or a plane outside [0, P),
// are dropped.
//
// What bounds it on an H100: at the main path's size (2^19 events, a 720 x
// 1280 image) the function reads 13 B/event (x, y, p, valid) and writes
// 3.7 MB, 10.5 MB or ~3.1 us of HBM time at 3.35 TB/s; the CMax histograms
// write 16 planes of the 720 x 644 box (29.7 MB, ~10.9 us).  The earlier
// design (one thread per event, a global atomicAdd per corner into an
// image its wrapper zeroed first, after ~10 preparation launches) spent its
// time in launches, the preparation's temporaries and random-address
// atomics (PERF.md).  This design:
//
//   1. count: a block takes 4096 consecutive events, counts its corner
//      votes per (plane, tile) bin in shared memory, and adds each nonzero
//      count to the global bin counts once; the last block to finish (a
//      ticket after a fence) scans the counts into each bin's segment
//      offset and, for bins longer than `chunk` votes, their chunk count;
//   2. place: the same blocks count again, reserve one range per bin in
//      its segment with one global atomicAdd, and write each vote (offset
//      within its tile, value) into the range; they also zero the output
//      tiles of bins that are split into several chunks;
//   3. accumulate: one block per chunk (one chunk per bin unless it is
//      long) zeroes a tile in shared memory, adds its votes with
//      shared-memory atomics, and writes the whole tile, zeros included,
//      with 16-byte stores where the pitch allows; a split bin's chunks
//      add their nonzero pixels into the zeroed tile with global atomics.
//
// No global atomic lands on the image except a split bin's, no memset of
// the image is needed, and no temporaries are made from the event record.
// Votes are binned per corner, so a corner never needs a halo.  The
// events are read twice (count, place; the second time mostly from L2) and
// the votes once more from L2 (8 B each).  A bin that holds most votes (an
// edge of the pattern) is cut into chunks so that no block serialises the
// frame.
//
// Numerics: each corner's value is (wr * wc) * val as the plain version
// forms it.  With integer coordinates every weight is 0 or +-val, and sums
// of +-1 in f32 are exact in any order below 2^24, so the result is
// bit-exact against the plain version whatever order the atomics land in.
// Fractional coordinates agree to f32 rounding of the summation order; the
// shared-memory atomics make that order, and so those sums, differ from
// run to run (as the global atomics before them did).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

// count and place: 1024 threads a block, 4 events a thread, so that a
// block's counters reach the global ones once per 4096 events
constexpr int kThreads = 1024;
constexpr int kEventsPerThread = 4;
constexpr int kEventsPerBlock = kThreads * kEventsPerThread;
constexpr int kVotes = 4 * kEventsPerThread;  // corner votes a thread holds
constexpr int kTileThreads = 256;             // accumulate
// counters a block keeps in shared memory: 36 KB, which with the scan's
// 8 KB stays under the 48 KB a block gets without opting in
constexpr int kMaxSharedBins = 9216;
constexpr int kMaxTile = 4096;                // 16 KB of f32 a tile

struct VoteArgs {
  const float* x;
  const float* y;
  const unsigned char* valid;  // nullable
  const float* p;              // nullable
  const float* weight;         // nullable
  const int* plane;            // nullable
  long long n;
  float scale, off_x, off_y;
  float lo_r, hi_r, lo_c, hi_c;  // floor(x') whose corners can meet the box
  int org_r, org_c;
  int p_mode;  // 0: p unused; 1: vote times sign(p); 2: plane p <= 0
  int nudge;
  int n_planes, h, w, pitch;
  int th_log2, tw_log2;  // tile shape (powers of two)
  int tiles_c, tiles;    // tiles per row of tiles, per plane
  int n_bins, chunk;
};

// A vote's key: its bin above the offset in the bin's tile.
constexpr int kLocBits = 12;  // offsets below kMaxTile
constexpr int kLocMask = (1 << kLocBits) - 1;

// The <= 4 corner votes of event i into slots [0, 4): key or -1, value.
__device__ __forceinline__ void event_votes(const VoteArgs& a, long long i,
                                            int* key, float* val) {
#pragma unroll
  for (int k = 0; k < 4; ++k) key[k] = -1;
  if (i >= a.n) return;
  if (a.valid != nullptr && !a.valid[i]) return;
  float v = a.scale;
  int q = 0;
  if (a.p_mode == 1) {
    if (!(a.p[i] > 0.0f)) v = -v;
  } else if (a.p_mode == 2) {
    const float pi = a.p[i];
    if (pi > 0.0f) {
      q = 0;
    } else if (pi <= 0.0f) {
      q = 1;
    } else {
      return;  // NaN: in neither plane
    }
  }
  if (a.weight != nullptr) v *= a.weight[i];
  if (a.plane != nullptr) q = a.plane[i];
  if (v == 0.0f || q < 0 || q >= a.n_planes) return;
  const float xi = a.x[i] + a.off_x;
  const float yi = a.y[i] + a.off_y;
  const float fx = floorf(a.nudge ? xi + 1e-6f : xi);
  const float fy = floorf(a.nudge ? yi + 1e-6f : yi);
  // written so that NaN is dropped; keeps the int casts defined
  if (!(fx >= a.lo_r && fx <= a.hi_r && fy >= a.lo_c && fy <= a.hi_c))
    return;
  const float dx = xi - fx;
  const float dy = yi - fy;
  const int r0 = (int)fx - a.org_r;
  const int c0 = (int)fy - a.org_c;
  const float wr[2] = {1.0f - dx, dx};
  const float wc[2] = {1.0f - dy, dy};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = r0 + u;
      const int c = c0 + s;
      const float wgt = wr[u] * wc[s];
      if (r < 0 || r >= a.h || c < 0 || c >= a.w || wgt == 0.0f) continue;
      const int tr = r >> a.th_log2;
      const int tc = c >> a.tw_log2;
      key[2 * u + s] = ((q * a.tiles + tr * a.tiles_c + tc) << kLocBits) |
                       ((r - (tr << a.th_log2)) << a.tw_log2) |
                       (c - (tc << a.tw_log2));
      val[2 * u + s] = wgt * v;
    }
  }
}

// This thread's events of the block's 4096, all loads issued first.
__device__ __forceinline__ void block_votes(const VoteArgs& a, int* key,
                                            float* val) {
  const long long e0 =
      (long long)blockIdx.x * kEventsPerBlock + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kEventsPerThread; ++k)
    event_votes(a, e0 + (long long)k * kThreads, key + 4 * k, val + 4 * k);
}

__device__ __forceinline__ int chunks_of(int count, int chunk) {
  // an empty bin still has one block, which writes its tile's zeros
  return count <= chunk ? 1 : (count + chunk - 1) / chunk;
}

// Exclusive scans of the bin counts (segment offsets; the place step's
// cursors start there) and of the chunks per bin, and each chunk's bin, by
// one block.
__device__ void scan_bins(const VoteArgs& a, const int* counts, int* offsets,
                          int* cursor, int* chunk_start, int* chunk_bin) {
  __shared__ int s_sum[kThreads];
  __shared__ int s_chk[kThreads];
  const int t = threadIdx.x;
  const int per = (a.n_bins + kThreads - 1) / kThreads;
  const int j0 = min(a.n_bins, t * per);
  const int j1 = min(a.n_bins, j0 + per);
  int sum = 0, chk = 0;
  for (int j = j0; j < j1; ++j) {
    const int c = __ldcg(counts + j);
    sum += c;
    chk += chunks_of(c, a.chunk);
  }
  s_sum[t] = sum;
  s_chk[t] = chk;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    const int vs = t >= d ? s_sum[t - d] : 0;
    const int vc = t >= d ? s_chk[t - d] : 0;
    __syncthreads();
    s_sum[t] += vs;
    s_chk[t] += vc;
    __syncthreads();
  }
  int run = t ? s_sum[t - 1] : 0;
  int runc = t ? s_chk[t - 1] : 0;
  for (int j = j0; j < j1; ++j) {
    const int c = __ldcg(counts + j);
    offsets[j] = run;
    cursor[j] = run;
    chunk_start[j] = runc;
    run += c;
    for (const int end = runc + chunks_of(c, a.chunk); runc < end; ++runc)
      chunk_bin[runc] = j;
  }
  if (t == kThreads - 1) {
    offsets[a.n_bins] = s_sum[t];
    chunk_start[a.n_bins] = s_chk[t];
  }
}

__global__ void __launch_bounds__(kThreads)
    hat_vote_count_kernel(VoteArgs a, int* ticket, int* counts, int* offsets,
                          int* cursor, int* chunk_start, int* chunk_bin) {
  extern __shared__ int s_bins[];
  __shared__ bool s_last;
  const bool in_smem = a.n_bins <= kMaxSharedBins;
  if (in_smem) {
    for (int j = threadIdx.x; j < a.n_bins; j += kThreads) s_bins[j] = 0;
    __syncthreads();
  }
  int key[kVotes];
  float val[kVotes];
  block_votes(a, key, val);
#pragma unroll
  for (int k = 0; k < kVotes; ++k) {
    if (key[k] < 0) continue;
    if (in_smem)
      atomicAdd(s_bins + (key[k] >> kLocBits), 1);
    else
      atomicAdd(counts + (key[k] >> kLocBits), 1);
  }
  if (in_smem) {
    __syncthreads();
    for (int j = threadIdx.x; j < a.n_bins; j += kThreads)
      if (s_bins[j] != 0) atomicAdd(counts + j, s_bins[j]);
  }
  // the last block to finish sees every count and scans them
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  scan_bins(a, counts, offsets, cursor, chunk_start, chunk_bin);
}

__device__ __forceinline__ void tile_box(const VoteArgs& a, int b, int* plane,
                                         int* row0, int* col0, int* rows,
                                         int* cols) {
  *plane = b / a.tiles;
  const int t = b - *plane * a.tiles;
  const int tr = t / a.tiles_c;
  *row0 = tr << a.th_log2;
  *col0 = (t - tr * a.tiles_c) << a.tw_log2;
  *rows = min(1 << a.th_log2, a.h - *row0);
  *cols = min(1 << a.tw_log2, a.pitch - *col0);
}

__global__ void __launch_bounds__(kThreads)
    hat_vote_place_kernel(VoteArgs a, const int* chunk_start, int* cursor,
                          int2* entries, float* __restrict__ out) {
  extern __shared__ int s_bins[];
  const bool in_smem = a.n_bins <= kMaxSharedBins;
  if (in_smem) {
    for (int j = threadIdx.x; j < a.n_bins; j += kThreads) s_bins[j] = 0;
    __syncthreads();
  }
  int key[kVotes];
  float val[kVotes];
  block_votes(a, key, val);
  if (in_smem) {
#pragma unroll
    for (int k = 0; k < kVotes; ++k)
      if (key[k] >= 0) atomicAdd(s_bins + (key[k] >> kLocBits), 1);
    __syncthreads();
    // one range per bin and block
    for (int j = threadIdx.x; j < a.n_bins; j += kThreads)
      if (s_bins[j] != 0) s_bins[j] = atomicAdd(cursor + j, s_bins[j]);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kVotes; ++k) {
    if (key[k] < 0) continue;
    const int b = key[k] >> kLocBits;
    const int slot = in_smem ? atomicAdd(s_bins + b, 1)
                             : atomicAdd(cursor + b, 1);
    entries[slot] = make_int2(key[k] & kLocMask, __float_as_int(val[k]));
  }
  // the tiles of split bins start at zero: their chunks add into them
  for (int b = blockIdx.x; b < a.n_bins; b += gridDim.x) {
    if (chunk_start[b + 1] - chunk_start[b] < 2) continue;
    int q, row0, col0, rows, cols;
    tile_box(a, b, &q, &row0, &col0, &rows, &cols);
    float* o = out + ((long long)q * a.h + row0) * a.pitch + col0;
    for (int j = threadIdx.x; j < (rows << a.tw_log2); j += kThreads) {
      const int c = j & ((1 << a.tw_log2) - 1);
      if (c < cols) o[(long long)(j >> a.tw_log2) * a.pitch + c] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kTileThreads)
    hat_vote_accumulate_kernel(VoteArgs a, const int* offsets,
                               const int* chunk_start, const int* chunk_bin,
                               const int2* entries,
                               float* __restrict__ out) {
  extern __shared__ __align__(16) float s_tile[];
  const int cb = blockIdx.x;
  if (cb >= chunk_start[a.n_bins]) return;
  const int b = chunk_bin[cb];
  const bool split = chunk_start[b + 1] - chunk_start[b] > 1;
  const int first = offsets[b] + (cb - chunk_start[b]) * a.chunk;
  const int last = min(offsets[b + 1], first + a.chunk);
  const int tw = 1 << a.tw_log2;
  const int tile_n = tw << a.th_log2;
  for (int j = threadIdx.x; j < tile_n; j += kTileThreads) s_tile[j] = 0.0f;
  __syncthreads();
  for (int e = first + threadIdx.x; e < last; e += kTileThreads) {
    const int2 v = entries[e];
    atomicAdd(s_tile + v.x, __int_as_float(v.y));
  }
  __syncthreads();
  int q, row0, col0, rows, cols;
  tile_box(a, b, &q, &row0, &col0, &rows, &cols);
  float* o = out + ((long long)q * a.h + row0) * a.pitch + col0;
  if (split) {
    for (int j = threadIdx.x; j < rows * tw; j += kTileThreads) {
      const int c = j & (tw - 1);
      const float s = s_tile[j];
      if (c < cols && s != 0.0f)
        atomicAdd(o + (long long)(j >> a.tw_log2) * a.pitch + c, s);
    }
  } else if ((a.pitch & 3) == 0) {
    // col0, cols and the pitch are multiples of 4: whole 16-byte pieces
    const int q4_log2 = a.tw_log2 - 2;
    const int cols4 = cols >> 2;
    for (int j = threadIdx.x; j < (rows << q4_log2); j += kTileThreads) {
      const int r = j >> q4_log2;
      const int c4 = j & ((1 << q4_log2) - 1);
      if (c4 < cols4)
        reinterpret_cast<float4*>(o + (long long)r * a.pitch)[c4] =
            reinterpret_cast<const float4*>(s_tile + r * tw)[c4];
    }
  } else {
    for (int j = threadIdx.x; j < rows * tw; j += kTileThreads) {
      const int c = j & (tw - 1);
      if (c < cols) o[(long long)(j >> a.tw_log2) * a.pitch + c] = s_tile[j];
    }
  }
}

int log2_of(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return (1 << k) == v ? k : -1;
}

}  // namespace

// Vote into out [n_planes, h, pitch] on `stream`.  `meta` is int32 scratch
// of 5 * n_bins + 3 + ceil(4 n / chunk) entries (n_bins = n_planes *
// ceil(h / tile_h) * ceil(pitch / tile_w)), `entries` 8-byte scratch of
// max(1, 4 n) entries; the caller allocates both, uninitialised.  Returns
// 0 when every launch was accepted, a cudaError_t, or -1 for arguments it
// does not take.
extern "C" int ebt_vote_tiled(const float* x, const float* y,
                              const unsigned char* valid, const float* p,
                              int p_mode, const float* weight, float scale,
                              const int* plane, int n_planes, long long n,
                              float off_x, float off_y, int org_r,
                              int org_c, int nudge, int h, int w, int pitch,
                              int tile_h, int tile_w, int chunk, int* meta,
                              void* entries, float* out, void* stream) {
  const int th_log2 = log2_of(tile_h);
  const int tw_log2 = log2_of(tile_w);
  if (n < 0 || n > (1LL << 29) || h <= 0 || w <= 0 || pitch < w ||
      n_planes <= 0 || chunk <= 0 || th_log2 < 0 || tw_log2 < 2 ||
      tile_h * tile_w > kMaxTile || p_mode < 0 || p_mode > 2 ||
      (p_mode != 0 && p == nullptr) || (p_mode == 2 && n_planes < 2))
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
  a.th_log2 = th_log2;
  a.tw_log2 = tw_log2;
  a.tiles_c = (pitch + tile_w - 1) / tile_w;
  const long long bins =
      (long long)n_planes * ((h + tile_h - 1) / tile_h) * a.tiles_c;
  if (bins >= (1 << (31 - kLocBits))) return -1;  // keys stay positive
  a.tiles = (int)(bins / n_planes);
  a.n_bins = (int)bins;
  a.chunk = chunk;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ticket = meta;
  int* counts = meta + 1;
  int* offsets = counts + a.n_bins;
  int* cursor = offsets + a.n_bins + 1;
  int* chunk_start = cursor + a.n_bins;
  int* chunk_bin = chunk_start + a.n_bins + 1;
  cudaError_t err =
      cudaMemsetAsync(meta, 0, sizeof(int) * (a.n_bins + 1), s);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + kEventsPerBlock - 1) / kEventsPerBlock;
  if (blocks < 1) blocks = 1;  // the one block still scans the counts
  const size_t smem_bins =
      a.n_bins <= kMaxSharedBins ? sizeof(int) * a.n_bins : 0;
  hat_vote_count_kernel<<<(unsigned)blocks, kThreads, smem_bins, s>>>(
      a, ticket, counts, offsets, cursor, chunk_start, chunk_bin);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int2* ent = static_cast<int2*>(entries);
  hat_vote_place_kernel<<<(unsigned)blocks, kThreads, smem_bins, s>>>(
      a, chunk_start, cursor, ent, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // at most one chunk a bin plus one for every `chunk` votes
  const long long chunks = a.n_bins + (4 * n + chunk - 1) / chunk;
  hat_vote_accumulate_kernel<<<(unsigned)chunks, kTileThreads,
                               sizeof(float) * tile_h * tile_w, s>>>(
      a, offsets, chunk_start, chunk_bin, ent, out);
  return (int)cudaGetLastError();
}
