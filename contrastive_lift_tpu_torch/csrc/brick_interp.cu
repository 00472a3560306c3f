// Brick-atlas trilinear density for Hopper (sm_90a), float32 or bfloat16 rows.
//
// Replaces the repository's only TPU kernel,
// contrastive_lift_tpu/ops/pallas_interp.py::brick_interp (kernel body
// _interp_kernel), and its XLA twin that production renders call,
// contrastive_lift_tpu/ops/fused_grid.py::sample_density_brick. Like the
// TPU kernel, both entry points take rows of either type and do all
// arithmetic in float32 after the load.
//
// An atlas row holds the 5x5x5 corner lattice of a 4-voxel brick (lane
// a*25+b*5+c, lanes 125-127 zero). The value at in-brick position (fx,fy,fz)
// is sum over lanes of row[lane] * hat(fx-a) * hat(fy-b) * hat(fz-c) with
// hat(t) = max(0, 1-|t|). The TPU kernel reduces all 128 lanes because the
// TPU has no dynamic lane indexing; here a thread reads only the 2x2x2 lanes
// whose hat weight can be non-zero, a in {a0, a0+1} with
// a0 = clamp(floor(fx), 0, 3). The weights stay in the hat form, so samples
// outside the box get the same clamped weights as the lane form (not linear
// extrapolation). The sum runs over 8 terms instead of 128, in another order,
// so results agree with the lane form to rounding, not bit for bit. A sample
// whose hat weights are all zero on some axis (far outside its brick, as a
// render's samples past the box are) has value 0 and loads no lane.
//
// What bounds each entry point on an H100 and what the design does about it
// (about 70 flops per sample: both are bound by memory, not arithmetic;
// measurements in PERF.md):
//
// * brick_interp(rows [P,128], frac [P,3]): every sample has its own row,
//   so the rows stream from device memory once (461 MB in float32 at the
//   r5b chunk of 900,096 samples), and the function needs only the 8 lanes
//   base+{0,1,5,6,25,26,30,31} of each, which lie in 2-5 of the row's 32-B
//   sectors in float32 and 1-3 in bfloat16. A block stages its frac slice
//   into shared memory with 16-B cp.async copies. Each thread handles 4
//   samples and issues all their loads (16-32) before it uses any. Each
//   (c0, c0+1) lane pair is one 16-B load of the aligned chunk holding lane
//   c0, plus a 4-B load when lane c0+1 starts the next chunk; the loads are
//   streaming (ld.global.nc.L1::no_allocate), since no row is read twice.
//   The bfloat16 rows halve the bytes.
// * sample_density_brick(atlas [B,128], xyz [P,3]): finds each sample's row
//   itself. The atlas (16.7 MB in float32 at r5b) fits in the 50 MB L2. A
//   render's samples are coherent (a ray's samples are a quarter voxel
//   apart, so a warp's 32 consecutive samples fall into 2-3 rows); random
//   points are not. Persistent warps walk over tiles of 64 consecutive
//   samples. A warp stages its tile's xyz into shared memory with 16-B
//   cp.async copies, and the next tile's while it gathers the current one.
//   For each of its 2 rounds of 32 samples, __match_any_sync groups the
//   lanes that share a row: a group of at least kShareMin (16) lanes has its
//   row copied once, whole and coalesced (512 B in float32, 256 B in
//   bfloat16), into a shared-memory slot of the warp (a row already staged
//   in an earlier round is not copied again) and reads its lanes there. The
//   other lanes, all of them on random points, gather their 8 lanes
//   directly with read-only loads, so random traffic keeps the direct path.
//   Both rounds' copies and gathers are issued before any is used. On the
//   H100 the L1 already merges a warp's loads of one row within each load
//   instruction, so the staging saves no bytes and costs a round trip: the
//   lower the threshold, the slower the kernel on the render's samples
//   (PERF.md).
// * sample_density_brick_span(atlas, xyz [S,T,3], W): the span form of the
//   JAX package's opt-in span gathers,
//   contrastive_lift_tpu/ops/fused_grid.py::sample_density_brick_span. The
//   T samples of a span (a sub-segment of one ray) lie along a line, so
//   their bricks form at most W runs, and the JAX function reads W atlas
//   rows a span instead of T. Here a warp takes min(32/T, 16/W) spans, T
//   lanes each; the first sample of each run copies the run's row whole
//   into shared memory with 16-B cp.async copies, and every sample reads its
//   8 corner lanes there, with the fused form's arithmetic: where no run is
//   clamped the values are the fused form's bit for bit. A span with more
//   brick changes than W-1 is clamped as JAX clamps it (its last run reads
//   the largest brick among its samples). Simple, not tuned: it moves whole
//   rows where the fused form moves 8 lanes a sample (PERF.md).
//
// Built by nvcc into a shared library with a plain C interface and bound with
// ctypes (contrastive_lift_tpu_torch/ops/brick_interp.py). Each entry point
// launches on the caller's stream and returns cudaGetLastError(). Row and
// atlas pointers must be 16-B aligned (both are read in 16-B chunks; the
// wrapper checks); frac and xyz may have any 4-B alignment (an unaligned
// slice is staged with scalar loads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// brick_interp: samples a thread handles, and a block's slice of them
constexpr int kSamplesPerThread = 4;
constexpr int kBlockSamples = kThreads * kSamplesPerThread;
// sample_density_brick: rounds of 32 samples in a warp's tile; lanes of a
// round that must share a row before the warp stages it whole; rows a warp
// can stage in one tile, so a staged group always finds a slot
constexpr int kRounds = 2;
constexpr int kTile = 32 * kRounds;
constexpr int kShareMin = 16;
constexpr int kRowSlots = kRounds * (32 / kShareMin);

// bfloat16 as its bits: the kernels only widen it to float32.
struct Bf16 {
  uint16_t bits;
};

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// Lowest lattice index whose hat weight can be non-zero, in [0, 3].
__device__ __forceinline__ int lattice_lo(float f) {
  return static_cast<int>(fminf(fmaxf(floorf(f), 0.0f), 3.0f));
}

// Lane offset of corner pair p (0..3) from lane a0*25+b0*5+c0: the pairs
// (c0, c0+1) at (a0,b0), (a0,b0+1), (a0+1,b0), (a0+1,b0+1).
__device__ __forceinline__ int pair_offset(int p) {
  return (p >> 1) * 25 + (p & 1) * 5;
}

// The sample's corner lattice position and its six hat weights.
struct Cell {
  int base;
  float wa[2], wb[2], wc[2];
};

__device__ __forceinline__ Cell cell_of(float fx, float fy, float fz) {
  const int a0 = lattice_lo(fx), b0 = lattice_lo(fy), c0 = lattice_lo(fz);
  Cell c;
  c.base = a0 * 25 + b0 * 5 + c0;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    c.wa[d] = hat(fx - static_cast<float>(a0 + d));
    c.wb[d] = hat(fy - static_cast<float>(b0 + d));
    c.wc[d] = hat(fz - static_cast<float>(c0 + d));
  }
  return c;
}

// Whether every axis has a corner with non-zero weight: if not, the value is
// 0 and no lane needs loading.
__device__ __forceinline__ bool has_weight(const Cell& c) {
  return (c.wa[0] != 0.0f || c.wa[1] != 0.0f) &&
         (c.wb[0] != 0.0f || c.wb[1] != 0.0f) &&
         (c.wc[0] != 0.0f || c.wc[1] != 0.0f);
}

// v[2p], v[2p+1]: the values at lanes base+pair_offset(p) and the next lane.
__device__ __forceinline__ float blend(const Cell& c, const float v[8]) {
  float acc = 0.0f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float w = c.wa[p >> 1] * c.wb[p & 1];
    acc += w * (c.wc[0] * v[2 * p] + c.wc[1] * v[2 * p + 1]);
  }
  return acc;
}

// ---- loads -----------------------------------------------------------------

// Streaming loads: read-only, and allocate nothing in L1.
__device__ __forceinline__ uint4 load16_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t load4_stream(const void* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Element l of a row in device memory, widened to float32 (read-only path).
template <typename T>
__device__ __forceinline__ float load_elem(const T* row, int l) {
  if constexpr (sizeof(T) == 4) {
    return __ldg(reinterpret_cast<const float*>(row) + l);
  } else {
    const unsigned short b =
        __ldg(reinterpret_cast<const unsigned short*>(row) + l);
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
}

// Element l of a row in shared memory, widened to float32.
template <typename T>
__device__ __forceinline__ float smem_elem(const T* row, int l) {
  if constexpr (sizeof(T) == 4) {
    return row[l];
  } else {
    return __uint_as_float(static_cast<uint32_t>(row[l].bits) << 16);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of this thread's newest copy groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Elements of type T in one 16-B chunk.
template <typename T>
constexpr int kChunkElems = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
}

// Element r of a 16-B chunk, widened to float32.
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4& v, int r) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word_of(v, r));
  } else {
    const uint32_t w = word_of(v, r >> 1);
    return __uint_as_float((r & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// The element at the start of a 4-B word, widened to float32.
template <typename T>
__device__ __forceinline__ float word_elem(uint32_t w) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else {
    return __uint_as_float(w << 16);
  }
}

// A sample's 8 corner values as loaded from device memory: for each pair,
// the 16-B chunk holding its first lane and, when the second lane starts
// the next chunk, the 4-B word holding that one.
struct PairChunks {
  uint4 chunk[4];
  uint32_t next[4];
};

template <typename T>
__device__ __forceinline__ void load_corners(const T* row, int base,
                                             PairChunks& c) {
  constexpr int kE = kChunkElems<T>;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int l = base + pair_offset(p);
    c.chunk[p] = load16_stream(row + (l & ~(kE - 1)));
    c.next[p] = 0u;
    if ((l & (kE - 1)) == kE - 1) c.next[p] = load4_stream(row + l + 1);
  }
}

template <typename T>
__device__ __forceinline__ void corner_values(const PairChunks& c, int base,
                                              float v[8]) {
  constexpr int kE = kChunkElems<T>;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = (base + pair_offset(p)) & (kE - 1);
    v[2 * p] = chunk_elem<T>(c.chunk[p], r);
    v[2 * p + 1] = r == kE - 1 ? word_elem<T>(c.next[p])
                               : chunk_elem<T>(c.chunk[p], r + 1);
  }
}

// Starts copying `count` floats from g to s, one 16-B cp.async copy per
// chunk from threads `first`, `first + step`, ..., when g is 16-B aligned;
// the rest, or all of it when g is not aligned, by scalar loads.
__device__ __forceinline__ void stage_floats(float* s, const float* g,
                                             int count, int first, int step) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15u) == 0u) {
    const int nvec = count >> 2;
    for (int v = first; v < nvec; v += step) cp_async16(s + 4 * v, g + 4 * v);
    done = 4 * nvec;
  }
  for (int e = done + first; e < count; e += step) s[e] = g[e];
}

// ---- brick_interp ------------------------------------------------------------

// Thread t of a block handles samples t, t+256, t+512, t+768 of the block's
// 1,024, so every load instruction of a warp covers 32 consecutive samples.
// A block's frac slice starts at a multiple of 12 KB, so it is 16-B aligned
// whenever the tensor is.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    brick_interp_kernel(const T* __restrict__ rows,
                        const float* __restrict__ frac,
                        float* __restrict__ out, int64_t n) {
  __shared__ __align__(16) float s_frac[3 * kBlockSamples];
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * kBlockSamples;
  const int nb = static_cast<int>(
      n - s0 < kBlockSamples ? n - s0 : static_cast<int64_t>(kBlockSamples));
  stage_floats(s_frac, frac + 3 * s0, 3 * nb, threadIdx.x, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  Cell cell[kSamplesPerThread];
  PairChunks chunks[kSamplesPerThread];
#pragma unroll
  for (int k = 0; k < kSamplesPerThread; ++k) {
    const int j = k * kThreads + threadIdx.x;
    chunks[k] = PairChunks{};
    if (j < nb) {
      cell[k] = cell_of(s_frac[3 * j], s_frac[3 * j + 1], s_frac[3 * j + 2]);
      if (has_weight(cell[k])) {
        load_corners<T>(rows + (s0 + j) * kLanes, cell[k].base, chunks[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSamplesPerThread; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (j < nb) {
      float v[8];
      corner_values<T>(chunks[k], cell[k].base, v);
      out[s0 + j] = blend(cell[k], v);
    }
  }
}

// ---- sample_density_brick ----------------------------------------------------

// Mirrors contrastive_lift_tpu/ops/fused_grid.py::_brick_coords: the
// sample's clamped cell picks the brick, f is the position inside it.
__device__ __forceinline__ int brick_row(const float g[3], int by, int bz,
                                         const float* q, float f[3]) {
  int brick[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p = (q[k] + 1.0f) * 0.5f * (g[k] - 1.0f);
    const float cell = fminf(fmaxf(floorf(p), 0.0f), g[k] - 2.0f);
    brick[k] = static_cast<int>(cell) / 4;
    f[k] = p - 4.0f * static_cast<float>(brick[k]);
  }
  return (brick[0] * by + brick[1]) * bz + brick[2];
}

// Samples of tile t (kTile per tile) that exist among n.
__device__ __forceinline__ int tile_size(int64_t t, int64_t n) {
  const int64_t left = n - t * kTile;
  return static_cast<int>(left < kTile ? left : static_cast<int64_t>(kTile));
}

// Each warp walks over tiles of kTile consecutive samples; lane l handles
// samples l and l+32 of a tile (one per round).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sample_density_brick_kernel(const T* __restrict__ atlas,
                                const float* __restrict__ xyz,
                                float* __restrict__ out, int64_t n, int gx,
                                int gy, int gz, float splus_shift) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kE = kChunkElems<T>;
  constexpr int kRowChunks = kLanes / kE;
  // a tile's xyz starts at a multiple of 768 B: 16-B aligned whenever the
  // tensor is
  __shared__ __align__(16) float s_xyz[kWarps][3 * kTile];
  __shared__ __align__(16) uint4 s_rows[kWarps][kRowSlots][kRowChunks];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* sx = s_xyz[warp];
  const float g[3] = {static_cast<float>(gx), static_cast<float>(gy),
                      static_cast<float>(gz)};
  const int by = (gy - 1 + 3) / 4;
  const int bz = (gz - 1 + 3) / 4;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (tile < n_tiles) {
    stage_floats(sx, xyz + 3 * tile * kTile, 3 * tile_size(tile, n), lane, 32);
  }
  cp_async_commit();

  for (; tile < n_tiles; tile += stride) {
    cp_async_wait<0>();
    __syncwarp();  // the tile's xyz is in shared memory, the slots are free
    const int nt = tile_size(tile, n);
    int row[kRounds];
    Cell cell[kRounds];
    bool live[kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int j = 32 * k + lane;
      float f[3] = {0.0f, 0.0f, 0.0f};
      row[k] = 0;
      if (j < nt) row[k] = brick_row(g, by, bz, sx + 3 * j, f);
      cell[k] = cell_of(f[0], f[1], f[2]);
      live[k] = j < nt && has_weight(cell[k]);
    }
    __syncwarp();  // every lane has read the tile's xyz

    // Stage the rows that kShareMin or more lanes of a round share; lane s
    // keeps the row held in slot s, `used` slots are taken (at most
    // 32 / kShareMin a round, so never more than kRowSlots).
    int slot_row = -1;
    int used = 0;
    int slot[kRounds];
    float v[kRounds][8];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      // lanes that need no row get keys that match nothing
      const int key = live[k] ? row[k] : -1 - lane;
      const unsigned peers = __match_any_sync(kAll, key);
      const bool shares = live[k] && __popc(peers) >= kShareMin;
      unsigned leaders =
          __ballot_sync(kAll, shares && lane == __ffs(peers) - 1);
      slot[k] = -1;
      while (leaders != 0u) {
        const int r = __shfl_sync(kAll, key, __ffs(leaders) - 1);
        leaders &= leaders - 1u;
        const unsigned held = __ballot_sync(kAll, slot_row == r);
        int s = __ffs(held) - 1;
        if (held == 0u) {
          s = used++;
          if (lane == s) slot_row = r;
          if (lane < kRowChunks) {
            cp_async16(&s_rows[warp][s][lane],
                       atlas + static_cast<int64_t>(r) * kLanes + lane * kE);
          }
        }
        if (shares && key == r) slot[k] = s;
      }
      if (live[k] && slot[k] < 0) {
        const T* src = atlas + static_cast<int64_t>(row[k]) * kLanes;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int l = cell[k].base + pair_offset(p);
          v[k][2 * p] = load_elem<T>(src, l);
          v[k][2 * p + 1] = load_elem<T>(src, l + 1);
        }
      }
    }
    cp_async_commit();
    // the next tile's xyz streams in while this tile's rows are used
    if (tile + stride < n_tiles) {
      stage_floats(sx, xyz + 3 * (tile + stride) * kTile,
                   3 * tile_size(tile + stride, n), lane, 32);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // the staged rows are in shared memory

#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int j = 32 * k + lane;
      if (j >= nt) continue;
      float value = 0.0f;
      if (live[k]) {
        if (slot[k] >= 0) {
          const T* srow = reinterpret_cast<const T*>(s_rows[warp][slot[k]]);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int l = cell[k].base + pair_offset(p);
            v[k][2 * p] = smem_elem<T>(srow, l);
            v[k][2 * p + 1] = smem_elem<T>(srow, l + 1);
          }
        }
        value = blend(cell[k], v[k]);
      }
      out[tile * kTile + j] = value + splus_shift;
    }
  }
  cp_async_wait<0>();
}

// ---- sample_density_brick_span -----------------------------------------------

// A warp handles min(32 / T, kSpanSlots / W) spans at once, T consecutive
// lanes per span, and stages up to W atlas rows for each of them.
constexpr int kSpanWarps = 4;
constexpr int kSpanThreads = 32 * kSpanWarps;
constexpr int kSpanSlots = 16;

// xyz [n_spans, T, 3] -> out [n_spans, T]: the T samples of a span lie
// consecutively along a ray, so their bricks form runs. Lane j of a span's
// lanes takes sample j: its run is the count of brick changes among samples
// 1..j, clamped to W-1 as in the JAX function; the first sample of each run
// copies the run's row (for the clamped last run, the largest brick among its
// samples, JAX's max) whole into the run's shared-memory slot, and every
// sample reads its 8 corner lanes there. A run that no sample starts is not
// copied and no sample reads its slot.
template <typename T>
__global__ void __launch_bounds__(kSpanThreads)
    sample_density_brick_span_kernel(const T* __restrict__ atlas,
                                     const float* __restrict__ xyz,
                                     float* __restrict__ out, int64_t n_spans,
                                     int span_len, int rows_per_span, int gx,
                                     int gy, int gz, float splus_shift) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kE = kChunkElems<T>;
  constexpr int kRowChunks = kLanes / kE;
  __shared__ __align__(16) uint4 s_rows[kSpanWarps][kSpanSlots][kLanes / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = rows_per_span;
  const int per_warp = min(32 / span_len, kSpanSlots / W);
  const int seg = lane / span_len;
  const int j = lane - seg * span_len;
  const bool in_seg = seg < per_warp;
  // the lanes of this lane's span
  const unsigned seg_lanes =
      !in_seg ? 0u
              : (span_len == 32 ? kAll
                                : ((1u << span_len) - 1u) << (seg * span_len));
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
  const float g[3] = {static_cast<float>(gx), static_cast<float>(gy),
                      static_cast<float>(gz)};
  const int by = (gy - 1 + 3) / 4;
  const int bz = (gz - 1 + 3) / 4;
  const int64_t n_groups = (n_spans + per_warp - 1) / per_warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSpanWarps;
  for (int64_t grp = static_cast<int64_t>(blockIdx.x) * kSpanWarps + warp;
       grp < n_groups; grp += stride) {
    const int64_t span = grp * per_warp + seg;
    const bool live = in_seg && span < n_spans;
    const int64_t s = span * span_len + j;
    float f[3] = {0.0f, 0.0f, 0.0f};
    int brick = -1;
    if (live) brick = brick_row(g, by, bz, xyz + 3 * s, f);
    const int prev = __shfl_up_sync(kAll, brick, 1);
    const bool moves = live && j > 0 && brick != prev;
    const int run_free = __popc(__ballot_sync(kAll, moves) & upto & seg_lanes);
    const int run = min(run_free, W - 1);
    // the largest brick among this and the later samples of the span that
    // fall in the last (clamped) run
    int top = (live && run == W - 1) ? brick : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(kAll, top, d);
      if (j + d < span_len) top = max(top, o);
    }
    const int slot = seg * W + run;
    const bool starts = live && (j == 0 || moves) && run_free < W;
    const int row = run_free == W - 1 ? top : brick;
    unsigned stagers = __ballot_sync(kAll, starts);
    while (stagers != 0u) {
      const int src = __ffs(stagers) - 1;
      stagers &= stagers - 1u;
      const int r = __shfl_sync(kAll, row, src);
      const int sl = __shfl_sync(kAll, slot, src);
      if (lane < kRowChunks) {
        cp_async16(&s_rows[warp][sl][lane],
                   atlas + static_cast<int64_t>(r) * kLanes + lane * kE);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();  // the staged rows are in shared memory
    if (live) {
      const Cell c = cell_of(f[0], f[1], f[2]);
      float value = 0.0f;
      if (has_weight(c)) {
        const T* srow = reinterpret_cast<const T*>(s_rows[warp][slot]);
        float v[8];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int l = c.base + pair_offset(p);
          v[2 * p] = smem_elem<T>(srow, l);
          v[2 * p + 1] = smem_elem<T>(srow, l + 1);
        }
        value = blend(c, v);
      }
      out[s] = value + splus_shift;
    }
    __syncwarp();  // every lane has read its slot before the next copies
  }
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kBlockSamples - 1) / kBlockSamples);
}

// At most `needed` blocks of `kernel` at `threads` a block: one wave of as
// many as the device keeps resident (found once per device into `cache`).
template <typename Kernel>
unsigned int resident_blocks(Kernel kernel, int threads, int64_t needed,
                             int (&cache)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = cache[dev & 63];
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cap = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return static_cast<unsigned int>(needed < cap ? needed : cap);
}

// Blocks of sample_density_brick_kernel<T> for n samples.
template <typename T>
unsigned int density_blocks(int64_t n) {
  static int cache[64] = {};
  return resident_blocks(sample_density_brick_kernel<T>, kThreads,
                         (n + kWarps * kTile - 1) / (kWarps * kTile), cache);
}

// Blocks of sample_density_brick_span_kernel<T> for n_groups warp groups.
template <typename T>
unsigned int span_blocks(int64_t n_groups) {
  static int cache[64] = {};
  return resident_blocks(sample_density_brick_span_kernel<T>, kSpanThreads,
                         (n_groups + kSpanWarps - 1) / kSpanWarps, cache);
}

}  // namespace

// rows_bf16: 0 for float32 rows, 1 for bfloat16 rows.
extern "C" int brick_interp_launch(const void* rows, int rows_bf16,
                                   const float* frac, float* out, int64_t n,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_bf16) {
    brick_interp_kernel<Bf16><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const Bf16*>(rows), frac, out, n);
  } else {
    brick_interp_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(rows), frac, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sample_density_brick_launch(const void* atlas, int atlas_bf16,
                                           const float* xyz, float* out,
                                           int64_t n, int gx, int gy, int gz,
                                           float splus_shift, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (atlas_bf16) {
    sample_density_brick_kernel<Bf16><<<density_blocks<Bf16>(n), kThreads, 0,
                                        s>>>(
        static_cast<const Bf16*>(atlas), xyz, out, n, gx, gy, gz, splus_shift);
  } else {
    sample_density_brick_kernel<float><<<density_blocks<float>(n), kThreads,
                                         0, s>>>(
        static_cast<const float*>(atlas), xyz, out, n, gx, gy, gz,
        splus_shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// xyz [n_spans, span_len, 3] -> out [n_spans, span_len]; span_len in
// [1, 32] and rows_per_span in [2, 16] (the wrapper checks).
extern "C" int sample_density_brick_span_launch(
    const void* atlas, int atlas_bf16, const float* xyz, float* out,
    int64_t n_spans, int span_len, int rows_per_span, int gx, int gy, int gz,
    float splus_shift, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_warp = (32 / span_len) < (kSpanSlots / rows_per_span)
                           ? 32 / span_len
                           : kSpanSlots / rows_per_span;
  const int64_t n_groups = (n_spans + per_warp - 1) / per_warp;
  if (atlas_bf16) {
    sample_density_brick_span_kernel<Bf16>
        <<<span_blocks<Bf16>(n_groups), kSpanThreads, 0, s>>>(
            static_cast<const Bf16*>(atlas), xyz, out, n_spans, span_len,
            rows_per_span, gx, gy, gz, splus_shift);
  } else {
    sample_density_brick_span_kernel<float>
        <<<span_blocks<float>(n_groups), kSpanThreads, 0, s>>>(
            static_cast<const float*>(atlas), xyz, out, n_spans, span_len,
            rows_per_span, gx, gy, gz, splus_shift);
  }
  return static_cast<int>(cudaGetLastError());
}
