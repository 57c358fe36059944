// Fused dense FAST-9/16 V-score + threshold + 3x3 non-max suppression over a
// whole image pyramid in one launch.
//
// Replaces the Pallas TPU kernel fast_nms (opendlv_perception_vision_
// orbslam2_tpu/ops/fast_pallas.py, body _fast_nms_kernel).  For every level
// of a pyramid (up to kMaxLevels levels, each a batch [B, H, W] float32, the
// two stereo eyes) it computes exactly
//     nms_scores(fast_score_map(img, threshold))
// of ops/fast.py over the WHOLE image: circle neighbours read with clamped
// (edge) indices like the plain chain's edge padding, and NMS neighbours
// outside the image count as -FLT_MAX like max_pool_3x3_same's padding.
// Subtract, negate, min and max are exact in float32, so the result equals
// the plain version bit for bit (up to the sign of a zero score).
//
// Bound: one read of each image and one write of each map, 8 B a pixel,
// ~23 MB for a KITTI stereo frame over 8 levels, ~7 us at 3.35 TB/s.  The
// operations this data needs are fewer than that takes: every pixel pays the
// compass test and the NMS (~21 operations), and only the pixels that pass
// the compass test (9-26 % on a rendered KITTI frame) pay the 9-arc tree
// (~95 operations a polarity).  So the kernel is bound by bytes; what it
// must avoid is launch count, idle SMs and work the answer does not need.
//
// Design:
// - One launch for all levels and eyes.  The per-level table (input and
//   output pointer, H, W, tiles across, tiles per image, first flat tile)
//   travels in the kernel's parameters; a block maps its flat index to
//   (level, eye, tile).  The largest level comes first, the small levels
//   fill the tail of the grid.
// - A block of 256 threads owns a 32 x 62 output tile.  It stages the image
//   tile with a 4-px halo (3 for the circle, 1 for the NMS ring) in shared
//   memory, with clamped reads; the score tile with its one-pixel NMS ring
//   is 34 x 64, 9.7 % more positions than outputs (a 32 x 8 tile scores
//   33 % more).  The 64-wide score row is two passes of a warp, so the
//   loops walk rows and columns with no division and test the image
//   bounds once per row and column.
// - Exact early-out, FAST's compass test (ops/fast.py::compass_test): a
//   polarity's 9-arc minimum exceeds the threshold only if all 9 d_i of an
//   arc do, and any 9 consecutive circle points hold at least 2 of the
//   compass points 0/4/8/12.  A polarity with fewer than 2 compass points
//   above the threshold therefore scores <= threshold, and a position that
//   fails for both scores 0.  The test is 8 min/max and 2 compares: "at
//   least 2 of 4 above" is "the second largest above".
// - The candidates are compacted with a warp ballot and a prefix count, so a
//   warp runs the tree on 32 candidates, not on 32 neighbours of which a few
//   pass.  Each warp fills its own segment of a shared list with the
//   positions of its own score rows (no atomics, no block barrier between
//   test and tree): candidates of one polarity from the front, of both from
//   the back.  The warp then runs the tree on its entries (both trees for
//   the few two-polarity entries, which come last), so the two results of a
//   position meet in one thread.
// - NMS reads the score tile from shared memory: each thread walks 8 rows
//   of one column, keeping the 3-wide row maxima in registers.
// - TMA and wgmma have no role here: a TMA tile load fills out-of-range
//   elements with zeros, but this function needs clamped (edge) reads at
//   the image border, and there is no matrix product.  The staging reads
//   are plain coalesced loads; they hit L2 for the overlapping halos.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int TW = 62;              // output tile width: the score tile is 64 wide
constexpr int TH = 32;              // output tile height
constexpr int NT = 256;             // threads per block
constexpr int NW = NT / 32;         // warps per block
constexpr int HALO = 4;             // 3 (circle radius) + 1 (NMS ring)
constexpr int IW = TW + 2 * HALO;   // staged image tile, 70 x 40
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 2;          // score tile: output tile + NMS ring, 64 x 34
constexpr int SH = TH + 2;
constexpr int SN = SW * SH;
constexpr int NMS_ROWS = TH / (NT / SW);  // rows per thread in the NMS pass
static_assert(SW == 64, "a warp row pass covers 32 columns, two of them a score row");
static_assert(NT % SW == 0 && TH % (NT / SW) == 0, "NMS pass layout");

struct Level {
  const float* in;
  float* out;
  int H, W, tiles_x, tiles_per_image, first;
};

struct Table {
  Level lv[kMaxLevels];
  int n_levels;
  float threshold;
};

// Best circular 9-arc min of e[0..15]: pairwise-min doubling (2, 4, 8
// points), one more point, then the max over the 16 arcs; the same values
// as ops/fast.py::_arc_response.
__device__ __forceinline__ float arc_response(const float (&e)[16]) {
  float p2[16], p4[16], p8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p2[i] = fminf(e[i], e[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) p4[i] = fminf(p2[i], p2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) p8[i] = fminf(p4[i], p4[(i + 4) & 15]);
  float out = fminf(p8[0], e[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) out = fmaxf(out, fminf(p8[i], e[(i + 8) & 15]));
  return out;
}

// Arc response at the staged pixel p (row stride IW) of e_i = sign * (p_i -
// c) over CIRCLE16 of ops/fast.py: sign = +1 is the bright polarity, -1 the
// dark one.  fmaf(sign, p_i, -sign * c) rounds sign * (p_i - c) once, and
// round-to-nearest is symmetric, so it equals the plain chain's d_i or -d_i
// exactly.
__device__ __forceinline__ float polarity_response(const float* p, float sign) {
  const float nc = -sign * p[0];
  float e[16];
#define FAST_CIRCLE(k, dy, dx) e[k] = fmaf(sign, p[(dy) * IW + (dx)], nc);
  FAST_CIRCLE(0, -3, 0)  FAST_CIRCLE(1, -3, 1)   FAST_CIRCLE(2, -2, 2)   FAST_CIRCLE(3, -1, 3)
  FAST_CIRCLE(4, 0, 3)   FAST_CIRCLE(5, 1, 3)    FAST_CIRCLE(6, 2, 2)    FAST_CIRCLE(7, 3, 1)
  FAST_CIRCLE(8, 3, 0)   FAST_CIRCLE(9, 3, -1)   FAST_CIRCLE(10, 2, -2)  FAST_CIRCLE(11, 1, -3)
  FAST_CIRCLE(12, 0, -3) FAST_CIRCLE(13, -1, -3) FAST_CIRCLE(14, -2, -2) FAST_CIRCLE(15, -3, -1)
#undef FAST_CIRCLE
  return arc_response(e);
}

constexpr int ROWS_W = (SH + NW - 1) / NW;       // score rows a warp takes at most
constexpr int SEG = ROWS_W * SW;                 // list entries per warp
constexpr unsigned short BRIGHT = 1u << 14, DARK = 1u << 15, POS = BRIGHT - 1u;
static_assert(SN <= POS, "a list entry keeps its position in 14 bits");

__global__ void __launch_bounds__(NT)
fast_nms_pyramid_kernel(const __grid_constant__ Table table) {
  __shared__ float tile[IH * IW];
  __shared__ float score[SN];
  __shared__ unsigned short list[NW * SEG];

  // flat tile index -> (level, eye, tile origin)
  const int flat = blockIdx.x;
  int l = 0;
  while (l + 1 < table.n_levels && flat >= table.lv[l + 1].first) ++l;
  const Level& lv = table.lv[l];
  const int H = lv.H, W = lv.W;
  const int t = flat - lv.first;
  const int eye = t / lv.tiles_per_image;
  const int rem = t - eye * lv.tiles_per_image;
  const int ty = rem / lv.tiles_x;
  const int y0 = ty * TH, x0 = (rem - ty * lv.tiles_x) * TW;
  const float* src = lv.in + (size_t)eye * H * W;
  float* dst = lv.out + (size_t)eye * H * W;
  const float th = table.threshold;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. Stage the image tile with its halo, clamped (edge) indices: warp w
  //    takes rows w, w + 8, ..., its lanes columns lane, lane + 32, lane + 64.
  //    All of a thread's loads are issued before its shared stores, so a
  //    block waits for one load latency, not for one per row in turn.
  constexpr int SROWS = (IH + NW - 1) / NW, SCOLS = (IW + 31) / 32;
  int gxs[SCOLS];
#pragma unroll
  for (int c = 0; c < SCOLS; ++c) gxs[c] = min(max(x0 - HALO + lane + 32 * c, 0), W - 1);
  float staged[SROWS][SCOLS];
#pragma unroll
  for (int r = 0; r < SROWS; ++r) {
    const int row = warp + NW * r;
    const float* src_row = src + (size_t)min(max(y0 - HALO + row, 0), H - 1) * W;
#pragma unroll
    for (int c = 0; c < SCOLS; ++c) {
      if (row < IH && lane + 32 * c < IW) staged[r][c] = __ldg(src_row + gxs[c]);
    }
  }
#pragma unroll
  for (int r = 0; r < SROWS; ++r) {
#pragma unroll
    for (int c = 0; c < SCOLS; ++c) {
      const int row = warp + NW * r;
      if (row < IH && lane + 32 * c < IW) tile[row * IW + lane + 32 * c] = staged[r][c];
    }
  }
  __syncthreads();

  // 2. Compass test on every position of the score tile: warp w takes rows
  //    sy = w, w + 8, ..., its lanes columns sx = lane and lane + 32.
  //    Position (sy, sx) is image pixel (y0 - 1 + sy, x0 - 1 + sx) and
  //    staged pixel (sy + 3, sx + 3).  "At least 2 of the 4 compass d_i >
  //    th" is "the second largest of them > th" (bright); for -d_i, "minus
  //    the second smallest > th" (dark).  Each warp compacts its own
  //    positions into its own list segment (no atomics): single-polarity
  //    candidates from the front, the candidates of both polarities from the
  //    back.  A position starts at 0 in the image and at -FLT_MAX outside
  //    (max_pool's finfo.min padding).
  int c1 = 0, c2 = 0;
  const unsigned below = (1u << lane) - 1u;
  bool col_in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) col_in[h] = unsigned(x0 - 1 + lane + 32 * h) < unsigned(W);
  for (int sy = warp; sy < SH; sy += NW) {
    const bool row_in = unsigned(y0 - 1 + sy) < unsigned(H);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sx = lane + 32 * h, i = sy * SW + sx;
      const bool in = row_in && col_in[h];
      bool bright = false, dark = false;
      if (in) {
        const float* p = tile + (sy + 3) * IW + sx + 3;
        const float c = p[0];
        const float d0 = p[-3 * IW] - c, d4 = p[3] - c, d8 = p[3 * IW] - c, d12 = p[-3] - c;
        const float lo = fmaxf(fminf(d0, d4), fminf(d8, d12));
        const float hi = fminf(fmaxf(d0, d4), fmaxf(d8, d12));
        bright = fmaxf(lo, hi) > th;     // second largest
        dark = -fminf(lo, hi) > th;      // minus the second smallest
      }
      score[i] = in ? 0.0f : -FLT_MAX;
      const unsigned m1 = __ballot_sync(0xffffffffu, bright != dark);
      const unsigned m2 = __ballot_sync(0xffffffffu, bright && dark);
      const unsigned short tag = (bright ? BRIGHT : 0) | (dark ? DARK : 0) | i;
      if (bright != dark) list[warp * SEG + c1 + __popc(m1 & below)] = tag;
      if (bright && dark) list[(warp + 1) * SEG - 1 - c2 - __popc(m2 & below)] = tag;
      c1 += __popc(m1);
      c2 += __popc(m2);
    }
  }
  __syncwarp();

  // 3. The 9-arc tree on the warp's own candidates (its rows' positions, so
  //    no other warp reads or writes them before the NMS): the
  //    single-polarity entries run one tree, then the two-polarity ones
  //    both.  The score is the plain chain's: v = max of the polarities,
  //    kept where v > th; a polarity that failed the compass test is <= th
  //    and cannot change it.
  for (int j = lane; j < c1 + c2; j += 32) {
    const unsigned short e =
        j < c1 ? list[warp * SEG + j] : list[(warp + 1) * SEG - 1 - (j - c1)];
    const int i = e & POS;
    const float* p = tile + ((i / SW) + 3) * IW + (i % SW) + 3;
    // one tree instance (a second would double the registers and halve the
    // blocks an SM holds); two-polarity entries go round twice
    const int n_pol = (e & BRIGHT) && (e & DARK) ? 2 : 1;
    float sign = (e & BRIGHT) ? 1.0f : -1.0f, v = -FLT_MAX;
#pragma unroll 1
    for (int k = 0; k < n_pol; ++k, sign = -sign) v = fmaxf(v, polarity_response(p, sign));
    if (v > th) score[i] = v;
  }
  __syncthreads();

  // 4. 3x3 NMS (keep the score where it is >= all 8 neighbours): thread
  //    (column ox, band) walks NMS_ROWS output rows with the 3-wide row
  //    maxima of the score tile in registers.
  const int ox = tid % SW, oy0 = (tid / SW) * NMS_ROWS;
  const int gx = x0 + ox;
  if (ox < TW && gx < W) {
    const float* col = score + oy0 * SW + ox;  // the row above output row oy0
    auto row_max = [&](int r) {
      const float* q = col + r * SW;
      return fmaxf(fmaxf(q[0], q[1]), q[2]);
    };
    float up = row_max(0), mid = row_max(1);
#pragma unroll
    for (int r = 0; r < NMS_ROWS; ++r) {
      const float down = row_max(r + 2);
      const int gy = y0 + oy0 + r;
      if (gy < H) {
        const float s = col[(r + 1) * SW + 1];
        const float best = fmaxf(fmaxf(up, mid), down);
        dst[(size_t)gy * W + gx] = s >= best ? s : 0.0f;
      }
      up = mid;
      mid = down;
    }
  }
}

}  // namespace

extern "C" {

// The output tile the launch table is cut into (the wrapper checks it).
void fast_nms_tile(int* tile_h, int* tile_w) {
  *tile_h = TH;
  *tile_w = TW;
}

// rows: n_levels x 7 int64 (input pointer, output pointer, H, W, tiles
// across, tiles per image, first flat tile), images [B, H, W] float32
// contiguous on the current device; n_blocks = the flat tile count.
// Returns cudaGetLastError() after the launch (0 on success).
int fast_nms_pyramid_launch(const long long* rows, int n_levels, int n_blocks,
                            float threshold, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Table table;
  for (int l = 0; l < n_levels; ++l) {
    const long long* r = rows + 7 * l;
    table.lv[l] = Level{reinterpret_cast<const float*>(r[0]), reinterpret_cast<float*>(r[1]),
                        static_cast<int>(r[2]), static_cast<int>(r[3]), static_cast<int>(r[4]),
                        static_cast<int>(r[5]), static_cast<int>(r[6])};
  }
  table.n_levels = n_levels;
  table.threshold = threshold;
  fast_nms_pyramid_kernel<<<n_blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
