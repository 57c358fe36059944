// Fused dense FAST-9/16 V-score + threshold + 3x3 non-max suppression.
//
// Replaces the Pallas TPU kernel fast_nms (opendlv_perception_vision_
// orbslam2_tpu/ops/fast_pallas.py, body _fast_nms_kernel).  Computes, for a
// batch of B images [B, H, W] float32 (the two stereo eyes of one pyramid
// level in one launch, blockIdx.z = image), exactly
//     nms_scores(fast_score_map(img, threshold))
// of ops/fast.py over the WHOLE image: circle neighbours read with clamped
// (edge) indices like the plain chain's edge padding, and NMS neighbours
// outside the image count as -FLT_MAX like max_pool_3x3_same's padding.
// The op tree is the plain chain's (subtract, negate, min/max), all exact in
// float32, so the result equals the plain version bit for bit.
//
// Bound: its memory traffic is one read of the image and one write of the
// score map, 8 B per pixel: ~2 x 1.44 Mpx x 8 B = ~23 MB per KITTI stereo
// frame over 8 levels, which the card moves in ~7 us.  The ~300 subtract /
// min / max per pixel (the V-score tree for both polarities, recomputed on
// the one-pixel NMS ring) take longer, so on an H100 the kernel is bound by
// ALU throughput and launch latency, not by bytes.  Design: one thread per
// output pixel; a 32x8 block stages a (8+8)x(32+8) tile of the image (4-px
// halo: 3 for the circle + 1 for NMS) in shared memory, computes the V-score
// on the tile plus one ring into a second shared tile, then each thread does
// its 3x3 NMS from shared memory.  No intermediate leaves registers/shared.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;   // output tile width (one warp per row)
constexpr int TY = 8;    // output tile height
constexpr int HALO = 4;  // 3 (circle radius) + 1 (NMS ring)
constexpr int IW = TX + 2 * HALO;
constexpr int IH = TY + 2 * HALO;
constexpr int SW = TX + 2;  // score tile: output tile + one NMS ring
constexpr int SH = TY + 2;

// CIRCLE16 of ops/fast.py, (dy, dx) in circular order.
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// Best circular 9-arc: prefix-min doubling tree (p2, p4, p8, w9), then the
// max over the 16 arcs — the same tree as ops/fast.py::_arc_response.
__device__ __forceinline__ float arc_response(const float (&d)[16]) {
  float p2[16], p4[16], p8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) p2[i] = fminf(d[i], d[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) p4[i] = fminf(p2[i], p2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) p8[i] = fminf(p4[i], p4[(i + 4) & 15]);
  float out = fminf(p8[0], d[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) out = fmaxf(out, fminf(p8[i], d[(i + 8) & 15]));
  return out;
}

__global__ void __launch_bounds__(TX * TY)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, float threshold) {
  __shared__ float tile[IH][IW];
  __shared__ float score[SH][SW];

  const int b = blockIdx.z;
  const float* src = img + (size_t)b * H * W;
  float* dst = out + (size_t)b * H * W;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // Stage the image tile with a 4-px halo, clamped (edge) indices.
  for (int i = tid; i < IH * IW; i += TX * TY) {
    const int ty = i / IW, tx = i % IW;
    const int gy = min(max(y0 - HALO + ty, 0), H - 1);
    const int gx = min(max(x0 - HALO + tx, 0), W - 1);
    tile[ty][tx] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // V-score, thresholded, on the output tile plus one ring.
  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float s = -FLT_MAX;  // outside the image: max_pool's finfo.min padding
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int cy = sy + HALO - 1, cx = sx + HALO - 1;  // tile coords
      const float c = tile[cy][cx];
      float d[16], nd[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        d[k] = tile[cy + kCircleDy[k]][cx + kCircleDx[k]] - c;
        nd[k] = -d[k];
      }
      const float v = fmaxf(arc_response(d), arc_response(nd));
      s = v > threshold ? v : 0.0f;
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  // 3x3 NMS: keep the score where it is >= all 8 neighbours.
  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx < W && gy < H) {
    const int sy = threadIdx.y + 1, sx = threadIdx.x + 1;
    const float s = score[sy][sx];
    float best = s;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) best = fmaxf(best, score[sy + dy][sx + dx]);
    dst[(size_t)gy * W + gx] = s >= best ? s : 0.0f;
  }
}

}  // namespace

extern "C" {

// img, out: [B, H, W] float32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch (0 on success).
int fast_nms_launch(const float* img, float* out, int B, int H, int W,
                    float threshold, void* stream) {
  const dim3 block(TX, TY, 1);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
