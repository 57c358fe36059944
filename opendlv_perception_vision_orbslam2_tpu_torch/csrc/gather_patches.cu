// Batched window ("patch") gather at per-window offsets.
//
// Replaces the Pallas TPU kernel gather_patches (opendlv_perception_vision_
// orbslam2_tpu/ops/gather_pallas.py).  For N top-left corners (y0, x0),
// clipped in the kernel to [0, H-ph] x [0, W-pw] exactly as the Pallas
// wrapper clips them, it copies the [ph, pw] windows of one float32 image
// [H, W] into out [N, ph, pw].
//
// Bound: memory traffic (it only copies).  At the ORB operating point it
// writes 4000 x 45 x 45 x 4 B = ~32 MB per stereo frame and reads the same
// from L2/HBM; the two SAD gathers add 2048 x (121 + 231) x 4 B = ~2.9 MB.
// Design: one block per window, threads walk the window in row-major order
// so neighbouring threads touch neighbouring columns (coalesced reads within
// a row, fully contiguous writes).  The TPU kernel's aligned-load-and-roll
// trick and its VMEM residency have no counterpart here: the image stays in
// device memory and L2 serves the overlapping windows.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const float* __restrict__ img, const int* __restrict__ y0,
                      const int* __restrict__ x0, float* __restrict__ out,
                      int H, int W, int ph, int pw) {
  const int n = blockIdx.x;
  const int y = min(max(y0[n], 0), H - ph);
  const int x = min(max(x0[n], 0), W - pw);
  const float* src = img + (size_t)y * W + x;
  float* dst = out + (size_t)n * ph * pw;
  for (int i = threadIdx.x; i < ph * pw; i += THREADS) {
    const int r = i / pw, c = i - r * pw;
    dst[i] = src[(size_t)r * W + c];
  }
}

}  // namespace

extern "C" {

// img [H, W] float32, y0/x0 [N] int32, out [N, ph, pw] float32; all
// contiguous on the current device, with H >= ph and W >= pw.
// Returns cudaGetLastError() after the launch (0 on success).
int gather_patches_launch(const float* img, const int* y0, const int* x0,
                          float* out, int N, int H, int W, int ph, int pw,
                          void* stream) {
  if (N > 0) {
    gather_patches_kernel<<<N, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        img, y0, x0, out, H, W, ph, pw);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
