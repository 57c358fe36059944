// Batched window ("patch") gather at per-window offsets, for up to kMaxJobs
// gathers (image, starts, window shape) in one launch.
//
// Replaces the Pallas TPU kernel gather_patches (opendlv_perception_vision_
// orbslam2_tpu/ops/gather_pallas.py).  For each job's N top-left corners
// (y0, x0), clipped in the kernel to [0, H-ph] x [0, W-pw] exactly as the
// Pallas wrapper clips them, it copies the [ph, pw] windows of one float32
// image [H, W] into out [N, ph, pw].
//
// Bound: bytes (it only copies).  At the ORB site it writes 4000 x 45 x 45
// x 4 B = 32.4 MB per stereo frame and reads the atlas rows the windows
// cover (~8.5 MB of the 15.6 MB two-eye atlas on a KITTI frame); the two
// stereo SAD gathers (11x11 and 11x21, N = 2048) write 2.9 MB.
//
// Design:
// - A job's output [N * ph * pw] floats is one flat array; each block owns
//   a contiguous span of it (kF4PerBlock float4s, 2048 floats) and each
//   thread writes whole float4s, 16-byte stores, fully coalesced.  Job
//   outputs start 16-byte aligned (the wrapper pads each to a multiple of
//   4 floats and fills the padding with zeros), so a span is aligned
//   whatever the window size (45 x 45 = 2025 floats is not).
// - A thread finds its first element's (window, row, column) with one
//   division by ph*pw and one by pw, then steps through its 4 elements with
//   compares.  The window shapes of the main path (45x45, 11x11, 11x21) are
//   template instances, so those divisions are multiply-shifts; any other
//   shape takes the runtime instance.
// - Reads go through the read-only path (__ldg); the atlas (15.6 MB) stays
//   in the 50 MB L2 and neighbouring windows share its lines.
// - One launch carries every job: the job table (pointers, N, H, W, ph, pw,
//   first block) is a kernel parameter, and a block maps its flat index to
//   its job.  The two SAD gathers are one launch.
// - No TMA: its 2-D tensor maps need 16-byte row strides (the 1285-float
//   ORB atlas row is not), and a tile load per window would be 45 rows of
//   180 B, no fewer transactions than these loads.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxJobs = 4;
constexpr int NT = 256;                // threads per block
constexpr int VEC = 2;                 // float4 stores per thread
constexpr int kF4PerBlock = NT * VEC;  // 2048 floats per block

struct Job {
  const float* img;
  const int* y0;
  const int* x0;
  float* out;
  int n, H, W, ph, pw, first;
};

struct Jobs {
  Job job[kMaxJobs];
  int n_jobs;
};

// Window n's first pixel, its start clipped into the image.
__device__ __forceinline__ const float* window(const Job& j, int ph, int pw, int n) {
  const int y = min(max(__ldg(j.y0 + n), 0), j.H - ph);
  const int x = min(max(__ldg(j.x0 + n), 0), j.W - pw);
  return j.img + (size_t)y * j.W + x;
}

// The 4 output elements of float4 q of job j; PH = PW = 0 reads the shape
// from the job.
template <int PH, int PW>
__device__ __forceinline__ void copy4(const Job& j, int q) {
  const int ph = PH ? PH : j.ph, pw = PW ? PW : j.pw;
  const int pp = ph * pw, total = j.n * pp, W = j.W;
  const int e = 4 * q;
  int n = e / pp;
  const int rem = e - n * pp;
  int r = rem / pw, c = rem - r * pw;
  const float* src = window(j, ph, pw, n);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = e + k < total ? __ldg(src + r * W + c) : 0.0f;
    if (++c == pw) {
      c = 0;
      if (++r == ph) {
        r = 0;
        if (++n < j.n) src = window(j, ph, pw, n);
      }
    }
  }
  reinterpret_cast<float4*>(j.out)[q] = make_float4(v[0], v[1], v[2], v[3]);
}

template <int PH, int PW>
__device__ __forceinline__ void copy_span(const Job& j, int span) {
  const int nq = (j.n * (PH ? PH : j.ph) * (PW ? PW : j.pw) + 3) / 4;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int q = span * kF4PerBlock + v * NT + threadIdx.x;
    if (q < nq) copy4<PH, PW>(j, q);
  }
}

__global__ void __launch_bounds__(NT)
gather_patches_kernel(const __grid_constant__ Jobs jobs) {
  const int flat = blockIdx.x;
  int k = 0;
  while (k + 1 < jobs.n_jobs && flat >= jobs.job[k + 1].first) ++k;
  const Job& j = jobs.job[k];
  const int span = flat - j.first;
  if (j.ph == 45 && j.pw == 45) {
    copy_span<45, 45>(j, span);
  } else if (j.ph == 11 && j.pw == 11) {
    copy_span<11, 11>(j, span);
  } else if (j.ph == 11 && j.pw == 21) {
    copy_span<11, 21>(j, span);
  } else {
    copy_span<0, 0>(j, span);
  }
}

}  // namespace

extern "C" {

// Floats of a job's output that one block writes (the wrapper's table
// assigns blocks with it).
int gather_block_floats() { return 4 * kF4PerBlock; }

// rows: n_jobs x 10 int64 (image, y0, x0, out pointers, N, H, W, ph, pw,
// first block); image [H, W] float32, y0/x0 [N] int32, out [>= N*ph*pw
// rounded up to 4] float32 16-byte aligned, all contiguous on the current
// device, with H >= ph and W >= pw.  n_blocks = the table's block count.
// Returns cudaGetLastError() after the launch (0 on success).
int gather_patches_launch(const long long* rows, int n_jobs, int n_blocks, void* stream) {
  if (n_jobs < 1 || n_jobs > kMaxJobs || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs;
  for (int k = 0; k < n_jobs; ++k) {
    const long long* r = rows + 10 * k;
    jobs.job[k] = Job{reinterpret_cast<const float*>(r[0]), reinterpret_cast<const int*>(r[1]),
                      reinterpret_cast<const int*>(r[2]), reinterpret_cast<float*>(r[3]),
                      static_cast<int>(r[4]), static_cast<int>(r[5]), static_cast<int>(r[6]),
                      static_cast<int>(r[7]), static_cast<int>(r[8]), static_cast<int>(r[9])};
  }
  jobs.n_jobs = n_jobs;
  gather_patches_kernel<<<n_blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
