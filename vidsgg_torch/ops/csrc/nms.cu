// Exact greedy NMS over many independent problems, one thread block each.
//
// Replaces the TPU kernel vidsgg/ops/pallas_nms.py:_nms_batch_kernel
// (wrapper nms_mask_pallas_batched). Contract, in ranked (score-descending,
// valid-first) order: box i is kept when it is valid and no kept box ranked
// before it has IoU (+1 areas) strictly greater than the threshold with it.
// With max_keep > 0 a problem stops at its max_keep-th keep or at its valid
// count, so exactly its first max_keep keeps are marked.
//
// What bounds it on an H100: not bytes. At the RPN call (16 problems x 6000
// boxes) it reads about 1.6 MB, under a microsecond at 3.35 TB/s. The limit
// is the serial scan: one __syncthreads per kept box, and only 16 of the 132
// SMs hold a block. The design keeps the whole problem (four coordinate
// rows, the areas, a suppression byte per box; 21 bytes a box, 126 KB at
// N = 6000) in dynamic shared memory, so after the first load the scan never
// touches device memory. A faster shape (a bitmask IoU pass over many
// blocks, then a warp-level scan) is later work.
//
// Bit-exactness with the plain PyTorch version and with vidsgg: IoU is
// computed in float32 in the reference order with explicit round-to-nearest
// intrinsics (no FMA contraction, IEEE division):
//   area  = (x2 - x1 + 1) * (y2 - y1 + 1)
//   iw    = min(x2, xi2) - max(x1, xi1) + 1   (ih likewise)
//   inter = max(iw, 0) * max(ih, 0)
//   iou   = inter / (area + area_i - inter)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
nms_scan_kernel(const float* __restrict__ boxes,          // [G, N, 4]
                const unsigned char* __restrict__ valid,  // [G, N]
                unsigned char* __restrict__ keep,         // [G, N]
                int n, float thresh, int max_keep) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + n;
  float* sx2 = sy1 + n;
  float* sy2 = sx2 + n;
  float* sarea = sy2 + n;
  unsigned char* sup = reinterpret_cast<unsigned char*>(sarea + n);
  __shared__ int s_valid_count;

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const float* b = boxes + base * 4;

  if (tid == 0) s_valid_count = 0;
  __syncthreads();

  int local_valid = 0;
  for (int j = tid; j < n; j += kThreads) {
    const float x1 = b[4 * j], y1 = b[4 * j + 1];
    const float x2 = b[4 * j + 2], y2 = b[4 * j + 3];
    sx1[j] = x1;
    sy1[j] = y1;
    sx2[j] = x2;
    sy2[j] = y2;
    sarea[j] = __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), 1.0f),
                         __fadd_rn(__fsub_rn(y2, y1), 1.0f));
    const bool v = valid[base + j] != 0;
    sup[j] = v ? 0 : 1;  // an invalid box is never kept
    keep[base + j] = 0;
    local_valid += v ? 1 : 0;
  }
  atomicAdd(&s_valid_count, local_valid);
  __syncthreads();
  const int valid_count = s_valid_count;

  int kept = 0;  // identical in every thread: all read the same sup[i]
  for (int i = 0; i < n; ++i) {
    if (max_keep > 0 && (kept >= max_keep || i >= valid_count)) break;
    // sup[i] was last written in an earlier kept step, before its barrier;
    // a skipped step writes nothing, so it needs no barrier of its own
    if (sup[i]) continue;
    ++kept;
    if (tid == 0) keep[base + i] = 1;
    const float xi1 = sx1[i], yi1 = sy1[i], xi2 = sx2[i], yi2 = sy2[i];
    const float ai = sarea[i];
    for (int j = i + 1 + tid; j < n; j += kThreads) {
      const float iw = __fadd_rn(__fsub_rn(fminf(sx2[j], xi2), fmaxf(sx1[j], xi1)), 1.0f);
      const float ih = __fadd_rn(__fsub_rn(fminf(sy2[j], yi2), fmaxf(sy1[j], yi1)), 1.0f);
      const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
      const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(sarea[j], ai), inter));
      if (iou > thresh) sup[j] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() as an int (0 = success).
// The caller keeps n within one block's shared memory (21 bytes a box).
int vidsgg_nms_launch(const float* boxes, const unsigned char* valid,
                      unsigned char* keep, int g, int n, float thresh,
                      int max_keep, void* stream) {
  const size_t smem = static_cast<size_t>(n) * (5 * sizeof(float) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<g, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, valid, keep, n, thresh, max_keep);
  return static_cast<int>(cudaGetLastError());
}

const char* vidsgg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
