// Edge-clamped 40x40 patch gather around ORB keypoints, for Hopper (sm_90a).
//
// Replaces the TPU kernel orbslam3_cpp_fork_tpu/ops/patches.py:_patch_kernel
// (pallas_call in _extract_patches_tpu), which extract_patches_dual reaches
// once per pyramid level per frame. It computes, for N keypoints (x, y) on
// one level and for one or two same-shape images (the raw level for the
// IC angle and its blurred copy for BRIEF):
//
//   out[g, n, r, c] = img_g[clamp(y_n + r - 19, 0, h-1), clamp(x_n + c - 19, 0, w-1)]
//
// with (x_n, y_n) first clipped into the image. The TPU kernel read an
// edge-padded, vertically stacked copy of the two images through a 48x256
// tile-aligned load, an 8-way row select and a lane roll; those exist only
// for Mosaic's (8, 128) tiling. Here the read coordinates are clamped in
// the kernel, so neither a padded nor a stacked image is ever built.
//
// Mapping: grid (ceil(N / KP_PER_BLOCK), n_images); a block of 40 x 8
// threads walks KP_PER_BLOCK keypoints of one image. Thread x is the patch
// column, so a warp writes consecutive floats of a patch row (and the next
// row, which follows it in memory): stores are coalesced, and reads are
// runs of 40 floats along an image row.
//
// What bounds it on this card: at 752x480 with 1000 features a frame
// writes 2 x 1247 x 1600 x 4 B ~= 16 MB of patches in 8 launches (one per
// level), about 5 us of HBM bandwidth at 3.35 TB/s, so each launch is
// dominated by launch latency, not by bytes. The extractor no longer
// takes this route: orb_describe.cu does all 8 levels in one launch with
// the IC moments and the BRIEF compares fused in, so that no patch tensor
// reaches HBM at all. This kernel stays as the counterpart of the
// reference's extract_patches and extract_patches_dual.

#include <cuda_runtime.h>

namespace {

constexpr int kRad = 19;
constexpr int kPatch = 40;
constexpr int kRowsPerPass = 8;
constexpr int kKpPerBlock = 4;

__global__ void patch_gather_kernel(const float* __restrict__ img_a,
                                    const float* __restrict__ img_b,
                                    const int* __restrict__ xy,
                                    float* __restrict__ out, int n, int h,
                                    int w) {
  const float* __restrict__ img = blockIdx.y == 0 ? img_a : img_b;
  float* __restrict__ dst =
      out + static_cast<size_t>(blockIdx.y) * n * kPatch * kPatch;
  const int c = threadIdx.x;
  for (int k = 0; k < kKpPerBlock; ++k) {
    const int i = blockIdx.x * kKpPerBlock + k;
    if (i >= n) return;
    const int x = min(max(xy[2 * i], 0), w - 1);
    const int y = min(max(xy[2 * i + 1], 0), h - 1);
    const int xx = min(max(x + c - kRad, 0), w - 1);
    float* __restrict__ p = dst + static_cast<size_t>(i) * kPatch * kPatch;
    for (int r = threadIdx.y; r < kPatch; r += kRowsPerPass) {
      const int yy = min(max(y + r - kRad, 0), h - 1);
      p[r * kPatch + c] = __ldg(img + static_cast<size_t>(yy) * w + xx);
    }
  }
}

}  // namespace

// img_a, img_b: contiguous f32 (h, w) on the device (img_b is read only
// when n_images == 2); xy: contiguous int32 (n, 2) as (x, y); out:
// contiguous f32 (n_images, n, 40, 40). Launches on `stream` and returns
// the launch's cudaError_t (0 on success). Does not synchronise.
extern "C" int patch_gather(const float* img_a, const float* img_b,
                            const int* xy, float* out, int n, int h, int w,
                            int n_images, void* stream) {
  if (n <= 0) return 0;
  if (n_images < 1 || n_images > 2 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kPatch, kRowsPerPass);
  const dim3 grid((n + kKpPerBlock - 1) / kKpPerBlock, n_images);
  patch_gather_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img_a, img_b, xy, out, n, h, w);
  return static_cast<int>(cudaGetLastError());
}
