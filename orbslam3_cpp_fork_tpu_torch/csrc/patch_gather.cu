// Edge-clamped 40x40 patch gather around ORB keypoints, for Hopper (sm_90a):
// every pyramid level in one launch.
//
// Replaces the TPU kernel orbslam3_cpp_fork_tpu/ops/patches.py:_patch_kernel
// (pallas_call in _extract_patches_tpu), which extract_patches_dual reaches
// once per pyramid level per frame. It computes, for the keypoints (x, y) of
// every level and for one or two images of that level (the raw level for
// the IC angle and its blurred copy for BRIEF):
//
//   out[g, i, r, c] = img_g[clamp(y_i + r - 19, 0, h-1), clamp(x_i + c - 19, 0, w-1)]
//
// with (x_i, y_i) first clipped into the image of keypoint i's level. The
// TPU kernel read an edge-padded, vertically stacked copy of the two images
// through a 48x256 tile-aligned load, an 8-way row select and a lane roll;
// those exist only for Mosaic's (8, 128) tiling. Here the read coordinates
// are clamped in the kernel, so neither a padded nor a stacked image is
// ever built. A TMA tile load cannot do the reads: it fills out-of-bounds
// elements with zeros, not with the clamped edge value.
//
// Mapping: one block of 128 threads per keypoint, all levels in one grid.
// The block finds its level from the start offsets of the level table
// (passed by value as a launch argument, as in orb_describe.cu: nothing is
// uploaded, and the launch can be captured in a CUDA graph). A patch is
// 6,400 contiguous bytes at a 16-byte-aligned offset, 400 float4 of 4
// neighbouring columns of one row. Each thread owns up to 7 of the 800
// float4 of both images' windows: it issues all their clamped scalar
// reads (up to 28) before its first store, then writes each as one 16-byte
// store, so a warp writes 512 contiguous bytes at a time.
//
// What bounds it on this card: bytes. At 752x480 with 1000 features a
// frame reads both 8-level pyramids once (~8.9 MB) and writes 2 x 1247 x
// 6,400 B ~= 16 MB of patches: 24.9 MB, 7.4 us at 3.35 TB/s. The 1247
// blocks of a frame fit in one wave (16 blocks of 128 threads an SM on
// 132 SMs), so latency is paid once a frame instead of once a level (the
// earlier design: 8 launches of 40x8-thread blocks that walked 4
// keypoints each, one load->store pass after another, 36.6 us of device
// time a frame). The extractor's main path does not take this route:
// orb_describe.cu keeps every window inside its block, so no patch
// tensor reaches HBM at all. This kernel is the counterpart of the
// reference's extract_patches and extract_patches_dual.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kRad = 19;
constexpr int kPatch = 40;
constexpr int kVecPerRow = kPatch / 4;
constexpr int kVecPerPatch = kPatch * kVecPerRow;  // 400 float4 a window
constexpr int kThreads = 128;
constexpr int kMaxVecPerThread = (2 * kVecPerPatch + kThreads - 1) / kThreads;  // 7

}  // namespace

// Mirrors ops/_kernels.py:LevelTable field for field (the table of
// orb_describe.cu): the gather reads raw[l] as image 0 and blur[l] as
// image 1.
struct LevelTable {
  const float* raw[kMaxLevels];
  const float* blur[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels + 1];  // keypoints of level l are [start[l], start[l+1])
  int n_levels;
};

namespace {

__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(const LevelTable t, const int* __restrict__ xy,
                    float4* __restrict__ out, int m, int n_images,
                    unsigned long long* __restrict__ counter) {
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  if (i == 0 && tid == 0) atomicAdd(counter, 1ULL);

  int l = 0;
  while (l + 1 < t.n_levels && i >= t.start[l + 1]) ++l;
  const int h = t.h[l];
  const int w = t.w[l];
  // The keypoint is clipped into the image first, then every read.
  const int x = min(max(__ldg(xy + 2 * i), 0), w - 1);
  const int y = min(max(__ldg(xy + 2 * i + 1), 0), h - 1);
  const int n_vec = n_images * kVecPerPatch;

  float4 v[kMaxVecPerThread];
#pragma unroll
  for (int j = 0; j < kMaxVecPerThread; ++j) {
    const int q = tid + j * kThreads;
    if (q < n_vec) {
      const int g = q / kVecPerPatch;
      const int p = q - g * kVecPerPatch;
      const int r = p / kVecPerRow;
      const int c = (p - r * kVecPerRow) * 4;
      const float* __restrict__ row =
          (g == 0 ? t.raw[l] : t.blur[l]) +
          static_cast<size_t>(min(max(y + r - kRad, 0), h - 1)) * w;
      const int x0 = x + c - kRad;
      v[j].x = __ldg(row + min(max(x0, 0), w - 1));
      v[j].y = __ldg(row + min(max(x0 + 1, 0), w - 1));
      v[j].z = __ldg(row + min(max(x0 + 2, 0), w - 1));
      v[j].w = __ldg(row + min(max(x0 + 3, 0), w - 1));
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxVecPerThread; ++j) {
    const int q = tid + j * kThreads;
    if (q < n_vec) {
      const int g = q / kVecPerPatch;
      const int p = q - g * kVecPerPatch;
      out[(static_cast<size_t>(g) * m + i) * kVecPerPatch + p] = v[j];
    }
  }
}

}  // namespace

// table: host pointer to the level table (copied into the launch's
// arguments); every level image is contiguous f32 (h, w) on the device
// (blur[l] is read only when n_images == 2). xy: contiguous int32 (m, 2) as
// (x, y), levels concatenated in order. out: contiguous f32 (n_images, m,
// 40, 40), 16-byte aligned. counter: one uint64 on the device, which the
// first thread of the grid adds one to. Launches on `stream` and returns
// the launch's cudaError_t (0 on success). Does not synchronise.
extern "C" int patch_gather(const LevelTable* table, const int* xy, float* out,
                            unsigned long long* counter, int m, int n_images,
                            void* stream) {
  if (m <= 0) return 0;
  if (n_images < 1 || n_images > 2 || table->n_levels < 1 ||
      table->n_levels > kMaxLevels || table->start[table->n_levels] != m ||
      reinterpret_cast<size_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < table->n_levels; ++l) {
    if (table->start[l + 1] > table->start[l] &&
        (table->h[l] <= 0 || table->w[l] <= 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  patch_gather_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, xy, reinterpret_cast<float4*>(out), m, n_images, counter);
  return static_cast<int>(cudaGetLastError());
}
