// Per-ray BVH traversal: closest hit and any hit, one thread per ray.
//
// Same contract as the XLA traversal in device/intersect.py (_traverse):
//   nodes (N, 12) f32  rows of scene.bvh: lo xyz, hi xyz, offset, n_prims,
//                      axis, pad. Depth-first layout: an interior node's
//                      first child is node + 1, its second child is
//                      `offset`; a leaf holds prims [offset, offset + n).
//   tris  (P, W) f32   prim_test_data rows; triangle verts in columns 0:9.
//   o, d  (R, 3) f32   ray origins and directions (unnormalised).
//   t_max (R,)   f32   per-ray limit; t_max <= 0 marks a dead lane.
// The triangle test is intersect.ray_triangle (watertight, pbrt-v3
// triangle.rs) written out operation for operation, and the box test is
// intersect.ray_aabb, so both paths agree up to float summation order.
//
// Built two ways from this one file:
//   nvcc (sm_90a): the CUDA kernels and their XLA FFI handlers;
//   a host C++ compiler: pbrt_bvh_traverse_host, a serial loop over the same
//   traverse_ray, which the CPU tests compare with the XLA traversal.

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace {

constexpr int kStackDepth = 64;
constexpr float kShadowEps = 1e-4f;  // intersect.SHADOW_EPS
constexpr float kInf = INFINITY;

struct RayHit {
  float t;
  int32_t prim;
  float b1;
  float b2;
  bool found;
};

HD float pick3(float a, float b, float c, int k) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// 1 / where(|v| < 1e-30, copysign-ish 1e-30, v), as intersect._traverse.
HD float safe_inv(float v) {
  if (fabsf(v) < 1e-30f) v = v < 0.0f ? -1e-30f : 1e-30f;
  return 1.0f / v;
}

template <bool kAnyHit>
HD RayHit traverse_ray(const float* __restrict__ nodes,
                       const float* __restrict__ tris, int tri_stride,
                       float ox, float oy, float oz, float dx, float dy,
                       float dz, float t_max) {
  RayHit h{kInf, -1, 0.0f, 0.0f, false};
  if (!(t_max > 0.0f)) return h;  // dead lane: cannot hit anything
  float t_best = t_max;

  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  // watertight permutation: kz = argmax |d| (first index on ties)
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const int kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  const int kx = kz == 2 ? 0 : kz + 1;
  const int ky = kx == 2 ? 0 : kx + 1;
  const float dpx = pick3(dx, dy, dz, kx);
  const float dpy = pick3(dx, dy, dz, ky);
  const float dpz = pick3(dx, dy, dz, kz);
  const float inv_dz = 1.0f / dpz;
  const float sx = -dpx * inv_dz;
  const float sy = -dpy * inv_dz;
  const float sz = inv_dz;

  int stack[kStackDepth];
  int sp = 0;
  int node = 0;
  while (true) {
    const float* n = nodes + 12 * node;
    // intersect.ray_aabb
    const float t0x = (n[0] - ox) * ix, t1x = (n[3] - ox) * ix;
    const float t0y = (n[1] - oy) * iy, t1y = (n[4] - oy) * iy;
    const float t0z = (n[2] - oz) * iz, t1z = (n[5] - oz) * iz;
    const float t_near =
        fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float t_far =
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) *
        1.0000004f;
    const bool box = t_near <= t_far && t_far > 0.0f && t_near < t_best;
    if (box) {
      const int off = static_cast<int>(n[6]);
      const int count = static_cast<int>(n[7]);
      if (count > 0) {
        for (int k = 0; k < count; ++k) {
          const float* v = tris + static_cast<int64_t>(tri_stride) * (off + k);
          // intersect.ray_triangle: translate, permute, shear
          const float p0x = pick3(v[0] - ox, v[1] - oy, v[2] - oz, kx);
          const float p0y = pick3(v[0] - ox, v[1] - oy, v[2] - oz, ky);
          const float p0z = pick3(v[0] - ox, v[1] - oy, v[2] - oz, kz);
          const float p1x = pick3(v[3] - ox, v[4] - oy, v[5] - oz, kx);
          const float p1y = pick3(v[3] - ox, v[4] - oy, v[5] - oz, ky);
          const float p1z = pick3(v[3] - ox, v[4] - oy, v[5] - oz, kz);
          const float p2x = pick3(v[6] - ox, v[7] - oy, v[8] - oz, kx);
          const float p2y = pick3(v[6] - ox, v[7] - oy, v[8] - oz, ky);
          const float p2z = pick3(v[6] - ox, v[7] - oy, v[8] - oz, kz);
          const float x0 = p0x + sx * p0z, y0 = p0y + sy * p0z;
          const float x1 = p1x + sx * p1z, y1 = p1y + sy * p1z;
          const float x2 = p2x + sx * p2z, y2 = p2y + sy * p2z;
          const float e0 = x1 * y2 - y1 * x2;
          const float e1 = x2 * y0 - y2 * x0;
          const float e2 = x0 * y1 - y0 * x1;
          const bool same_sign = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                                 (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
          const float det = e0 + e1 + e2;
          if (!same_sign || det == 0.0f) continue;
          const float z0 = sz * p0z, z1 = sz * p1z, z2 = sz * p2z;
          const float t_scaled = e0 * z0 + e1 * z1 + e2 * z2;
          const float inv_det = 1.0f / det;
          const float t = t_scaled * inv_det;
          if (t > kShadowEps && t < t_best) {
            t_best = t;
            h.t = t;
            h.prim = off + k;
            h.b1 = e1 * inv_det;
            h.b2 = e2 * inv_det;
            h.found = true;
            if (kAnyHit) return h;
          }
        }
      } else {
        // interior: visit the near child first (bvh.rs dir_is_neg order)
        const bool neg = pick3(dx, dy, dz, static_cast<int>(n[8])) < 0.0f;
        const int near_child = neg ? off : node + 1;
        const int far_child = neg ? node + 1 : off;
        if (sp < kStackDepth) stack[sp++] = far_child;
        node = near_child;
        continue;
      }
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
  return h;
}

}  // namespace

#ifdef __CUDACC__

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;

template <bool kAnyHit>
__global__ void traverse_kernel(const float* __restrict__ o,
                                const float* __restrict__ d,
                                const float* __restrict__ t_max,
                                const float* __restrict__ nodes,
                                const float* __restrict__ tris, int tri_stride,
                                int64_t n_rays, float* __restrict__ t_out,
                                int32_t* __restrict__ prim_out,
                                float* __restrict__ b1_out,
                                float* __restrict__ b2_out,
                                bool* __restrict__ hit_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const RayHit h = traverse_ray<kAnyHit>(
      nodes, tris, tri_stride, o[3 * i], o[3 * i + 1], o[3 * i + 2],
      d[3 * i], d[3 * i + 1], d[3 * i + 2], t_max[i]);
  if (kAnyHit) {
    hit_out[i] = h.found;
  } else {
    t_out[i] = h.t;
    prim_out[i] = h.prim;
    b1_out[i] = h.b1;
    b2_out[i] = h.b2;
  }
}

ffi::Error check_inputs(const ffi::Buffer<ffi::F32>& o,
                        const ffi::Buffer<ffi::F32>& d,
                        const ffi::Buffer<ffi::F32>& t_max,
                        const ffi::Buffer<ffi::F32>& nodes,
                        const ffi::Buffer<ffi::F32>& tris) {
  const auto od = o.dimensions();
  const auto nd = nodes.dimensions();
  const auto td = tris.dimensions();
  if (od.size() != 2 || od[1] != 3 || d.element_count() != o.element_count() ||
      t_max.element_count() * 3 != o.element_count())
    return ffi::Error::InvalidArgument("bvh traversal: rays must be (R, 3)");
  if (nd.size() != 2 || nd[1] != 12)
    return ffi::Error::InvalidArgument("bvh traversal: nodes must be (N, 12)");
  if (td.size() != 2 || td[1] < 9)
    return ffi::Error::InvalidArgument("bvh traversal: tris must be (P, >=9)");
  return ffi::Error::Success();
}

ffi::Error launch_error() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

int grid_for(int64_t n) { return static_cast<int>((n + kBlock - 1) / kBlock); }

ffi::Error closest_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> o,
                        ffi::Buffer<ffi::F32> d, ffi::Buffer<ffi::F32> t_max,
                        ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> tris,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> prim_out,
                        ffi::ResultBuffer<ffi::F32> b1_out,
                        ffi::ResultBuffer<ffi::F32> b2_out) {
  ffi::Error err = check_inputs(o, d, t_max, nodes, tris);
  if (err.failure()) return err;
  const int64_t n = t_max.element_count();
  if (n == 0) return ffi::Error::Success();
  traverse_kernel<false><<<grid_for(n), kBlock, 0, stream>>>(
      o.typed_data(), d.typed_data(), t_max.typed_data(), nodes.typed_data(),
      tris.typed_data(), static_cast<int>(tris.dimensions()[1]), n,
      t_out->typed_data(), prim_out->typed_data(), b1_out->typed_data(),
      b2_out->typed_data(), nullptr);
  return launch_error();
}

ffi::Error any_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> o,
                    ffi::Buffer<ffi::F32> d, ffi::Buffer<ffi::F32> t_max,
                    ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> tris,
                    ffi::ResultBuffer<ffi::PRED> hit_out) {
  ffi::Error err = check_inputs(o, d, t_max, nodes, tris);
  if (err.failure()) return err;
  const int64_t n = t_max.element_count();
  if (n == 0) return ffi::Error::Success();
  traverse_kernel<true><<<grid_for(n), kBlock, 0, stream>>>(
      o.typed_data(), d.typed_data(), t_max.typed_data(), nodes.typed_data(),
      tris.typed_data(), static_cast<int>(tris.dimensions()[1]), n, nullptr,
      nullptr, nullptr, nullptr, hit_out->typed_data());
  return launch_error();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PbrtBvhClosest, closest_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(PbrtBvhAny, any_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::PRED>>());

#else  // host build for the CPU tests

extern "C" void pbrt_bvh_traverse_host(const float* o, const float* d,
                                       const float* t_max, const float* nodes,
                                       const float* tris, int tri_stride,
                                       int64_t n_rays, int any_hit,
                                       float* t_out, int32_t* prim_out,
                                       float* b1_out, float* b2_out,
                                       uint8_t* hit_out) {
  for (int64_t i = 0; i < n_rays; ++i) {
    const RayHit h =
        any_hit ? traverse_ray<true>(nodes, tris, tri_stride, o[3 * i],
                                     o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                     d[3 * i + 1], d[3 * i + 2], t_max[i])
                : traverse_ray<false>(nodes, tris, tri_stride, o[3 * i],
                                      o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                      d[3 * i + 1], d[3 * i + 2], t_max[i]);
    t_out[i] = h.t;
    prim_out[i] = h.prim;
    b1_out[i] = h.b1;
    b2_out[i] = h.b2;
    hit_out[i] = h.found ? 1 : 0;
  }
}

#endif
