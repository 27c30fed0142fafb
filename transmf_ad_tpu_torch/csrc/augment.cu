// K13: the train step's augmentation of a batch, every sample and modality in
// one launch, decoding the step's draws on the device.
//
// Replaces no TPU kernel: the JAX package's augmentation is XLA
// (transmf_ad_tpu/data/transforms.py::augment_batch, :172). It exists so that
// the host never reads the draws: the wrapper (data/transforms.py) passes the
// step's (B, 6) float32 uniforms as a device pointer and each block decodes
// its sample's draw itself, so the step has no host sync, and the batch is
// one launch instead of the plain version's per-sample dense-matrix passes.
//
// The draw, per sample, in double precision as Python computes it
// (data/transforms.py::decode): flip = u0 < flip_prob; angle = u1 <
// rotate_prob ? lo + (hi - lo) * u2 : 0; zoom = u3 < zoom_prob ? min + (max -
// min) * u4 : 1. A draw with no flip, angle 0 and zoom 1 is the identity.
// Coordinates are float32, with zoom, a = -tan(angle / 2) and b = sin(angle)
// rounded to float32, as a Python scalar is in a float32 tensor operation.
//
// Bound on the card: bytes, one read and one write of each volume (at the
// cells' (6, 182, 218, 182) x 2 in bfloat16, 347 MB: 0.104 ms).
//
// One block of 1,024 threads a (sample, modality, destination x-plane), the
// planes ordered sample, modality, x. Each block:
// - identity draw: copies its plane bit for bit;
// - otherwise the x, y and z passes of the plain version (separable linear
//   interpolation, each axis clamped at its border; the x pass mirrored when
//   flipped) are one 8-tap gather from the two source x-planes, mixed in the
//   passes' order x, y, z, each mix a * (1 - w) + b * w rounded as the plain
//   two-tap version rounds it (no contraction into FMAs). The y and z taps
//   (two indices and a weight, from an IEEE division by the zoom) are
//   tabled once a plane, so a voxel costs its loads and mixes;
// - a rotation (angle != 0) runs on a Y x Z float32 plane: the gather fills
//   it, three shears move it in place (y by a, each z column by the constant
//   -a * (z - cz); z by b, each y row by -b * (y - cy); y by a again), with
//   __syncthreads between them. A warp owns a line: it reads all of its
//   voxels' two taps into registers, then writes the line back. Without a
//   rotation the shears are skipped, exactly as the plain passes with a
//   coefficient of +-0 leave the plane;
// - the epilogue stores the plane in 16-byte groups (bfloat16 rounded to
//   nearest even), the plane's unaligned ends one element at a time.
// Two variants, by shape alone (`smem_fits`, which the wrapper reads through
// transmf_augment_scratch_floats): "smem" keeps the plane and the taps in shared memory (4 * Y * Z + 12 * (Y + Z)
// bytes: 44 KB at 91x109x91, 164 KB at 182x218x182) and needs a line of at
// most 256 voxels; "global" runs the same stages on two float32 planes
// and the taps a block in device scratch from the wrapper (shears from one
// plane into the other, so a line of any length), a persistent grid of
// `blocks` blocks walking the planes.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace transmf {
namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLineRegs = 8;  // a line of 32 * 8 = 256 voxels in registers
constexpr int kMaxModalities = 2;  // MRI and PET
// the most a "smem" block's working memory (work_floats) may take: a
// block's 227 KB less room for its static `Draw`
constexpr int64_t kMaxSmemBytes = 227 * 1024 - 256;

struct Volumes {
  const void* in[kMaxModalities];
  void* out[kMaxModalities];
};

struct DrawCfg {
  double flip_prob, rotate_prob, rot_lo, rot_hi, zoom_prob, zoom_min,
      zoom_max;
};

struct Draw {
  int identity, flip, rotate;
  float zoom, a, b;
};

__device__ Draw decode(const float* __restrict__ u, const DrawCfg& c) {
  const double p_flip = u[0], p_rot = u[1], u_rot = u[2], p_zoom = u[3],
               u_zoom = u[4];
  double angle = 0.0, zoom = 1.0;
  if (p_rot < c.rotate_prob) {
    angle = __dadd_rn(c.rot_lo,
                      __dmul_rn(__dsub_rn(c.rot_hi, c.rot_lo), u_rot));
  }
  if (p_zoom < c.zoom_prob) {
    zoom = __dadd_rn(c.zoom_min,
                     __dmul_rn(__dsub_rn(c.zoom_max, c.zoom_min), u_zoom));
  }
  Draw d;
  d.flip = p_flip < c.flip_prob;
  d.identity = !d.flip && angle == 0.0 && zoom == 1.0;
  d.rotate = angle != 0.0;
  d.zoom = __double2float_rn(zoom);
  d.a = d.rotate ? __double2float_rn(-tan(angle / 2.0)) : 0.f;
  d.b = d.rotate ? __double2float_rn(sin(angle)) : 0.f;
  return d;
}

// The two taps and the weight of a fractional source coordinate, clamped to
// [0, size - 1] as the plain version's interpolation matrix is.
struct Tap {
  int lo, hi;
  float w;
};

__device__ __forceinline__ Tap tap(float src, int size) {
  const float top = static_cast<float>(size - 1);
  const float lo = fminf(fmaxf(floorf(src), 0.f), top);
  const float w = fminf(fmaxf(__fsub_rn(src, lo), 0.f), 1.f);
  const float hi = fminf(fmaxf(__fadd_rn(lo, 1.f), 0.f), top);
  return {static_cast<int>(lo), static_cast<int>(hi), w};
}

// (d - c) / zoom + c
__device__ __forceinline__ float zoomed(int d, float c, float zoom) {
  return __fadd_rn(__fdiv_rn(__fsub_rn(static_cast<float>(d), c), zoom), c);
}

// a * (1 - w) + b * w, each operation rounded
__device__ __forceinline__ float mix(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, w)), __fmul_rn(b, w));
}

// The zoomed (and flipped) volume at (y, z) of the destination plane whose x
// taps are `tx`, its y and z taps `ty` and `tz`; `vol` is the sample's
// volume.
template <typename T>
__device__ __forceinline__ float gathered(const T* __restrict__ vol,
                                          const Tap& tx, const Tap& ty,
                                          const Tap& tz, int Y, int Z) {
  const int64_t yz = static_cast<int64_t>(Y) * Z;
  const T* p0 = vol + tx.lo * yz;
  const T* p1 = vol + tx.hi * yz;
  const int64_t r0 = static_cast<int64_t>(ty.lo) * Z,
                r1 = static_cast<int64_t>(ty.hi) * Z;
  const float a00 = mix(to_f32(p0[r0 + tz.lo]), to_f32(p1[r0 + tz.lo]), tx.w);
  const float a10 = mix(to_f32(p0[r1 + tz.lo]), to_f32(p1[r1 + tz.lo]), tx.w);
  const float a01 = mix(to_f32(p0[r0 + tz.hi]), to_f32(p1[r0 + tz.hi]), tx.w);
  const float a11 = mix(to_f32(p0[r1 + tz.hi]), to_f32(p1[r1 + tz.hi]), tx.w);
  return mix(mix(a00, a10, ty.w), mix(a01, a11, ty.w), tz.w);
}

// One shear of the Y x Z plane `src` (z fastest) into `dst`. Along y, column
// z moves by t = c * (z - cz): out(y, z) = src at y - t; along z, row y by t =
// c * (y - cy): out(y, z) = src at z - t. A warp owns a line; `src` may be
// `dst` when a line fits in the registers (len <= 32 * kLineRegs).
__device__ void shear(const float* src, float* dst, int Y, int Z, bool along_y,
                      float c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lines = along_y ? Z : Y, len = along_y ? Y : Z;
  const int64_t line_step = along_y ? 1 : Z, step = along_y ? Z : 1;
  const float center = 0.5f * ((along_y ? Z : Y) - 1);
  for (int l = warp; l < lines; l += kWarps) {
    const float t = __fmul_rn(c, __fsub_rn(static_cast<float>(l), center));
    const float* s = src + l * line_step;
    float* d = dst + l * line_step;
    for (int i0 = 0; i0 < len; i0 += 32 * kLineRegs) {
      float r[kLineRegs];
#pragma unroll
      for (int k = 0; k < kLineRegs; ++k) {
        const int i = i0 + 32 * k + lane;
        if (i < len) {
          const Tap tp = tap(__fsub_rn(static_cast<float>(i), t), len);
          r[k] = mix(s[tp.lo * step], s[tp.hi * step], tp.w);
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kLineRegs; ++k) {
        const int i = i0 + 32 * k + lane;
        if (i < len) d[i * step] = r[k];
      }
    }
  }
}

// the elements of `dst` before its first 16-byte boundary, at most n
template <typename T>
__device__ __forceinline__ int64_t lead(const T* dst, int64_t n) {
  const int64_t k = static_cast<int64_t>(
      ((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / sizeof(T));
  return k < n ? k : n;
}

// dst[y * Z + z] = value(y, z) over the Y x Z plane, in 16-byte groups
// between its unaligned ends (a thread's group walks z, then y)
template <typename T, typename F>
__device__ __forceinline__ void store_plane(T* __restrict__ dst, int Y, int Z,
                                            F value) {
  constexpr int V = 16 / sizeof(T);
  const int64_t n = static_cast<int64_t>(Y) * Z;
  const int64_t head = lead(dst, n);
  const int64_t groups = (n - head) / V;
  auto one = [&](int64_t i) {
    const int y = static_cast<int>(i / Z);
    dst[i] = value(y, static_cast<int>(i - static_cast<int64_t>(y) * Z));
  };
  for (int64_t i = threadIdx.x; i < head; i += kThreads) one(i);
  uint4* vec = reinterpret_cast<uint4*>(dst + head);
  for (int64_t g = threadIdx.x; g < groups; g += kThreads) {
    const int64_t i = head + g * V;
    int y = static_cast<int>(i / Z);
    int z = static_cast<int>(i - static_cast<int64_t>(y) * Z);
    T e[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      e[j] = value(y, z);
      if (++z == Z) {
        z = 0;
        ++y;
      }
    }
    uint4 q;
    memcpy(&q, e, sizeof(q));
    vec[g] = q;
  }
  for (int64_t i = head + groups * V + threadIdx.x; i < n; i += kThreads) {
    one(i);
  }
}

// the identity draw's plane, its bits unchanged; 16-byte loads too where the
// source sits at the same offset from a 16-byte boundary as the destination
template <typename T>
__device__ __forceinline__ void copy_plane(T* __restrict__ dst,
                                           const T* __restrict__ src, int Y,
                                           int Z) {
  if (((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src)) &
       15) != 0) {
    store_plane(dst, Y, Z, [&](int y, int z) {
      return src[static_cast<int64_t>(y) * Z + z];
    });
    return;
  }
  constexpr int V = 16 / sizeof(T);
  const int64_t n = static_cast<int64_t>(Y) * Z;
  const int64_t head = lead(dst, n);
  for (int64_t i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  const int64_t groups = (n - head) / V;
  const uint4* from = reinterpret_cast<const uint4*>(src + head);
  uint4* to = reinterpret_cast<uint4*>(dst + head);
  for (int64_t g = threadIdx.x; g < groups; g += kThreads) to[g] = from[g];
  for (int64_t i = head + groups * V + threadIdx.x; i < n; i += kThreads) {
    dst[i] = src[i];
  }
}

// A block's working memory, floats: the plane, a second plane ("global"
// only: the shears go from one to the other), then the y and z taps of the
// zoom (a `Tap` is three 4-byte words)
__host__ __device__ constexpr int64_t work_floats(int Y, int Z, bool shared) {
  return (shared ? 1 : 2) * static_cast<int64_t>(Y) * Z + 3 * (Y + Z);
}

// "smem" takes the shape: its working memory fits a block's shared memory
// and no line is longer than a warp's registers hold
constexpr bool smem_fits(int Y, int Z) {
  return work_floats(Y, Z, true) * static_cast<int64_t>(sizeof(float)) <=
             kMaxSmemBytes &&
         Y <= 32 * kLineRegs && Z <= 32 * kLineRegs;
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    augment_kernel(Volumes vols, int M, const float* __restrict__ u,
                   DrawCfg cfg, int B, int X, int Y, int Z,
                   float* __restrict__ scratch) {
  extern __shared__ float smem_work[];
  __shared__ Draw draw;
  const int64_t yz = static_cast<int64_t>(Y) * Z;
  const int planes = B * M * X;
  float* plane = kShared ? smem_work
                         : scratch + work_floats(Y, Z, false) * blockIdx.x;
  float* other = kShared ? plane : plane + yz;
  Tap* ytab = reinterpret_cast<Tap*>(plane + (kShared ? 1 : 2) * yz);
  Tap* ztab = ytab + Y;
  for (int p = blockIdx.x; p < planes; p += gridDim.x) {
    const int x = p % X, m = (p / X) % M, b = p / (X * M);
    if (threadIdx.x == 0) draw = decode(u + 6 * b, cfg);
    __syncthreads();
    const Draw d = draw;
    const T* vol = static_cast<const T*>(vols.in[m]) +
                   static_cast<int64_t>(b) * X * yz;
    T* dst = static_cast<T*>(vols.out[m]) +
             (static_cast<int64_t>(b) * X + x) * yz;
    if (d.identity) {
      copy_plane(dst, vol + x * yz, Y, Z);
    } else {
      for (int i = threadIdx.x; i < Y + Z; i += kThreads) {
        if (i < Y) {
          ytab[i] = tap(zoomed(i, 0.5f * (Y - 1), d.zoom), Y);
        } else {
          ztab[i - Y] = tap(zoomed(i - Y, 0.5f * (Z - 1), d.zoom), Z);
        }
      }
      float sx = zoomed(x, 0.5f * (X - 1), d.zoom);
      if (d.flip) sx = __fsub_rn(static_cast<float>(X - 1), sx);
      const Tap tx = tap(sx, X);
      __syncthreads();
      auto at = [&](int y, int z) {
        return gathered(vol, tx, ytab[y], ztab[z], Y, Z);
      };
      if (!d.rotate) {
        store_plane(dst, Y, Z,
                    [&](int y, int z) { return from_f32<T>(at(y, z)); });
      } else {
        // thread t fills (y, z) = divmod(t + k * kThreads, Z), k = 0, 1, ...
        const int dy = kThreads / Z, dz = kThreads - dy * Z;
        int y = threadIdx.x / Z, z = threadIdx.x - y * Z;
        while (y < Y) {
          plane[static_cast<int64_t>(y) * Z + z] = at(y, z);
          y += dy;
          z += dz;
          if (z >= Z) {
            z -= Z;
            ++y;
          }
        }
        __syncthreads();
        shear(plane, other, Y, Z, true, d.a);
        __syncthreads();
        shear(other, plane, Y, Z, false, d.b);
        __syncthreads();
        shear(plane, other, Y, Z, true, d.a);
        __syncthreads();
        store_plane(dst, Y, Z, [&](int y, int z) {
          return from_f32<T>(other[static_cast<int64_t>(y) * Z + z]);
        });
      }
    }
    __syncthreads();  // `draw`, the taps and the plane are the next plane's
  }
}

}  // namespace
}  // namespace transmf

// The device scratch a "global" block takes for (Y, Z) planes, in float32
// words; 0 where the shape takes "smem", which needs none.
extern "C" long long transmf_augment_scratch_floats(int Y, int Z) {
  using namespace transmf;
  return smem_fits(Y, Z) ? 0 : work_floats(Y, Z, false);
}

// in0, in1 / out0, out1: the modalities' (B, X, Y, Z) inputs and outputs
// (the first m used); u: (B, 6) float32 uniforms on the device; where the
// shape takes "global", `scratch` holds transmf_augment_scratch_floats(Y, Z)
// float32 for each of `blocks` blocks.
extern "C" int transmf_augment(const void* in0, const void* in1, void* out0,
                               void* out1, int m,
                               const float* u, int B, int X, int Y, int Z,
                               double flip_prob, double rotate_prob,
                               double rot_lo, double rot_hi, double zoom_prob,
                               double zoom_min, double zoom_max, int dtype,
                               float* scratch, int blocks, void* stream) {
  using namespace transmf;
  if (m < 1 || m > kMaxModalities || B < 1 || X < 1 || Y < 1 || Z < 1 ||
      static_cast<int64_t>(B) * m * X > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool shared = smem_fits(Y, Z);
  if (!shared && (scratch == nullptr || blocks < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = work_floats(Y, Z, true) * sizeof(float);
  const Volumes vols{{in0, in1}, {out0, out1}};
  const DrawCfg cfg{flip_prob, rotate_prob, rot_lo, rot_hi,
                    zoom_prob, zoom_min,    zoom_max};
  const int planes = B * m * X;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (shared) {
      auto kernel = augment_kernel<T, true>;
      if (allow_smem(kernel, smem) != cudaSuccess) return;
      kernel<<<planes, kThreads, smem, s>>>(vols, m, u, cfg, B, X, Y, Z,
                                            nullptr);
    } else {
      augment_kernel<T, false><<<planes < blocks ? planes : blocks, kThreads,
                                 0, s>>>(
          vols, m, u, cfg, B, X, Y, Z, scratch);
    }
  });
}
