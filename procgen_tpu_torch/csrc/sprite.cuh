// Sprite-slot painting shared by the frame kernels (render_suffix.cu,
// render_frame.cu): the K1b per-slot pass and the K1c canvas composite of
// the Pallas TPU kernel procgen_tpu/render/pallas_kernel.py (_render_env,
// slot_body :706-830 and apply_canvas :946-950), evaluated for one pixel.
//
// A pixel's canvases live in registers, one premultiplied RGBA canvas per z
// level.  Every slot blends into the canvas of its z level with
// a = ((texel * f32(1/255)) * alpha) * cover and the canvas is rounded to
// bf16 after every slot, in the Pallas kernel's operation order; a dead or
// foreign-z slot blends with a = 0, which is an exact identity, so it is
// skipped.  Build with -fmad=false -prec-div=true -ftz=false.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pgt {

constexpr int RES = 64;
constexpr int MAX_NZ = 4;

// ent_f / ent_i columns (procgen_tpu_torch/render/render_kernel.py)
constexpr int EF_X0 = 0, EF_Y0 = 1, EF_W2 = 2, EF_H2 = 3, EF_ALPHA = 4,
              EF_R = 5, EF_N = 8;
constexpr int EI_ROW = 0, EI_LIVE = 1, EI_FB = 2, EI_PFLIP = 3, EI_QFLIP = 4,
              EI_Z = 5, EI_NTH = 6, EI_NTV = 7, EI_TILEH = 8, EI_TILEV = 9,
              EI_N = 10;

// the f32 rounding of the double 1/255, as the JAX code multiplies by it
constexpr float INV255 = 0x1.010102p-8f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// texel index along one axis: (pix - origin) / extent, optional in-rect
// tiling, nearest texel, optional flip
__device__ __forceinline__ int axis_index(float pix, float origin,
                                          float extent, int ntiles, int tile,
                                          int flip, int S, bool* valid) {
  float u = (pix - origin) / extent;
  *valid = (u >= 0.f) && (u < 1.f);
  float ut = u * (float)ntiles;
  float uu = tile > 0 ? ut - floorf(ut) : u;
  int ui = clampi((int)(uu * (float)S), 0, S - 1);
  return flip > 0 ? S - 1 - ui : ui;
}

// Copy one env's slot table (cap slots of EF_N floats and EI_N ints) into
// shared memory; the caller synchronises.
__device__ __forceinline__ void load_slots(const float* __restrict__ ent_f,
                                           const int32_t* __restrict__ ent_i,
                                           int64_t env, int cap, float* sf,
                                           int32_t* si) {
  for (int k = threadIdx.x; k < cap * EF_N; k += blockDim.x)
    sf[k] = ent_f[env * cap * EF_N + k];
  for (int k = threadIdx.x; k < cap * EI_N; k += blockDim.x)
    si[k] = ent_i[env * cap * EI_N + k];
}

// Paint every slot at the pixel centre (sx, sy) into canv[z] (cleared
// first).  atlas: uint8 [n_rows, S, S, 4].
__device__ __forceinline__ void paint_slots(const float* sf, const int32_t* si,
                                            int cap, int nz,
                                            const uint8_t* __restrict__ atlas,
                                            int S, int n_rows, float sx,
                                            float sy, float canv[MAX_NZ][4]) {
#pragma unroll
  for (int z = 0; z < MAX_NZ; ++z)
#pragma unroll
    for (int c = 0; c < 4; ++c) canv[z][c] = 0.f;

  for (int i = 0; i < cap; ++i) {
    const float* f = sf + i * EF_N;
    const int32_t* e = si + i * EI_N;
    if (!(e[EI_LIVE] > 0 && e[EI_Z] >= 0)) continue;
    const int zc = e[EI_Z] < nz - 1 ? e[EI_Z] : nz - 1;

    bool xvalid, yvalid;
    const int q = axis_index(sx, f[EF_X0], f[EF_W2], e[EI_NTH], e[EI_TILEH],
                             e[EI_QFLIP], S, &xvalid);
    const int p = axis_index(sy, f[EF_Y0], f[EF_H2], e[EI_NTV], e[EI_TILEV],
                             e[EI_PFLIP], S, &yvalid);
    const bool inside = xvalid && yvalid;
    const float cover = inside ? 1.f : 0.f;

    float tex[4] = {0.f, 0.f, 0.f, 0.f};
    if (inside) {
      const int r = clampi(e[EI_ROW], 0, n_rows - 1);
      const uint8_t* t = atlas + (((int64_t)r * S + p) * S + q) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) tex[c] = (float)t[c];
    }

    const bool fb = e[EI_FB] > 0;
    const float a = fb ? cover : ((tex[3] * INV255) * f[EF_ALPHA]) * cover;
    const float keep = 1.f - a;
#pragma unroll
    for (int z = 0; z < MAX_NZ; ++z) {
      if (z != zc) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rgb = fb ? f[EF_R + c] : tex[c];
        canv[z][c] = bf16_round(rgb * a + canv[z][c] * keep);
      }
      canv[z][3] = bf16_round(a + canv[z][3] * keep);
    }
  }
}

// Composite canvas z (a runtime index, -1 for none) over one channel value:
// round(rgb + obs * (1 - a)).  The static unroll keeps canv in registers.
__device__ __forceinline__ float composite(float o, float canv[MAX_NZ][4],
                                           int z, int c) {
#pragma unroll
  for (int k = 0; k < MAX_NZ; ++k)
    if (k == z) o = rintf(canv[k][c] + o * (1.f - canv[k][3]));
  return o;
}

}  // namespace pgt
