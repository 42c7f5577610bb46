// The whole 64x64 frame of a game that is not static, for sm_90a.
//
// Replaces the Pallas TPU kernel procgen_tpu/render/pallas_kernel.py
// (_render_env inside the pl.pallas_call at :1136) on its non-static path
// with the standard background crop and the entity pool alone, which miner
// takes.  Per pixel, in the QPainter pipeline's order:
//   K1d  background crop of the env's image (:656-666), else 0;
//   K1c  the z=-1 sprite canvas composited over it;
//   K1e  the grid tiles: nearest texel of the aligned tile window, alpha
//        blended with alpha = texel / 255 as a true division (:976-1011);
//   K1f  the colored cells: the cell's r, g, b where its valid plane is
//        > 0.5, the pixel lies in the cell's central inset and no tile
//        covers it (:1016-1038);
//   K1c  the z=0, then the z=1 canvas; rounded; written as uint8.
// The sprite canvases come from the same slot code as render_suffix.cu
// (sprite.cuh).  procgen_tpu_torch/render/render_kernel.py:
// render_frame_reference is the same function in plain torch; the two
// agree byte for byte.
//
// The TPU kernel resamples a per-env tile canvas (u8 [5, NC*sA, NC*sA],
// 24.5 KB an env in miner easy) that its prep writes to HBM.  Here prep
// writes a per-cell row table (int32 [NC, NC]) instead and the kernel reads
// texel (ri % sA, ci % sA) of row table[ri / sA][ci / sA] from the grid
// atlas; a cell is covered by a tile iff its row is below the atlas's
// transparent row.  The cell is picked from the canvas row and column as
// the TPU kernel picks it, floor((wxs - low_x) * sA) / sA, not floor(wxs).
//
// Bound: bytes.  Per env the kernel writes the 12 KiB frame and reads the
// row table, the cell planes (5 NC^2 floats), the slots and the scalars:
// about 2.6 KB in miner easy, 10 KB in hard.  The atlases (grid, entity,
// background ~20 KB an image) are shared by every env and stay in L2.
// Design: one 256-thread block per env, one thread per pixel column and
// sixteen rows a thread; the block stages the env's scalars, row table,
// cell planes and slots in shared memory; each pixel's canvases stay in
// registers, so only the frame goes out to device memory.
//
// Exactness: build with -fmad=false -prec-div=true -ftz=false (kernels.py)
// and keep the TPU kernel's operation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sprite.cuh"

namespace {

using namespace pgt;

constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / RES;

// per-env scalar columns (render_kernel.py SF_* / SI_*)
constexpr int SF_UNIT = 0, SF_VIS = 1, SF_XOFF = 2, SF_YOFF = 3, SF_MRY = 5,
              SF_MRH = 7, SF_BGRX = 8, SF_BGRW = 9, SF_TOPY = 11,
              SF_LOWX = 12, SF_N = 13;
constexpr int SI_BGROW = 0, SI_N = 3;

struct Geometry {
  int cap, nz, zm1, z0, z1;          // slots, canvases, canvas of z=-1/0/1
  int NC, sA, n_grid_rows, opaque;   // cell window, tile px, grid atlas rows
  int use_bg, nb, BH, BW;            // background atlas
  int S, n_ent_rows;                 // entity atlas
};

__global__ void __launch_bounds__(THREADS)
render_frame_kernel(const float* __restrict__ sf_g,
                    const int32_t* __restrict__ si_g,
                    const int32_t* __restrict__ gtab_g,
                    const float* __restrict__ cell5_g,
                    const float* __restrict__ ent_f,
                    const int32_t* __restrict__ ent_i,
                    const uint8_t* __restrict__ grid_atlas,
                    const uint8_t* __restrict__ bg_atlas,
                    const uint8_t* __restrict__ ent_atlas,
                    uint8_t* __restrict__ out, Geometry g) {
  extern __shared__ int32_t smem[];
  const int NC2 = g.NC * g.NC;
  float* sc = reinterpret_cast<float*>(smem);           // [SF_N]
  int32_t* sci = smem + SF_N;                           // [SI_N]
  int32_t* tab = sci + SI_N;                            // [NC, NC]
  float* cell = reinterpret_cast<float*>(tab + NC2);    // [5, NC, NC]
  float* slf = cell + 5 * NC2;                          // [cap, EF_N]
  int32_t* sli = reinterpret_cast<int32_t*>(slf + g.cap * EF_N);  // [cap, EI_N]

  const int64_t env = blockIdx.x;
  for (int k = threadIdx.x; k < SF_N; k += THREADS) sc[k] = sf_g[env * SF_N + k];
  for (int k = threadIdx.x; k < SI_N; k += THREADS) sci[k] = si_g[env * SI_N + k];
  for (int k = threadIdx.x; k < NC2; k += THREADS) tab[k] = gtab_g[env * NC2 + k];
  for (int k = threadIdx.x; k < 5 * NC2; k += THREADS)
    cell[k] = cell5_g[env * 5 * NC2 + k];
  load_slots(ent_f, ent_i, env, g.cap, slf, sli);
  __syncthreads();

  const float unit = sc[SF_UNIT], vis = sc[SF_VIS];
  const float x_off = sc[SF_XOFF], y_off = sc[SF_YOFF];
  const int GS = g.NC * g.sA;
  const float fsA = (float)g.sA;

  // per-column quantities
  const int col = threadIdx.x % RES;
  const float sx = (float)col + 0.5f;
  const float wxs = (sx + x_off) / unit;
  const float cxx = (wxs - sc[SF_LOWX]) * fsA;
  const int ci = clampi((int)floorf(cxx), 0, GS - 1);
  const bool in_c = (cxx >= 0.f) && (cxx < (float)GS);
  const float u_frac = wxs - floorf(wxs);

  const float bgr_x = sc[SF_BGRX], bgr_w = sc[SF_BGRW];
  const int bg_col = clampi((int)((sx - bgr_x) / bgr_w * (float)g.BW), 0, g.BW - 1);
  const bool bg_in_x = (sx >= bgr_x) && (sx < bgr_x + bgr_w);
  const uint8_t* bg_img =
      bg_atlas + (int64_t)clampi(sci[SI_BGROW], 0, g.nb - 1) * g.BH * g.BW * 3;

  for (int row = threadIdx.x / RES; row < RES; row += ROWS_PER_PASS) {
    const float sy = (float)row + 0.5f;
    const float wys = vis - (sy - y_off) / unit;

    // K1d: background crop
    float obs[3] = {0.f, 0.f, 0.f};
    if (g.use_bg) {
      const float mr_y = sc[SF_MRY], mr_h = sc[SF_MRH];
      const int bg_row =
          clampi((int)((sy - mr_y) / mr_h * (float)g.BH), 0, g.BH - 1);
      const bool in_y = (sy >= mr_y) && (sy < mr_y + mr_h);
      if (in_y && bg_in_x) {
        const uint8_t* t = bg_img + ((int64_t)bg_row * g.BW + bg_col) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) obs[c] = (float)t[c];
      }
    }

    // K1b: the sprite canvases; K1c: z = -1
    float canv[MAX_NZ][4];
    paint_slots(slf, sli, g.cap, g.nz, ent_atlas, g.S, g.n_ent_rows, sx, sy,
                canv);
#pragma unroll
    for (int c = 0; c < 3; ++c) obs[c] = composite(obs[c], canv, g.zm1, c);

    // K1e: grid tiles
    const float cyx = (sc[SF_TOPY] - wys) * fsA;
    const int ri = clampi((int)floorf(cyx), 0, GS - 1);
    const bool inside = in_c && (cyx >= 0.f) && (cyx < (float)GS);
    const int cell_idx = (ri / g.sA) * g.NC + ci / g.sA;
    float tex[4] = {0.f, 0.f, 0.f, 0.f};
    bool covered = false;
    if (inside) {
      const int r = clampi(tab[cell_idx], 0, g.n_grid_rows - 1);
      const uint8_t* t =
          grid_atlas + (((int64_t)r * g.sA + ri % g.sA) * g.sA + ci % g.sA) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) tex[c] = (float)t[c];
      covered = r < g.opaque;
    }
    const float alpha = tex[3] / 255.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      obs[c] = rintf(obs[c] * (1.f - alpha) + tex[c] * alpha);

    // K1f: colored cells
    if (inside && !covered && cell[3 * NC2 + cell_idx] > 0.5f) {
      const float half = cell[4 * NC2 + cell_idx] * 0.5f;
      const float v_frac = wys - floorf(wys);
      if (fabsf(u_frac - 0.5f) < half && fabsf(v_frac - 0.5f) < half) {
#pragma unroll
        for (int c = 0; c < 3; ++c) obs[c] = cell[c * NC2 + cell_idx];
      }
    }

    // K1c: z = 0, then z = 1
    const int64_t px = ((env * RES + row) * RES + col) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float o = composite(obs[c], canv, g.z0, c);
      o = composite(o, canv, g.z1, c);
      out[px + c] = (uint8_t)(int32_t)o;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes by procgen_tpu_torch/kernels.py).
// sf: f32 [n, 13]; si: int32 [n, 3]; gtab: int32 [n, NC, NC]; cell5: f32
// [n, 5, NC, NC]; ent_f: f32 [n, cap, 8]; ent_i: int32 [n, cap, 10];
// grid_atlas: uint8 [n_grid_rows, sA, sA, 4]; bg_atlas: uint8 [nb, BH, BW,
// 3]; ent_atlas: uint8 [n_ent_rows, S, S, 4]; out: uint8 [n, 64, 64, 3].
// zm1/z0/z1: the canvas index of z = -1, 0, 1, or -1 for none.  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int render_frame(const float* sf, const int32_t* si,
                            const int32_t* gtab, const float* cell5,
                            const float* ent_f, const int32_t* ent_i,
                            const uint8_t* grid_atlas, const uint8_t* bg_atlas,
                            const uint8_t* ent_atlas, uint8_t* out, int n,
                            int cap, int nz, int zm1, int z0, int z1, int NC,
                            int sA, int n_grid_rows, int opaque, int use_bg,
                            int nb, int BH, int BW, int S, int n_ent_rows,
                            cudaStream_t stream) {
  if (n <= 0) return 0;
  if (nz < 1 || nz > MAX_NZ || cap < 0 || NC < 1 || sA < 1 ||
      n_grid_rows < 1 || nb < 1 || BH < 1 || BW < 1 || S < 1 ||
      n_ent_rows < 1 || zm1 >= nz || z0 >= nz || z1 >= nz)
    return (int)cudaErrorInvalidValue;
  const Geometry g{cap, nz, zm1, z0, z1, NC, sA, n_grid_rows, opaque,
                   use_bg, nb, BH, BW, S, n_ent_rows};
  const size_t smem = (size_t)(SF_N + SI_N + 6 * NC * NC +
                               cap * (EF_N + EI_N)) * sizeof(int32_t);
  render_frame_kernel<<<(unsigned)n, THREADS, smem, stream>>>(
      sf, si, gtab, cell5, ent_f, ent_i, grid_atlas, bg_atlas, ent_atlas, out,
      g);
  return (int)cudaGetLastError();
}
