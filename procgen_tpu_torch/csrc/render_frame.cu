// The whole 64x64 frame of a game that is not static, for sm_90a.
//
// Replaces the Pallas TPU kernel procgen_tpu/render/pallas_kernel.py
// (_render_env inside the pl.pallas_call at :1136) on its non-static path,
// which miner, coinrun, fruitbot and starpilot take, under the static
// camera or the agent-centred one, with a fixed background image or, under
// generated assets, each env's own painted canvas (:679-680): then the
// "atlas" is the envs' [N, 128, 128, 3] uint8 canvases and each env's
// SI_BGROW is its own index, a u8 texel is exact in the Pallas kernel's
// bf16, and the canvas is cropped with aspect 1 or tiled, never scrolled.
// Per pixel, in the QPainter pipeline's order:
//   K1d  the env's background image (else 0), in one of three modes per
//        launch: the standard crop with the random x offset (:656-666);
//        fruitbot's vertical tiling (:646-655): row frac((sy - mr_y) /
//        tile_h) of the image, column (sx - mr_x) / mr_w of it, inside the
//        world rect; or starpilot's time-scrolled tiles (:632-645): 18
//        square tiles of side 3 * 64 from y = -64, shifted by the scroll
//        offset bg_xoff, tx = sx - bg_xoff, column frac(tx / side) of the
//        image where 0 <= tx < 18 * side, row (sy + 64) / side of it.  The
//        division by the constant side is a multiply by its f32 reciprocal,
//        as XLA compiles the JAX package's.  The mode is a template
//        parameter, so each mode's kernel carries no test of the others;
//   K1c  the z=-1 canvases composited over it;
//   K1e  the grid tiles: nearest texel of the camera's cell window, alpha
//        blended with alpha = texel / 255 as a true division (:976-1011);
//   K1f  the colored cells: the cell's r, g, b where its valid plane is
//        > 0.5, the pixel lies in the cell's central inset and no tile
//        covers it (:1016-1038);
//   K1c  the z=0, then the z=1 canvases; rounded; written as uint8.
// Two sprite pools paint into canvases of their own: the entity pool and
// the decor pool (trails, explosions).  At each z level the entity pool's
// canvas is composited first, then the decor pool's (paint_z, :952-959).
// The slot code is render_suffix.cu's (sprite.cuh).
// procgen_tpu_torch/render/render_kernel.py: render_frame_reference is the
// same function in plain torch; the two agree byte for byte.
//
// Each pool is walked in slot order up to its live count.  The pools are
// compacted, so no live slot lies past the count.  For pools of more than
// 16 slots the TPU kernel paints through a grouped pass (K2, :864-926) and a
// legacy slot stream (:832-842); that grouping is a schedule for the TPU's
// matrix unit and paints the same canvases as this in-order walk.
//
// The TPU kernel resamples a per-env tile canvas (u8 [5, NC*sA, NC*sA]) that
// its prep writes to HBM.  Here prep writes a per-cell row table (int32
// [NC, NC]) instead and the kernel reads texel (ri % sA, ci % sA) of row
// table[ri / sA][ci / sA] from the grid atlas; a cell is covered by a tile
// iff its row is below the atlas's transparent row.  The cell is picked
// from the canvas row and column as the TPU kernel picks it,
// floor((wxs - low_x) * sA) / sA, not floor(wxs).
//
// Bound: bytes.  Per env the kernel writes the 12 KiB frame and reads the
// row table and cell planes (6 NC^2 words: 6 KB for the centred camera's
// 16x16 window, 96 KB for a 64x64 world), the slots of both pools (72 B
// each) and the scalars.  The atlases are shared by every env and stay in
// L2.  Design: one 256-thread block per env, one thread per pixel column
// and sixteen rows a thread, so a warp is 32 columns of one row.  The block
// stages in shared memory the env's scalars, row table (16 KB for a 64x64
// window) and slots; it computes once what depends only on the pixel column
// (world x, the cell column and its texel column, the inset test's |u -
// 1/2|, the background column) or only on the row (the same for y, the
// background row), and a table of the 256 grid alphas texel / 255; and it
// plans the sprite painting once (sprite.cuh: the list of the slots that
// paint, their texel index per pixel column and per pixel row, per row a
// mask of the slots that cover it), so a pixel blends only the slots whose
// rectangle holds it.  The cell planes (80 KB for a 64x64 window) are read
// from global memory where a pixel needs them (cached in L1/L2).  Each
// pixel's canvases stay in registers; the pixels go to a shared-memory
// frame that the block stores 16 bytes a thread.  Pools or windows that
// need more than 48 KB of shared memory take it as dynamic shared memory,
// up to the 227 KiB of a block.
//
// Exactness: build with -fmad=false -prec-div=true -ftz=false (kernels.py)
// and keep the TPU kernel's operation order.  Each row or column term is
// the per-pixel expression evaluated once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sprite.cuh"

namespace {

using namespace pgt;

constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / RES;

// per-env scalar columns (render_kernel.py SF_* / SI_*)
constexpr int SF_UNIT = 0, SF_VIS = 1, SF_XOFF = 2, SF_YOFF = 3, SF_MRX = 4,
              SF_MRY = 5, SF_MRW = 6, SF_MRH = 7, SF_BGRX = 8, SF_BGRW = 9,
              SF_TILEH = 10, SF_TOPY = 11, SF_LOWX = 12, SF_N = 13;
// K1d's background modes (render_kernel.py BG_*)
constexpr int BG_NONE = 0, BG_CROP = 1, BG_TILED = 2, BG_SCROLL = 3;
// the scrolled tiles' side and its f32 reciprocal (starpilot, bg_k = 3)
constexpr float SCROLL_SIDE = 3.0f * RES;
constexpr float SCROLL_INV_SIDE = 1.0f / SCROLL_SIDE;
constexpr int SI_BGROW = 0, SI_ENT_COUNT = 1, SI_DEC_COUNT = 2, SI_N = 3;

struct Geometry {
  int cap, dcap, nz, nzd;            // slots and canvases of each pool
  CanvasOrder order;                 // the canvases' composite order
  int NC, sA, n_grid_rows, opaque;   // cell window, tile px, grid atlas rows
  int nb, BH, BW;                    // background atlas
  int S, n_ent_rows;                 // entity atlas
};

// The terms of one pixel column or one pixel row: the cell window's cell
// (-1 outside the window) and texel within the cell, |frac - 1/2| for the
// colored cell's inset test, and the background texel's offset in the
// image (-1 where the background does not reach).
struct AxisTerms {
  int* cell;     // column: ci / sA; row: (ri / sA) * NC
  int* texel;    // ci % sA, ri % sA
  float* half;   // fabsf(u_frac - 0.5f), fabsf(v_frac - 0.5f)
  int* bg;       // bg_col * 3, bg_row * BW * 3
  __device__ void carve(Carve& cv) {
    cell = cv.take<int>(RES);
    texel = cv.take<int>(RES);
    half = cv.take<float>(RES);
    bg = cv.take<int>(RES);
  }
};

// Dynamic shared memory of one block: the frame, the slot tables, the
// scalars, the row table, the column and row terms, the alpha table.
size_t frame_smem(int NC, int cap, int dcap) {
  return align16(FRAME_BYTES) + slot_tables_bytes(cap + dcap) +
         align16(SF_N * 4) + align16(SI_N * 4) + align16((size_t)NC * NC * 4) +
         2 * 4 * align16(RES * 4) + align16(256 * 4);
}

// The column terms (thread x < 64: column x) or row terms (x - 64: row).
template <int BG>
__device__ __forceinline__ void axis_terms(const float* sc, const Geometry& g,
                                           AxisTerms& cols, AxisTerms& rows) {
  const int GS = g.NC * g.sA;
  const float fsA = (float)g.sA;
  const float unit = sc[SF_UNIT];
  constexpr bool tiled = BG == BG_TILED;
  if (threadIdx.x < RES) {
    const int col = threadIdx.x;
    const float sx = (float)col + 0.5f;
    const float wxs = (sx + sc[SF_XOFF]) / unit;
    const float cxx = (wxs - sc[SF_LOWX]) * fsA;
    const int ci = clampi((int)floorf(cxx), 0, GS - 1);
    const bool in_c = (cxx >= 0.f) && (cxx < (float)GS);
    cols.cell[col] = in_c ? ci / g.sA : -1;
    cols.texel[col] = ci % g.sA;
    cols.half[col] = fabsf((wxs - floorf(wxs)) - 0.5f);
    // the image column: in the crop's rect or the world rect, or on the
    // scrolled tiles
    int bg_col = 0;
    bool bg_in_x = false;
    if constexpr (BG == BG_SCROLL) {
      const float tx = sx - sc[SF_BGRX];
      const float fx = tx * SCROLL_INV_SIDE;
      bg_col = clampi((int)((fx - floorf(fx)) * (float)g.BW), 0, g.BW - 1);
      bg_in_x = (tx >= 0.f) && (tx < 18.0f * SCROLL_SIDE);
    } else if constexpr (BG != BG_NONE) {
      const float bgr_x = sc[tiled ? SF_MRX : SF_BGRX];
      const float bgr_w = sc[tiled ? SF_MRW : SF_BGRW];
      bg_col = clampi((int)((sx - bgr_x) / bgr_w * (float)g.BW), 0, g.BW - 1);
      bg_in_x = (sx >= bgr_x) && (sx < bgr_x + bgr_w);
    }
    cols.bg[col] = bg_in_x ? bg_col * 3 : -1;
  } else if (threadIdx.x < 2 * RES) {
    const int row = threadIdx.x - RES;
    const float sy = (float)row + 0.5f;
    const float wys = sc[SF_VIS] - (sy - sc[SF_YOFF]) / unit;
    const float cyx = (sc[SF_TOPY] - wys) * fsA;
    const int ri = clampi((int)floorf(cyx), 0, GS - 1);
    const bool in_r = (cyx >= 0.f) && (cyx < (float)GS);
    rows.cell[row] = in_r ? (ri / g.sA) * g.NC : -1;
    rows.texel[row] = ri % g.sA;
    rows.half[row] = fabsf((wys - floorf(wys)) - 0.5f);
    int bg_row = 0;
    bool in_y = false;
    if constexpr (BG != BG_NONE) {
      const float mr_y = sc[SF_MRY], mr_h = sc[SF_MRH];
      float fy;
      if constexpr (BG == BG_SCROLL) {
        fy = (sy + (float)RES) * SCROLL_INV_SIDE;
      } else if constexpr (tiled) {
        fy = (sy - mr_y) / sc[SF_TILEH];
        fy = fy - floorf(fy);
      } else {
        fy = (sy - mr_y) / mr_h;
      }
      bg_row = clampi((int)(fy * (float)g.BH), 0, g.BH - 1);
      in_y = BG == BG_SCROLL || ((sy >= mr_y) && (sy < mr_y + mr_h));
    }
    rows.bg[row] = in_y ? bg_row * g.BW * 3 : -1;
  }
}

template <int BG>
__global__ void __launch_bounds__(THREADS)
render_frame_kernel(const float* __restrict__ sf_g,
                    const int32_t* __restrict__ si_g,
                    const int32_t* __restrict__ gtab_g,
                    const float* __restrict__ cell5_g,
                    const float* __restrict__ ent_f,
                    const int32_t* __restrict__ ent_i,
                    const float* __restrict__ dec_f,
                    const int32_t* __restrict__ dec_i,
                    const uint8_t* __restrict__ grid_atlas,
                    const uint8_t* __restrict__ bg_atlas,
                    const uint8_t* __restrict__ ent_atlas,
                    uint8_t* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NC2 = g.NC * g.NC;
  Carve cv{smem};
  uint8_t* frame = cv.take<uint8_t>(FRAME_BYTES);
  SlotTables t;
  t.carve(cv, g.cap + g.dcap);
  float* sc = cv.take<float>(SF_N);
  int32_t* sci = cv.take<int32_t>(SI_N);
  int32_t* tab = cv.take<int32_t>(NC2);
  AxisTerms cols, rows;
  cols.carve(cv);
  rows.carve(cv);
  float* alpha_of = cv.take<float>(256);

  const int64_t env = blockIdx.x;
  for (int k = threadIdx.x; k < SF_N; k += THREADS) sc[k] = sf_g[env * SF_N + k];
  for (int k = threadIdx.x; k < SI_N; k += THREADS) sci[k] = si_g[env * SI_N + k];
  for (int k = threadIdx.x; k < NC2; k += THREADS) tab[k] = gtab_g[env * NC2 + k];
  load_slots(ent_f, ent_i, env, g.cap, 0, t);
  load_slots(dec_f, dec_i, env, g.dcap, g.cap, t);
  clear_masks(t, g.cap + g.dcap);
  // the grid alpha of each texel alpha, the true division of K1e
  for (int k = threadIdx.x; k < 256; k += THREADS) alpha_of[k] = (float)k / 255.0f;
  __syncthreads();
  if (threadIdx.x >= THREADS - 32)
    compact_slots(t, g.cap, g.dcap, clampi(sci[SI_ENT_COUNT], 0, g.cap),
                  clampi(sci[SI_DEC_COUNT], 0, g.dcap), g.nz, g.nzd, g.order,
                  g.S, g.n_ent_rows);
  else
    axis_terms<BG>(sc, g, cols, rows);
  __syncthreads();
  axis_tables(t, g.S);
  __syncthreads();

  const float* cell = cell5_g + env * 5 * NC2;   // [5, NC, NC]
  const uint8_t* bg_img =
      bg_atlas + (int64_t)clampi(sci[SI_BGROW], 0, g.nb - 1) * g.BH * g.BW * 3;
  const uchar4* texels = reinterpret_cast<const uchar4*>(ent_atlas);
  const uchar4* grid_texels = reinterpret_cast<const uchar4*>(grid_atlas);

  const int col = threadIdx.x % RES;
  const int c_cell = cols.cell[col], c_texel = cols.texel[col];
  const float c_half = cols.half[col];
  const int c_bg = cols.bg[col];

  for (int row = threadIdx.x / RES; row < RES; row += ROWS_PER_PASS) {
    // K1d: the background, cropped, tiled or scrolled
    float obs[3] = {0.f, 0.f, 0.f};
    if constexpr (BG != BG_NONE) {
      const int r_bg = rows.bg[row];
      if (r_bg >= 0 && c_bg >= 0) {
        const uint8_t* img = bg_img + r_bg + c_bg;
#pragma unroll
        for (int c = 0; c < 3; ++c) obs[c] = (float)img[c];
      }
    }

    // K1b: the sprite canvases of both pools; K1c: z = -1
    float canv[MAX_CANVASES][4];
    clear_canvases(canv);
    const bool painted =
        __any_sync(0xffffffffu, paint_pixel(t, row, col, texels, g.S, canv));
#pragma unroll
    for (int c = 0; c < 3; ++c)
      obs[c] = composite_range(obs[c], canv, 0, g.order.end_pre, c, painted);

    // K1e: grid tiles
    const int r_cell = rows.cell[row];
    const bool inside = c_cell >= 0 && r_cell >= 0;
    const int cell_idx = r_cell + c_cell;
    float tex[4] = {0.f, 0.f, 0.f, 0.f};
    bool covered = false;
    if (inside) {
      const int r = clampi(tab[cell_idx], 0, g.n_grid_rows - 1);
      const uchar4 tx = __ldg(grid_texels + (r * g.sA + rows.texel[row]) * g.sA + c_texel);
      tex[0] = (float)tx.x;
      tex[1] = (float)tx.y;
      tex[2] = (float)tx.z;
      tex[3] = (float)tx.w;
      covered = r < g.opaque;
    }
    // a transparent texel (or none) blends with alpha 0: obs * 1 + tex * 0,
    // rounded, is obs, which is a whole number here (a background byte,
    // 0, or a rounded composite)
    if (tex[3] != 0.f) {
      const float alpha = alpha_of[(int)tex[3]];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        obs[c] = rintf(obs[c] * (1.f - alpha) + tex[c] * alpha);
    }

    // K1f: colored cells
    if (inside && !covered && __ldg(cell + 3 * NC2 + cell_idx) > 0.5f) {
      const float half = __ldg(cell + 4 * NC2 + cell_idx) * 0.5f;
      if (c_half < half && rows.half[row] < half) {
#pragma unroll
        for (int c = 0; c < 3; ++c) obs[c] = __ldg(cell + c * NC2 + cell_idx);
      }
    }

    // K1c: z = 0, then z = 1
    uint8_t* px = frame + (row * RES + col) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      px[c] = (uint8_t)(int32_t)composite_range(obs[c], canv, g.order.end_pre,
                                                g.order.end_all, c, painted);
  }
  __syncthreads();
  copy_frame(out + env * FRAME_BYTES, frame);
}

using FrameKernel = decltype(&render_frame_kernel<BG_NONE>);

FrameKernel instance_of(int bg_mode) {
  return bg_mode == BG_SCROLL  ? render_frame_kernel<BG_SCROLL>
         : bg_mode == BG_TILED ? render_frame_kernel<BG_TILED>
         : bg_mode == BG_CROP  ? render_frame_kernel<BG_CROP>
                               : render_frame_kernel<BG_NONE>;
}

}  // namespace

// Plain C entry point (loaded with ctypes by procgen_tpu_torch/kernels.py).
// sf: f32 [n, 13] (camera, world rect, crop rect or scroll offset, tile
// height, window);
// si: int32 [n, 3] (background row, entity and decor live counts); gtab:
// int32 [n, NC, NC]; cell5: f32 [n, 5, NC, NC]; ent_f / dec_f: f32 [n,
// cap|dcap, 8]; ent_i / dec_i: int32 [n, cap|dcap, 10]; grid_atlas: uint8
// [n_grid_rows, sA, sA, 4]; bg_atlas: uint8 [nb, BH, BW, 3]; ent_atlas:
// uint8 [n_ent_rows, S, S, 4], S <= 255 (the axis tables are uint8); out:
// uint8 [n, 64, 64, 3].  zm1/z0/z1 and dzm1/dz0/dz1: each pool's canvas
// index of z = -1, 0, 1 among its nz / nzd canvases, or -1 for none.
// bg_mode: BG_NONE, BG_CROP, BG_TILED or BG_SCROLL.  Refuses a window and
// pools whose block would need more than 227 KiB of shared memory.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int render_frame(const float* sf, const int32_t* si,
                            const int32_t* gtab, const float* cell5,
                            const float* ent_f, const int32_t* ent_i,
                            const float* dec_f, const int32_t* dec_i,
                            const uint8_t* grid_atlas, const uint8_t* bg_atlas,
                            const uint8_t* ent_atlas, uint8_t* out, int n,
                            int cap, int dcap, int nz, int nzd, int zm1, int z0,
                            int z1, int dzm1, int dz0, int dz1, int NC, int sA,
                            int n_grid_rows, int opaque, int bg_mode, int nb,
                            int BH, int BW, int S, int n_ent_rows,
                            cudaStream_t stream) {
  if (n <= 0) return 0;
  const int zs[3] = {zm1, z0, z1}, dzs[3] = {dzm1, dz0, dz1};
  bool ok = nz >= 1 && nzd >= 0 && nz + nzd <= MAX_CANVASES && cap >= 0 &&
            dcap >= 0 && NC >= 1 && sA >= 1 && n_grid_rows >= 1 && nb >= 1 &&
            bg_mode >= BG_NONE && bg_mode <= BG_SCROLL &&
            BH >= 1 && BW >= 1 && S >= 1 && S < OUTSIDE && n_ent_rows >= 1;
  for (int k = 0; k < 3; ++k)
    ok = ok && zs[k] >= -1 && zs[k] < nz && dzs[k] >= -1 && dzs[k] < nzd;
  // at z = -1 (before the grid), then z = 0, then z = 1: the entity pool's
  // canvas, then the decor pool's (paint_z, pallas_kernel.py:952-959)
  CanvasOrder order{};
  ok = ok && make_order(zs, dzs, 3, 1, nz, &order);
  const size_t smem = frame_smem(NC, cap, dcap);
  if (!ok || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Geometry g{cap, dcap, nz, nzd, order,
                   NC, sA, n_grid_rows, opaque, nb, BH, BW, S, n_ent_rows};
  const FrameKernel kernel = instance_of(bg_mode);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)n, THREADS, smem, stream>>>(
      sf, si, gtab, cell5, ent_f, ent_i, dec_f, dec_i, grid_atlas, bg_atlas,
      ent_atlas, out, g);
  return (int)cudaGetLastError();
}

// The compiled instance's resources for this background mode, window and
// pools (pgt::occupancy).
extern "C" int render_frame_occupancy(int bg_mode, int NC, int cap, int dcap,
                                      int* out) {
  return occupancy(instance_of(bg_mode), frame_smem(NC, cap, dcap), THREADS, out);
}
