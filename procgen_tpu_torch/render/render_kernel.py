"""The per-step frame render: prep in torch, the sprite suffix in CUDA.

The counterpart of ``procgen_tpu.render.pallas_kernel`` on the
static-prefix path, which maze takes: the background, grid tiles and
colored cells are composed once per level into ``state.frame``
(lifecycle.env_reset), and each step composites only the entity sprites
over that frame.

* ``prep`` evaluates every game hook at ``[N, cap]`` scale (rects, atlas
  rows, flips, tiling, fallback colors) — ``_prep_pool`` of the JAX
  package, operation for operation.
* ``render_suffix`` launches ``csrc/render_suffix.cu`` on CUDA tensors;
  ``render_suffix_reference`` is the same function as vectorised torch and
  runs for CPU tensors.  Both reproduce the Pallas kernel's K1a (start
  from the cached frame), K1b (per-slot sampling into premultiplied bf16
  canvases, one per z level) and K1c (composite z=0 then z=1, round, u8).
* ``post`` adds the velocity squares and game overlays.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.constants import SPACE
from .atlas import ROT_OVERHANG, get_atlases
from .renderer import camera, post

f32 = torch.float32
i32 = torch.int32
u8 = torch.uint8

RES = 64

# ent_f columns
EF_X0, EF_Y0, EF_W2, EF_H2, EF_ALPHA, EF_R, EF_G, EF_B = range(8)
EF_N = 8
# ent_i columns
(EI_ROW, EI_LIVE, EI_FB, EI_PFLIP, EI_QFLIP, EI_Z, EI_NTH, EI_NTV,
 EI_TILEH, EI_TILEV) = range(10)
EI_N = 10

# Launches of the CUDA kernel since import (or since a caller reset it);
# render_suffix adds one per launch and nothing else touches it.
LAUNCHES = 0


class RenderPlan:
    """Static per-game plan: the entity atlas in the kernel's layout."""

    def __init__(self, game, res: int):
        assert res == RES, "the frame kernel is 64x64 only"
        _, _, ent_atlas = get_atlases(game, res)
        if ent_atlas is None:
            raise NotImplementedError("monochrome sprites not ported (ROADMAP)")
        self.game = game
        self.res = res
        self.ent_atlas = ent_atlas
        self.z_levels = tuple(game.ENT_Z_LEVELS)
        self.S = ent_atlas.tile_px
        rows = ent_atlas.rows  # [n1e, S, S, 4] u8, transparent row kept
        self.n1e = rows.shape[0]
        # rows, then their transposes: the quarter-turn variants
        self.atlas_np = np.ascontiguousarray(
            np.concatenate([rows, np.transpose(rows, (0, 2, 1, 3))], axis=0)
        )  # [2*n1e, S, S, 4] u8
        self._dev: dict = {}

    def atlas(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.atlas_np, device=device)
        return self._dev[key]


_PLANS: dict = {}


def get_plan(game, res: int = RES) -> RenderPlan:
    key = (game.name, game.options.distribution_mode, res, id(type(game)),
           game.options.use_monochrome_assets)
    if key not in _PLANS:
        _PLANS[key] = RenderPlan(game, res)
    return _PLANS[key]


def supports(game, res: int = RES) -> bool:
    """Games whose per-step frame this module reproduces: the JAX gate
    (procgen_tpu/render/pallas_kernel.py:204-215) restricted to the ported
    static-prefix path with the entity pool alone at z in (0, 1)."""
    from ..core.game import BasicAbstractGame

    if res != RES:
        return False
    if type(game).paint_background is not BasicAbstractGame.paint_background:
        return False
    if type(game).grid_cell_colors is not BasicAbstractGame.grid_cell_colors:
        return False
    return (
        bool(game.static_prefix)
        and not game.DECOR_CAP
        and tuple(game.ENT_Z_LEVELS) in ((0,), (1,), (0, 1))
    )


# ---------------------------------------------------------------------------
# prep: game hooks at [N, cap] scale (procgen_tpu/render/pallas_kernel.py
# _prep_pool, :437-545)
# ---------------------------------------------------------------------------


def prep(plan: RenderPlan, s):
    """Per-slot sprite parameters: (ent_f f32 [N, cap, 8], ent_i int32
    [N, cap, 10])."""
    game = plan.game
    res = plan.res
    e = s.ents
    n, cap = e.x.shape
    unit, vis, x_off, y_off = camera(game, s, res)
    c = lambda t: t[:, None]  # noqa: E731  [N] -> [N, 1]

    img_all = game.image_for_type(s, e.image_type)
    live_all = e.active & (img_all >= 0) & (img_all != SPACE)
    live_all = live_all & game.should_draw_entity_mask(s)
    row_all = plan.ent_atlas.row_for(img_all, game.mask_theme(img_all, e.image_theme))
    is_fallback = row_all == plan.ent_atlas.transparent_row
    tile_ratio_all = game.entity_tile_ratio(s, e)

    x0_w = (e.x - e.rx) * c(unit) - c(x_off)
    y0_w = (c(vis) - (e.y + e.ry)) * c(unit) + c(y_off)
    w2_w = 2 * e.rx * c(unit)
    h2_w = 2 * e.ry * c(unit)
    x0_a = res * (e.x - e.rx)
    y0_a = res * (e.y + e.ry)
    w2_a = 2 * res * e.rx
    h2_a = 2 * res * e.ry
    ua = e.use_abs_coords
    x0 = torch.where(ua, x0_a, x0_w)
    y0 = torch.where(ua, y0_a, y0_w)
    w2 = torch.where(ua, w2_a, w2_w)
    h2 = torch.where(ua, h2_a, h2_w)
    x0, y0, w2, h2 = game.adjust_image_rect(img_all, x0, y0, w2, h2)
    w2 = torch.clamp_min(w2, 1e-6)
    h2 = torch.clamp_min(h2, 1e-6)

    fr, fg, fb = game.color_for_type(img_all, e.image_theme)

    # rotation quarter + reflection -> atlas variant + index flips: with T
    # the transposed variant, use_t=0 samples orig[p, refl ? S-1-q : q]
    # and use_t=1 samples origT[refl ? S-1-p : p, q], so
    # pflip = rowflip ^ (use_t & refl) and qflip = colflip ^ (~use_t & refl)
    qf = e.rotation * (2.0 / torch.pi)
    q = torch.remainder(torch.round(qf).to(i32), 4)
    refl = e.is_reflected
    arb = torch.abs(qf - torch.round(qf)) > 1e-4
    brow, has_bank = plan.ent_atlas.bank_row_for(row_all, refl.to(i32), e.rotation)
    use_bank = arb & has_bank

    grow = torch.where(use_bank, ROT_OVERHANG, 1.0).to(f32)
    x0 = x0 - w2 * (grow - 1.0) * 0.5
    y0 = y0 - h2 * (grow - 1.0) * 0.5
    w2 = torch.clamp_min(w2 * grow, 1e-6)
    h2 = torch.clamp_min(h2 * grow, 1e-6)
    use_t = ((q == 1) | (q == 3)) & ~use_bank
    rowflip = ((q == 2) | (q == 3)) & ~use_bank
    colflip = ((q == 1) | (q == 2)) & ~use_bank
    refl = refl & ~use_bank
    pflip = rowflip ^ (use_t & refl)
    qflip = colflip ^ (~use_t & refl)
    row2 = torch.where(use_bank, brow, row_all + torch.where(use_t, plan.n1e, 0))

    tr = tile_ratio_all
    nt_h = torch.clamp_min((w2 / (h2 * torch.clamp_min(tr, 1e-6))).to(i32), 1)
    nt_v = torch.clamp_min((h2 / (w2 * torch.clamp_min(-tr, 1e-6))).to(i32), 1)

    z_idx = torch.full_like(e.render_z, -1)
    for j, z in enumerate(plan.z_levels):
        z_idx = torch.where(e.render_z == z, j, z_idx)

    def col(v):
        return torch.as_tensor(v, device=e.x.device).to(f32).expand(n, cap)

    ent_f = torch.stack(
        [x0, y0, w2, h2, e.alpha, col(fr), col(fg), col(fb)], dim=-1
    ).contiguous()
    ent_i = torch.stack(
        [row2.to(i32), live_all.to(i32), is_fallback.to(i32),
         pflip.to(i32), qflip.to(i32), z_idx.to(i32), nt_h, nt_v,
         (tr > 0).to(i32), (tr < 0).to(i32)],
        dim=-1,
    ).contiguous()
    return ent_f, ent_i


# ---------------------------------------------------------------------------
# the suffix: plain torch version and the CUDA kernel
# ---------------------------------------------------------------------------


def render_suffix_reference(base, ent_f, ent_i, atlas, nz: int):
    """Plain torch sprite suffix: the kernel's function on [N, cap, ...].

    ``base`` uint8 [N, 64, 64, 3] (the cached prefix frame), ``ent_f`` /
    ``ent_i`` from ``prep``, ``atlas`` uint8 [2*n1e, S, S, 4].  Slots
    paint in order into premultiplied RGBA canvases, one per z index,
    each rounded to bf16 after every slot; the canvases then composite
    over the frame in z order.  Returns uint8 [N, 64, 64, 3]."""
    n, res = base.shape[0], base.shape[1]
    cap = ent_f.shape[1]
    S = atlas.shape[1]
    dev = base.device
    sx = (torch.arange(res, dtype=f32, device=dev) + 0.5)[None, :]
    sy = sx
    canv = torch.zeros((nz, n, res, res, 4), dtype=f32, device=dev)
    nidx = torch.arange(n, device=dev)[:, None, None]
    for i in range(cap):
        fi = ent_f[:, i]
        ii = ent_i[:, i]
        x0, y0, w2, h2 = (fi[:, k:k + 1] for k in (EF_X0, EF_Y0, EF_W2, EF_H2))
        u = (sx - x0) / w2  # [N, res]
        xvalid = (u >= 0) & (u < 1)
        ut = u * ii[:, EI_NTH:EI_NTH + 1].to(f32)
        u_ = torch.where(ii[:, EI_TILEH:EI_TILEH + 1] > 0, ut - torch.floor(ut), u)
        ui = (u_ * S).to(i32).clamp(0, S - 1)
        qidx = torch.where(ii[:, EI_QFLIP:EI_QFLIP + 1] > 0, S - 1 - ui, ui)

        v = (sy - y0) / h2
        yvalid = (v >= 0) & (v < 1)
        vt = v * ii[:, EI_NTV:EI_NTV + 1].to(f32)
        v_ = torch.where(ii[:, EI_TILEV:EI_TILEV + 1] > 0, vt - torch.floor(vt), v)
        vi = (v_ * S).to(i32).clamp(0, S - 1)
        pidx = torch.where(ii[:, EI_PFLIP:EI_PFLIP + 1] > 0, S - 1 - vi, vi)

        row = ii[:, EI_ROW].long().clamp(0, atlas.shape[0] - 1)
        tex = atlas[row[:, None, None], pidx.long()[:, :, None],
                    qidx.long()[:, None, :]].to(f32)  # [N, res, res, 4]
        inside = yvalid[:, :, None] & xvalid[:, None, :]
        tex = torch.where(inside[..., None], tex, 0.0)
        cover = inside.to(f32)

        fb = (ii[:, EI_FB] > 0)[:, None, None]
        alpha_e = fi[:, EF_ALPHA][:, None, None]
        a = torch.where(fb, cover, tex[..., 3] * (1.0 / 255.0) * alpha_e * cover)
        on = (ii[:, EI_LIVE] > 0) & (ii[:, EI_Z] >= 0)
        a = torch.where(on[:, None, None], a, 0.0)
        rgb = torch.where(fb[..., None], fi[:, EF_R:EF_B + 1][:, None, None, :],
                          tex[..., :3])
        zc = ii[:, EI_Z].long().clamp(0, nz - 1)
        old = canv[zc, nidx[:, 0, 0]]  # [N, res, res, 4]
        a1 = a[..., None]
        new_rgb = (rgb * a1 + old[..., :3] * (1 - a1))
        new_a = a1 + old[..., 3:] * (1 - a1)
        new = torch.cat([new_rgb, new_a], dim=-1).to(torch.bfloat16).to(f32)
        canv[zc, nidx[:, 0, 0]] = new

    obs = base.to(f32)
    for z in range(nz):
        c4 = canv[z]
        obs = torch.round(c4[..., :3] + obs * (1 - c4[..., 3:]))
    return obs.to(i32).to(u8)


def render_suffix(base, ent_f, ent_i, atlas, nz: int):
    """Launch ``csrc/render_suffix.cu`` on CUDA tensors (same contract as
    ``render_suffix_reference``); raises on anything it does not take."""
    global LAUNCHES
    from .. import kernels

    dev = base.device
    if dev.type != "cuda":
        raise ValueError("render_suffix takes CUDA tensors")
    n = base.shape[0]
    for name, t, dt, shape in (
        ("base", base, u8, (n, RES, RES, 3)),
        ("ent_f", ent_f, f32, (n, ent_f.shape[1], EF_N)),
        ("ent_i", ent_i, i32, (n, ent_f.shape[1], EI_N)),
        ("atlas", atlas, u8, (atlas.shape[0], atlas.shape[1], atlas.shape[1], 4)),
    ):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"render_suffix: {name} must be {dt} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"render_suffix: {name} must be contiguous")
    cap = ent_f.shape[1]
    # up to 4 canvases in registers; the slots' 72 bytes each in the
    # default 48 KiB of shared memory
    if not 1 <= nz <= 4 or cap * 72 > 48 * 1024:
        raise ValueError(f"render_suffix: nz={nz} or cap={cap} out of range")
    out = torch.empty((n, RES, RES, 3), dtype=u8, device=dev)
    if n == 0:
        return out
    lib = kernels.load()
    err = lib.render_suffix(
        base.data_ptr(), ent_f.data_ptr(), ent_i.data_ptr(), atlas.data_ptr(),
        out.data_ptr(), n, cap, nz, atlas.shape[1], atlas.shape[0],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"render_suffix launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def synthetic_slots(n: int, cap: int, n_rows: int, seed: int = 0):
    """Made-up (ent_f, ent_i) CPU tensors covering what maze states do not
    reach: fallback slots, alpha < 1, tall sprites (h2 > 24), rects over
    the frame edges, flipped and transposed-variant rows, tiling along
    either axis, dead and foreign-z slots.  Built with numpy from ``seed``;
    the kernel check feeds them to the kernel and its plain version."""
    rng = np.random.RandomState(seed)
    shape = (n, cap)
    ent_f = np.zeros(shape + (EF_N,), np.float32)
    ent_f[..., EF_X0] = rng.uniform(-24, 72, shape)
    ent_f[..., EF_Y0] = rng.uniform(-24, 72, shape)
    ent_f[..., EF_W2] = rng.choice([0.7, 4.0, 9.0, 17.5, 30.0, 61.0], shape)
    ent_f[..., EF_H2] = rng.choice([0.7, 4.0, 9.0, 25.0, 40.0, 70.0], shape)
    ent_f[..., EF_ALPHA] = np.where(
        rng.rand(*shape) < 0.5, 1.0, rng.uniform(0, 1, shape)
    )
    ent_f[..., EF_R:EF_B + 1] = rng.randint(0, 256, shape + (3,))
    ent_i = np.zeros(shape + (EI_N,), np.int32)
    ent_i[..., EI_ROW] = rng.randint(0, n_rows, shape)
    ent_i[..., EI_LIVE] = rng.rand(*shape) < 0.85
    ent_i[..., EI_FB] = rng.rand(*shape) < 0.2
    ent_i[..., EI_PFLIP] = rng.rand(*shape) < 0.4
    ent_i[..., EI_QFLIP] = rng.rand(*shape) < 0.4
    ent_i[..., EI_Z] = rng.choice([-1, 0, 1, 1], shape)
    ent_i[..., EI_NTH] = rng.randint(1, 5, shape)
    ent_i[..., EI_NTV] = rng.randint(1, 5, shape)
    mode = rng.randint(0, 3, shape)  # 0: stretch, 1: tile x, 2: tile y
    ent_i[..., EI_TILEH] = mode == 1
    ent_i[..., EI_TILEV] = mode == 2
    return torch.as_tensor(ent_f), torch.as_tensor(ent_i)


def render_obs_batch(game, states, res: int = RES):
    """Batched uint8 [N, 64, 64, 3] frames on the static-prefix path: the
    CUDA kernel for CUDA states, its plain torch version for CPU states."""
    if not supports(game, res):
        raise NotImplementedError(
            f"{game.name}: only the static-prefix frame path is ported"
        )
    plan = get_plan(game, res)
    ent_f, ent_i = prep(plan, states)
    base = states.frame
    atlas = plan.atlas(base.device)
    nz = len(plan.z_levels)
    if base.is_cuda:
        out = render_suffix(base.contiguous(), ent_f, ent_i, atlas, nz)
    else:
        out = render_suffix_reference(base, ent_f, ent_i, atlas, nz)
    return post(game, states, out.to(i32), res).to(u8)
