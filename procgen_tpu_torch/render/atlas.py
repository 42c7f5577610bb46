"""Sprite/background atlas baking + the (type, theme) -> atlas row lookup.

The numpy baking is a copy of ``procgen_tpu.render.atlas`` (PIL bilinear
resize of the baked artifact's images, rotation banks), so both packages
hold byte-equal atlases (tests/test_torch_host.py).  The row lookups the
JAX package writes as static where-chains are gathers from small tables
here; they return the same rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.constants import MAX_ASSETS
from . import assets as asset_tables
from .assetgen_host import bake_generated_asset
from .assets import monochrome_color


def _load_image(rel_path: str) -> Optional[np.ndarray]:
    """RGBA pixels from the baked artifact; raises when a referenced asset
    is missing from it (the reference fatals on unloadable images,
    resources.cpp:26-28)."""
    pix = asset_tables.load_rgba(rel_path)
    if pix is None and asset_tables.assets_available():
        raise FileNotFoundError(
            f"asset {rel_path!r} missing from the baked artifact"
        )
    return pix


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.fromarray(img).resize((w, h), Image.BILINEAR), np.uint8
    )


# Rotated bank tiles cover a sqrt(2)-enlarged footprint so the rotated
# sprite's corners survive; renderers enlarge the screen rect of banked
# draws by the same factor.
ROT_OVERHANG = float(np.sqrt(2.0))


def _rotate_tile(pix: np.ndarray, theta: float,
                 footprint: float = ROT_OVERHANG) -> np.ndarray:
    """Nearest-neighbor texture-space rotation by ``theta`` (clockwise in
    screen coords, matching Qt rotate); out-of-source texels transparent."""
    S = pix.shape[0]
    ii, jj = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    a = ((jj + 0.5) / S - 0.5) * footprint  # right+
    b = ((ii + 0.5) / S - 0.5) * footprint  # down+
    c, s_ = np.cos(theta), np.sin(theta)
    p = a * c + b * s_
    q = -a * s_ + b * c
    sc = np.floor((p + 0.5) * S).astype(np.int64)
    sr = np.floor((q + 0.5) * S).astype(np.int64)
    inb = (sc >= 0) & (sc < S) & (sr >= 0) & (sr < S)
    out = np.zeros_like(pix)
    out[inb] = pix[sr[inb], sc[inb]]
    return out


class GridAtlas:
    """Pre-scaled tile atlas + (img, theme) -> row tables."""

    def __init__(self, game, tile_px: int):
        self.tile_px = tile_px
        entries = []  # (img_type, theme, pixels[s,s,4])
        if game.options.use_generated_assets:
            # every drawable type gets one generated theme (basic-abstract-
            # game.cpp:93-110; procgen_tpu/render/atlas.py:93-111)
            for type_ in range(MAX_ASSETS):
                if not (game.asset_for_type(type_)
                        or game.RESERVED_ASSETS.get(type_)):
                    continue
                raw = bake_generated_asset(
                    int(game.fixed_asset_seed), type_,
                    bool(game.use_block_asset(type_)),
                )
                entries.append((type_, 0, _resize(raw, tile_px, tile_px)))
        else:
            for type_ in range(MAX_ASSETS):
                names = game.asset_names(type_)
                for theme, name in enumerate(names):
                    raw = _load_image(name)
                    if raw is None:
                        r, g, b = monochrome_color(type_ % 64, theme)
                        pix = np.zeros((tile_px, tile_px, 4), np.uint8)
                        pix[..., 0], pix[..., 1], pix[..., 2] = r, g, b
                        pix[..., 3] = 255
                    else:
                        pix = _resize(raw, tile_px, tile_px)
                    entries.append((type_, theme, pix))

        self.entries = [(t, th) for t, th, _ in entries]
        n = len(entries)
        rows = np.zeros((n + 1, tile_px, tile_px, 4), np.uint8)
        for i, (_, _, pix) in enumerate(entries):
            rows[i] = pix
        # final row = fully transparent (SPACE / unknown)
        self.transparent_row = n

        # arbitrary-rotation bank (procgen_tpu/render/atlas.py:132-169)
        default_k = int(getattr(game, "ROT_BANK_K", 32))
        arb_decl = getattr(game, "ARB_ROT_TYPES", ()) or ()
        if isinstance(arb_decl, dict):
            arb_k = {int(t): int(k) for t, k in arb_decl.items()}
        else:
            arb_k = {int(t): default_k for t in arb_decl}
        bank_start = np.full((n + 1,), -1, np.int64)
        bank_k = np.full((n + 1,), 0, np.int64)
        bank_rows = []
        for i, ((t, th), (_, _, pix)) in enumerate(zip(self.entries, entries)):
            if t not in arb_k:
                continue
            k = arb_k[t]
            bank_start[i] = n + 1 + len(bank_rows)
            bank_k[i] = k
            for refl in (False, True):
                src = pix[:, ::-1] if refl else pix
                for b in range(k):
                    bank_rows.append(_rotate_tile(src, 2.0 * np.pi * b / k))
        if bank_rows:
            rows = np.concatenate([rows, np.stack(bank_rows)], axis=0)
        self.rows = rows  # [n+1+bank, s, s, 4]
        self.bank_start = bank_start  # base row -> first bank row (or -1)
        self.bank_k = bank_k  # base row -> angle buckets

        # lookup tables for row_for: table[t, th] is the row of (t, th),
        # else the row of (t, 0), else the transparent row
        self.n_themes = max([th + 1 for _, th in self.entries] or [1])
        table = np.full((MAX_ASSETS, self.n_themes), n, np.int64)
        for row, (t, th) in enumerate(self.entries):
            if th == 0:
                table[t, :] = np.where(table[t, :] == n, row, table[t, :])
        for row, (t, th) in enumerate(self.entries):
            table[t, th] = row
        self._table_np = table
        self._tables: dict = {}

    def _table(self, device):
        key = str(device)
        if key not in self._tables:
            self._tables[key] = (
                torch.as_tensor(self._table_np, device=device),
                torch.as_tensor(self.bank_start, device=device),
                torch.as_tensor(self.bank_k, device=device),
            )
        return self._tables[key]

    def rows_on(self, device) -> torch.Tensor:
        """The atlas rows as a uint8 [n_rows, S, S, 4] tensor on
        ``device`` (cached)."""
        key = ("rows", str(device))
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(self.rows, device=device)
        return self._tables[key]

    def row_for(self, img, theme):
        """(img, theme) int tensors -> atlas row (int32), by table gather."""
        table, _, _ = self._table(img.device)
        img = img.long()
        theme = theme.long()
        known = (img >= 0) & (img < MAX_ASSETS)
        t = img.clamp(0, MAX_ASSETS - 1)
        in_th = (theme >= 0) & (theme < self.n_themes)
        th = torch.where(in_th, theme, torch.zeros_like(theme))
        row = table[t, th]
        row = torch.where(known, row, torch.full_like(row, self.transparent_row))
        return row.to(torch.int32)

    def bank_row_for(self, base_row, refl, rot):
        """(bank row, has_bank) for (base row, reflection, angle); the base
        row itself when the type has no bank."""
        _, start, kk = self._table(base_row.device)
        br = base_row.long().clamp(0, len(self.bank_start) - 1)
        st = start[br]
        k = kk[br]
        has = st >= 0
        if not bool(np.any(self.bank_start >= 0)):
            return base_row.to(torch.int32), has
        # k / two_pi per entry, a Python float rounded to f32 as in the JAX
        # where-chain, times the angle
        scale = torch.as_tensor(
            (self.bank_k / (2.0 * np.pi)).astype(np.float32),
            device=base_row.device,
        )[br]
        bucket = torch.round(rot * scale).to(torch.int32).long()
        bucket = torch.remainder(bucket, torch.clamp_min(k, 1))
        out = torch.where(has, st + refl.long() * k + bucket, base_row.long())
        return out.to(torch.int32), has


class BackgroundAtlas:
    """Background group images + original aspects, pre-scaled to the output
    resolution (procgen_tpu/render/atlas.py:210-228)."""

    def __init__(self, names: list[str], res: int = 64):
        self.BH = res
        self.BW = res * 5 // 3
        n = max(len(names), 1)
        self.pixels = np.zeros((n, self.BH, self.BW, 3), np.uint8)
        self.aspects = np.ones((n,), np.float32)
        self.loaded = False
        for i, name in enumerate(names):
            raw = _load_image(name)
            if raw is None:
                continue
            self.pixels[i] = _resize(raw, self.BH, self.BW)[..., :3]
            self.aspects[i] = raw.shape[1] / raw.shape[0]
            self.loaded = True
        self._dev: dict = {}

    def tensors(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (
                torch.as_tensor(self.pixels, device=device),
                torch.as_tensor(self.aspects, device=device),
            )
        return self._dev[key]


_CACHE: dict = {}


def get_atlases(game, res: int):
    """(GridAtlas, BackgroundAtlas, entity GridAtlas) for a game at a given
    resolution; cached.  Raises when the asset artifact is missing."""
    # the tile size follows the camera, so center_agent is part of the
    # key, with every option; generated sprites follow the asset seed
    key = (
        game.name, game.options, res, id(type(game)), bool(game.center_agent),
        game.options.use_generated_assets and int(game.fixed_asset_seed),
    )
    if key in _CACHE:
        return _CACHE[key]
    if not (asset_tables.assets_available() or game.options.use_generated_assets):
        raise RuntimeError(
            "no assets: the baked artifact procgen_tpu/data/assets.npz "
            "is missing (tools/bake_assets.py)"
        )
    if game.options.use_monochrome_assets:
        grid_atlas = None
        ent_atlas = None
    else:
        if game.center_agent:
            vis = game.visibility
        else:
            vis = max(game.WORLD_DIM_MAX)
            vis = max(vis, game.min_visibility)
        tile_px = max(2, int(np.ceil(res / vis)))
        grid_atlas = GridAtlas(game, tile_px)
        ent_atlas = GridAtlas(game, max(16, res // 2))
    if game.uses_procgen_background:
        bg_atlas = None  # each env's painted canvas, state.bg_canvas
    else:
        bg_atlas = BackgroundAtlas(game.background_names(), res)
        if not bg_atlas.loaded:
            bg_atlas = None
    _CACHE[key] = (grid_atlas, bg_atlas, ent_atlas)
    return _CACHE[key]
