"""Asset tables: background groups + color helpers.

Path lists mirror resources.cpp:828-953 (counts matter for RNG parity:
``background_index = randn(len(group))`` at every reset).  The tables are a
copy of ``procgen_tpu.render.assets``; the atlas baking lives in
``atlas.py``.
"""

SPACE_BACKGROUNDS = [
    "space_backgrounds/deep_space_01.png",
    "space_backgrounds/spacegen_01.png",
    "space_backgrounds/milky_way_01.png",
    "space_backgrounds/ez_space_lite_01.png",
    "space_backgrounds/meyespace_v1_01.png",
    "space_backgrounds/eye_nebula_01.png",
    "space_backgrounds/deep_sky_01.png",
    "space_backgrounds/space_nebula_01.png",
    "space_backgrounds/Background-1.png",
    "space_backgrounds/Background-2.png",
    "space_backgrounds/Background-3.png",
    "space_backgrounds/Background-4.png",
    "space_backgrounds/parallax-space-backgound.png",
]

_PLATFORM_BACKGROUNDS_BASE = [
    "platform_backgrounds/alien_bg.png",
    "platform_backgrounds/another_world_bg.png",
    "platform_backgrounds/back_cave.png",
    "platform_backgrounds/caverns.png",
    "platform_backgrounds/cyberpunk_bg.png",
    "platform_backgrounds/parallax_forest.png",
    "platform_backgrounds/scifi_bg.png",
    "platform_backgrounds/scifi2_bg.png",
    "platform_backgrounds/living_tissue_bg.png",
    "platform_backgrounds/airadventurelevel1.png",
    "platform_backgrounds/airadventurelevel2.png",
    "platform_backgrounds/airadventurelevel3.png",
    "platform_backgrounds/airadventurelevel4.png",
    "platform_backgrounds/cave_background.png",
    "platform_backgrounds/blue_desert.png",
    "platform_backgrounds/blue_grass.png",
    "platform_backgrounds/blue_land.png",
    "platform_backgrounds/blue_shroom.png",
    "platform_backgrounds/colored_desert.png",
    "platform_backgrounds/colored_grass.png",
    "platform_backgrounds/colored_land.png",
    "platform_backgrounds/colored_shroom.png",
    "platform_backgrounds/landscape1.png",
    "platform_backgrounds/landscape2.png",
    "platform_backgrounds/landscape3.png",
    "platform_backgrounds/landscape4.png",
    "platform_backgrounds/battleback1.png",
    "platform_backgrounds/battleback2.png",
    "platform_backgrounds/battleback3.png",
    "platform_backgrounds/battleback4.png",
    "platform_backgrounds/battleback5.png",
    "platform_backgrounds/battleback6.png",
    "platform_backgrounds/battleback7.png",
    "platform_backgrounds/battleback8.png",
    "platform_backgrounds/battleback9.png",
    "platform_backgrounds/battleback10.png",
    "platform_backgrounds/sunrise.png",
    "platform_backgrounds_2/beach1.png",
    "platform_backgrounds_2/beach2.png",
    "platform_backgrounds_2/beach3.png",
    "platform_backgrounds_2/beach4.png",
    "platform_backgrounds_2/fantasy1.png",
    "platform_backgrounds_2/fantasy2.png",
    "platform_backgrounds_2/fantasy3.png",
    "platform_backgrounds_2/fantasy4.png",
    "platform_backgrounds_2/candy1.png",
    "platform_backgrounds_2/candy2.png",
    "platform_backgrounds_2/candy3.png",
    "platform_backgrounds_2/candy4.png",
]

# space backgrounds are appended to the platform group at load time
# (resources.cpp:975-977)
PLATFORM_BACKGROUNDS = _PLATFORM_BACKGROUNDS_BASE + SPACE_BACKGROUNDS

TOPDOWN_BACKGROUNDS = [
    "topdown_backgrounds/floortiles.png",
    "topdown_backgrounds/backgrounddetailed1.png",
    "topdown_backgrounds/backgrounddetailed2.png",
    "topdown_backgrounds/backgrounddetailed3.png",
    "topdown_backgrounds/backgrounddetailed4.png",
    "topdown_backgrounds/backgrounddetailed5.png",
    "topdown_backgrounds/backgrounddetailed6.png",
    "topdown_backgrounds/backgrounddetailed7.png",
    "topdown_backgrounds/backgrounddetailed8.png",
]

TOPDOWN_SIMPLE_BACKGROUNDS = ["topdown_backgrounds/floortiles.png"]

WATER_BACKGROUNDS = [
    "water_backgrounds/water1.png",
    "water_backgrounds/water2.png",
    "water_backgrounds/water3.png",
    "water_backgrounds/water4.png",
    "water_backgrounds/underwater1.png",
    "water_backgrounds/underwater2.png",
    "water_backgrounds/underwater3.png",
]

WATER_SURFACE_BACKGROUNDS = [
    "water_backgrounds/water1.png",
    "water_backgrounds/water2.png",
    "water_backgrounds/water3.png",
    "water_backgrounds/water4.png",
]

# caves = platform_backgrounds[2], [3], [13] (resources.cpp:979-981)
CAVES = [
    PLATFORM_BACKGROUNDS[2],
    PLATFORM_BACKGROUNDS[3],
    PLATFORM_BACKGROUNDS[13],
]


import os

# The baked asset artifact of the JAX package (tools/bake_assets.py): every
# used PNG in one npz, keys img/<relpath> (RGBA u8, possibly downscaled) and
# size/<relpath> (ORIGINAL w,h).  The port reads it by path and never
# imports procgen_tpu, so both packages bake their atlases from one file.
_ARTIFACT_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "procgen_tpu", "data", "assets.npz"
)
_artifact_cache: list = []


def asset_artifact():
    if not _artifact_cache:
        if os.path.isfile(_ARTIFACT_PATH):
            import numpy as _np

            _artifact_cache.append(_np.load(_ARTIFACT_PATH))
        else:
            _artifact_cache.append(None)
    return _artifact_cache[0]


def assets_available() -> bool:
    return asset_artifact() is not None


def load_rgba(rel_path):
    """RGBA uint8 pixels for an asset from the baked artifact, or None."""
    art = asset_artifact()
    if art is not None:
        key = f"img/{rel_path}"
        if key in art.files:
            return art[key]
    return None


def png_size(rel_path):
    """Original (width, height) of an asset, or None if unavailable."""
    art = asset_artifact()
    key = f"size/{rel_path}"
    if art is not None and key in art.files:
        w, h = art[key]
        return (int(w), int(h))
    return None


def aspect_for(rel_path) -> float:
    """width/height of the sprite (basic-abstract-game.cpp:114); 1.0 when
    assets are absent."""
    size = png_size(rel_path)
    if size is None:
        return 1.0
    return size[0] / size[1]


def monochrome_color(type_, theme):
    """color_for_type in use_monochrome_assets mode
    (basic-abstract-game.cpp:464-490).  Works on Python ints and int
    tensors alike; returns (r, g, b) in [0, 255]."""
    k = 4
    kcubed = k * k * k
    chunk = 256 // k
    p1, p2 = 29, 19
    new_type = (p1 * (type_ + 1)) % kcubed
    new_type = (new_type + p2 * theme) % kcubed
    r = chunk * (new_type // (k * k) + 1) - 1
    g = chunk * ((new_type // k) % k + 1) - 1
    b = chunk * (new_type % k + 1) - 1
    return r, g, b
