"""RGB renderer for SafeLife boards with procedurally-drawn sprites, and
the PNG and GIF files it writes (the port's copy of
``safelife_tpu.render.graphics``).

Capability parity with ``safelife/render_graphics.py`` (sprite compositing
at 14 px/cell, foreground color from the cell color, background tint from
the goal color; npz trajectory -> png/gif via ``render_file``).  The
reference ships a hand-drawn sprite sheet; here every sprite is generated
from geometry at import time — no binary assets.

The files are written with the standard library and a small host encoder,
with no imaging package: a PNG is zlib-compressed rows (:func:`write_png`,
:func:`read_png`); a GIF is GIF89a with one global palette of at most 256
colours, exact for rendered frames, whose LZW code streams come from
``gif.cpp`` (built with ``g++`` into ``safelife_torch/build/`` at first
use, :func:`write_gif`).
"""

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib

import numpy as np

from .. import cells as C

SPRITE_SIZE = 14

# Cell colors (KRGYBMCW) as foreground RGB; goals as light background tints.
CELL_RGB = np.array([
    [64, 64, 64],      # black -> dark gray so it shows on white
    [220, 50, 47],     # red
    [60, 160, 60],     # green
    [200, 160, 30],    # yellow
    [60, 90, 220],     # blue
    [170, 70, 200],    # magenta
    [40, 170, 190],    # cyan
    [250, 250, 250],   # white
], np.uint8)
GOAL_RGB = np.array([
    [200, 200, 200],   # no goal -> light gray
    [240, 190, 190],
    [190, 230, 190],
    [240, 235, 180],
    [185, 210, 245],
    [230, 195, 240],
    [190, 235, 240],
    [252, 252, 252],
], np.uint8)


def _grid():
    s = SPRITE_SIZE
    y, x = np.mgrid[0:s, 0:s]
    cy = cx = (s - 1) / 2
    return x - cx, y - cy  # centered coords


def _make_sprites():
    """mask[type] in [0,1]: 1 = foreground color, 0 = background."""
    x, y = _grid()
    r = np.hypot(x, y)
    s = SPRITE_SIZE
    sprites = {}
    sprites[C.EMPTY] = np.zeros((s, s))
    sprites[C.LIFE] = (r <= 4.2).astype(float)
    sprites[C.HARD_LIFE] = ((r <= 5.2) & (r >= 2.2)).astype(float) \
        + (r < 1.5)
    wall = np.ones((s, s))
    wall[0, :] = wall[:, 0] = 0.7
    wall[-1, :] = wall[:, -1] = 0.4
    sprites[C.WALL] = wall
    crate = np.zeros((s, s))
    crate[1:-1, 1:-1] = 1.0
    crate[np.abs(np.abs(x) - np.abs(y)) < 1.0] = 0.35
    sprites[C.CRATE] = crate
    sprites[C.TREE] = ((np.abs(x) <= (y + 6) * 0.45) & (y < 5)).astype(float) \
        + ((np.abs(x) < 1.3) & (y >= 4)).astype(float)
    sprites[C.PLANT] = (r <= 3.0).astype(float) * 0.9 \
        + ((np.abs(x) < 1.0) & (y > 2)).astype(float)
    sprites[C.ICE_CUBE] = (((np.abs(x) > 4) | (np.abs(y) > 4))
                           & (np.abs(x) <= 6) & (np.abs(y) <= 6)
                           ).astype(float) + 0.3 * ((np.abs(x) <= 4)
                                                    & (np.abs(y) <= 4))
    sprites[C.SPAWNER] = ((np.abs(x) + np.abs(y)) <= 5.5).astype(float) * 0.8
    sprites[C.HARD_SPAWNER] = ((np.abs(x) + np.abs(y)) <= 6.5).astype(float)
    sprites[C.LEVEL_EXIT] = (np.abs(np.abs(x) - np.abs(y)) < 1.4).astype(float)
    sprites[C.FOUNTAIN] = ((np.abs(x) < 1.4) | (np.abs(y) < 1.4)).astype(float) \
        * ((np.abs(x) + np.abs(y)) < 8)
    sprites[C.PARASITE] = ((np.abs(x) < 1.4) & (y < 3)).astype(float) \
        + ((r <= 1.4) * (y > 3.5))
    sprites[C.WEED] = (((np.abs(x) < 1.2) | (np.abs(y) < 1.2)
                        | (np.abs(np.abs(x) - np.abs(y)) < 1.2)) & (r < 5.5)
                       ).astype(float)
    return sprites


def _agent_sprites():
    """Arrow sprites for the 4 orientations (0=up, 1=right, 2=down, 3=left)."""
    x, y = _grid()
    up = ((np.abs(x) <= (5 - y) * 0.5) & (y >= -5) & (y <= 5)).astype(float)
    return [up, np.rot90(up, -1), np.rot90(up, 2), np.rot90(up, 1)]


SPRITES = _make_sprites()
AGENT_SPRITES = _agent_sprites()
# Optional hand-drawn art: per-type (s, s, 3) sprite RGB multiplied into
# the foreground color, reference-style (render_graphics.py:100-102:
# tile = (1-alpha)*bg + alpha*sprite_rgb*fg).  Procedural sprites have no
# RGB component (equivalent to all-ones).  Populated by load_sprite_sheet.
SPRITE_RGB = {}
AGENT_SPRITE_RGB = None

# Reference sprite-sheet layout (render_graphics.py:24-44): (row, col) of
# each cell type's 14x14 tile; the agent's four orientations sit at row 0,
# cols 1-4.
_SHEET_LAYOUT = {
    C.EMPTY: (0, 0), C.LIFE: (1, 0), C.HARD_LIFE: (1, 1),
    C.WALL: (2, 2), C.CRATE: (2, 3), C.PLANT: (1, 3), C.TREE: (1, 4),
    C.ICE_CUBE: (2, 0), C.PARASITE: (2, 4), C.WEED: (1, 2),
    C.SPAWNER: (3, 0), C.HARD_SPAWNER: (3, 2), C.LEVEL_EXIT: (3, 1),
    C.FOUNTAIN: (2, 1),
}


def load_sprite_sheet(path):
    """Use a hand-drawn sprite sheet in the reference's format.

    ``path`` is a PNG laid out as a grid of 14x14 tiles exactly like the
    reference's ``safelife/sprites.png`` (loaded at
    ``render_graphics.py:13-23``): RGBA, alpha = the compositing mask,
    RGB multiplied into the per-cell foreground color.  Grayscale/RGB
    sheets (no alpha) use luminance as the mask.  Replaces the procedural
    sprites in place; call once at startup (the CLI honors the
    ``SAFELIFE_SPRITES`` environment variable).
    """
    global AGENT_SPRITE_RGB
    sheet = read_png(path).astype(np.float32) / 255.0
    if sheet.ndim == 2:
        sheet = sheet[..., None].repeat(3, axis=-1)
    s = SPRITE_SIZE

    def tile(i, j):
        t = sheet[s * i:s * i + s, s * j:s * j + s]
        if t.shape[:2] != (s, s):
            raise ValueError(f"sprite sheet too small for tile ({i},{j})")
        if t.shape[-1] == 4:
            return t[..., 3], t[..., :3]
        return t.mean(axis=-1), np.ones((s, s, 3), np.float32)

    for cell, (i, j) in _SHEET_LAYOUT.items():
        SPRITES[cell], SPRITE_RGB[cell] = tile(i, j)
    agents = [tile(0, 1 + k) for k in range(4)]
    AGENT_SPRITES[:] = [a[0] for a in agents]
    AGENT_SPRITE_RGB = [a[1] for a in agents]


if os.environ.get("SAFELIFE_SPRITES"):
    load_sprite_sheet(os.environ["SAFELIFE_SPRITES"])


def _sprite_mask(cell, orientation):
    """Clipped [0,1] sprite mask for one (color-stripped) cell value."""
    if cell == 0:
        return np.zeros((SPRITE_SIZE, SPRITE_SIZE))
    if cell & C.AGENT:
        mask = AGENT_SPRITES[orientation % 4]
    else:
        mask = SPRITES.get(cell & ~C.COLORS)
        if mask is None:
            mask = SPRITES[C.WALL] * 0.5
    return np.clip(mask, 0, 1)


def _sprite_rgb(cell, orientation):
    """(s, s, 3) sprite color (sheet art only; ones for procedural)."""
    if cell and (cell & C.AGENT) and AGENT_SPRITE_RGB is not None:
        return AGENT_SPRITE_RGB[orientation % 4]
    rgb = SPRITE_RGB.get(cell & ~C.COLORS) if cell else None
    return np.ones((SPRITE_SIZE, SPRITE_SIZE, 3), np.float32) \
        if rgb is None else rgb


def render_board(board, goals=None, orientation=0):
    """(H, W) board -> (H*14, W*14, 3) uint8 RGB image.

    Fully vectorized (one sprite-table gather + one blend) — the renderer
    runs on 1000-frame episode gifs at every training checkpoint, so a
    per-cell Python loop is too slow.
    """
    board = np.asarray(board, np.uint16)
    goals = np.zeros_like(board) if goals is None else np.asarray(goals)
    h, w = board.shape
    s = SPRITE_SIZE
    goal_colors = (goals & C.COLORS) >> C.COLOR_BIT
    cell_colors = (board & C.COLORS) >> C.COLOR_BIT

    # One mask per DISTINCT cell value on this board (a handful), gathered
    # into an (H, W, s, s) mask field.
    values, inverse = np.unique(board, return_inverse=True)
    table = np.stack([_sprite_mask(int(v), orientation) for v in values]
                     ).astype(np.float32)
    m = table[inverse].reshape(h, w, s, s)[..., None]

    bg = GOAL_RGB[goal_colors].astype(np.float32)[:, :, None, None, :]
    fg = CELL_RGB[cell_colors].astype(np.float32)[:, :, None, None, :]
    if SPRITE_RGB:  # hand-drawn sheet art: fg modulated per pixel
        rgb_table = np.stack([_sprite_rgb(int(v), orientation)
                              for v in values]).astype(np.float32)
        fg = fg * rgb_table[inverse].reshape(h, w, s, s, 3)
    tiles = (bg * (1 - m) + fg * m).astype(np.uint8)  # (H, W, s, s, 3)
    return tiles.transpose(0, 2, 1, 3, 4).reshape(h * s, w * s, 3)


def render_game(game, view_size=None):
    """Render a SafeLifeGame to RGB (optionally agent-centered)."""
    from .text import recenter_view
    board, goals = game.board, game.goals
    if view_size is not None:
        center = (game.agent_loc[1], game.agent_loc[0])
        board = recenter_view(board, view_size, center, game.exit_locs)
        goals = recenter_view(goals, view_size, center)
    return render_board(board, goals, game.orientation)


def render_file(fname, duration=0.1):
    """Render a level npz (single frame -> .png) or a recorded trajectory
    npz with stacked boards (-> .gif, ``duration`` seconds a frame).
    Returns the output path."""
    data = np.load(fname)
    keys = data.files
    base = fname[:-4] if fname.endswith(".npz") else fname
    if "board" in keys and np.asarray(data["board"]).ndim == 3:
        boards = np.asarray(data["board"])
        goals = np.asarray(data["goals"]) if "goals" in keys else \
            np.zeros_like(boards)
        orientations = np.asarray(data["orientation"]) \
            if "orientation" in keys else np.zeros(len(boards), int)
        frames = (render_board(b, g, int(o))
                  for b, g, o in zip(boards, goals, orientations))
        out = base + ".gif"
        write_gif(out, frames, delay_cs=round(duration * 100))
    else:
        board = np.asarray(data["board"])
        goals = np.asarray(data["goals"]) if "goals" in keys else None
        orientation = int(data["orientation"]) if "orientation" in keys else 0
        out = base + ".png"
        write_png(out, render_board(board, goals, orientation))
    return out


# --- PNG ------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit gray, RGB, gray + alpha, RGBA).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path, image):
    """Write an (H, W, 3) uint8 RGB image as an 8-bit PNG, every row
    unfiltered."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8 images, not "
                         f"{image.shape} {image.dtype}")
    h, w, _ = image.shape
    rows = np.zeros((h, 1 + w * 3), np.uint8)  # filter byte 0 a row
    rows[:, 1:] = image.reshape(h, w * 3)
    with open(path, "wb") as fh:
        fh.write(_PNG_SIGNATURE)
        fh.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                 0, 0, 0)))
        fh.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fh.write(_png_chunk(b"IEND", b""))


def read_png(path):
    """Read an 8-bit, non-interlaced gray, gray + alpha, RGB or RGBA PNG
    (any of the five row filters) as an (H, W) or (H, W, C) uint8 array;
    raise ValueError naming anything else."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, kind, _, _, interlace = header
    if depth != 8 or kind not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {kind},"
            f" interlace {interlace}); 8-bit non-interlaced gray, gray + "
            f"alpha, RGB or RGBA only")
    c = _PNG_CHANNELS[kind]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        out[y] = prev = _unfilter(raw[y, 0], raw[y, 1:], prev, c)
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def _unfilter(kind, row, prev, bpp):
    """One PNG row with its filter undone (``prev`` the row above, done)."""
    if kind == 0:
        return row.copy()
    if kind == 1:  # Sub: a running sum along each channel, mod 256
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:  # Up
        return row + prev
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG row filter {kind}")
    out = row.astype(np.int32)
    up = prev.astype(np.int32)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:  # Average
            out[i] = (out[i] + (a + b) // 2) & 255
            continue
        c = up[i - bpp] if i >= bpp else 0  # Paeth
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return out.astype(np.uint8)


# --- GIF ------------------------------------------------------------------

_GIF_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "gif.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
_GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_gif_lock = threading.Lock()
_gif_lib = None
# The LZW code size of every frame: palette indices of 8 bits, so frames
# are coded before the palette is complete.
_GIF_CODE_BITS = 8


def _gif_library():
    """``gif.cpp`` as a loaded library, compiled with ``g++`` on first use
    into ``safelife_torch/build/`` under a hash of its source and flags."""
    global _gif_lib
    with _gif_lock:
        if _gif_lib is None:
            with open(_GIF_SOURCE, "rb") as fh:
                digest = hashlib.sha256(
                    " ".join(_GXX_FLAGS).encode() + fh.read()).hexdigest()
            path = os.path.join(_BUILD_DIR, f"gif-{digest[:16]}.so")
            if not os.path.exists(path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                proc = subprocess.run(
                    ["g++", *_GXX_FLAGS, _GIF_SOURCE, "-o", tmp],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for gif.cpp:\n"
                                       f"{proc.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
            u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
            lib.sl_gif_index.argtypes = [u8, ctypes.c_longlong, u8,
                                         ctypes.c_int, u8]
            lib.sl_gif_index.restype = ctypes.c_int
            lib.sl_gif_lzw.argtypes = [u8, ctypes.c_longlong, ctypes.c_int,
                                       u8, ctypes.c_longlong]
            lib.sl_gif_lzw.restype = ctypes.c_longlong
            _gif_lib = lib
        return _gif_lib


def write_gif(path, frames, delay_cs=10):
    """Write (H, W, 3) uint8 RGB frames as an endlessly looping GIF89a with
    ``delay_cs`` hundredths of a second a frame.  The global palette is
    exact, so the file decodes to the frames' own pixels; a frame set with
    more than 256 colours raises ValueError.  ``frames`` may be any
    iterable: each frame is coded as it arrives."""
    lib = _gif_library()
    palette = np.zeros((256, 3), np.uint8)
    colours = 0
    prev = None
    blocks = []
    for frame in frames:
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"GIF frames are (H, W, 3), not {frame.shape}")
        if prev is None:
            shape = frame.shape[:2]
            top, left, part = 0, 0, frame
        else:
            if frame.shape[:2] != shape:
                raise ValueError(f"frame of {frame.shape[:2]} in a GIF of "
                                 f"{shape}")
            # Only the rectangle that changed: the frame before stays
            # under it (disposal 1), as consecutive frames differ little.
            changed = (frame != prev).reshape(shape[0], -1)
            rows = np.flatnonzero(changed.any(axis=1))
            cols = np.flatnonzero(changed.any(axis=0)) // 3
            top, left = (rows[0], cols[0]) if len(rows) else (0, 0)
            bottom, right = (rows[-1], cols[-1]) if len(rows) else (0, 0)
            part = np.ascontiguousarray(frame[top:bottom + 1,
                                              left:right + 1])
        prev = frame
        n = part.shape[0] * part.shape[1]
        idx = np.empty(n, np.uint8)
        colours = lib.sl_gif_index(part.reshape(-1), n, palette, colours,
                                   idx)
        if colours < 0:
            raise ValueError("GIF frames hold more than 256 colours; an "
                             "exact palette cannot hold them")
        # Each code is at most 12 bits and covers at least one pixel.
        buf = np.empty(2 * n + 64, np.uint8)
        size = lib.sl_gif_lzw(idx, n, _GIF_CODE_BITS, buf, len(buf))
        if size < 0:
            raise RuntimeError("GIF LZW stream overran its buffer")
        code = buf[:size].tobytes()
        blocks.append(
            # Graphic control: keep the frame (disposal 1), the delay.
            b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs) + b"\x00\x00"
            # Image descriptor: the rectangle, no local palette.
            + b"\x2c" + struct.pack("<HHHH", left, top, part.shape[1],
                                    part.shape[0])
            + b"\x00" + bytes([_GIF_CODE_BITS])
            + b"".join(bytes([len(code[i:i + 255])]) + code[i:i + 255]
                       for i in range(0, len(code), 255))
            + b"\x00")
    if prev is None:
        raise ValueError("a GIF needs at least one frame")
    with open(path, "wb") as fh:
        # Screen of the frames' size, a global palette of 256 entries.
        fh.write(b"GIF89a" + struct.pack("<HH", shape[1], shape[0])
                 + b"\xf7\x00\x00" + palette.tobytes())
        # Loop forever (the NETSCAPE2.0 application extension).
        fh.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        fh.writelines(blocks)
        fh.write(b"\x3b")
