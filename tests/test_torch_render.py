"""The port's graphics renderer and its image files against the JAX
package on the CPU: ``render_board`` pixel for pixel on the first levels
of every v1.0 suite at all four orientations, the PNG and the trajectory
GIF of ``render_file`` decoded with imageio against the JAX package's
files (which imageio writes), the GIF's frame delay, the port's PNG reader
against imageio on every colour type and row filter, a hand-drawn sprite
sheet, and the exact-palette limit.  Every comparison is exact: pixels
are integers.
"""

import os
import struct
import zlib

import imageio.v2 as imageio
import imageio.v3 as iio3
import numpy as np
import pytest

from safelife_torch import cells as C
from safelife_torch.levels import loader as tloader
from safelife_torch.render import graphics as TG
from safelife_tpu.render import graphics as JG

SUITES = ("append-still", "append-dynamic", "append-spawn", "prune-still",
          "prune-still-hard", "prune-dynamic", "prune-spawn", "navigation")


def _first_level(suite):
    return tloader.load_levels(f"benchmarks/v1.0/{suite}")[0]


@pytest.mark.parametrize("suite", SUITES)
def test_render_board_matches_jax(suite):
    lv = _first_level(suite)
    for orientation in range(4):
        got = TG.render_board(lv["board"], lv["goals"], orientation)
        want = JG.render_board(lv["board"], lv["goals"], orientation)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, f"orientation {orientation}")
    np.testing.assert_array_equal(TG.render_board(lv["board"]),
                                  JG.render_board(lv["board"]))


def _save_level(path, lv, orientation=2):
    np.savez(path, board=lv["board"], goals=lv["goals"],
             orientation=orientation)


def test_render_file_png_matches_jax(tmp_path):
    lv = _first_level("prune-dynamic")
    files = {}
    for name, module in (("port", TG), ("jax", JG)):
        path = str(tmp_path / f"{name}.npz")
        _save_level(path, lv)
        files[name] = module.render_file(path)
        assert files[name] == path[:-4] + ".png"
    got = imageio.imread(files["port"])
    np.testing.assert_array_equal(got, imageio.imread(files["jax"]))
    np.testing.assert_array_equal(got, TG.render_board(lv["board"],
                                                       lv["goals"], 2))
    np.testing.assert_array_equal(TG.read_png(files["port"]), got)


def _trajectory(path, suite="prune-spawn", n=12):
    """A trajectory npz of ``n`` frames: the first levels of a suite's bank
    under turning orientations, then a level whose board changes a little
    from frame to frame."""
    levels = tloader.load_levels(f"benchmarks/v1.0/{suite}")
    boards = [lv["board"] for lv in levels[:n // 2]]
    goals = [lv["goals"] for lv in levels[:n // 2]]
    board = levels[0]["board"].copy()
    for t in range(n - n // 2):
        board = board.copy()
        board[2 + t, 3:5] = C.LIFE | C.COLOR_B
        boards.append(board)
        goals.append(levels[0]["goals"])
    np.savez(path, board=np.stack(boards), goals=np.stack(goals),
             orientation=np.arange(n) % 4)
    return np.stack(boards), np.stack(goals), np.arange(n) % 4


def test_trajectory_gif_matches_jax(tmp_path):
    files = {}
    for name, module in (("port", TG), ("jax", JG)):
        path = str(tmp_path / f"{name}.npz")
        boards, goals, orients = _trajectory(path)
        files[name] = module.render_file(path)
        assert files[name] == path[:-4] + ".gif"
    got = imageio.mimread(files["port"])
    want = imageio.mimread(files["jax"])
    assert len(got) == len(want) == len(boards)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[..., :3], w[..., :3], f"frame {t}")
        np.testing.assert_array_equal(
            g[..., :3], TG.render_board(boards[t], goals[t], orients[t]))
    # 10 hundredths of a second a frame, the JAX package's documented
    # duration=0.1 s (imageio there writes no delay: ROADMAP C4).
    assert iio3.immeta(files["port"])["duration"] == 100
    assert iio3.immeta(files["port"])["loop"] == 0


def test_gif_frames_beyond_an_exact_palette_raise(tmp_path):
    frame = np.zeros((3, 100, 3), np.uint8)
    frame[..., 0] = np.arange(300).reshape(3, 100) % 256
    frame[..., 1] = np.arange(300).reshape(3, 100) // 256
    with pytest.raises(ValueError, match="256 colours"):
        TG.write_gif(str(tmp_path / "a.gif"), [frame])
    # 256 colours are exact.
    ok = frame[:, :, :].copy()
    ok[..., 1] = 0
    TG.write_gif(str(tmp_path / "b.gif"), [ok, ok[::-1]])
    got = imageio.mimread(str(tmp_path / "b.gif"))
    np.testing.assert_array_equal(got[0][..., :3], ok)
    np.testing.assert_array_equal(got[1][..., :3], ok[::-1])


def _filtered_png(path, image, kind):
    """An 8-bit PNG of ``image`` with every row under PNG filter ``kind``."""
    h, w = image.shape[:2]
    c = 1 if image.ndim == 2 else image.shape[2]
    raw = image.reshape(h, w * c).astype(np.int32)
    left = np.pad(raw, ((0, 0), (c, 0)))[:, :-c]
    up = np.pad(raw, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (c, 0)))[:, :-c]
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) // 2
    else:
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    rows = np.concatenate([np.full((h, 1), kind),
                           (raw - pred) & 255], axis=1).astype(np.uint8)
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d)))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_matches_imageio(tmp_path, channels):
    rng = np.random.RandomState(channels)
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    # Smooth gradients with noise, so that every filter has work to do.
    image = (np.add.outer(np.arange(23) * 7, np.arange(31) * 5)
             .reshape(23, 31, *([1] * (len(shape) - 2)))
             + rng.randint(0, 40, shape)).astype(np.uint8)
    path = str(tmp_path / "imageio.png")
    imageio.imwrite(path, image)
    np.testing.assert_array_equal(TG.read_png(path), imageio.imread(path))
    for kind in range(5):
        path = str(tmp_path / f"filter{kind}.png")
        _filtered_png(path, image, kind)
        got = TG.read_png(path)
        np.testing.assert_array_equal(got, image, f"filter {kind}")
        np.testing.assert_array_equal(got, imageio.imread(path))
    if channels == 3:
        path = str(tmp_path / "port.png")
        TG.write_png(path, image)
        np.testing.assert_array_equal(imageio.imread(path), image)
        np.testing.assert_array_equal(TG.read_png(path), image)


def test_read_png_refuses_other_formats(tmp_path):
    path = str(tmp_path / "deep.png")
    imageio.imwrite(path, np.arange(64, dtype=np.uint16).reshape(8, 8) * 999)
    with pytest.raises(ValueError, match="bit depth 16"):
        TG.read_png(path)
    path = str(tmp_path / "not.png")
    with open(path, "wb") as fh:
        fh.write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        TG.read_png(path)


def test_sprite_sheet_matches_jax(tmp_path):
    """A reference-format sprite sheet (14 px RGBA tiles, the agent's
    orientations at row 0, columns 1-4), loaded by both renderers: the
    same pixels, and the sheet's alpha shows the goal tint."""
    sheet = np.zeros((14 * 4, 14 * 5, 4), np.uint8)
    for i in range(4):
        for j in range(5):
            sheet[14 * i:14 * i + 14, 14 * j:14 * j + 14, :3] = \
                (50 * i + 20, 40 * j + 20, 180)
            sheet[14 * i + 3:14 * i + 11, 14 * j + 3:14 * j + 11, 3] = 255
    path = str(tmp_path / "sheet.png")
    imageio.imwrite(path, sheet)

    board = np.array([[C.LIFE | C.COLOR_G, C.WALL],
                      [C.PLAYER, C.SPAWNER | C.COLOR_R]], np.uint16)
    goals = np.array([[C.COLOR_B, 0], [0, C.COLOR_G]], np.uint16)
    procedural = TG.render_board(board)
    images = {}
    for name, G in (("port", TG), ("jax", JG)):
        saved = (dict(G.SPRITES), list(G.AGENT_SPRITES),
                 dict(G.SPRITE_RGB), G.AGENT_SPRITE_RGB)
        try:
            G.load_sprite_sheet(path)
            images[name] = [G.render_board(board, goals, o)
                            for o in range(4)]
        finally:  # restore the procedural art for other tests
            G.SPRITES.clear()
            G.SPRITES.update(saved[0])
            G.AGENT_SPRITES[:] = saved[1]
            G.SPRITE_RGB.clear()
            G.SPRITE_RGB.update(saved[2])
            G.AGENT_SPRITE_RGB = saved[3]
    for got, want in zip(images["port"], images["jax"]):
        np.testing.assert_array_equal(got, want)
    got = images["port"][0]
    assert got.shape == procedural.shape == (28, 28, 3)
    assert not np.array_equal(TG.render_board(board, goals), got)
    assert tuple(got[0, 14]) == tuple(TG.GOAL_RGB[0])
    assert not TG.SPRITE_RGB and TG.AGENT_SPRITE_RGB is None


def test_render_game_view(tmp_path):
    from safelife_torch.game import SafeLifeGame
    from safelife_tpu.game import SafeLifeGame as JaxGame
    lv = _first_level("append-spawn")
    path = str(tmp_path / "level.npz")
    np.savez(path, board=lv["board"], goals=lv["goals"],
             agent_loc=(int(lv["agent_col"]), int(lv["agent_row"])),
             orientation=3)
    for view in (None, (9, 11)):
        np.testing.assert_array_equal(
            TG.render_game(SafeLifeGame.load(path), view),
            JG.render_game(JaxGame.load(path), view))
    assert os.path.exists(TG.render_file(path))
