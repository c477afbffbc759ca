"""Pyglet window frontend for interactive play (reference
``interactive_game.py:702-815`` run_gl; port of
``safelife_tpu.interactive.gl``).

Shares all game/editor/recording logic with the terminal frontend via
:meth:`GameLoop.handle_key`; this module only maps pyglet key events to
the shared key vocabulary and blits the sprite-composited frame
(:func:`safelife_torch.render.graphics.render_game`) into the window.

pyglet is imported when the window opens, so the module imports without
it; :meth:`GameLoop.run_gl` falls back to the terminal when pyglet is
missing, matching the reference's behavior on machines without a display
stack.
"""

import numpy as np


def _keymap(K):
    """pyglet key symbol -> the frontend-agnostic key names of
    play.PLAY_KEYS &c."""
    return {
        K.UP: "UP", K.DOWN: "DOWN", K.LEFT: "LEFT", K.RIGHT: "RIGHT",
        K.SPACE: " ", K.ENTER: "\r", K.ESCAPE: "\x1b",
        K.BACKSLASH: "\\", K.COMMA: ",", K.PERIOD: ".",
        K.ASTERISK: "*",
    }


def _key_name(K, keymap, symbol, modifiers):
    if symbol in keymap:
        return keymap[symbol]
    name = K.symbol_string(symbol)  # e.g. 'A', '_8'
    if len(name) == 1 and name.isalpha():
        return name.upper() if modifiers & K.MOD_SHIFT else name.lower()
    if name == "_8" and modifiers & K.MOD_SHIFT:
        return "*"
    return None


def run_gl_loop(loop, scale=2):
    """Drive a :class:`~safelife_torch.interactive.play.GameLoop` in a
    pyglet window.  ``scale`` magnifies the 14px sprites.  Raises
    ImportError without pyglet."""
    import pyglet
    from pyglet.window import key as K

    from ..render import graphics

    keymap = _keymap(K)

    if loop.game is None and not loop.next_level():
        return

    frame = graphics.render_game(loop.game, loop.view_size)
    window = pyglet.window.Window(
        width=frame.shape[1] * scale, height=frame.shape[0] * scale,
        caption="SafeLife", resizable=True)

    state = {"image": None}

    def refresh():
        game = loop.game
        if game is None:
            return
        rgb = graphics.render_game(game, loop.view_size)
        rgb = np.ascontiguousarray(rgb[::-1])  # pyglet's origin: bottom-left
        state["image"] = pyglet.image.ImageData(
            rgb.shape[1], rgb.shape[0], "RGB", rgb.tobytes())

    refresh()

    @window.event
    def on_draw():
        window.clear()
        img = state["image"]
        if img is not None:
            img.blit(0, 0, width=window.width, height=window.height)
        title = (loop.game.title if loop.game else None) or "SafeLife"
        mode = f" [EDIT {loop.edit_mode}]" if loop.edit_mode else ""
        label = pyglet.text.Label(
            f"{title}{mode}  steps: {loop.game.num_steps if loop.game else 0}"
            f"  points: {loop.total_points}  {loop.message}",
            x=4, y=window.height - 14, font_size=10)
        label.draw()

    @window.event
    def on_key_press(symbol, modifiers):
        name = _key_name(K, keymap, symbol, modifiers)
        if name is None:
            return
        loop.handle_key(name)
        if loop.status == "QUIT":
            pyglet.app.exit()
        elif loop.status == "NEXT":
            if not loop.next_level():
                pyglet.app.exit()
        refresh()

    pyglet.app.run()
