"""Raw single-character terminal input (reference: keyboard_input.py; the
port's copy of ``safelife_tpu.interactive.keyboard``).

Reads one keypress without waiting for Enter; arrow keys arrive as escape
sequences and are translated to the names below.
"""

import sys

KEYS = {
    "\x1b[A": "UP",
    "\x1b[B": "DOWN",
    "\x1b[C": "RIGHT",
    "\x1b[D": "LEFT",
    "\x03": "INTERRUPT",   # Ctrl-C
    "\x04": "EOF",         # Ctrl-D
    "\x7f": "BACKSPACE",
}

try:
    import termios
    import tty

    def getch():
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setraw(fd)
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # escape sequence (arrows etc.)
                ch += sys.stdin.read(2)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        return ch
except ImportError:  # pragma: no cover - windows
    import msvcrt

    def getch():
        ch = msvcrt.getch()
        if ch in (b"\x00", b"\xe0"):
            ch2 = msvcrt.getch()
            return {b"H": "\x1b[A", b"P": "\x1b[B",
                    b"M": "\x1b[C", b"K": "\x1b[D"}.get(ch2, "")
        return ch.decode("utf8", errors="ignore")


def getkey():
    """One keypress, with arrows translated to 'UP'/'DOWN'/'LEFT'/'RIGHT'."""
    ch = getch()
    return KEYS.get(ch, ch)
