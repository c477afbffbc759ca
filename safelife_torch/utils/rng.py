"""Host-side RNG bridge replicating the reference engine's random stream
(the port's copy of ``safelife_tpu.utils.rng``).

The reference C extension consumes uniforms from numpy's *global* MT19937
stream through a 10,000-double buffer (``speedups_src/random.c:8-52``):
``seed(s)`` seeds numpy's global RNG and immediately draws a fresh buffer of
10,000 doubles; each CA spawn test pops the next double, refilling the buffer
(with another 10,000-draw) whenever it runs dry.

:class:`NumpyRandomBridge` reproduces that exact stream with a private
``RandomState`` so that fixed-seed trajectories can be replayed bit-exactly
without touching numpy's global state.  The host game
(:mod:`safelife_torch.game`) draws from it; the batched environment draws
Philox bits on the device instead (:mod:`safelife_torch.ops.rng`).
"""

import numpy as np

BUFFER_SIZE = 10000


class NumpyRandomBridge:
    """Replays the reference's buffered MT19937 uniform stream."""

    def __init__(self, seed=None):
        self.seed(seed)

    def seed(self, seed=None):
        self._state = np.random.RandomState(seed)
        # The reference refills eagerly on seed() via reset_buffer().
        self._buffer = self._state.random_sample(BUFFER_SIZE)
        self._pos = 0

    def draw(self, n):
        """Return the next ``n`` uniforms in consumption order."""
        out = np.empty(n, dtype=np.float64)
        filled = 0
        while filled < n:
            if self._pos >= BUFFER_SIZE:
                self._buffer = self._state.random_sample(BUFFER_SIZE)
                self._pos = 0
            take = min(n - filled, BUFFER_SIZE - self._pos)
            out[filled:filled + take] = self._buffer[self._pos:self._pos + take]
            self._pos += take
            filled += take
        return out

    def draw_one(self):
        return self.draw(1)[0]
