"""Procedural level generation (port of ``safelife_tpu.procgen``).

Python orchestration in :mod:`.generate`, the native annealer and labeller
in :mod:`.native`, the batched annealer and level factories on the card in
:mod:`.batched`.  This package also resolves YAML parameter files in the
reference wire format (``random/*.yaml`` with ``_defaults.yaml``
inheritance, reference ``file_finder.py:122-140``) and feeds generated
levels into level banks on a device.
"""

import functools
import os

import numpy as np

from .generate import (  # noqa: F401
    build_fence, fix_random_values, gen_game, make_partitioned_regions,
    populate_region, stability_mask)
from . import native  # noqa: F401

PARAM_TYPES = ("yaml", "json")


@functools.lru_cache()
def _default_params():
    import yaml

    from ..levels import loader
    from . import presets
    try:
        fname = next(loader.find_files("random/_defaults.yaml",
                                       file_types=PARAM_TYPES))
    except FileNotFoundError:
        return presets.DEFAULTS
    with open(fname) as fh:
        return yaml.safe_load(fh)


def load_params(source=None):
    """Resolve procgen parameters: a yaml path, a task name (built-in
    preset or ``random/<name>.yaml`` on the level search path), or a params
    dict — merged over the defaults (named_regions dict-merged)."""
    import yaml

    from ..levels import loader
    from . import presets

    defaults = _default_params()
    if source is None:
        data = {}
    elif isinstance(source, dict):
        data = source
    else:
        name = str(source)
        data = None
        if not name.endswith((".yaml", ".json")) and os.sep not in name:
            try:
                fname = next(loader.find_files(
                    os.path.join("random", name), file_types=PARAM_TYPES))
            except FileNotFoundError:
                fname = None
            if fname is None:
                if name not in presets.TASKS:
                    raise FileNotFoundError(
                        f"no procgen yaml or built-in preset named '{name}' "
                        f"(presets: {sorted(presets.TASKS)})")
                data = presets.TASKS[name]
            else:
                name = fname
        if data is None:
            if os.sep not in name or not os.path.exists(name):
                name = next(loader.find_files(name, file_types=PARAM_TYPES))
            with open(name) as fh:
                data = yaml.safe_load(fh)
    named_regions = dict(defaults.get("named_regions", {}))
    named_regions.update(data.get("named_regions", {}))
    params = dict(defaults)
    params.update(data)
    params["named_regions"] = named_regions
    return params


def gen_game_from_file(source=None, seed=None):
    """Generate one game from a yaml parameter file / task name."""
    if seed is not None:
        np.random.seed(seed)
    return gen_game(**load_params(source))


def gen_levels(source=None, num_levels=8, seed=None):
    """Generate level dicts suitable for ``levels.loader.build_bank``."""
    if seed is not None:
        np.random.seed(seed)
    params = load_params(source)
    levels = []
    for i in range(num_levels):
        game = gen_game(**params)
        levels.append(dict(
            board=game.board.astype(np.uint16),
            goals=game.goals.astype(np.uint16),
            agent_row=np.int32(game.agent_loc[1]),
            agent_col=np.int32(game.agent_loc[0]),
            orientation=np.int32(game.orientation),
            spawn_prob=np.float32(game.spawn_prob),
            min_performance=np.float32(game.min_performance),
            name=f"procgen-{i}",
        ))
    return levels


def gen_bank(source=None, num_levels=8, seed=None, device=None):
    """A LevelBank of fresh procgen levels on ``device`` (``cuda`` unless
    the caller passes another)."""
    from ..levels.loader import build_bank, group_by_shape

    levels = gen_levels(source, num_levels, seed)
    groups = group_by_shape(levels)
    if len(groups) > 1:
        # Procgen params may randomize board shape; keep the largest group.
        levels = max(groups.values(), key=len)
    return build_bank(levels, device=device)
