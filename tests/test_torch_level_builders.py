"""The port's level-data scripts (``make_puzzles``, ``make_levels``,
``make_v01_levels``) rebuild every packaged single-level archive, array
for array, and the READMEs beside them; ``--check`` fails on a
difference; and ``make_puzzles`` writes what ``scripts/make_puzzles.py``
writes."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from safelife_torch.levels.loader import PACKAGED_LEVELS
from safelife_torch.scripts import (level_archives, make_levels,
                                    make_puzzles, make_v01_levels)

# One thread keeps torch from leaving an OpenMP pool in the test process
# that slows the JAX tests run after it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBDIRS = ("puzzles", "mazes", "patterns", "examples", "benchmarks/v0.1")


def archives(root):
    """The single-level archives under ``root`` (the v1.0 suites are
    combined archives that procgen builds), as paths relative to it."""
    found = []
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith(os.path.join("benchmarks", "v1.0")):
            continue
        found += [os.path.join(rel, f) for f in files if f.endswith(".npz")]
    return sorted(found)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("levels"))
    for script in (make_puzzles, make_levels, make_v01_levels):
        script.build(out)
    return out


def test_every_packaged_archive_is_rebuilt(built):
    got = archives(built)
    assert got == archives(PACKAGED_LEVELS)
    assert len(got) == 79
    assert level_archives.differences(built, SUBDIRS) == []


@pytest.mark.parametrize("readme", ["benchmarks/v0.1/README.md",
                                    "examples/README.md"])
def test_readmes_are_the_packaged_text(built, readme):
    with open(os.path.join(built, readme)) as a, \
            open(os.path.join(PACKAGED_LEVELS, readme)) as b:
        assert a.read() == b.read()


def test_check_fails_on_a_difference(tmp_path, capsys):
    out = str(tmp_path)

    def build(out):
        make_puzzles.build(out)
        path = os.path.join(out, "puzzles", "03 - weeding.npz")
        with np.load(path) as data:
            fields = dict(data)
        fields["board"][1, 1] ^= 1
        np.savez_compressed(path, **fields)

    level_archives.main(make_puzzles.build, ("puzzles",), "", [
        "--out", out, "--check"])
    assert "check: 0 differences" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exit_:
        level_archives.main(build, ("puzzles",), "", ["--out", out,
                                                      "--check"])
    assert exit_.value.code == 1
    assert level_archives.differences(out, ("puzzles",)) == [
        ("puzzles/03 - weeding.npz", "board")]


def test_make_puzzles_writes_what_the_jax_script_writes(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_make_puzzles", os.path.join(ROOT, "scripts", "make_puzzles.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.OUT = str(tmp_path / "jax")
    for fn in (module.p01_first_steps, module.p02_gardener,
               module.p03_weeding, module.p04_warehouse, module.p05_tug,
               module.p06_china_shop, module.p07_the_hatchery,
               module.p08_metronome):
        fn()
    make_puzzles.build(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port" / "puzzles"))
    assert len(names) == 8
    for name in names:
        with np.load(tmp_path / "jax" / name) as want, \
                np.load(tmp_path / "port" / "puzzles" / name) as got:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype, (name, key)
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{name} {key}")
