"""Command-line interface: ``python -m safelife_torch <command>`` (port of
``safelife_tpu.__main__``).

Capability parity with the reference CLI (``safelife/__main__.py``:
play/print/new/render) plus the training-framework commands the reference
keeps in separate scripts (train ~ ``start-training``, bench ~
``benchmarking.py``).  ``train``, ``bench`` and ``selftest`` run on the
CUDA card unless ``--device`` names another device; without CUDA they
refuse to start unless given ``--device cpu``.
"""

import argparse
import sys

# ``train --algo``: the policy's class (``training.driver.NETS``).
ALGOS = {"cnn": "SafeLifeCNN", "lstm": "SafeLifeLSTMNet",
         "gtrxl": "SafeLifeGTrXLNet"}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="safelife_torch",
        description="SafeLife on PyTorch and CUDA: play, render, train, "
                    "benchmark.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def device_option(p):
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; without CUDA "
                            "pass --device cpu)")

    p = sub.add_parser("play", help="interactively play levels")
    p.add_argument("levels", nargs="*", default=["puzzles"],
                   help="level files / globs / procgen yaml")
    p.add_argument("--view", type=int, default=0,
                   help="view size (0 = whole board)")
    p.add_argument("--gl", action="store_true",
                   help="play in a pyglet window (falls back to the "
                        "terminal when pyglet is unavailable)")

    p = sub.add_parser("print", help="print levels to the terminal")
    p.add_argument("levels", nargs="+")

    p = sub.add_parser("new", help="procedurally generate a new level")
    p.add_argument("params", nargs="?", default="random/append-still",
                   help="procgen yaml parameter file")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save", type=str, default=None, help="save to npz")
    p.add_argument("--play", action="store_true", help="play it")

    p = sub.add_parser("render", help="render npz level/trajectory to png/gif")
    p.add_argument("files", nargs="+")

    p = sub.add_parser("train", help="train PPO on SafeLife levels")
    p.add_argument("logdir", help="data directory for logs + checkpoints")
    p.add_argument("--task", default=None,
                   help="benchmark task curriculum (append-still, "
                        "prune-still, append-spawn, prune-spawn, "
                        "navigation); overrides --levels")
    p.add_argument("--levels", nargs="+",
                   default=["benchmarks/v1.0/append-still.npz"])
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--steps", type=float, default=6e6)
    p.add_argument("--impact-penalty", type=float, default=0.0)
    p.add_argument("--min-performance", type=float, default=0.01)
    p.add_argument("--view", type=int, default=33)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--algo", choices=tuple(ALGOS), default="cnn",
                   help="policy: feedforward CNN (default), or the "
                        "recurrent CNN+LSTM or CNN+GTrXL (12 layers, a "
                        "512-step memory) trained with RecurrentPPO")
    p.add_argument("--eval-every", type=float, default=0,
                   help="frozen-suite eval cadence in env steps "
                        "(0 = at every checkpoint; the final eval "
                        "always runs)")
    device_option(p)

    p = sub.add_parser("gen-benchmarks",
                       help="generate frozen benchmark level archives")
    p.add_argument("out_dir", help="output root for the suites")
    p.add_argument("--tasks", nargs="+", default=None)
    p.add_argument("--num-levels", type=int, default=100)
    p.add_argument("--workers", type=int, default=8)

    p = sub.add_parser("bench", help="run a policy over a benchmark suite")
    p.add_argument("suite", nargs="?", default="append-still")
    p.add_argument("--policy", default="random",
                   help="'random' or a checkpoint logdir")
    p.add_argument("--logfile", default=None)
    p.add_argument("--side-effects", type=int, default=0,
                   help="side-effect sample count (0 = skip)")
    device_option(p)

    p = sub.add_parser("selftest",
                       help="verify the device against host goldens")
    device_option(p)

    args = parser.parse_args(argv)
    return COMMANDS[args.cmd](args)


def cmd_play(args):
    from .interactive.play import GameLoop, games_from_files
    view = (args.view, args.view) if args.view else None
    loop = GameLoop(games_from_files(*args.levels), view_size=view)
    loop.run_gl() if getattr(args, "gl", False) else loop.run()


def cmd_print(args):
    from .interactive.play import GameLoop, games_from_files
    GameLoop(games_from_files(*args.levels), print_only=True).run()


def cmd_new(args):
    from .procgen import gen_game_from_file
    game = gen_game_from_file(args.params, seed=args.seed)
    if args.save:
        game.save(args.save)
        print(f"saved to {game.file_name}")
    if args.play:
        from .interactive.play import GameLoop
        GameLoop(iter([game])).run()
    else:
        from .render import text as render_text
        print(render_text.render_game(game))


def cmd_render(args):
    from .render.graphics import render_file
    from .levels import loader
    for pattern in args.files:
        for fname in loader.find_files(pattern):
            out = render_file(fname)
            print(f"{fname} -> {out}")


def cmd_train(args):
    """Train in this process, or as one rank of a data-parallel job when a
    launcher set the SAFELIFE_* variables (``safelife_torch.scripts.
    launch``): the rank joins the group, takes its card (``--device cpu``:
    gloo on the CPU) and trains its shard of ``--num-envs`` on the mesh;
    rank 0 writes the run's files."""
    import logging

    from . import resolve_device
    from .parallel import distributed
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    mesh = None
    if distributed.initialize(device=args.device):
        mesh = distributed.make_global_mesh(args.device)
    device = mesh.device if mesh else resolve_device(args.device)
    from .training.ppo import PPOConfig
    ppo_cfg = PPOConfig(data_shards=mesh.world_size if mesh else 1)
    if args.task:
        from .training.curricula import make_curriculum_trainer
        trainer, total = make_curriculum_trainer(
            args.task, impact_penalty=args.impact_penalty,
            logdir=args.logdir, num_envs=args.num_envs, seed=args.seed,
            ppo_cfg=ppo_cfg, view_shape=(args.view, args.view),
            recurrent=args.algo != "cnn", net=ALGOS[args.algo],
            eval_every=int(args.eval_every), device=device, mesh=mesh)
        trainer.restore_checkpoint()
        trainer.train(min(total, int(args.steps)) if args.steps else None)
    else:
        from .training.driver import Trainer, TrainerConfig
        cfg = TrainerConfig(
            num_envs=args.num_envs, total_steps=int(args.steps),
            view_shape=(args.view, args.view),
            impact_penalty=args.impact_penalty,
            min_performance=args.min_performance,
            seed=args.seed, logdir=args.logdir,
            recurrent=args.algo != "cnn", net=ALGOS[args.algo],
            eval_every=int(args.eval_every))
        trainer = Trainer(cfg, ppo_cfg, level_paths=tuple(args.levels),
                          device=device, mesh=mesh)
        trainer.restore_checkpoint()
        trainer.train()
    distributed.shutdown()


def cmd_bench(args):
    from . import benchmarking as B
    from . import resolve_device
    device = resolve_device(args.device)
    view = None
    if args.policy == "random":
        policy = B.random_policy()
    else:
        from .training.driver import load_policy
        policy, view = load_policy(args.policy, device=device)
    kw = {"view_shape": view} if view else {}
    results = B.run_benchmark(
        args.suite, policy, logfile=args.logfile,
        side_effect_samples=args.side_effects, device=device, **kw)
    print(B.summarize(results))


def cmd_gen_benchmarks(args):
    from .levels.iterator import gen_benchmarks
    outputs = gen_benchmarks(args.out_dir, tasks=args.tasks,
                             num_levels=args.num_levels,
                             num_workers=args.workers)
    for out in outputs:
        print(out)


def cmd_selftest(args):
    import torch

    from . import resolve_device
    from .utils.integrity import check_device_integrity
    device = resolve_device(args.device)
    check_device_integrity(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "the CPU")
    kernels = " and kernels K4 and T1" if device.type == "cuda" else ""
    print(f"integrity OK on {name}: CA advance, scoring chains, "
          f"side-effect count, reset gather{kernels} all match host goldens")


COMMANDS = {
    "play": cmd_play,
    "print": cmd_print,
    "new": cmd_new,
    "render": cmd_render,
    "train": cmd_train,
    "bench": cmd_bench,
    "gen-benchmarks": cmd_gen_benchmarks,
    "selftest": cmd_selftest,
}


if __name__ == "__main__":
    sys.exit(main())
