"""The GTrXL memory's mean valid length over the window's rollout steps,
a share of its 512 steps, in %: the program's counter, brought back in
each batch's report."""


def read(raw):
    return raw.get("memory_fill_pct") if raw.get("kind") == "train" else None
