"""The FLOP and byte formulas against hand counts."""

from portbench.harness import common, counts, weights


def config(name):
    return common.load_json(f"portbench/configs/{name}.json")


# Hand counts, two FLOPs a multiply-add, at 33x33 with 15 channels:
# conv 32x5x5/2 -> 15x15, conv 64x3x3/2 -> 7x7, conv 64x3x3/1 -> 5x5.
CONV = (2 * 15 * 15 * 32 * 5 * 5 * 15, 2 * 7 * 7 * 64 * 3 * 3 * 32,
        2 * 5 * 5 * 64 * 3 * 3 * 64)
HEADS = 2 * 512 * 9 + 2 * 512 * 1


def test_cnn_forward():
    f = counts.forward_flops(config("safelife-cnn"))
    assert f == {"bf16": sum(CONV) + 2 * 1600 * 512, "f32": HEADS}
    assert abs(sum(f.values()) / 1e6 - 10.70) < 0.01


def test_lstm_forward():
    f = counts.forward_flops(config("safelife-lstm"))
    assert f == {"bf16": sum(CONV),
                 "f32": 2 * 4 * 512 * (1600 + 512) + HEADS}


def test_train_batch_counts_backward_twice_but_the_first_layer_once():
    cfg = config("safelife-cnn")
    f = counts.train_flops(cfg, samples=10, epochs=3, rollout_samples=11)
    fwd = counts.forward_flops(cfg)
    total = sum(f.values())
    want = 11 * sum(fwd.values()) + 3 * 10 * (3 * sum(fwd.values())
                                               - CONV[0])
    assert total == want
    assert abs(counts.least_seconds({"bf16": 989e12, "f32": 67e12}) - 2) < 1e-12


def test_env_step_bytes():
    assert counts.env_step_bytes((26, 26), (33, 33), 15, 4096) == 4096 * (
        3 * 26 * 26 * 2 + 33 * 33 * 15)


def test_weight_shapes_match_the_nets():
    import torch
    from safelife_torch.training import model
    for name, cls in (("safelife-cnn", model.SafeLifeCNN),
                      ("safelife-lstm", model.SafeLifeLSTMNet)):
        cfg = config(name)
        net = cls(view_shape=tuple(cfg["view_shape"]),
                  in_channels=cfg["channels"])
        want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        made = weights.make(cfg, 2**31 + 3, torch.device("cpu"))
        assert {k: tuple(v.shape) for k, v in made.items()} == want
        again = weights.make(cfg, 2**31 + 3, torch.device("cpu"))
        assert all(torch.equal(made[k], again[k]) for k in made)
